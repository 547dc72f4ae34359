// Fused GroupNorm (+ residual add) (+ ReLU), forward, bf16, NHWC.
//
// Replaces: tensorflowonspark_tpu/models/resnet.py:59-63 `norm` (flax
// nn.GroupNorm with num_groups=min(groups, ch), epsilon 1e-6, statistics
// in f32 with var = E[x^2] - E[x]^2 clamped at 0), the nn.relu after it and,
// at the end of each bottleneck, the residual add at resnet.py:89.  On the
// TPU that is an XLA fusion, not a Pallas kernel.
//
// Bound on an H100: device-memory bytes.  Per element it does about ten
// f32 operations against 4-6 bytes of traffic, far below the card's ~295
// operations per byte.  The least traffic is x read once, the residual read
// once and y written once.
//
// Two paths; the wrapper (kernels/group_norm.py `_plan`) picks one by shape
// alone, and a failure on either raises: neither stands in for the other.
//
// One pass, gn_one_pass (every ResNet-50 norm at 224^2).  A thread-block
// cluster of k <= 8 blocks holds one sample: block r of the cluster owns
// pixels [r*ceil(HW/k), ...) with all their channels, a contiguous byte
// range of NHWC x, which thread 0 stages into shared memory with four 1-D
// bulk copies (cp.async.bulk, completing on one mbarrier each), so summing
// starts when the first quarter has landed.  Each block sums x and x*x per
// channel and then per group in f32, in a fixed order; after a cluster
// barrier every block reads all ranks' group partials through distributed
// shared memory in rank order 0..k-1, so all blocks hold the same
// (mean, rstd).  Then each thread, which always owns the same 8 channels,
// keeps their mean, rstd*gamma and beta in registers, streams the
// residual in 16-byte loads, sixteen in flight per thread, normalises x out
// of shared memory and writes y in 16-byte stores.  x is read from device
// memory once.  No float atomics: the same bits on every run.  A block
// arrives on a second cluster barrier once it has read its peers' partials
// and waits on it only before it exits, so its shared memory outlives
// every peer's reads.
//
// Two passes, for a sample larger than a cluster's shared memory: three
// launches on the caller's stream.
//  1. gn_stats, grid (chunks, N).  A block sums x and x*x in f32 over a
//     contiguous range of pixels of one sample.  A thread reads 16-byte
//     vectors of 8 contiguous channels; a pixel's C channels are C/8
//     vectors and thread t always reads vector t % (C/8), so a warp reads
//     consecutive addresses.  The threads' sums are combined in shared
//     memory, in a fixed order, into per-group partials in a
//     (N, chunks, G, 2) f32 scratch.
//  2. gn_finalize: one thread per (sample, group) adds its chunks in order
//     and writes mean and rstd.
//  3. gn_apply: one thread per 16-byte vector computes
//     act((x - mean) * rstd * gamma + beta + residual) in f32 and writes
//     bf16, rounding once.
// What that costs: x is read twice, once by each pass, so the traffic is
// 2|x| + |residual| + |y| against the bound's |x| + |residual| + |y|.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kVec = 8;  // bf16 channels in one 16-byte vector
constexpr int kMaxThreads = 256;
constexpr int kApplyThreads = 256;
constexpr long long kApplyMaxBlocks = 132LL * 16;

__device__ __forceinline__ void unpack8(const uint4& u, float f[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float f[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  }
  return u;
}

// x: N * hw * cvecs vectors.  partials: (N, chunks, groups, 2) f32.
// Shared memory: [blockDim.x][2][kVec] thread sums, then [C][2] channel sums.
__global__ void gn_stats(const uint4* __restrict__ x,
                         float* __restrict__ partials, long long hw,
                         int cvecs, int groups, int cpg,
                         long long rows_per_chunk) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int rows_per_iter = nthreads / cvecs;
  const int cv = tid % cvecs;
  const int chunk = blockIdx.x;
  const long long n = blockIdx.y;
  const long long row_begin = chunk * rows_per_chunk;
  const long long row_end = min(hw, row_begin + rows_per_chunk);
  const uint4* xs = x + n * hw * cvecs;

  float s[kVec], q[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    s[j] = 0.f;
    q[j] = 0.f;
  }
  for (long long r = row_begin + tid / cvecs; r < row_end; r += rows_per_iter) {
    float f[kVec];
    unpack8(xs[r * cvecs + cv], f);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      s[j] += f[j];
      q[j] += f[j] * f[j];
    }
  }
  float* part = smem;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    part[(2 * tid) * kVec + j] = s[j];
    part[(2 * tid + 1) * kVec + j] = q[j];
  }
  __syncthreads();

  const int C = cvecs * kVec;
  float* chan = smem + nthreads * 2 * kVec;
  for (int c = tid; c < C; c += nthreads) {
    const int v = c / kVec;
    const int j = c % kVec;
    float a = 0.f, b = 0.f;
    for (int k = 0; k < rows_per_iter; ++k) {
      const int t = k * cvecs + v;
      a += part[(2 * t) * kVec + j];
      b += part[(2 * t + 1) * kVec + j];
    }
    chan[2 * c] = a;
    chan[2 * c + 1] = b;
  }
  __syncthreads();

  for (int g = tid; g < groups; g += nthreads) {
    float a = 0.f, b = 0.f;
    for (int c = g * cpg; c < (g + 1) * cpg; ++c) {
      a += chan[2 * c];
      b += chan[2 * c + 1];
    }
    float* out = partials + ((n * gridDim.x + chunk) * groups + g) * 2;
    out[0] = a;
    out[1] = b;
  }
}

// stats: (N, groups, 2) f32 = (mean, rstd).
__global__ void gn_finalize(const float* __restrict__ partials,
                            float* __restrict__ stats, int n, int chunks,
                            int groups, float count, float eps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * groups) return;
  const int b = i / groups;
  const int g = i % groups;
  float s = 0.f, q = 0.f;
  for (int k = 0; k < chunks; ++k) {
    const float* p = partials + ((static_cast<long long>(b) * chunks + k) *
                                 groups + g) * 2;
    s += p[0];
    q += p[1];
  }
  const float mean = s / count;
  const float var = fmaxf(q / count - mean * mean, 0.f);
  stats[2 * i] = mean;
  stats[2 * i + 1] = rsqrtf(var + eps);
}

__global__ void gn_apply(const uint4* __restrict__ x,
                         const uint4* __restrict__ residual,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         const float* __restrict__ stats,
                         uint4* __restrict__ y, long long total, long long hw,
                         int cvecs, int groups, int cpg, int relu) {
  const long long per_sample = hw * cvecs;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       v < total; v += stride) {
    const int c0 = static_cast<int>(v % cvecs) * kVec;
    const float* st = stats + (v / per_sample) * groups * 2;
    float f[kVec];
    float r[kVec] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    unpack8(x[v], f);
    if (residual != nullptr) unpack8(residual[v], r);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int c = c0 + j;
      const int g = c / cpg;
      float o = (f[j] - st[2 * g]) * (st[2 * g + 1] * gamma[c]) + beta[c];
      o += r[j];
      if (relu) o = fmaxf(o, 0.f);
      f[j] = o;
    }
    y[v] = pack8(f);
  }
}

// ---- one pass over a thread-block cluster ----

constexpr int kChunks = 4;        // bulk copies per block, one mbarrier each
constexpr int kUnroll = 16;       // residual loads a thread keeps in flight
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use

// Shared memory of one gn_one_pass block, in this order: x's rows
// (16-byte vectors), the chunks' mbarriers, per-thread sums
// [threads][kVec] (sums, then squares), per-channel sums [C][2], this
// block's per-group partials [groups][2] (read by the cluster's peers) and
// the sample's (mean, rstd) [groups][2].  kernels/group_norm.py
// `_one_pass_smem` computes the same sum.
__host__ __device__ inline long long one_pass_smem(long long rows_per_block,
                                                   int cvecs, int groups,
                                                   int threads) {
  return rows_per_block * cvecs * 16 + kChunks * 8LL +
         static_cast<long long>(threads) * kVec * 4 +
         static_cast<long long>(cvecs) * kVec * 2 * 4 +
         static_cast<long long>(groups) * 4 * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Arrive once and expect `bytes` of bulk copies in the current phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into this block's shared memory.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A 16-byte load that the compiler keeps ahead of the thread's later
// stores (a coherent load: a non-coherent one may sink past them), so a run
// of them is in flight together.
__device__ __forceinline__ uint4 ld_in_flight(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// chan[2 * c + which] = the sum of the owners' entries for channel c in
// part ([threads][kVec]), in thread order.
__device__ __forceinline__ void sum_to_channels(const float* part,
                                                float* chan, int which,
                                                int cvecs,
                                                int rows_per_iter) {
  for (int c = threadIdx.x; c < cvecs * kVec; c += blockDim.x) {
    const int v = c / kVec;
    const int j = c % kVec;
    float a = 0.f;
    for (int k = 0; k < rows_per_iter; ++k) {
      a += part[(k * cvecs + v) * kVec + j];
    }
    chan[2 * c + which] = a;
  }
}

template <bool kResidual, bool kRelu>
__device__ __forceinline__ uint4 apply8(const uint4& xv, const uint4& rv,
                                        const float m[kVec],
                                        const float a[kVec],
                                        const float b[kVec]) {
  float f[kVec], r[kVec];
  unpack8(xv, f);
  if (kResidual) unpack8(rv, r);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    float o = (f[j] - m[j]) * a[j] + b[j];
    if (kResidual) o += r[j];
    if (kRelu) o = fmaxf(o, 0.f);
    f[j] = o;
  }
  return pack8(f);
}

// grid (k, N), cluster (k, 1, 1): cluster n normalises sample n; rank r
// owns rows (pixels) [r * rows_per_block, (r + 1) * rows_per_block) of it.
template <bool kResidual, bool kRelu>
__global__ void __launch_bounds__(kMaxThreads)
    gn_one_pass(const uint4* __restrict__ x,
                const uint4* __restrict__ residual,
                const float* __restrict__ gamma,
                const float* __restrict__ beta, uint4* __restrict__ y,
                int hw, int cvecs, int groups, int cpg, int rows_per_block,
                float eps) {
  extern __shared__ __align__(16) unsigned char one_pass_smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int rows_per_iter = nthreads / cvecs;
  const int cv = tid % cvecs;
  const int C = cvecs * kVec;
  const int row0 = rank * rows_per_block;
  const int rows = max(0, min(hw - row0, rows_per_block));
  const long long base =
      (static_cast<long long>(blockIdx.y) * hw + row0) * cvecs;

  uint4* xs = reinterpret_cast<uint4*>(one_pass_smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      xs + static_cast<size_t>(rows_per_block) * cvecs);
  float* part = reinterpret_cast<float*>(bars + kChunks);
  float* chan = part + nthreads * kVec;
  float* gpart = chan + 2 * C;
  float* gstat = gpart + 2 * groups;

  // stage this block's rows: kChunks bulk copies, one barrier each
  const int chunk_rows = (rows + kChunks - 1) / kChunks;
  if (tid == 0) {
    for (int i = 0; i < kChunks; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < kChunks; ++i) {
      const int r0 = min(rows, i * chunk_rows);
      const int r1 = min(rows, r0 + chunk_rows);
      const uint32_t bytes = static_cast<uint32_t>(r1 - r0) * cvecs * 16u;
      mbar_expect_tx(&bars[i], bytes);
      if (bytes != 0) {
        bulk_load(xs + r0 * cvecs, x + base + r0 * cvecs, bytes, &bars[i]);
      }
    }
  }

  // per-thread sums over the chunks as they land
  float s[kVec], q[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    s[j] = 0.f;
    q[j] = 0.f;
  }
  for (int i = 0; i < kChunks; ++i) {
    const int r0 = min(rows, i * chunk_rows);
    const int r1 = min(rows, r0 + chunk_rows);
    mbar_wait(&bars[i], 0);
    for (int r = r0 + tid / cvecs; r < r1; r += rows_per_iter) {
      float f[kVec];
      unpack8(xs[r * cvecs + cv], f);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        s[j] += f[j];
        q[j] += f[j] * f[j];
      }
    }
  }
  // threads -> channels (sums, then squares) -> groups, in a fixed order
#pragma unroll
  for (int j = 0; j < kVec; ++j) part[tid * kVec + j] = s[j];
  __syncthreads();
  sum_to_channels(part, chan, 0, cvecs, rows_per_iter);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kVec; ++j) part[tid * kVec + j] = q[j];
  __syncthreads();
  sum_to_channels(part, chan, 1, cvecs, rows_per_iter);
  __syncthreads();
  for (int g = tid; g < groups; g += nthreads) {
    float a = 0.f, b = 0.f;
    for (int c = g * cpg; c < (g + 1) * cpg; ++c) {
      a += chan[2 * c];
      b += chan[2 * c + 1];
    }
    gpart[2 * g] = a;
    gpart[2 * g + 1] = b;
  }

  // every rank's partials, read in rank order: the same stats everywhere
  cluster.sync();
  const float count = static_cast<float>(hw) * static_cast<float>(cpg);
  for (int g = tid; g < groups; g += nthreads) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < ranks; ++r) {
      const float* p = cluster.map_shared_rank(gpart, r);
      a += p[2 * g];
      b += p[2 * g + 1];
    }
    const float mean = a / count;
    const float var = fmaxf(b / count - mean * mean, 0.f);
    gstat[2 * g] = mean;
    gstat[2 * g + 1] = rsqrtf(var + eps);
  }
  cluster_arrive();  // done reading the peers' shared memory
  __syncthreads();

  // apply: this thread's 8 channels' constants in registers
  float m[kVec], a[kVec], b[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int c = cv * kVec + j;
    const int g = c / cpg;
    m[j] = gstat[2 * g];
    a[j] = gstat[2 * g + 1] * gamma[c];
    b[j] = beta[c];
  }
  const uint4* rs = kResidual ? residual + base : nullptr;
  uint4* ys = y + base;
  int r = tid / cvecs;
  for (; r + (kUnroll - 1) * rows_per_iter < rows;
       r += kUnroll * rows_per_iter) {
    uint4 rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      rv[u] = kResidual
                  ? ld_in_flight(rs + (r + u * rows_per_iter) * cvecs + cv)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = (r + u * rows_per_iter) * cvecs + cv;
      ys[v] = apply8<kResidual, kRelu>(xs[v], rv[u], m, a, b);
    }
  }
  for (; r < rows; r += rows_per_iter) {
    const int v = r * cvecs + cv;
    ys[v] = apply8<kResidual, kRelu>(
        xs[v], kResidual ? rs[v] : make_uint4(0u, 0u, 0u, 0u), m, a, b);
  }
  cluster_wait();  // no peer still reads this block's partials
}

template <bool kResidual, bool kRelu>
cudaError_t launch_one_pass(const cudaLaunchConfig_t& cfg, const void* x,
                            const void* residual, const void* gamma,
                            const void* beta, void* y, int hw, int cvecs,
                            int groups, int cpg, int rows_per_block,
                            float eps) {
  return cudaLaunchKernelEx(
      &cfg, gn_one_pass<kResidual, kRelu>, static_cast<const uint4*>(x),
      static_cast<const uint4*>(residual), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<uint4*>(y), hw, cvecs,
      groups, cpg, rows_per_block, eps);
}

cudaLaunchConfig_t one_pass_config(cudaLaunchAttribute* attr, int cluster,
                                   unsigned n, int threads, int smem,
                                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, n, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kResidual, bool kRelu>
cudaError_t prepare_one(const cudaLaunchConfig_t& cfg, int* max_clusters) {
  cudaError_t err = cudaFuncSetAttribute(
      gn_one_pass<kResidual, kRelu>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && cfg.gridDim.x > 8) {  // beyond the portable 8
    err = cudaFuncSetAttribute(gn_one_pass<kResidual, kRelu>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  }
  if (err != cudaSuccess) return err;
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, gn_one_pass<kResidual, kRelu>,
                                       &cfg);
  if (err == cudaSuccess && fit < *max_clusters) *max_clusters = fit;
  return err;
}

}  // namespace

// y = act(GroupNorm(x) * gamma + beta [+ residual]) over bf16 NHWC x.
// residual may be null.  partials: (n, chunks, groups, 2) f32 scratch;
// stats: (n, groups, 2) f32 scratch.  The caller checks shapes, alignment
// (16 bytes), c % 8 == 0, c / 8 <= 256 and c % groups == 0.  Returns the
// first CUDA error of the three launches, 0 when all were accepted.
extern "C" int tfos_group_norm_act_bf16(
    const void* x, const void* residual, const void* gamma, const void* beta,
    void* y, void* partials, void* stats, long long n, long long hw, int c,
    int groups, int chunks, long long rows_per_chunk, float eps, int relu,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cvecs = c / kVec;
  const int cpg = c / groups;
  const int threads = (kMaxThreads / cvecs) * cvecs;
  const size_t smem =
      (static_cast<size_t>(threads) * 2 * kVec + static_cast<size_t>(c) * 2) *
      sizeof(float);
  gn_stats<<<dim3(chunks, static_cast<unsigned>(n)), threads, smem, s>>>(
      static_cast<const uint4*>(x), static_cast<float*>(partials), hw, cvecs,
      groups, cpg, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int ng = static_cast<int>(n) * groups;
  gn_finalize<<<(ng + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partials), static_cast<float*>(stats),
      static_cast<int>(n), chunks, groups, static_cast<float>(hw * cpg), eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long total = n * hw * cvecs;
  long long blocks = (total + kApplyThreads - 1) / kApplyThreads;
  if (blocks > kApplyMaxBlocks) blocks = kApplyMaxBlocks;
  gn_apply<<<static_cast<unsigned>(blocks), kApplyThreads, 0, s>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(residual),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(stats), static_cast<uint4*>(y), total, hw,
      cvecs, groups, cpg, relu);
  return static_cast<int>(cudaGetLastError());
}

// On the current device: lets the one-pass kernels use up to kMaxSmem
// bytes of dynamic shared memory, and writes to *max_clusters how many
// clusters of `cluster` blocks (`threads` threads, `smem` bytes each) fit
// on the card at once, the least over the four variants; 0 means the
// launch cannot run.  Returns the first CUDA error, 0 when none.
extern "C" int tfos_group_norm_one_pass_prepare(int cluster, int threads,
                                                int smem, int* max_clusters) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      one_pass_config(&attr, cluster, 1, threads, smem, nullptr);
  *max_clusters = 1 << 30;
  cudaError_t err = prepare_one<false, false>(cfg, max_clusters);
  if (err == cudaSuccess) err = prepare_one<false, true>(cfg, max_clusters);
  if (err == cudaSuccess) err = prepare_one<true, false>(cfg, max_clusters);
  if (err == cudaSuccess) err = prepare_one<true, true>(cfg, max_clusters);
  if (err != cudaSuccess) *max_clusters = 0;
  return static_cast<int>(err);
}

// The same function as tfos_group_norm_act_bf16 in one launch: a cluster
// of `cluster` blocks per sample, `smem` bytes of dynamic shared memory per
// block, which must equal one_pass_smem for these sizes (the wrapper's
// plan) and fit kMaxSmem; the wrapper has run the prepare call above on
// this device.  No scratch.  Returns the CUDA error of the launch.
extern "C" int tfos_group_norm_one_pass_bf16(
    const void* x, const void* residual, const void* gamma, const void* beta,
    void* y, long long n, long long hw, int c, int groups, int cluster,
    int smem, float eps, int relu, void* stream) {
  const int cvecs = c / kVec;
  const int threads = (kMaxThreads / cvecs) * cvecs;
  const long long rows_per_block = (hw + cluster - 1) / cluster;
  if (hw > (1LL << 30) || smem > kMaxSmem ||
      smem != one_pass_smem(rows_per_block, cvecs, groups, threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      one_pass_config(&attr, cluster, static_cast<unsigned>(n), threads, smem,
                      static_cast<cudaStream_t>(stream));
  const int h = static_cast<int>(hw);
  const int cpg = c / groups;
  const int rpb = static_cast<int>(rows_per_block);
  cudaError_t err;
  if (residual != nullptr) {
    err = relu ? launch_one_pass<true, true>(cfg, x, residual, gamma, beta, y,
                                             h, cvecs, groups, cpg, rpb, eps)
               : launch_one_pass<true, false>(cfg, x, residual, gamma, beta,
                                              y, h, cvecs, groups, cpg, rpb,
                                              eps);
  } else {
    err = relu ? launch_one_pass<false, true>(cfg, x, residual, gamma, beta,
                                              y, h, cvecs, groups, cpg, rpb,
                                              eps)
               : launch_one_pass<false, false>(cfg, x, residual, gamma, beta,
                                               y, h, cvecs, groups, cpg, rpb,
                                               eps);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
