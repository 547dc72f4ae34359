// Backward of the fused GroupNorm (+ residual add) (+ ReLU), bf16, NHWC.
//
// Replaces: the gradient XLA derives (jax.value_and_grad at
// tensorflowonspark_tpu/parallel/train.py:410-425) of flax nn.GroupNorm,
// nn.relu and the block-end add at tensorflowonspark_tpu/models/resnet.py:
// 59-63,89.  On the TPU that is an XLA fusion, not a Pallas kernel.
//
// Inputs: dy, x, the forward's output y (only its ReLU mask, y > 0, is
// used), gamma, and the (mean, rstd) per (sample, group) in f32 that the
// forward kernel wrote (csrc/group_norm.cu, the stats output).  With
// M = H*W*C/G and xh = (x - mean) * rstd, per (sample, group):
//   dz = dy * [y > 0] with the ReLU, else dy;   d_residual = dz;
//   dx = rstd * (dz*gamma - mean_M(dz*gamma) - xh * mean_M(dz*gamma*xh));
//   dgamma_c = sum_{n,hw} dz*xh,   dbeta_c = sum_{n,hw} dz.
// Both group means follow from per-(sample, channel) sums, since
// sum_M dz*gamma = sum_{c in g} gamma_c * sum_hw dz (and likewise with
// dz*xh), so one reduction serves dx, dgamma and dbeta.
//
// Bound on an H100: device-memory bytes, as the forward (about 15 f32
// operations per element against 8-10 bytes).  The least traffic is x, y
// and dy read once and dx (and d_residual) written once.
//
// Two paths; the wrapper (kernels/group_norm.py `_plan_backward`) picks one
// by shape (and the cluster size by the card's cluster capacity) alone, and
// a failure on either raises: neither stands in for the other.
//
// One pass, gn_bwd_one_pass (every ResNet-50 norm backward at 224^2, every
// norm backward of the model zoo): ONE launch a call.  A thread-block
// cluster of k <= 16 blocks holds one sample (9-16 as a non-portable
// cluster, only where 8 blocks cannot hold dz: Inception-v3's stem
// samples); block r owns pixels [r*ceil(HW/k), ...), a contiguous byte
// range of each NHWC tensor.
//  1. Load.  Thread 0 stages the block's dy (and, where x and dz fit
//     together, x) into shared memory with four 1-D bulk copies each
//     (cp.async.bulk, one mbarrier each).  As the quarters land the
//     threads form dz = dy*[y > 0] in place (y, and x where it is not
//     resident, read with 16-byte loads, sixteen in flight per thread,
//     issued before the wait for the quarter that holds their rows; exact
//     in bf16, since dz is dy or 0) and write d_residual = dz, its one
//     write.
//  2. Block sums.  In the same sweep each thread sums dz and dz*xh in f32
//     over its pixels, always on the 16-byte vector t % (C/8); threads are
//     combined per channel in shared memory in a fixed order.
//  3. Cluster reduction.  After a cluster barrier every block reads all
//     ranks' per-channel sums through distributed shared memory in rank
//     order 0..k-1, so every block holds the sample's sums, and from them
//     the two group coefficients (gn_bwd_finalize's arithmetic).  Rank r
//     writes its slice of the channels, [r*ceil(C/k), ...), of those sums
//     to an (N, C, 2) f32 scratch, for dgamma and dbeta.
//  4. Apply.  Each block writes dx for its pixels from shared memory,
//     rounding once to bf16, last-loaded rows first.  A block arrives on a
//     second cluster barrier once it has read its peers' sums and waits on
//     it only before it exits, so its shared memory outlives every peer's
//     reads.
//  5. dgamma/dbeta across samples, with no float atomics and no second
//     launch.  After its scratch writes and a __threadfence() (step 3),
//     rank r of every cluster takes an int ticket for slice r with
//     atomicAdd; after step 4 the block that drew the last ticket (the
//     N-th) adds the N samples' sums of its slice in sample order (the
//     samples split over its threads in contiguous ranges, added in range
//     order), writes dgamma and dbeta, and resets the ticket to 0 for the
//     next call.  The sum does not depend on which cluster came last.
//     The tickets live in the wrapper's cached scratch, zeroed once when
//     it is allocated.
// Where x and dz of a sample do not fit 8 blocks together (kXResident
// false: 112^2x64, 56^2x256, and every 9-16-block sample), x stays in
// device memory and is read in steps 2 and 4, both within the cluster's
// lifetime.  Step 2 reads it under an L2 evict_last policy (createpolicy,
// ld.global.L2::cache_hint) and y under evict_first; step 4 reads x again
// under evict_first, releasing it, and walks the block's rows in reverse,
// so the rows loaded last, the likeliest still in L2, come first.  The
// clusters in flight hold at most ~2.9 MB of x each (150^2x64 over 16
// SMs), ~20 MB at the 7 clusters of 16 an H100 runs at once, inside the
// 50 MB L2: the second read is meant to hit there, leaving device-memory
// traffic at the bound's x, y, dy read once and dx written once.
// What bounds it on the card (chip_smoke.py, PERF.md): a block needs up to
// ~200 KB of shared memory, so one block holds an SM and its load, reduce,
// barrier and apply phases do not overlap another block's.  At batch 256
// a call takes 1.6-2.2x its byte bound, 1.8x over a ResNet-50 step, and is
// 1.2x faster than the four launches; at 7^2 (13 rows a block, 2.6-3.8x)
// that fixed cost a wave weighs most and it is no faster than them.  Over
// 16 blocks (Inception's stem at batch 64) a call takes 1.7-2.0x its byte
// bound against the four launches' 2.1-2.2x: an H100 runs 7 such clusters
// at once, so 64 samples are 10 waves, the last of one cluster, and in a
// cluster's life (kernels/phases.py) the step-2 sweep, three streams of
// 16-byte loads and bulk copies at ~2.6 TB/s over the card, takes over
// half.  Staging y and x through a ring of bulk copies in the ~50 KB left
// beside dz keeps less in flight than the loads and was slower.
//
// Four launches, for a sample whose dz alone exceeds 16 blocks' shared
// memory (224^2x64; none of the model zoo's), on the caller's stream:
//  1. gn_bwd_reduce, grid (chunks, N): a block sums dz and dz*xh in f32 per
//     channel over a contiguous range of one sample's pixels, thread t
//     always on the 16-byte vector t % (C/8) as in the forward's gn_stats,
//     threads combined in shared memory in a fixed order, into a
//     (N, chunks, C, 2) scratch.
//  2. gn_bwd_finalize, grid N: adds a sample's chunks in order into
//     (N, C, 2) per-channel sums, then per group the two means, into a
//     (N, G, 2) scratch.
//  3. gn_bwd_apply: one thread per 16-byte vector writes dx and, where the
//     forward had a residual, d_residual, in bf16, rounding once.
//  4. gn_bwd_params: one thread per channel adds the samples' sums in
//     order into dgamma and dbeta (f32).
// This path reads x, y and dy twice, once in each of passes 1 and 3.
// No float atomics on either path: the same bits on every run.

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

// dz of one vector: dy, zeroed where the forward's ReLU output was not
// positive.
template <bool kRelu>
__device__ __forceinline__ void load_dz(const uint4* dy, const uint4* y,
                                        long long v, float d[kVec]) {
  unpack8(dy[v], d);
  if (kRelu) {
    float o[kVec];
    unpack8(y[v], o);
#pragma unroll
    for (int j = 0; j < kVec; ++j) d[j] = o[j] > 0.f ? d[j] : 0.f;
  }
}

// partials: (N, chunks, C, 2) f32 = (sum dz, sum dz*xh).
// Shared memory: [blockDim.x][2][kVec] thread sums.
template <bool kRelu>
__global__ void gn_bwd_reduce(const uint4* __restrict__ dy,
                              const uint4* __restrict__ x,
                              const uint4* __restrict__ y,
                              const float* __restrict__ stats,
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
  const long long base = n * hw * cvecs;

  float m[kVec], rs[kVec], s[kVec], q[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int g = (cv * kVec + j) / cpg;
    m[j] = stats[(n * groups + g) * 2];
    rs[j] = stats[(n * groups + g) * 2 + 1];
    s[j] = 0.f;
    q[j] = 0.f;
  }
  for (long long r = row_begin + tid / cvecs; r < row_end;
       r += rows_per_iter) {
    const long long v = base + r * cvecs + cv;
    float d[kVec], f[kVec];
    load_dz<kRelu>(dy, y, v, d);
    unpack8(x[v], f);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      s[j] += d[j];
      q[j] += d[j] * ((f[j] - m[j]) * rs[j]);
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
  float* out = partials + (n * gridDim.x + chunk) * C * 2;
  for (int c = tid; c < C; c += nthreads) {
    const int v = c / kVec;
    const int j = c % kVec;
    float a = 0.f, b = 0.f;
    for (int k = 0; k < rows_per_iter; ++k) {
      const int t = k * cvecs + v;
      a += part[(2 * t) * kVec + j];
      b += part[(2 * t + 1) * kVec + j];
    }
    out[2 * c] = a;
    out[2 * c + 1] = b;
  }
}

// chan: (N, C, 2) f32 = a sample's (sum dz, sum dz*xh) per channel.
// coef: (N, G, 2) f32 = (mean_M(dz*gamma), mean_M(dz*gamma*xh)).
// Shared memory: [C][2] gamma-weighted channel sums.
__global__ void gn_bwd_finalize(const float* __restrict__ partials,
                                const float* __restrict__ gamma,
                                float* __restrict__ chan,
                                float* __restrict__ coef, int chunks, int C,
                                int groups, int cpg, float count) {
  extern __shared__ float wsum[];
  const long long n = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < chunks; ++k) {
      const float* p = partials + ((n * chunks + k) * C + c) * 2;
      a += p[0];
      b += p[1];
    }
    chan[(n * C + c) * 2] = a;
    chan[(n * C + c) * 2 + 1] = b;
    wsum[2 * c] = a * gamma[c];
    wsum[2 * c + 1] = b * gamma[c];
  }
  __syncthreads();
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int c = g * cpg; c < (g + 1) * cpg; ++c) {
      a += wsum[2 * c];
      b += wsum[2 * c + 1];
    }
    coef[(n * groups + g) * 2] = a / count;
    coef[(n * groups + g) * 2 + 1] = b / count;
  }
}

template <bool kRelu, bool kResidual>
__global__ void gn_bwd_apply(const uint4* __restrict__ dy,
                             const uint4* __restrict__ x,
                             const uint4* __restrict__ y,
                             const float* __restrict__ gamma,
                             const float* __restrict__ stats,
                             const float* __restrict__ coef,
                             uint4* __restrict__ dx, uint4* __restrict__ dres,
                             long long total, long long hw, int cvecs,
                             int groups, int cpg) {
  const long long per_sample = hw * cvecs;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       v < total; v += stride) {
    const int c0 = static_cast<int>(v % cvecs) * kVec;
    const long long off = (v / per_sample) * groups * 2;
    const float* st = stats + off;
    const float* cf = coef + off;
    float d[kVec], f[kVec];
    load_dz<kRelu>(dy, y, v, d);
    unpack8(x[v], f);
    if (kResidual) dres[v] = pack8(d);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int c = c0 + j;
      const int g = c / cpg;
      const float rstd = st[2 * g + 1];
      const float xh = (f[j] - st[2 * g]) * rstd;
      f[j] = rstd * (d[j] * gamma[c] - cf[2 * g] - xh * cf[2 * g + 1]);
    }
    dx[v] = pack8(f);
  }
}

// dbeta_c = sum_n chan[n, c, 0], dgamma_c = sum_n chan[n, c, 1], in order.
__global__ void gn_bwd_params(const float* __restrict__ chan,
                              float* __restrict__ dgamma,
                              float* __restrict__ dbeta, int n, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float a = 0.f, b = 0.f;
  for (int i = 0; i < n; ++i) {
    a += chan[(static_cast<long long>(i) * C + c) * 2];
    b += chan[(static_cast<long long>(i) * C + c) * 2 + 1];
  }
  dbeta[c] = a;
  dgamma[c] = b;
}

template <bool kRelu, bool kResidual>
void launch_apply(unsigned blocks, cudaStream_t s, const void* dy,
                  const void* x, const void* y, const void* gamma,
                  const void* stats, const void* coef, void* dx, void* dres,
                  long long total, long long hw, int cvecs, int groups,
                  int cpg) {
  gn_bwd_apply<kRelu, kResidual><<<blocks, kApplyThreads, 0, s>>>(
      static_cast<const uint4*>(dy), static_cast<const uint4*>(x),
      static_cast<const uint4*>(y), static_cast<const float*>(gamma),
      static_cast<const float*>(stats), static_cast<const float*>(coef),
      static_cast<uint4*>(dx), static_cast<uint4*>(dres), total, hw, cvecs,
      groups, cpg);
}

// ---- one pass over a thread-block cluster ----

constexpr int kChunks = 4;        // bulk copies per tensor, one mbarrier each
constexpr int kUnroll = 16;       // 16-byte loads a thread keeps in flight
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use
constexpr int kMaxCluster = 16;   // an H100's largest (non-portable)
                                  // cluster; tickets per call

// Shared memory of one gn_bwd_one_pass block, in this order: dz's rows
// (16-byte vectors), x's rows (only when x is resident), the 2*kChunks
// mbarriers (dy's, then x's), per-thread sums [threads][kVec], this
// block's per-channel (sum dz, sum dz*xh) [C][2] (read by the cluster's
// peers), the sample's per-channel sums times gamma [C][2], the group
// coefficients [groups][2] and a 16-byte slot for the ticket's verdict.
// kernels/group_norm.py `_one_pass_bwd_smem` computes the same sum.
__host__ __device__ inline long long bwd_one_pass_smem(
    long long rows_per_block, int cvecs, int groups, int threads,
    bool x_resident) {
  return rows_per_block * cvecs * 16 * (x_resident ? 2 : 1) +
         2LL * kChunks * 8 + static_cast<long long>(threads) * kVec * 4 +
         static_cast<long long>(cvecs) * kVec * 4 * 4 +
         static_cast<long long>(groups) * 2 * 4 + 16;
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

// L2 cache policies for ld_hinted: keep the lines (evict_last), or let
// them go first (evict_first).
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// ld_in_flight under an L2 cache policy.
__device__ __forceinline__ uint4 ld_hinted(const uint4* p, uint64_t policy) {
  uint4 v;
  asm volatile(
      "ld.global.L1::no_allocate.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, "
      "[%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy)
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

struct BwdArgs {
  const uint4* dy;
  const uint4* x;
  const uint4* y;  // the forward's output; read only with the ReLU
  const float* gamma;
  const float* stats;  // (N, groups, 2) (mean, rstd)
  uint4* dx;
  uint4* dres;      // null without a residual
  float* dparams;   // (2, C): dgamma, then dbeta
  float* chan_out;  // (N, C, 2) scratch
  int* tickets;     // [kMaxCluster], a rank each, 0 between calls
  int n, hw, cvecs, groups, cpg, rows_per_block;
};

// One vector of step 1-2: dz in place of dy (with the ReLU), d_residual,
// and the thread's sums.  v indexes the block's rows.
template <bool kRelu, bool kResidual, bool kXResident>
__device__ __forceinline__ void sum_vector(uint4* dzs, const uint4* xs,
                                           uint4* dres, int v,
                                           const uint4& yv, const uint4& xv,
                                           const float m[kVec],
                                           const float rs[kVec],
                                           float s[kVec], float q[kVec]) {
  float d[kVec], f[kVec];
  uint4 dv = dzs[v];
  unpack8(dv, d);
  if (kRelu) {
    float o[kVec];
    unpack8(yv, o);
#pragma unroll
    for (int j = 0; j < kVec; ++j) d[j] = o[j] > 0.f ? d[j] : 0.f;
    dv = pack8(d);  // exact: each entry is a bf16 value or 0
    dzs[v] = dv;
  }
  if (kResidual) dres[v] = dv;
  unpack8(kXResident ? xs[v] : xv, f);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    s[j] += d[j];
    q[j] += d[j] * ((f[j] - m[j]) * rs[j]);
  }
}

// dx of one vector, as gn_bwd_apply computes it.
__device__ __forceinline__ uint4 dx_vector(const uint4& dzv, const uint4& xv,
                                           const float m[kVec],
                                           const float rs[kVec],
                                           const float gm[kVec],
                                           const float ca[kVec],
                                           const float cb[kVec]) {
  float d[kVec], f[kVec];
  unpack8(dzv, d);
  unpack8(xv, f);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float xh = (f[j] - m[j]) * rs[j];
    f[j] = rs[j] * (d[j] * gm[j] - ca[j] - xh * cb[j]);
  }
  return pack8(f);
}

// Phase stamps, compiled in only with -DTFOS_GN_PHASE_STAMPS (the build
// that kernels/phases.py times): at each phase boundary, after a block
// barrier, thread 0 of each of the first kStampBlocks blocks reads
// %globaltimer (ns) into gn_stamps[block][i].
#ifdef TFOS_GN_PHASE_STAMPS
constexpr int kStamps = 8;
constexpr int kStampBlocks = 4096;
__device__ unsigned long long gn_stamps[kStampBlocks * kStamps];
__device__ __forceinline__ void phase_stamp(int i) {
  __syncthreads();
  const int block = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0 && block < kStampBlocks) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    gn_stamps[block * kStamps + i] = t;
  }
}
#define PHASE_STAMP(i) phase_stamp(i)
#else
#define PHASE_STAMP(i)
#endif

// grid (k, N), cluster (k, 1, 1): cluster n differentiates sample n; rank
// r owns rows (pixels) [r * rows_per_block, (r + 1) * rows_per_block).
template <bool kRelu, bool kResidual, bool kXResident>
__global__ void __launch_bounds__(kMaxThreads, 1)
    gn_bwd_one_pass(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char bwd_smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int cvecs = a.cvecs;
  const int rows_per_iter = nthreads / cvecs;
  const int cv = tid % cvecs;
  const int C = cvecs * kVec;
  const int groups = a.groups;
  const int cpg = a.cpg;
  const long long sample = blockIdx.y;
  const int row0 = rank * a.rows_per_block;
  const int rows = max(0, min(a.hw - row0, a.rows_per_block));
  const long long base = (sample * a.hw + row0) * cvecs;

  uint4* dzs = reinterpret_cast<uint4*>(bwd_smem_raw);
  uint4* xs = dzs + static_cast<size_t>(a.rows_per_block) * cvecs;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      kXResident ? xs + static_cast<size_t>(a.rows_per_block) * cvecs : xs);
  float* part = reinterpret_cast<float*>(bars + 2 * kChunks);
  float* chan = part + nthreads * kVec;
  float* tot = chan + 2 * C;
  float* coef = tot + 2 * C;
  int* last = reinterpret_cast<int*>(coef + 2 * groups);

  PHASE_STAMP(0);
  // 1. stage dy (and x): kChunks bulk copies each, one barrier each
  const int chunk_rows = (rows + kChunks - 1) / kChunks;
  if (tid == 0) {
    for (int i = 0; i < 2 * kChunks; ++i) mbar_init(&bars[i], 1);
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
        bulk_load(dzs + r0 * cvecs, a.dy + base + r0 * cvecs, bytes, &bars[i]);
      }
      if (kXResident) {
        mbar_expect_tx(&bars[kChunks + i], bytes);
        if (bytes != 0) {
          bulk_load(xs + r0 * cvecs, a.x + base + r0 * cvecs, bytes,
                    &bars[kChunks + i]);
        }
      }
    }
  }

  // 2. dz, d_residual and the thread's sums, as the chunks land
  float m[kVec], rs[kVec], s[kVec], q[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int g = (cv * kVec + j) / cpg;
    m[j] = a.stats[(sample * groups + g) * 2];
    rs[j] = a.stats[(sample * groups + g) * 2 + 1];
    s[j] = 0.f;
    q[j] = 0.f;
  }
  const uint4* yg = kRelu ? a.y + base : nullptr;
  const uint4* xg = a.x + base;
  uint4* dres = kResidual ? a.dres + base : nullptr;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  // a streamed x is kept in L2 for step 4, which releases it; y goes first
  const uint64_t keep = kXResident ? 0 : l2_evict_last();
  const uint64_t release = kXResident ? 0 : l2_evict_first();
  // kUnroll of this thread's rows at a time: their y (and streamed x)
  // loads issued together, then a wait for the chunks that hold the rows
  const int span = kUnroll * rows_per_iter;
  int landed = 0;  // chunks this thread has waited for
  for (int r = tid / cvecs; r < rows; r += span) {
    uint4 yv[kUnroll], xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = (r + u * rows_per_iter) * cvecs + cv;
      const bool in = r + u * rows_per_iter < rows;
      yv[u] = !kRelu || !in ? zero
              : kXResident  ? ld_in_flight(yg + v)
                            : ld_hinted(yg + v, release);
      xv[u] = !kXResident && in ? ld_hinted(xg + v, keep) : zero;
    }
    const int need =
        min(rows - 1, r + (kUnroll - 1) * rows_per_iter) / chunk_rows;
    for (; landed <= need; ++landed) {
      mbar_wait(&bars[landed], 0);
      if (kXResident) mbar_wait(&bars[kChunks + landed], 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * rows_per_iter < rows) {
        sum_vector<kRelu, kResidual, kXResident>(
            dzs, xs, dres, (r + u * rows_per_iter) * cvecs + cv, yv[u],
            xv[u], m, rs, s, q);
      }
    }
  }
  if (tid == 0) {  // every copy has landed before the block can exit
    for (int i = 0; i < kChunks; ++i) {
      mbar_wait(&bars[i], 0);
      if (kXResident) mbar_wait(&bars[kChunks + i], 0);
    }
  }
  PHASE_STAMP(1);
  // threads -> channels (sum dz, then sum dz*xh), in a fixed order
#pragma unroll
  for (int j = 0; j < kVec; ++j) part[tid * kVec + j] = s[j];
  __syncthreads();
  sum_to_channels(part, chan, 0, cvecs, rows_per_iter);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kVec; ++j) part[tid * kVec + j] = q[j];
  __syncthreads();
  sum_to_channels(part, chan, 1, cvecs, rows_per_iter);

  // 3. every rank's sums, read in rank order: the same sums everywhere;
  // this rank's slice of them goes to the scratch for dgamma and dbeta
  PHASE_STAMP(2);
  cluster.sync();
  PHASE_STAMP(3);
  const int slice = (C + ranks - 1) / ranks;
  const int c_lo = rank * slice;
  const int c_hi = min(C, c_lo + slice);
  // a thread owns channels tid + k * nthreads, k < kVec (C <= kVec *
  // nthreads), and each channel adds the ranks in order.  With a channel a
  // thread, every rank's load is in flight together; else ranks outermost,
  // so the thread's remote loads of one rank are in flight together
  float ta[kVec], tb[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    ta[k] = 0.f;
    tb[k] = 0.f;
  }
  if (C <= nthreads) {
    float2 v[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      const float2* p = reinterpret_cast<const float2*>(
          cluster.map_shared_rank(chan, min(r, ranks - 1)));
      v[r] = tid < C && r < ranks ? p[tid] : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < ranks) {
        ta[0] += v[r].x;
        tb[0] += v[r].y;
      }
    }
  } else {
    for (int r = 0; r < ranks; ++r) {
      const float2* p =
          reinterpret_cast<const float2*>(cluster.map_shared_rank(chan, r));
      float2 v[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int c = tid + k * nthreads;
        v[k] = c < C ? p[c] : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        ta[k] += v[k].x;
        tb[k] += v[k].y;
      }
    }
  }
  cluster_arrive();  // done reading the peers' shared memory
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int c = tid + k * nthreads;
    if (c >= C) continue;
    if (c >= c_lo && c < c_hi) {
      a.chan_out[(sample * C + c) * 2] = ta[k];
      a.chan_out[(sample * C + c) * 2 + 1] = tb[k];
    }
    tot[2 * c] = ta[k] * a.gamma[c];  // weighted by gamma, as gn_bwd_finalize
    tot[2 * c + 1] = tb[k] * a.gamma[c];
  }
  // this rank's ticket for its slice, once the slice's scratch writes are
  // visible (the fence waits on this thread's writes so far, not on dx);
  // its value is read only after step 4, so the atomic's round trip
  // overlaps the apply
  __threadfence();
  __syncthreads();
  int ticket = 0;
  if (tid == 0) ticket = atomicAdd(&a.tickets[rank], 1);
  const float count = static_cast<float>(a.hw) * static_cast<float>(cpg);
  for (int g = tid; g < groups; g += nthreads) {
    float sa = 0.f, sb = 0.f;
    for (int c = g * cpg; c < (g + 1) * cpg; ++c) {
      sa += tot[2 * c];
      sb += tot[2 * c + 1];
    }
    coef[2 * g] = sa / count;
    coef[2 * g + 1] = sb / count;
  }
  __syncthreads();

  PHASE_STAMP(4);
  // 4. dx from shared memory: this thread's 8 channels' constants in
  // registers
  float gm[kVec], ca[kVec], cb[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int c = cv * kVec + j;
    const int g = c / cpg;
    gm[j] = a.gamma[c];
    ca[j] = coef[2 * g];
    cb[j] = coef[2 * g + 1];
  }
  uint4* dxg = a.dx + base;
  // step 2's spans in reverse: a streamed x's last-loaded rows first
  for (int r0 = rows > 0 ? (rows - 1) / span * span : -1; r0 >= 0;
       r0 -= span) {
    const int r = r0 + tid / cvecs;
    uint4 xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool in = r + u * rows_per_iter < rows;
      xv[u] = !kXResident && in
                  ? ld_hinted(xg + (r + u * rows_per_iter) * cvecs + cv,
                              release)
                  : zero;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * rows_per_iter < rows) {
        const int v = (r + u * rows_per_iter) * cvecs + cv;
        dxg[v] = dx_vector(dzs[v], kXResident ? xs[v] : xv[u], m, rs, gm, ca,
                           cb);
      }
    }
  }

  // 5. the block that drew slice `rank`'s last ticket adds its samples in
  // order
  if (tid == 0) *last = ticket == a.n - 1;
  __syncthreads();
  PHASE_STAMP(5);
  if (*last) {
    // channel c of the slice, samples split into `split` contiguous
    // ranges, one thread each; the ranges' sums added in range order
    __threadfence();
    const float2* sums = reinterpret_cast<const float2*>(a.chan_out);
    const int width = max(0, c_hi - c_lo);
    const int split = width > 0 ? max(1, nthreads / width) : 1;
    const int per = (a.n + split - 1) / split;
    const int lanes = split * width;
    for (int t = tid; t < max(lanes, width); t += nthreads) {
      const int c = c_lo + t % width;
      const int i0 = split > 1 ? (t / width) * per : 0;
      const int i1 = split > 1 ? min(a.n, i0 + per) : a.n;
      float sa = 0.f, sb = 0.f;
#pragma unroll 16
      for (int i = i0; i < i1; ++i) {
        const float2 p = __ldcg(sums + static_cast<long long>(i) * C + c);
        sa += p.x;
        sb += p.y;
      }
      if (split > 1) {
        part[2 * t] = sa;
        part[2 * t + 1] = sb;
      } else {
        a.dparams[c] = sb;      // dgamma
        a.dparams[C + c] = sa;  // dbeta
      }
    }
    if (split > 1) {
      __syncthreads();
      for (int t = tid; t < width; t += nthreads) {
        float sa = 0.f, sb = 0.f;
        for (int k = 0; k < split; ++k) {
          sa += part[2 * (k * width + t)];
          sb += part[2 * (k * width + t) + 1];
        }
        a.dparams[c_lo + t] = sb;
        a.dparams[C + c_lo + t] = sa;
      }
    }
    if (tid == 0) a.tickets[rank] = 0;
  }
  PHASE_STAMP(6);
  cluster_wait();  // no peer still reads this block's sums
  PHASE_STAMP(7);
}

template <bool kRelu, bool kResidual, bool kXResident>
cudaError_t launch_bwd_one_pass(const cudaLaunchConfig_t& cfg,
                                const BwdArgs& args) {
  return cudaLaunchKernelEx(&cfg, gn_bwd_one_pass<kRelu, kResidual,
                                                  kXResident>, args);
}

template <bool kRelu, bool kResidual>
cudaError_t launch_bwd_one_pass(const cudaLaunchConfig_t& cfg,
                                const BwdArgs& args, bool x_resident) {
  return x_resident ? launch_bwd_one_pass<kRelu, kResidual, true>(cfg, args)
                    : launch_bwd_one_pass<kRelu, kResidual, false>(cfg, args);
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

template <bool kRelu, bool kResidual, bool kXResident>
cudaError_t prepare_bwd(const cudaLaunchConfig_t& cfg, int* max_clusters) {
  auto kernel = gn_bwd_one_pass<kRelu, kResidual, kXResident>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && cfg.gridDim.x > 8) {  // beyond the portable 8
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return err;
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
  if (err == cudaSuccess && fit < *max_clusters) *max_clusters = fit;
  return err;
}

}  // namespace

// The gradients of y = act(GroupNorm(x) * gamma + beta [+ residual]) over
// bf16 NHWC tensors: dx (bf16), d_residual (bf16; null when the forward had
// no residual or its gradient is not wanted), dgamma and dbeta (f32, (c,)).
// y is the forward's output (null when relu is 0); stats (n, groups, 2) f32
// its (mean, rstd).  Scratch, f32: partials (n, chunks, c, 2), chan
// (n, c, 2), coef (n, groups, 2).  The caller checks shapes, alignment
// (16 bytes), c % 8 == 0, c / 8 <= 256 and c % groups == 0.  Returns the
// first CUDA error of the four launches, 0 when all were accepted.
extern "C" int tfos_group_norm_bwd_bf16(
    const void* dy, const void* x, const void* y, const void* gamma,
    const void* stats, void* dx, void* dres, void* dgamma, void* dbeta,
    void* partials, void* chan, void* coef, long long n, long long hw, int c,
    int groups, int chunks, long long rows_per_chunk, int relu,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cvecs = c / kVec;
  const int cpg = c / groups;
  const int threads = (kMaxThreads / cvecs) * cvecs;
  if (relu && y == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(threads) * 2 * kVec * sizeof(float);
  const dim3 grid(chunks, static_cast<unsigned>(n));
  if (relu) {
    gn_bwd_reduce<true><<<grid, threads, smem, s>>>(
        static_cast<const uint4*>(dy), static_cast<const uint4*>(x),
        static_cast<const uint4*>(y), static_cast<const float*>(stats),
        static_cast<float*>(partials), hw, cvecs, groups, cpg,
        rows_per_chunk);
  } else {
    gn_bwd_reduce<false><<<grid, threads, smem, s>>>(
        static_cast<const uint4*>(dy), static_cast<const uint4*>(x), nullptr,
        static_cast<const float*>(stats), static_cast<float*>(partials), hw,
        cvecs, groups, cpg, rows_per_chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  gn_bwd_finalize<<<static_cast<unsigned>(n), kMaxThreads,
                    static_cast<size_t>(c) * 2 * sizeof(float), s>>>(
      static_cast<const float*>(partials), static_cast<const float*>(gamma),
      static_cast<float*>(chan), static_cast<float*>(coef), chunks, c, groups,
      cpg, static_cast<float>(hw * cpg));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long total = n * hw * cvecs;
  long long blocks = (total + kApplyThreads - 1) / kApplyThreads;
  if (blocks > kApplyMaxBlocks) blocks = kApplyMaxBlocks;
  const unsigned b = static_cast<unsigned>(blocks);
  if (relu) {
    if (dres != nullptr) {
      launch_apply<true, true>(b, s, dy, x, y, gamma, stats, coef, dx, dres,
                               total, hw, cvecs, groups, cpg);
    } else {
      launch_apply<true, false>(b, s, dy, x, y, gamma, stats, coef, dx, dres,
                                total, hw, cvecs, groups, cpg);
    }
  } else {
    if (dres != nullptr) {
      launch_apply<false, true>(b, s, dy, x, y, gamma, stats, coef, dx, dres,
                                total, hw, cvecs, groups, cpg);
    } else {
      launch_apply<false, false>(b, s, dy, x, y, gamma, stats, coef, dx,
                                 dres, total, hw, cvecs, groups, cpg);
    }
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  gn_bwd_params<<<(c + kMaxThreads - 1) / kMaxThreads, kMaxThreads, 0, s>>>(
      static_cast<const float*>(chan), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), static_cast<int>(n), c);
  return static_cast<int>(cudaGetLastError());
}

// On the current device: lets the one-pass backward kernels use up to
// kMaxSmem bytes of dynamic shared memory (and, for `cluster` > 8, a
// non-portable cluster), and writes to *max_clusters how
// many clusters of `cluster` blocks (`threads` threads, `smem` bytes each)
// fit on the card at once, the least over the eight variants; 0 means the
// launch cannot run.  Returns the first CUDA error, 0 when none.
extern "C" int tfos_group_norm_bwd_one_pass_prepare(int cluster, int threads,
                                                    int smem,
                                                    int* max_clusters) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      one_pass_config(&attr, cluster, 1, threads, smem, nullptr);
  *max_clusters = 1 << 30;
  cudaError_t err = cudaSuccess;
  const auto step = [&](cudaError_t (*fn)(const cudaLaunchConfig_t&, int*)) {
    if (err == cudaSuccess) err = fn(cfg, max_clusters);
  };
  step(prepare_bwd<false, false, false>);
  step(prepare_bwd<false, false, true>);
  step(prepare_bwd<false, true, false>);
  step(prepare_bwd<false, true, true>);
  step(prepare_bwd<true, false, false>);
  step(prepare_bwd<true, false, true>);
  step(prepare_bwd<true, true, false>);
  step(prepare_bwd<true, true, true>);
  if (err != cudaSuccess) *max_clusters = 0;
  return static_cast<int>(err);
}

// The same function as tfos_group_norm_bwd_bf16 in one launch: a cluster
// of `cluster` blocks per sample, `smem` bytes of dynamic shared memory per
// block, which must equal bwd_one_pass_smem for these sizes and x_resident
// (the wrapper's plan) and fit kMaxSmem; the wrapper has run the prepare
// call above on this device.  dparams: (2, c) f32, dgamma then dbeta.
// Scratch: chan (n, c, 2) f32 and tickets, kMaxCluster ints that are 0
// before the call and are 0 again after it.  Returns the CUDA error of the
// launch.
extern "C" int tfos_group_norm_bwd_one_pass_bf16(
    const void* dy, const void* x, const void* y, const void* gamma,
    const void* stats, void* dx, void* dres, void* dparams, void* chan,
    void* tickets, long long n, long long hw, int c, int groups, int cluster,
    int smem, int x_resident, int relu, void* stream) {
  const int cvecs = c / kVec;
  const int threads = (kMaxThreads / cvecs) * cvecs;
  const long long rows_per_block = (hw + cluster - 1) / cluster;
  if ((relu && y == nullptr) || hw > (1LL << 30) || cluster < 1 ||
      cluster > kMaxCluster || smem > kMaxSmem ||
      smem != bwd_one_pass_smem(rows_per_block, cvecs, groups, threads,
                                x_resident != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      one_pass_config(&attr, cluster, static_cast<unsigned>(n), threads, smem,
                      static_cast<cudaStream_t>(stream));
  BwdArgs args;
  args.dy = static_cast<const uint4*>(dy);
  args.x = static_cast<const uint4*>(x);
  args.y = static_cast<const uint4*>(y);
  args.gamma = static_cast<const float*>(gamma);
  args.stats = static_cast<const float*>(stats);
  args.dx = static_cast<uint4*>(dx);
  args.dres = static_cast<uint4*>(dres);
  args.dparams = static_cast<float*>(dparams);
  args.chan_out = static_cast<float*>(chan);
  args.tickets = static_cast<int*>(tickets);
  args.n = static_cast<int>(n);
  args.hw = static_cast<int>(hw);
  args.cvecs = cvecs;
  args.groups = groups;
  args.cpg = c / groups;
  args.rows_per_block = static_cast<int>(rows_per_block);
  const bool xr = x_resident != 0;
  cudaError_t err;
  if (relu) {
    err = dres != nullptr ? launch_bwd_one_pass<true, true>(cfg, args, xr)
                          : launch_bwd_one_pass<true, false>(cfg, args, xr);
  } else {
    err = dres != nullptr ? launch_bwd_one_pass<false, true>(cfg, args, xr)
                          : launch_bwd_one_pass<false, false>(cfg, args, xr);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

#ifdef TFOS_GN_PHASE_STAMPS
// Copies gn_stamps (kStampBlocks x kStamps ns) to host memory `out`.
extern "C" int tfos_gn_backward_phase_stamps(unsigned long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, gn_stamps, sizeof(gn_stamps)));
}
#endif
