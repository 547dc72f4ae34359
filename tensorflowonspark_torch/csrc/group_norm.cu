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
// Design, right and simple first: three launches on the caller's stream.
//  1. gn_stats, grid (chunks, N).  A block sums x and x*x in f32 over a
//     contiguous range of pixels of one sample.  A thread reads 16-byte
//     vectors of 8 contiguous channels; a pixel's C channels are C/8
//     vectors and thread t always reads vector t % (C/8), so a warp reads
//     consecutive addresses.  The threads' sums are combined in shared
//     memory, in a fixed order, into per-group partials in a
//     (N, chunks, G, 2) f32 scratch.  No float atomics: the result is the
//     same from run to run.
//  2. gn_finalize: one thread per (sample, group) adds its chunks in order
//     and writes mean and rstd.
//  3. gn_apply: one thread per 16-byte vector computes
//     act((x - mean) * rstd * gamma + beta + residual) in f32 and writes
//     bf16, rounding once.
// What the design costs: x is read twice, once by each pass, so the traffic
// is 2|x| + |residual| + |y| against the bound's |x| + |residual| + |y|.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
