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
// dz*xh), so one reduction serves dx, dgamma and dbeta.  Four launches on
// the caller's stream:
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
// No float atomics: the same bits on every run.
//
// Bound on an H100: device-memory bytes, as the forward.  The least
// traffic is x, y and dy read once and dx (and d_residual) written once;
// this design reads x, y and dy twice, once in each of passes 1 and 3.

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
