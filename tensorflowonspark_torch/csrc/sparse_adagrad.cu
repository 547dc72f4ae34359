// AdaGrad on only the table rows a batch touched, f32, one launch a call.
//
// Replaces: tensorflowonspark_tpu/embedding.py:36 `sparse_adagrad_update`
// (the squared gradients of every occurrence of a row go into its
// accumulator first, then each occurrence's update -lr*g*rsqrt(acc+eps) is
// added, scaled by the post-accumulation value), and, with `combine`, the
// full-table pass `_dense_adagrad` at models/widedeep.py:283 after the
// gather's VJP (the occurrences' gradients summed first, then one AdaGrad
// update a row).  On the TPU both are XLA scatters and elementwise passes,
// not Pallas kernels.  Restricting the dense pass to the touched rows is
// the same function: an untouched row adds g*g = 0 to its accumulator and
// -lr*0*rsqrt(acc+eps) = -0.0 to its table entry, and x + (-0.0) == x.
//
// Bound on an H100: device-memory bytes, and at batch 1024 mostly latency.
// Per row element it does a few f32 operations against 16 bytes of table
// and accumulator traffic plus 4 bytes of gradient an occurrence.  The
// least traffic is the ids and the row gradients read once and each
// touched row of the table and the accumulator read and written once: for
// the wide&deep deep table at batch 1024 (26,624 ids, rows of 32 f32)
// about 17 MB, 5 us.  The literal dense pass moves the whole table and
// accumulator instead (about 2 GB at Config(): 2.6 M rows).
//
// Design.  The wrapper (kernels/sparse_adagrad.py) sorts the flat ids with
// a stable sort (index preparation on ints only), so the occurrences of a
// row form one segment of the sorted ids, in their order in the batch.
// One launch: a group of T threads (T = the row width rounded up to a power
// of two, at most 32: a warp for the deep table, one thread for the scalar
// rows of the wide table) takes one sorted position; a group whose
// position does not start a segment returns at once, the group that starts
// it walks the segment.  Lanes run across the row.  Each lane reads its
// accumulator and table entry once, adds the occurrences' terms in
// occurrence order and writes each once.  No float atomics and a fixed
// order: the same bits every run, and the order of the reference's
// sequential scatter.  Every product and sum is rounded on its own
// (__fmul_rn/__fadd_rn, no contraction into an FMA) and rsqrt is the
// correctly rounded 1/sqrt, as PyTorch computes it on the CPU.  The
// wrapper's sort has already wrapped each id in [-vocab, 0) to id + vocab,
// the row JAX's .at[ids] names by a negative index; an id still outside
// [0, vocab) is dropped, as JAX's scatter drops it: nothing is written out
// of bounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float rsqrt_rn(float x) {
  return __frcp_rn(__fsqrt_rn(x));
}

template <typename Id>
__global__ void __launch_bounds__(kThreads) adagrad_segments(
    const Id* __restrict__ sorted_ids, const int64_t* __restrict__ perm,
    const float* __restrict__ grads, float* __restrict__ table,
    float* __restrict__ acc, int64_t n, int64_t vocab, int dim,
    int group_log2, float neg_lr, float eps, int combine) {
  const int64_t pos =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >>
      group_log2;
  if (pos >= n) return;
  const Id id = sorted_ids[pos];
  if (pos > 0 && sorted_ids[pos - 1] == id) return;  // not a segment's start
  if (id < 0 || static_cast<int64_t>(id) >= vocab) return;
  int64_t end = pos + 1;
  while (end < n && sorted_ids[end] == id) ++end;

  const int group = 1 << group_log2;
  const int lane = threadIdx.x & (group - 1);
  const int64_t row = static_cast<int64_t>(id) * dim;
  for (int c = lane; c < dim; c += group) {
    float a = acc[row + c];
    float t = table[row + c];
    if (combine) {
      // the gather's VJP sums into a zero gradient in occurrence order
      float s = 0.0f;
      for (int64_t j = pos; j < end; ++j) {
        s = __fadd_rn(s, grads[perm[j] * dim + c]);
      }
      a = __fadd_rn(a, __fmul_rn(s, s));
      t = __fadd_rn(t, __fmul_rn(__fmul_rn(neg_lr, s),
                                 rsqrt_rn(__fadd_rn(a, eps))));
    } else {
      for (int64_t j = pos; j < end; ++j) {
        const float g = grads[perm[j] * dim + c];
        a = __fadd_rn(a, __fmul_rn(g, g));
      }
      const float r = rsqrt_rn(__fadd_rn(a, eps));
      for (int64_t j = pos; j < end; ++j) {
        const float g = grads[perm[j] * dim + c];
        t = __fadd_rn(t, __fmul_rn(__fmul_rn(neg_lr, g), r));
      }
    }
    acc[row + c] = a;
    table[row + c] = t;
  }
}

}  // namespace

// sorted_ids: the n flat ids, negative ones wrapped, sorted stably (int32 when id_bytes is 4,
// int64 when 8); perm: int64, perm[j] is the occurrence of sorted_ids[j];
// grads: (n, dim) f32, row i the gradient of occurrence i; table and acc:
// (vocab, dim) f32, updated in place.  Returns the CUDA error of the launch.
extern "C" int tfos_sparse_adagrad_f32(
    const void* sorted_ids, int id_bytes, const void* perm, const void* grads,
    void* table, void* acc, long long n, long long vocab, int dim,
    float neg_lr, float eps, int combine, void* stream) {
  if (n <= 0) return 0;
  if (dim <= 0 || (id_bytes != 4 && id_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int group_log2 = 0;
  while ((1 << group_log2) < dim && group_log2 < 5) ++group_log2;
  const long long threads = n << group_log2;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const int64_t*>(perm);
  const auto* g = static_cast<const float*>(grads);
  auto* t = static_cast<float*>(table);
  auto* a = static_cast<float*>(acc);
  if (id_bytes == 4) {
    adagrad_segments<int32_t><<<static_cast<unsigned>(blocks), kThreads, 0,
                                s>>>(
        static_cast<const int32_t*>(sorted_ids), p, g, t, a, n, vocab, dim,
        group_log2, neg_lr, eps, combine);
  } else {
    adagrad_segments<int64_t><<<static_cast<unsigned>(blocks), kThreads, 0,
                                s>>>(
        static_cast<const int64_t*>(sorted_ids), p, g, t, a, n, vocab, dim,
        group_log2, neg_lr, eps, combine);
  }
  return static_cast<int>(cudaGetLastError());
}
