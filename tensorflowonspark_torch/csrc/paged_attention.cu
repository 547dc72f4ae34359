// The decode tier's two paged-KV kernels, f32: the K/V append and the
// attention that reads K/V in place through each row's page table.
//
// Replaces: the XLA scatters and gathers of tensorflowonspark_tpu/models/
// tinylm.py.  tfos_kv_append is `k_pool.at[i, pages, offs].set(k)` and its
// `v` twin (prefill_fn :167, prefill_chunk_fn :247, decode_fn :318);
// tfos_paged_attention is the page-table gather plus the masked softmax
// that follows it (prefill_chunk_fn :249-255, decode_fn :320-322 with
// _attend_one :124, and prefill_fn :169-173, whose positions the legacy
// prefill reads back from the pool).  None of them is a Pallas kernel: the
// JAX package has none, so these kernels are added, not owed.
//
// Geometry.  A pool is (layers, num_pages, page_size, H, K) f32; a row r
// (a decode slot, or a chunk row) holds L query positions t, each at the
// global position p = start[r] + t clamped into [0, max_len - 1] (the
// reference clips at max_len - 1; below 0 is only a guard), and its own page
// table of P physical page ids; position j of row r lives in page
// page_tables[r, j / page_size] at offset j % page_size.  Page 0 is the
// trash page: a table entry never allocated reads 0.
//
// tfos_kv_append writes k[r, t] and v[r, t] (R, L, H, K) to position p of
// layer `layer` when t < lens[r] (every t when lens is null: the decode
// step, whose idle slots carry all-zero tables), and to page 0 at offset
// p % page_size otherwise, as the reference routes padded positions to the
// trash page.  Several positions may land on one place of page 0 in a
// launch; which write wins is undefined, as it is for XLA's scatter, so
// page 0 holds garbage that nothing reads for a valid position.  A page id
// outside [0, num_pages) is dropped (XLA's scatter drops an out-of-bounds
// update).  One thread an element.
//
// tfos_paged_attention: query (r, t, h) attends over j = 0..p with the
// scores q.k / sqrt(K) (`scale`) and a softmax accumulated in f32, reading
// K and V in place; positions beyond p add nothing, exactly as the
// reference's -1e30 mask gives them a weight of 0.  A page id is clamped
// into [0, num_pages) (XLA's gather clamps).  One warp a (r, t, h), lanes
// over head_dim (K <= 128: up to 4 values a lane), an online softmax
// (running max m, sum l, output acc) over the row's positions, one page
// table entry read a page.  The butterfly sum of the warp gives every lane
// the same score, so the result is the same bits on every run.  One
// kernel serves L = 1 (the decode step, start = seq_lens) and L = a chunk
// rung (chunked prefill, start = start_lens).
//
// Bound on an H100: device-memory bytes.  Each launch must read q, the K/V
// of the positions the rows see and the tables, and write o (or, for the
// append, read k and v and write them into the pools).  At the decode
// engine's geometry (8 slots, 128 positions, 4 heads of 32) that is under
// 1 MB, well under a microsecond at 3.35 TB/s, so a launch is latency:
// the serial walk over positions (a dependent warp reduction each) sets
// its time.  This first design is simple on purpose; splitting the walk
// over warps (a split-K softmax), or a block a row that reads each K/V
// page once for every query of the row, are the redesigns it leaves open.
//
// TFOS_PLANTED_CAUSAL_OFF_BY_ONE builds a faulty twin whose causal bound
// is j < p: chip_smoke.py phase 17 checks that its gates catch it.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kMaxHeadDim = 128;
constexpr int kLanesPerWarp = 32;
constexpr int kAttnWarps = 4;  // warps a block of the attention kernel

__global__ void tfos_kv_append(float* __restrict__ k_pool,
                               float* __restrict__ v_pool,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const int* __restrict__ page_tables,
                               const int* __restrict__ start,
                               const int* __restrict__ lens, int rows, int L,
                               int hk, int P, int page_size, int num_pages,
                               int max_len, long long layer_offset) {
  const long long total = static_cast<long long>(rows) * L * hk;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int e = static_cast<int>(idx % hk);
    const long long rt = idx / hk;
    const int t = static_cast<int>(rt % L);
    const int r = static_cast<int>(rt / L);
    const int p = min(max(start[r] + t, 0), max_len - 1);
    const bool valid = lens == nullptr || t < lens[r];
    const int page = valid ? page_tables[static_cast<long long>(r) * P +
                                         p / page_size]
                           : 0;
    if (page < 0 || page >= num_pages) continue;
    const long long dst =
        layer_offset +
        (static_cast<long long>(page) * page_size + p % page_size) * hk + e;
    k_pool[dst] = k[idx];
    v_pool[dst] = v[idx];
  }
}

__global__ void tfos_paged_attention(const float* __restrict__ q,
                                     const float* __restrict__ k_pool,
                                     const float* __restrict__ v_pool,
                                     float* __restrict__ o,
                                     const int* __restrict__ page_tables,
                                     const int* __restrict__ start, int rows,
                                     int L, int H, int K, int P,
                                     int page_size, int num_pages,
                                     int max_len, long long layer_offset,
                                     float scale) {
  const int lane = threadIdx.x % kLanesPerWarp;
  const long long w = blockIdx.x * static_cast<long long>(kAttnWarps) +
                      threadIdx.x / kLanesPerWarp;
  if (w >= static_cast<long long>(rows) * L * H) return;  // whole warps
  const int h = static_cast<int>(w % H);
  const long long rt = w / H;
  const int t = static_cast<int>(rt % L);
  const int r = static_cast<int>(rt / L);
  const int hk = H * K;
  const float* qrow = q + rt * hk + static_cast<long long>(h) * K;

  float qv[kMaxHeadDim / kLanesPerWarp];
  float acc[kMaxHeadDim / kLanesPerWarp];
#pragma unroll
  for (int i = 0; i < kMaxHeadDim / kLanesPerWarp; ++i) {
    const int d = lane + i * kLanesPerWarp;
    qv[i] = d < K ? qrow[d] : 0.0f;
    acc[i] = 0.0f;
  }
#ifdef TFOS_PLANTED_CAUSAL_OFF_BY_ONE
  const int n = min(max(start[r] + t, 0), max_len - 1);  // j < p: planted
#else
  const int n = min(max(start[r] + t, 0), max_len - 1) + 1;  // j <= p
#endif
  float m = -CUDART_INF_F;
  float l = 0.0f;
  const int* table = page_tables + static_cast<long long>(r) * P;
  for (int first = 0; first < n; first += page_size) {
    int page = table[first / page_size];
    page = min(max(page, 0), num_pages - 1);
    const long long base =
        layer_offset + static_cast<long long>(page) * page_size * hk +
        static_cast<long long>(h) * K;
    const int count = min(page_size, n - first);
#pragma unroll 4
    for (int off = 0; off < count; ++off) {
      const float* krow = k_pool + base + static_cast<long long>(off) * hk;
      const float* vrow = v_pool + base + static_cast<long long>(off) * hk;
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < kMaxHeadDim / kLanesPerWarp; ++i) {
        const int d = lane + i * kLanesPerWarp;
        if (d < K) dot = fmaf(qv[i], krow[d], dot);
      }
#pragma unroll
      for (int s = kLanesPerWarp / 2; s > 0; s /= 2) {
        dot += __shfl_xor_sync(0xffffffffu, dot, s);
      }
      const float score = dot * scale;
      const float m_new = fmaxf(m, score);
      const float corr = expf(m - m_new);  // 0 at the first position
      const float weight = expf(score - m_new);
      l = l * corr + weight;
#pragma unroll
      for (int i = 0; i < kMaxHeadDim / kLanesPerWarp; ++i) {
        const int d = lane + i * kLanesPerWarp;
        if (d < K) acc[i] = acc[i] * corr + weight * vrow[d];
      }
      m = m_new;
    }
  }
  float* orow = o + rt * hk + static_cast<long long>(h) * K;
#pragma unroll
  for (int i = 0; i < kMaxHeadDim / kLanesPerWarp; ++i) {
    const int d = lane + i * kLanesPerWarp;
    if (d < K) orow[d] = acc[i] / l;
  }
}

bool geometry_ok(int rows, int L, int H, int K, int P, int page_size,
                 int num_pages, int max_len, int layer, int layers) {
  return rows >= 1 && L >= 1 && H >= 1 && K >= 1 && P >= 1 &&
         page_size >= 1 && num_pages >= 1 && max_len >= 1 &&
         static_cast<long long>(P) * page_size >= max_len && layer >= 0 &&
         layer < layers;
}

}  // namespace

// Write k and v (rows, L, H, K) into layer `layer` of the pools (layers,
// num_pages, page_size, H, K); lens may be null (every position valid).
// Returns a cudaError_t: an invalid geometry, or the launch's own error.
extern "C" int tfos_kv_append_f32(void* k_pool, void* v_pool, const void* k,
                                  const void* v, const void* page_tables,
                                  const void* start, const void* lens,
                                  int rows, int L, int H, int K, int P,
                                  int page_size, int num_pages, int max_len,
                                  int layer, int layers, void* stream) {
  if (!geometry_ok(rows, L, H, K, P, page_size, num_pages, max_len, layer,
                   layers)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hk = H * K;
  const long long total = static_cast<long long>(rows) * L * hk;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  const long long layer_offset =
      static_cast<long long>(layer) * num_pages * page_size * hk;
  tfos_kv_append<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(k_pool), static_cast<float*>(v_pool),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(page_tables), static_cast<const int*>(start),
      static_cast<const int*>(lens), rows, L, hk, P, page_size, num_pages,
      max_len, layer_offset);
  return static_cast<int>(cudaGetLastError());
}

// o (rows, L, H, K) = softmax(q.K^T * scale) V over each query's positions
// 0..min(start[r] + t, max_len - 1), K and V read in place from layer
// `layer` of the pools.  Returns a cudaError_t.
extern "C" int tfos_paged_attention_f32(const void* q, const void* k_pool,
                                        const void* v_pool, void* o,
                                        const void* page_tables,
                                        const void* start, int rows, int L,
                                        int H, int K, int P, int page_size,
                                        int num_pages, int max_len, int layer,
                                        int layers, float scale,
                                        void* stream) {
  if (!geometry_ok(rows, L, H, K, P, page_size, num_pages, max_len, layer,
                   layers) ||
      K > kMaxHeadDim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long warps = static_cast<long long>(rows) * L * H;
  const long long blocks = (warps + kAttnWarps - 1) / kAttnWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long layer_offset =
      static_cast<long long>(layer) * num_pages * page_size * H * K;
  tfos_paged_attention<<<static_cast<unsigned>(blocks),
                         kAttnWarps * kLanesPerWarp, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), static_cast<float*>(o),
      static_cast<const int*>(page_tables), static_cast<const int*>(start),
      rows, L, H, K, P, page_size, num_pages, max_len, layer_offset, scale);
  return static_cast<int>(cudaGetLastError());
}
