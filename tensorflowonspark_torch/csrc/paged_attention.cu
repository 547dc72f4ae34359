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
// update).
//
// The append is a copy: 2 R L H K floats read and as many written (256
// rows x 128 positions of tinylm.Config(): 67 MB, 0.020 ms at 3.35 TB/s),
// so bytes in flight and instructions a byte set its speed.  Design: a
// (row r, position t) is one work item, and a warp moves an item's row of
// H K floats of k and of v as 16-byte (float4) copies, lane c the c-th
// float4 (striding by 32 for rows wider than 128 floats).  The item's
// k and v loads go out (read-only path) before its scalars come back, so
// nothing is stored before every load of its first chunk is issued.  The
// item's start[r], lens[r] and page-table entry are read once an item (a
// broadcast: every lane the same address), with 32-bit index arithmetic
// (r = item / L and the page p / page_size); the pool offset is formed once
// an item in 64 bits (layers x pages x page_size x H K may pass 2^31).  The
// grid, ceil(R L / warps a block) blocks, is fixed by the shapes alone
// (kernels/paged_attention.py::append_plan), so a CUDA graph replays it
// with new start values.  No atomics,
// one launch a call: the same bits on every run, page 0 aside.
//
// tfos_paged_attention: query (r, t, h) attends over j = 0..p with the
// scores q.k * `scale` and a softmax accumulated in f32, reading K and V in
// place; positions beyond p add nothing, exactly as the reference's -1e30
// mask gives them a weight of 0.  A page id is clamped into [0, num_pages)
// (XLA's gather clamps).  One kernel serves L = 1 (the decode step, start =
// seq_lens) and L = a chunk rung (chunked prefill, start = start_lens).
//
// Design: one block of 128 threads a (row, head, tile of QT queries); the
// grid, R * H * ceil(L / QT) blocks, is fixed by the shapes alone, so a
// CUDA graph replays it with new start values.  The block reads its row's
// page-table entries and its query tile beside start[r], then walks the
// positions 0..n-1 that its last query sees (n = p_last + 1, read on the
// device) a tile of TP at a time: each tile's K and V slices of the head
// (K floats a position) are staged in shared memory by 16-byte cp.async
// copies, two stages deep (the next tile in flight while the block works
// on this one), so each K/V element crosses device memory once a (row,
// head, query tile) and not once a query.  A staged tile's tail
// past n is zero-filled; nothing past n is ever loaded.  A tile is then
//   scored and weighted: warp w holds queries w, w + 4, ... (QA of them)
//     over the whole tile, a lane TP / 32 positions, dot products read
//     from shared memory with q broadcast; a score past its query's bound
//     is -inf; one butterfly a query gives the tile's max, the running max
//     m rescales once a tile (corr = 2^(m_old - m_new), scores in the log2
//     domain) and the weights go to shared memory; each lane keeps its own
//     share of the sum l, added up once at the end;
//   applied: a group of ceil_pow2(K/4) lanes holds a query's output, four
//     dims a lane, for QPT queries; acc = acc * corr + P V over the staged
//     V tile.  A query never touches a V row past its own bound (a padded
//     chunk position may hold anything: 0 * NaN is NaN).  Where the tile
//     has fewer queries than groups (the decode step, QT = 1) the groups
//     split the tile's positions, JS ways, and their partial outputs, all
//     scaled by the same m, are summed through shared memory in a fixed
//     order at the end.
// Two barriers a tile, no atomics and one launch a call: the result is the
// same bits on every run.  The host-side plan
// (kernels/paged_attention.py::plan) chooses QT (1 for the decode step;
// else up to 32, halved until the grid fills the card, down to 4), TP (64
// for K <= 32, else 32), the threads and the dynamic shared memory; the entry checks them against the layout it computes
// (attn_layout) and refuses what no instantiation takes.  Above 48 KB
// (K > 64, or a long table) the kernel's
// MaxDynamicSharedMemorySize is raised once a device by
// tfos_paged_attention_prepare when the library loads or a plan first
// needs it, before any capture of the decode engine (its warmup runs every
// signature eagerly first).
//
// Bound on an H100: the bytes (q, the K/V of the distinct positions the
// rows see, the tables, o at 3.35 TB/s) and the f32 operations (4 a head
// element for each (query, position) pair at 67 TFLOP/s outside the tensor
// cores, which TF32 would put out of the 1e-5 gate) bound it alike at size:
// 256 rows x 128 causal positions of tinylm.Config() (4 heads of 32) read
// 67 MB, 0.020 ms, against 0.016 ms of FMAs.  The decode step (8 rows, 32
// blocks, <= 128 positions) is latency: the table and start loads, the
// staged tiles' copies, and two barriers a tile.
//
// TFOS_PLANTED_CAUSAL_OFF_BY_ONE builds a faulty twin whose causal bound
// is j < p, TFOS_PLANTED_APPEND_OFF_BY_ONE one whose append writes offset
// (p + 1) % page_size of p's page: chip_smoke.py phase 17 checks that its
// gates catch each.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxHeadDim = 128;
constexpr int kThreads = 128;  // threads a block of the attention kernel
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;  // K/V tiles staged at once (more was no faster)
constexpr int kSmemOptIn = 232448;  // 227 KB: a block's most on an H100
constexpr int kMinBlocks = 5;  // attention blocks an SM: <= 102 registers
                               // (4 where a thread holds 8 queries' scores)
constexpr int kScoreUnroll = 2;  // head_dim / 4 steps of a score unrolled

// Floats a lane copies at once: a float4, 16 bytes (1 is the probe's
// 4-byte variant, tools/torch_paged_attention_probe.py).
constexpr int kAppendVec = 4;
#ifdef TFOS_PLANTED_APPEND_OFF_BY_ONE
constexpr int kAppendSlotShift = 1;  // planted: offset (p + 1) % page_size
#else
constexpr int kAppendSlotShift = 0;
#endif

template <int N>
struct VecOf;
template <>
struct VecOf<4> {
  using type = float4;
};
template <>
struct VecOf<1> {
  using type = float;
};

struct AppendArgs {
  float* k_pool;
  float* v_pool;
  const float* k;
  const float* v;
  const int* page_tables;
  const int* start;
  const int* lens;  // null: every position valid
  long long layer_offset;  // floats before layer `layer` of a pool
  int items;  // R * L
  int L, hk, P, page_size, num_pages, max_len;
};

// One warp a (row, position) item.
__global__ void tfos_kv_append(const AppendArgs a) {
  using Vec = VecOf<kAppendVec>::type;
  const int item = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (item >= a.items) return;  // the last block's spare warps
  const int c0 = (threadIdx.x & 31) * kAppendVec;
  const long long src = static_cast<long long>(item) * a.hk;
  Vec kv, vv;
  if (c0 < a.hk) {  // the row's first chunk, in flight while the scalars come
    kv = __ldg(reinterpret_cast<const Vec*>(a.k + src + c0));
    vv = __ldg(reinterpret_cast<const Vec*>(a.v + src + c0));
  }
  const int r = item / a.L;
  const int t = item - r * a.L;
  const int p = min(max(__ldg(a.start + r) + t, 0), a.max_len - 1);
  const bool valid = a.lens == nullptr || t < __ldg(a.lens + r);
  const int pg = p / a.page_size;
  const int page =
      valid ? __ldg(a.page_tables + static_cast<long long>(r) * a.P + pg) : 0;
  int slot = p - pg * a.page_size + kAppendSlotShift;
  if (slot == a.page_size) slot = 0;
  const long long dst =
      a.layer_offset + (static_cast<long long>(page) * a.page_size + slot) *
                           a.hk;
  if (page < 0 || page >= a.num_pages) return;  // outside the pool
  for (int c = c0; c < a.hk;) {
    *reinterpret_cast<Vec*>(a.k_pool + dst + c) = kv;
    *reinterpret_cast<Vec*>(a.v_pool + dst + c) = vv;
    c += 32 * kAppendVec;
    if (c >= a.hk) break;
    kv = __ldg(reinterpret_cast<const Vec*>(a.k + src + c));  // wider rows
    vv = __ldg(reinterpret_cast<const Vec*>(a.v + src + c));
  }
}

struct AttnArgs {
  const float* q;
  const float* k_pool;
  const float* v_pool;
  float* o;
  const int* page_tables;
  const int* start;
  long long layer_offset;
  float scale;
  int L, H, K, P, page_size, num_pages, max_len;
  int qt, tp, nqt, pages;  // the plan's tiles, query tiles a row, table
};

// Byte offsets of the attention block's dynamic shared memory: two
// K tiles (TP rows of K + 4 floats: the pad keeps a quarter warp's 16-byte
// reads of 8 rows on distinct banks) and V tiles (TP rows of K floats:
// lanes read along a row), the query tile (broadcast reads), the weights
// (TP + 4 floats a query: four rows' 16-byte reads on distinct banks),
// corr, l and the bound a query, the table.  Keep
// kernels/paged_attention.py::_smem in step.
struct AttnLayout {
  int ks, vs, qs, ss, corr, lsum, pq, tbl, total;
};

__host__ __device__ inline AttnLayout attn_layout(int qt, int tp, int K,
                                                  int pages) {
  const int kp = K + 4, sp = tp + 4;
  AttnLayout a;
  a.ks = 0;
  a.vs = a.ks + kStages * tp * kp * 4;
  a.qs = a.vs + kStages * tp * K * 4;
  a.ss = a.qs + qt * K * 4;
  a.corr = a.ss + qt * sp * 4;
  a.lsum = a.corr + qt * 4;
  a.pq = a.lsum + qt * 4;
  a.tbl = a.pq + qt * 4;
  a.total = a.tbl + pages * 4;
  return a;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fma4(float4& acc, float p, const float4& v) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
}

// Stage positions [j0, j0 + TP) of head h's K and V into one stage, a
// 16-byte column `col` (4 floats; col < K / 4) of rows row0, row0 + rstep,
// ... a thread: rows past n (the block's walk) are zero-filled and never
// loaded.
__device__ __forceinline__ void stage_tile(const AttnArgs& a, float* kd,
                                           float* vd, const int* tbl,
                                           long long head, int col, int row0,
                                           int rstep, int j0, int n) {
  const int kp = a.K + 4;
  const int cnt = min(a.tp, n - j0);
  const long long hk = static_cast<long long>(a.H) * a.K;
  for (int row = row0; row < a.tp; row += rstep) {
    float* kdst = kd + row * kp + 4 * col;
    float* vdst = vd + row * a.K + 4 * col;
    if (row < cnt) {
      const int j = j0 + row;
      const int page = j / a.page_size;
      const long long src =
          a.layer_offset +
          (static_cast<long long>(tbl[page]) * a.page_size + j -
           page * a.page_size) * hk +
          head + 4 * col;
      cp_async16(kdst, a.k_pool + src);
      cp_async16(vdst, a.v_pool + src);
    } else {
      *reinterpret_cast<float4*>(kdst) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(vdst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// QA: queries a scoring thread holds; JB: positions a lane scores (TP / 32:
// a warp scores whole rows of the tile); QPT: queries a lane group
// accumulates.
template <int QA, int JB, int QPT>
__global__ void __launch_bounds__(kThreads, QA >= 8 ? 4 : kMinBlocks)
    tfos_paged_attention(const AttnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const AttnLayout lay = attn_layout(a.qt, a.tp, a.K, a.pages);
  float* ks = reinterpret_cast<float*>(smem + lay.ks);
  float* vs = reinterpret_cast<float*>(smem + lay.vs);
  float* qs = reinterpret_cast<float*>(smem + lay.qs);
  float* ss = reinterpret_cast<float*>(smem + lay.ss);
  float* corr = reinterpret_cast<float*>(smem + lay.corr);
  float* lsum = reinterpret_cast<float*>(smem + lay.lsum);
  int* pq = reinterpret_cast<int*>(smem + lay.pq);
  int* tbl = reinterpret_cast<int*>(smem + lay.tbl);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int QT = a.qt, TP = a.tp, K = a.K, K4 = K / 4;
  const int kp = K + 4, sp = TP + 4;
  const int kstage = TP * kp, vstage = TP * K;
  const int qtile = static_cast<int>(blockIdx.x % a.nqt);
  const int rh = static_cast<int>(blockIdx.x / a.nqt);
  const int h = rh % a.H, r = rh / a.H;
  const int t0 = qtile * QT;
  const int nq = min(QT, a.L - t0);  // the tile's real queries
  const long long hk = static_cast<long long>(a.H) * K;
  const long long head = static_cast<long long>(h) * K;
  // applying (and copying): groups of D4 lanes (a power of two >= K / 4),
  // four dims a lane; group g holds query qg (+ G * i) and split `split`
  // of the positions
  int D4 = 1;
  while (D4 < K4) D4 *= 2;
  const int G = kThreads / D4;
  const int g = tid / D4, d4 = tid % D4;

  // the table (every page a query could see) and the query tile load
  // beside start[r]: neither depends on it
  const int* table = a.page_tables + static_cast<long long>(r) * a.P;
  for (int i = tid; i < a.pages; i += kThreads) {
    tbl[i] = min(max(table[i], 0), a.num_pages - 1);
  }
  const float* qrow = a.q + (static_cast<long long>(r) * a.L + t0) * hk + head;
  if (d4 < K4) {
    for (int qi = g; qi < QT; qi += G) {
      float* dst = qs + qi * K + 4 * d4;
      const float* src = qrow + qi * hk + 4 * d4;
      const bool real = qi < nq;
      dst[0] = real ? src[0] : 0.0f;
      dst[1] = real ? src[1] : 0.0f;
      dst[2] = real ? src[2] : 0.0f;
      dst[3] = real ? src[3] : 0.0f;
    }
  }
  const int s0 = a.start[r];
#ifdef TFOS_PLANTED_CAUSAL_OFF_BY_ONE
  constexpr int kBound = -1;  // j < p: planted
#else
  constexpr int kBound = 0;  // j <= p
#endif
  // the last query's bound sets the walk (p grows with t)
  const int n = min(max(s0 + t0 + nq - 1, 0), a.max_len - 1) + kBound + 1;
  const int ntiles = n > 0 ? (n + TP - 1) / TP : 0;
  if (tid < QT) pq[tid] = min(max(s0 + t0 + tid, 0), a.max_len - 1) + kBound;
  __syncthreads();
  const bool copies = d4 < K4;
  if (copies && ntiles > 0) stage_tile(a, ks, vs, tbl, head, d4, g, G, 0, n);
  cp_async_commit();

  // scoring: warp w holds queries w + 4 i (i < QA) over every position of
  // the tile, lane + 32 b (b < JB); scores in the log2 domain (q.k *
  // scale * log2(e)), so a weight is one exp2.  The row's max is one
  // butterfly of the warp a tile; each lane keeps its own share of the sum
  // (every share scaled by the same max), added up once at the end
  const bool scores = warp < QT;
  const float scale2 = a.scale * 1.4426950408889634f;
  float m[QA], l[QA];
#pragma unroll
  for (int i = 0; i < QA; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.0f;
  }
  const int JS = max(1, min(G / QT, TP / 4));
  const int chunk = TP / JS;
  const int qg = g % QT, split = g / QT;
  const bool applies = d4 < K4 && split < JS;
  float4 acc[QPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int tile = 0; tile < ntiles; ++tile) {
    // this tile's copies landed, and every thread is past the last tile:
    // its stage takes the next tile, in flight while this one is worked
    cp_async_wait<0>();
    __syncthreads();
    const int next = (tile + 1) & 1;
    if (copies && tile + 1 < ntiles) {
      stage_tile(a, ks + next * kstage, vs + next * vstage, tbl, head, d4, g,
                 G, (tile + 1) * TP, n);
    }
    cp_async_commit();
    const int j0 = tile * TP;
    const int cnt = min(TP, n - j0);
    const float* kt = ks + (tile & 1) * kstage;
    const float* vt = vs + (tile & 1) * vstage;

    if (scores) {  // scores, -inf past each query's bound; then weights
      float sc[QA][JB];
#pragma unroll
      for (int i = 0; i < QA; ++i) {
#pragma unroll
        for (int b = 0; b < JB; ++b) sc[i][b] = 0.0f;
      }
#pragma unroll(kScoreUnroll)
      for (int c = 0; c < K4; ++c) {
        float4 kv[JB];
#pragma unroll
        for (int b = 0; b < JB; ++b) {
          kv[b] = *reinterpret_cast<const float4*>(kt + (lane + 32 * b) * kp +
                                                   4 * c);
        }
#pragma unroll
        for (int i = 0; i < QA; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(
              qs + (warp + kWarps * i) * K + 4 * c);
#pragma unroll
          for (int b = 0; b < JB; ++b) {
            sc[i][b] = fmaf(qv.x, kv[b].x, sc[i][b]);
            sc[i][b] = fmaf(qv.y, kv[b].y, sc[i][b]);
            sc[i][b] = fmaf(qv.z, kv[b].z, sc[i][b]);
            sc[i][b] = fmaf(qv.w, kv[b].w, sc[i][b]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < QA; ++i) {
        const int q = warp + kWarps * i;
        if (q >= QT) break;  // QT < 4 * QA only where QA == 1
        const int bound = q < nq ? min(cnt - 1, pq[q] - j0) : -1;
        float mt = -CUDART_INF_F;
#pragma unroll
        for (int b = 0; b < JB; ++b) {
          sc[i][b] = lane + 32 * b <= bound ? sc[i][b] * scale2
                                            : -CUDART_INF_F;
          mt = fmaxf(mt, sc[i][b]);
        }
#pragma unroll
        for (int o = 16; o > 0; o /= 2) {
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        }
        const float m_new = fmaxf(m[i], mt);
        const float c = exp2f(m[i] - m_new);  // 0 at the first tile
        float sum = 0.0f;
#pragma unroll
        for (int b = 0; b < JB; ++b) {
          const float p = exp2f(sc[i][b] - m_new);  // exactly 0 where -inf
          ss[q * sp + lane + 32 * b] = p;
          sum += p;
        }
        l[i] = l[i] * c + sum;
        m[i] = m_new;
        if (lane == 0) corr[q] = c;
      }
    }
    __syncthreads();

    if (applies) {  // acc = acc * corr + P V, never past a query's bound
      const int jb = split * chunk;
      int lim[QPT];
      int lo = chunk, hi = 0;
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const int q = qg + G * i;
        lim[i] = q < nq ? max(0, min(min(cnt, pq[q] - j0 + 1) - jb, chunk))
                        : 0;
        lo = min(lo, lim[i]);
        hi = max(hi, lim[i]);
        if (q < nq) {
          const float c = corr[q];
          acc[i].x *= c;
          acc[i].y *= c;
          acc[i].z *= c;
          acc[i].w *= c;
        }
      }
      const float* vcol = vt + jb * K + 4 * d4;
      const float* prow = ss + qg * sp + jb;
      for (int j = 0; j < hi; j += 4) {
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          v[u] = *reinterpret_cast<const float4*>(vcol + (j + u) * K);
        }
#pragma unroll
        for (int i = 0; i < QPT; ++i) {
          const float4 p = *reinterpret_cast<const float4*>(
              prow + G * i * sp + j);
          if (j + 4 <= lo) {
            fma4(acc[i], p.x, v[0]);
            fma4(acc[i], p.y, v[1]);
            fma4(acc[i], p.z, v[2]);
            fma4(acc[i], p.w, v[3]);
          } else {  // a V row past lim[i] may hold anything
            if (j < lim[i]) fma4(acc[i], p.x, v[0]);
            if (j + 1 < lim[i]) fma4(acc[i], p.y, v[1]);
            if (j + 2 < lim[i]) fma4(acc[i], p.z, v[2]);
            if (j + 3 < lim[i]) fma4(acc[i], p.w, v[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if (scores) {  // the lanes' shares of each sum, added in a fixed order
#pragma unroll
    for (int i = 0; i < QA; ++i) {
#pragma unroll
      for (int o = 16; o > 0; o /= 2) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
      }
      const int q = warp + kWarps * i;
      if (lane == 0 && q < nq) lsum[q] = l[i];
    }
  }
  __syncthreads();  // every read of the stages done: stage 0 is free

  float* orow = a.o + (static_cast<long long>(r) * a.L + t0) * hk + head +
                4 * d4;
  if (JS == 1) {
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int q = qg + G * i;
      if (applies && q < nq) {
        const float li = lsum[q];
        *reinterpret_cast<float4*>(orow + q * hk) = make_float4(
            acc[i].x / li, acc[i].y / li, acc[i].z / li, acc[i].w / li);
      }
    }
  } else {  // the splits' partials, summed in split order
    float4* part = reinterpret_cast<float4*>(ks);
    if (applies) part[g * D4 + d4] = acc[0];
    __syncthreads();
    if (applies && split == 0 && qg < nq) {
      float4 t = part[qg * D4 + d4];
      for (int s = 1; s < JS; ++s) {
        const float4 u = part[(qg + QT * s) * D4 + d4];
        t.x += u.x;
        t.y += u.y;
        t.z += u.z;
        t.w += u.w;
      }
      const float li = lsum[qg];
      *reinterpret_cast<float4*>(orow + qg * hk) =
          make_float4(t.x / li, t.y / li, t.z / li, t.w / li);
    }
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
// Launched as the plan (threads a block, blocks) says; the plan must be one
// this file takes: threads whole warps, blocks ceil(rows L / (threads /
// 32)); k, v and the pools 16-byte aligned and H K a multiple of 4.
// Anything else returns cudaErrorInvalidValue, launching nothing.  Returns
// a cudaError_t.
extern "C" int tfos_kv_append_f32(void* k_pool, void* v_pool, const void* k,
                                  const void* v, const void* page_tables,
                                  const void* start, const void* lens,
                                  int rows, int L, int H, int K, int P,
                                  int page_size, int num_pages, int max_len,
                                  int layer, int layers, int threads,
                                  int blocks, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (!geometry_ok(rows, L, H, K, P, page_size, num_pages, max_len, layer,
                   layers)) {
    return bad;
  }
  const long long hk = static_cast<long long>(H) * K;
  const long long total = static_cast<long long>(rows) * L;
  const auto misaligned = [](const void* ptr) {
    return reinterpret_cast<std::uintptr_t>(ptr) % 16 != 0;
  };
  if (hk % 4 != 0 || hk > INT_MAX || total > INT_MAX || threads < 32 ||
      threads > 1024 || threads % 32 != 0 || misaligned(k) ||
      misaligned(v) || misaligned(k_pool) || misaligned(v_pool)) {
    return bad;
  }
  const long long per_block = threads / 32;  // items a block
  if (blocks != (total + per_block - 1) / per_block ||
      blocks * per_block > INT_MAX) {
    return bad;
  }
  AppendArgs a;
  a.k_pool = static_cast<float*>(k_pool);
  a.v_pool = static_cast<float*>(v_pool);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.page_tables = static_cast<const int*>(page_tables);
  a.start = static_cast<const int*>(start);
  a.lens = static_cast<const int*>(lens);
  a.layer_offset = static_cast<long long>(layer) * num_pages * page_size * hk;
  a.items = static_cast<int>(total);
  a.L = L;
  a.hk = static_cast<int>(hk);
  a.P = P;
  a.page_size = page_size;
  a.num_pages = num_pages;
  a.max_len = max_len;
  tfos_kv_append<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <int QA, int JB, int QPT>
cudaError_t launch_attention(const AttnArgs& a, unsigned blocks, int smem,
                             cudaStream_t stream) {
  tfos_paged_attention<QA, JB, QPT><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The (QA, JB, QPT) instantiations a plan can ask for: keep
// kernels/paged_attention.py::_KERNEL_SHAPES in step.
#define TFOS_ATTN_SHAPES(X)                                         \
  X(1, 2, 1) X(2, 2, 1) X(4, 2, 1) X(8, 2, 1) X(8, 2, 2) X(1, 1, 1) \
      X(2, 1, 1) X(2, 1, 2) X(4, 1, 2) X(4, 1, 4)

}  // namespace

// Raise the attention kernel's dynamic shared memory limit to the card's
// 227 KB on the current device, for plans above the 48 KB default.  Call
// once a device, outside any stream capture.  Returns a cudaError_t.
extern "C" int tfos_paged_attention_prepare() {
#define TFOS_ATTN_PREPARE(qa, jb, qpt)                                  \
  {                                                                     \
    const cudaError_t err = cudaFuncSetAttribute(                       \
        tfos_paged_attention<qa, jb, qpt>,                              \
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptIn);       \
    if (err != cudaSuccess) return static_cast<int>(err);               \
  }
  TFOS_ATTN_SHAPES(TFOS_ATTN_PREPARE)
#undef TFOS_ATTN_PREPARE
  return 0;
}

// o (rows, L, H, K) = softmax(q.K^T * scale) V over each query's positions
// 0..min(start[r] + t, max_len - 1), K and V read in place from layer
// `layer` of the pools, launched as the plan (q_tile, pos_tile, threads,
// smem) says.  The plan must be one this file's layout and
// instantiations take: a bad geometry or plan returns
// cudaErrorInvalidValue, launching nothing.  Returns a cudaError_t.
extern "C" int tfos_paged_attention_f32(
    const void* q, const void* k_pool, const void* v_pool, void* o,
    const void* page_tables, const void* start, int rows, int L, int H, int K,
    int P, int page_size, int num_pages, int max_len, int layer, int layers,
    float scale, int q_tile, int pos_tile, int threads, int smem,
    void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  if (!geometry_ok(rows, L, H, K, P, page_size, num_pages, max_len, layer,
                   layers) ||
      K > kMaxHeadDim || K % 4 != 0 || threads != kThreads ||
      (pos_tile != 32 && pos_tile != 64) || q_tile < 1 || q_tile > 32 ||
      (q_tile & (q_tile - 1)) != 0) {
    return static_cast<int>(bad);
  }
  const int pages = (max_len + page_size - 1) / page_size;
  if (smem != attn_layout(q_tile, pos_tile, K, pages).total ||
      smem > kSmemOptIn) {
    return static_cast<int>(bad);
  }
  const int nqt = (L + q_tile - 1) / q_tile;
  const long long blocks = static_cast<long long>(rows) * H * nqt;
  if (blocks > 0x7fffffffLL) return static_cast<int>(bad);
  int lanes = 1;
  while (lanes < K / 4) lanes *= 2;
  const int qa = (q_tile + kWarps - 1) / kWarps;
  const int jb = pos_tile / 32;
  const int qpt = q_tile > kThreads / lanes ? q_tile / (kThreads / lanes) : 1;
  AttnArgs a;
  a.q = static_cast<const float*>(q);
  a.k_pool = static_cast<const float*>(k_pool);
  a.v_pool = static_cast<const float*>(v_pool);
  a.o = static_cast<float*>(o);
  a.page_tables = static_cast<const int*>(page_tables);
  a.start = static_cast<const int*>(start);
  a.layer_offset = static_cast<long long>(layer) * num_pages * page_size * H *
                   static_cast<long long>(K);
  a.scale = scale;
  a.L = L;
  a.H = H;
  a.K = K;
  a.P = P;
  a.page_size = page_size;
  a.num_pages = num_pages;
  a.max_len = max_len;
  a.qt = q_tile;
  a.tp = pos_tile;
  a.nqt = nqt;
  a.pages = pages;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TFOS_ATTN_LAUNCH(sa, sb, sp)                                     \
  if (qa == sa && jb == sb && qpt == sp) {                               \
    return static_cast<int>(launch_attention<sa, sb, sp>(                \
        a, static_cast<unsigned>(blocks), smem, s));                     \
  }
  TFOS_ATTN_SHAPES(TFOS_ATTN_LAUNCH)
#undef TFOS_ATTN_LAUNCH
  return static_cast<int>(bad);
}
