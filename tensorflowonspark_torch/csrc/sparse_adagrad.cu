// AdaGrad on only the table rows a batch touched, f32: one launch that
// groups the ids by row, and one launch that updates every table sharing
// those ids (the wide&deep step's deep and wide tables together).
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
// The least traffic is the ids and the row gradients read once and each
// touched row of the tables and accumulators read and written once: for
// the wide&deep step at batch 1024 (26,624 ids; deep rows of 32 f32 and
// scalar wide rows) about 12-17 MB, 4-5 us.  The literal dense pass moves
// the whole tables instead (about 2 GB at Config(): 2.6 M rows).
//
// The order of the sums is the contract: a row's occurrences are added in
// their order in the batch, one rounding an operation (__fadd_rn and
// __fmul_rn, no contraction into an FMA), rsqrt as rn(1/rn(sqrt)), as
// PyTorch's index_add_ and rsqrt compute them on the CPU.  So the result
// is bit-identical to the plain version run on the CPU, and the same bits
// on every run: no float atomics anywhere.
//
// Grouping (tfos_id_grouping, one launch).  Key of an occurrence: its id,
// wrapped into [0, vocab) when it lies in [-vocab, 0) (the row JAX's
// .at[ids] names by a negative index), or `vocab` when it is still out of
// range: those sort after every row into a dropped tail, as JAX's scatter
// drops them.  A stable LSD radix sort of (key, position) pairs, 8 bits a
// pass, as many passes as vocab has bits (3 at Config()'s 2.6 M rows, for
// int32 and int64 ids alike), run by one cluster of 8 blocks of 1,024
// threads.  Each of the 256 warps owns a contiguous range of the pass's
// source order and holds it in registers (up to 4 steps of 32 keys).  A
// warp ranks a step's keys by ballots on the digit's bits (rank = lanes
// before it with the same digit) and counts them in a histogram of its
// own in shared memory, so the counts and ranks do not depend on any
// order of execution.  A digit's offset for a warp is the count of smaller
// digits in the whole cluster, plus the same digit in earlier blocks (read
// from their shared memory over the cluster), plus the same digit in
// earlier warps of the block: so the scatter is stable.  A block first
// sorts its keys by digit in shared memory, then writes them out in that
// order, so each digit's run of the block reaches L2 as one stretch rather
// than as 4-byte stores scattered over it.  The ping-pong buffers stay in
// L2 at this size (26,624 pairs x 8 B) and are read with ld.global.cg,
// since other SMs wrote them; the cluster barrier's release and acquire
// order each pass's stores before the next pass's loads.  A last phase
// finds each segment's start (a key that differs from its left
// neighbour), ranks it the same way over the cluster and writes the starts
// and the rows in order, then the in-range count into every later start
// and [segment count, in-range count] into `meta`.  Beyond 32,768 ids a
// warp loads each step twice and scatters straight to L2.
//
// Update (tfos_adagrad_segment_walk, one launch for one or two tables).
// One warp a segment, read from the grouping: no scan for a segment's end
// and no thread that starts and returns.  The grid is sized from n, never
// from a count read back to the host; a warp strides over the segments
// and stops at the first empty one (every start past the last segment is
// the in-range count).  A 32-wide deep row: lane c owns column c.  For
// each chunk of up to 32 occurrences the warp reads the 32 positions with
// one load, then stages the chunk's gradients in shared memory by
// cp.async before any add (4 KB a chunk of deep rows: 16-byte copies,
// four occurrences an instruction), then each lane adds its column
// over the chunk in occurrence order.  A scalar wide row: each lane loads
// its own occurrence's gradient, and the in-order sum walks them by
// __shfl_sync (every lane computes the same chain; lane 0 writes).  Both
// tables of the wide&deep step share the segment and the chunk's
// positions, so their loads are in flight together.  The sparse mode walks
// a segment of at most 32 occurrences twice from its stage; a longer one
// is staged again for the second walk.  One stage a warp and four warps a
// block keep 40 registers a thread and 16 KB a block, so many segments
// are in flight (a second stage, to overlap chunks, cost more in
// occupancy than it saved).  Wider rows take lanes past 32 in column
// blocks of 32.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;

// --- grouping -------------------------------------------------------------

constexpr int kRadixBits = 8;
constexpr int kDigits = 1 << kRadixBits;
constexpr int kCluster = 8;
constexpr int kGroupThreads = 1024;
constexpr int kGroupWarps = kGroupThreads / 32;
// a warp keeps up to this many steps of 32 keys in registers (more spill
// at 64 registers a thread), and a block stages its scatter in shared
// memory: n up to 8 x 1024 x 4 = 32,768 ids, batch 1,260 of wide&deep;
// beyond, a warp loads each step twice and scatters straight to L2
constexpr int kRegSteps = 4;
constexpr int kStaged = kGroupThreads * kRegSteps;
constexpr int kGroupDynamicSmem =
    2 * kStaged * static_cast<int>(sizeof(int));

struct GroupSmem {
  int hist[kGroupWarps][kDigits];  // per warp: count, then earlier warps'
  int quarter[4][kDigits];         // the column scan's partial sums
  int block_total[kDigits];        // this block's count of each digit
  int digit_base[kDigits];         // smaller digits + earlier blocks'
  int block_start[kDigits];        // smaller digits of this block
  int scan_incl[2][kDigits];
  int warp_sum[2][kGroupWarps];
  int cluster_sums[4];
};

template <typename Id>
__device__ __forceinline__ int wrapped_key(Id id, int vocab) {
  int64_t v = static_cast<int64_t>(id);
  if (v < 0) v += vocab;
  return (v >= 0 && v < vocab) ? static_cast<int>(v) : vocab;
}

template <typename Id>
__device__ __forceinline__ void load_pair(int p, const Id* ids,
                                          const int* ks, const int* ps,
                                          int64_t i, int vocab, int& key,
                                          int& pos) {
  if (p == 0) {
    key = wrapped_key(__ldg(ids + i), vocab);
    pos = static_cast<int>(i);
  } else {
    key = __ldcg(ks + i);
    pos = __ldcg(ps + i);
  }
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// The lanes whose digit (0..kDigits, kDigits for an idle lane) equals
// this lane's, from one ballot a bit.
__device__ __forceinline__ unsigned digit_peers(int digit) {
  unsigned peers = kFull;
#pragma unroll
  for (int b = 0; b <= kRadixBits; ++b) {
    const unsigned m = __ballot_sync(kFull, (digit >> b) & 1);
    peers &= ((digit >> b) & 1) ? m : ~m;
  }
  return peers;
}

// After every warp counted its digits into sm.hist: turn hist into each
// warp's count of its digit in earlier warps of the block; fill
// sm.block_start (smaller digits of this block) and sm.digit_base (smaller
// digits in the cluster plus the same digit in earlier blocks, read from
// their shared memory).
__device__ __forceinline__ void digit_offsets(GroupSmem& sm,
                                              cg::cluster_group& cluster,
                                              int rank, int t, int warp,
                                              int lane) {
  __syncthreads();
  {  // four threads a digit, eight warps each
    const int d = t & (kDigits - 1), q = t / kDigits;
    int run = 0;
    for (int w = q * 8; w < q * 8 + 8; ++w) run += sm.hist[w][d];
    sm.quarter[q][d] = run;
  }
  __syncthreads();
  {
    const int d = t & (kDigits - 1), q = t / kDigits;
    int run = 0;
    for (int r = 0; r < q; ++r) run += sm.quarter[r][d];
    for (int w = q * 8; w < q * 8 + 8; ++w) {
      const int c = sm.hist[w][d];
      sm.hist[w][d] = run;
      run += c;
    }
    if (q == 3) sm.block_total[d] = run;
  }
  cluster.sync();
  if (t < kDigits) {
    int before = 0, total = 0;
    for (int r = 0; r < kCluster; ++r) {
      const int c = *cluster.map_shared_rank(&sm.block_total[t], r);
      before += r < rank ? c : 0;
      total += c;
    }
    const int own = sm.block_total[t];
    const int incl = warp_incl_scan(total, lane);
    const int own_incl = warp_incl_scan(own, lane);
    if (lane == 31) {
      sm.warp_sum[0][warp] = incl;
      sm.warp_sum[1][warp] = own_incl;
    }
    sm.scan_incl[0][t] = incl - total + before;
    sm.scan_incl[1][t] = own_incl - own;
  }
  __syncthreads();
  if (t < kDigits) {
    int prior = 0, own_prior = 0;
    for (int w = 0; w < warp; ++w) {
      prior += sm.warp_sum[0][w];
      own_prior += sm.warp_sum[1][w];
    }
    sm.digit_base[t] = prior + sm.scan_incl[0][t];
    sm.block_start[t] = own_prior + sm.scan_incl[1][t];
  }
  __syncthreads();
}

template <typename Id>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kGroupThreads, 1) tfos_id_grouping(
        const Id* __restrict__ ids, int64_t n, int vocab, int passes,
        int* keys_out, int* pos_out, int* keys_tmp, int* pos_tmp,
        int* seg_start, int* seg_row, int* meta) {
  __shared__ GroupSmem sm;
  extern __shared__ int staged[];  // kStaged keys, then kStaged positions
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const unsigned before_me = (1u << lane) - 1;
  // this warp's range of each pass's source order: warps in (block, warp)
  // order cover the n slots in order
  const int64_t per_warp =
      (n + kCluster * kGroupWarps - 1) / (kCluster * kGroupWarps);
  const int64_t lo = min(n, (rank * kGroupWarps + warp) * per_warp);
  const int64_t hi = min(n, lo + per_warp);
  const bool resident = per_warp <= 32 * kRegSteps;  // the same for all
  const int64_t block_lo = min(n, rank * kGroupWarps * per_warp);
  const int block_count = static_cast<int>(
      min(n, (rank + 1) * kGroupWarps * per_warp) - block_lo);

  for (int p = 0; p < passes; ++p) {
    const int shift = p * kRadixBits;
    // the last pass writes the outputs; the passes before alternate
    const bool to_out = ((passes - 1 - p) & 1) == 0;
    int* kd = to_out ? keys_out : keys_tmp;
    int* pd = to_out ? pos_out : pos_tmp;
    const int* ks = to_out ? keys_tmp : keys_out;
    const int* ps = to_out ? pos_tmp : pos_out;

    for (int i = t; i < kGroupWarps * kDigits; i += kGroupThreads) {
      (&sm.hist[0][0])[i] = 0;
    }
    if (resident) {
      // every step's pair loaded at once; a lane's rank among its warp's
      // earlier keys of the same digit found while counting; the block's
      // keys sorted by digit in shared memory, then written out in order,
      // so each digit's run of this block goes to L2 as one stretch
      int key[kRegSteps], pos[kRegSteps], local[kRegSteps];
#pragma unroll
      for (int k = 0; k < kRegSteps; ++k) {
        const int64_t i = lo + 32 * k + lane;
        key[k] = 0;
        pos[k] = 0;
        local[k] = 0;
        if (i < hi) load_pair(p, ids, ks, ps, i, vocab, key[k], pos[k]);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kRegSteps; ++k) {
        if (lo + 32 * k < hi) {
          const bool valid = lo + 32 * k + lane < hi;
          const int digit =
              valid ? (key[k] >> shift) & (kDigits - 1) : kDigits;
          const unsigned peers = digit_peers(digit);
          const int leader = __ffs(peers) - 1;
          int run = 0;
          if (valid && lane == leader) {  // this warp's own counter
            run = sm.hist[warp][digit];
            sm.hist[warp][digit] = run + __popc(peers);
          }
          __syncwarp();
          local[k] = __shfl_sync(kFull, run, leader) +
                     __popc(peers & before_me);
        }
      }
      digit_offsets(sm, cluster, rank, t, warp, lane);
#pragma unroll
      for (int k = 0; k < kRegSteps; ++k) {
        if (lo + 32 * k + lane < hi) {
          const int digit = (key[k] >> shift) & (kDigits - 1);
          const int slot =
              sm.block_start[digit] + sm.hist[warp][digit] + local[k];
          staged[slot] = key[k];
          staged[kStaged + slot] = pos[k];
        }
      }
      __syncthreads();
      for (int j = t; j < block_count; j += kGroupThreads) {
        const int key = staged[j];
        const int digit = (key >> shift) & (kDigits - 1);
        const int dst = sm.digit_base[digit] + j - sm.block_start[digit];
        kd[dst] = key;
        pd[dst] = staged[kStaged + j];
      }
    } else {
      __syncthreads();
      // count: one shared-memory add per distinct digit of a step
      for (int64_t base = lo; base < hi; base += 32) {
        const int64_t i = base + lane;
        const bool valid = i < hi;
        int key = 0, pos = 0;
        if (valid) load_pair(p, ids, ks, ps, i, vocab, key, pos);
        const int digit = valid ? (key >> shift) & (kDigits - 1) : kDigits;
        const unsigned peers = digit_peers(digit);
        if (valid && lane == __ffs(peers) - 1) {
          sm.hist[warp][digit] += __popc(peers);
        }
        __syncwarp();
      }
      digit_offsets(sm, cluster, rank, t, warp, lane);
      // scatter, stable: the digit's running offset in this warp plus the
      // lanes before it with the same digit
      for (int64_t base = lo; base < hi; base += 32) {
        const int64_t i = base + lane;
        const bool valid = i < hi;
        int key = 0, pos = 0;
        if (valid) load_pair(p, ids, ks, ps, i, vocab, key, pos);
        const int digit = valid ? (key >> shift) & (kDigits - 1) : kDigits;
        const unsigned peers = digit_peers(digit);
        const int leader = __ffs(peers) - 1;
        int run = 0;
        if (valid && lane == leader) {
          run = sm.hist[warp][digit];
          sm.hist[warp][digit] = run + __popc(peers);
        }
        __syncwarp();
        run = __shfl_sync(kFull, run, leader);
        if (valid) {
          const int dst =
              sm.digit_base[digit] + run + __popc(peers & before_me);
          kd[dst] = key;
          pd[dst] = pos;
        }
      }
    }
    // the barrier's release and acquire order these stores before the
    // next pass's loads in every block of the cluster
    cluster.sync();
  }

  // segment starts over the sorted keys: count (starts, in-range keys) a
  // warp, rank them over the cluster, write the starts and the rows in
  // order; the starts past the last segment hold the in-range count
  auto key_at = [&](int64_t i, int& key, int& prev) {
    const bool valid = i < hi;
    key = valid ? __ldcg(keys_out + i) : vocab;
    prev = (valid && i > 0) ? __ldcg(keys_out + i - 1) : -1;
  };
  int hk[kRegSteps], hp[kRegSteps];  // resident: loaded once for both walks
  if (resident) {
#pragma unroll
    for (int k = 0; k < kRegSteps; ++k) {
      key_at(lo + 32 * k + lane, hk[k], hp[k]);
    }
  }
  int heads = 0, inside = 0;
  auto count_step = [&](int key, int prev) {
    heads += __popc(__ballot_sync(kFull, key < vocab && key != prev));
    inside += __popc(__ballot_sync(kFull, key < vocab));
  };
  if (resident) {
#pragma unroll
    for (int k = 0; k < kRegSteps; ++k) {
      if (lo + 32 * k < hi) count_step(hk[k], hp[k]);
    }
  } else {
    for (int64_t base = lo; base < hi; base += 32) {
      int key, prev;
      key_at(base + lane, key, prev);
      count_step(key, prev);
    }
  }
  if (lane == 0) {
    sm.warp_sum[0][warp] = heads;
    sm.warp_sum[1][warp] = inside;
  }
  __syncthreads();
  if (warp < 2) {
    const int c = sm.warp_sum[warp][lane];
    const int incl = warp_incl_scan(c, lane);
    sm.hist[warp][lane] = incl - c;
    if (lane == 31) sm.block_total[warp] = incl;
  }
  cluster.sync();
  if (t < 2) {
    int before = 0, total = 0;
    for (int r = 0; r < kCluster; ++r) {
      const int c = *cluster.map_shared_rank(&sm.block_total[t], r);
      before += r < rank ? c : 0;
      total += c;
    }
    sm.cluster_sums[t] = before;
    sm.cluster_sums[2 + t] = total;
  }
  __syncthreads();
  const int count = sm.cluster_sums[2];  // segments
  const int m = sm.cluster_sums[3];      // in-range occurrences
  int run = sm.cluster_sums[0] + sm.hist[0][warp];
  auto write_step = [&](int64_t i, int key, int prev) {
    const bool head = key < vocab && key != prev;
    const unsigned b = __ballot_sync(kFull, head);
    if (head) {
      const int r = run + __popc(b & before_me);
      seg_start[r] = static_cast<int>(i);
      seg_row[r] = key;
    }
    run += __popc(b);
    if (i < hi && i >= count) seg_start[i + 1] = m;
  };
  if (resident) {
#pragma unroll
    for (int k = 0; k < kRegSteps; ++k) {
      if (lo + 32 * k < hi) write_step(lo + 32 * k + lane, hk[k], hp[k]);
    }
  } else {
    for (int64_t base = lo; base < hi; base += 32) {
      int key, prev;
      key_at(base + lane, key, prev);
      write_step(base + lane, key, prev);
    }
  }
  if (rank == 0 && t == 0) {
    seg_start[count] = m;
    meta[0] = count;
    meta[1] = m;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// --- update ---------------------------------------------------------------

constexpr int kWalkWarps = 4;
constexpr int kWalkThreads = kWalkWarps * 32;

enum Layout { kNone, kColumn, kScalar };

struct TableArg {
  const float* grads;
  float* table;
  float* acc;
  int dim;
  int vec;  // rows of whole 32-float blocks at 16-byte aligned addresses
};

__device__ __forceinline__ float rsqrt_rn(float x) {
  return __frcp_rn(__fsqrt_rn(x));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// one lane's share of one table's row in one column block
struct Side {
  float a, t, s, r;
  bool on;
  int64_t at;
};

template <int L>
__device__ __forceinline__ void side_open(Side& S, const TableArg& T, int kb,
                                          int lane, int64_t row) {
  S = Side{0.0f, 0.0f, 0.0f, 0.0f, false, 0};
  if (L == kNone) return;
  const int c = L == kScalar ? 0 : kb * 32 + lane;
  S.on = L == kScalar ? kb == 0 : c < T.dim;
  S.at = row * T.dim + c;
  S.a = S.on ? T.acc[S.at] : 0.0f;
  S.t = S.on ? T.table[S.at] : 0.0f;
}

// Start the loads of a chunk's gradients: a column table's into the
// warp's stage (slot j, column c: occurrence j's column kb * 32 + c), a
// scalar table's occurrence `lane` into `own`.  Rows of whole blocks of
// 32 floats go 16 bytes a copy, four occurrences' eight pieces an
// instruction; others 4 bytes a copy, the lane's own column.
template <int L>
__device__ __forceinline__ void stage_issue(float* warp_stage, float& own,
                                            const Side& S, const TableArg& T,
                                            int my_pos, int cnt, int kb,
                                            int lane) {
  if constexpr (L == kColumn) {
    const float* g = T.grads + kb * 32;
    if (T.vec) {
      const int items = cnt * 8;  // eight 16-byte pieces an occurrence
      for (int base = 0; base < items; base += 32) {
        const int it = base + lane;
        const int j = it >> 3, q = it & 7;
        const int p = __shfl_sync(kFull, my_pos, j);
        if (it < items) {
          cp_async16(warp_stage + j * 32 + q * 4,
                     g + static_cast<int64_t>(p) * T.dim + q * 4);
        }
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        const int p = __shfl_sync(kFull, my_pos, j);
        if (S.on) {
          cp_async4(warp_stage + j * 32 + lane,
                    g + static_cast<int64_t>(p) * T.dim + lane);
        }
      }
    }
  } else if constexpr (L == kScalar) {
    own = (S.on && lane < cnt) ? T.grads[my_pos] : 0.0f;
  }
}

// walk 0: combine's sum; walk 1: sparse's squares; walk 2: sparse's updates
template <int L, int kWalk>
__device__ __forceinline__ void walk(const float* col, float own, Side& S,
                                     int cnt, float neg_lr) {
  if constexpr (L != kNone) {
    for (int j = 0; j < cnt; ++j) {
      float v;
      if constexpr (L == kColumn) {
        v = col[j * 32];
      } else {
        v = __shfl_sync(kFull, own, j);
      }
      if (kWalk == 0) {
        S.s = __fadd_rn(S.s, v);
      } else if (kWalk == 1) {
        S.a = __fadd_rn(S.a, __fmul_rn(v, v));
      } else {
        S.t = __fadd_rn(S.t, __fmul_rn(__fmul_rn(neg_lr, v), S.r));
      }
    }
  }
}

__device__ __forceinline__ void combine_close(Side& S, float neg_lr,
                                              float eps) {
  // the gather's VJP summed into a zero gradient, in occurrence order
  S.a = __fadd_rn(S.a, __fmul_rn(S.s, S.s));
  S.t = __fadd_rn(S.t, __fmul_rn(__fmul_rn(neg_lr, S.s),
                                 rsqrt_rn(__fadd_rn(S.a, eps))));
}

template <int L>
__device__ __forceinline__ void side_close(const Side& S, const TableArg& T,
                                           int lane) {
  if (L == kNone) return;
  if (S.on && (L == kColumn || lane == 0)) {
    T.acc[S.at] = S.a;
    T.table[S.at] = S.t;
  }
}

template <int L0, int L1>
__global__ void __launch_bounds__(kWalkThreads) tfos_adagrad_segment_walk(
    const int* __restrict__ pos, const int* __restrict__ seg_start,
    const int* __restrict__ seg_row, int64_t segments, TableArg t0,
    TableArg t1, int col_blocks, float neg_lr, float eps, int combine) {
  constexpr int kStages = (L0 == kColumn) + (L1 == kColumn);
  __shared__ __align__(16) float
      stage[kWalkWarps][kStages > 0 ? kStages : 1][32][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* stage0 = &stage[warp][0][0][0];
  float* stage1 = &stage[warp][kStages - 1 > 0 ? kStages - 1 : 0][0][0];
  const float* col0 = stage0 + lane;  // this lane's column
  const float* col1 = stage1 + lane;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * kWalkWarps + warp;
       s < segments; s += static_cast<int64_t>(gridDim.x) * kWalkWarps) {
    const int start = __ldg(seg_start + s);
    const int end = __ldg(seg_start + s + 1);
    if (start >= end) break;  // past the last segment: so are the later
    const int64_t row = __ldg(seg_row + s);
    const bool single = end - start <= 32;
    for (int kb = 0; kb < col_blocks; ++kb) {
      Side s0, s1;
      side_open<L0>(s0, t0, kb, lane, row);
      side_open<L1>(s1, t1, kb, lane, row);
      float own0 = 0.0f, own1 = 0.0f;
      for (int cs = start; cs < end; cs += 32) {
        const int cnt = min(32, end - cs);
        const int my_pos = lane < cnt ? __ldg(pos + cs + lane) : 0;
        stage_issue<L0>(stage0, own0, s0, t0, my_pos, cnt, kb, lane);
        stage_issue<L1>(stage1, own1, s1, t1, my_pos, cnt, kb, lane);
        cp_async_wait_all();
        if (combine) {
          walk<L0, 0>(col0, own0, s0, cnt, neg_lr);
          walk<L1, 0>(col1, own1, s1, cnt, neg_lr);
        } else {
          walk<L0, 1>(col0, own0, s0, cnt, neg_lr);
          walk<L1, 1>(col1, own1, s1, cnt, neg_lr);
          if (single) {  // the chunk is the segment: walk its stage again
            s0.r = rsqrt_rn(__fadd_rn(s0.a, eps));
            s1.r = rsqrt_rn(__fadd_rn(s1.a, eps));
            walk<L0, 2>(col0, own0, s0, cnt, neg_lr);
            walk<L1, 2>(col1, own1, s1, cnt, neg_lr);
          }
        }
      }
      if (combine) {
        combine_close(s0, neg_lr, eps);
        combine_close(s1, neg_lr, eps);
      } else if (!single) {
        s0.r = rsqrt_rn(__fadd_rn(s0.a, eps));
        s1.r = rsqrt_rn(__fadd_rn(s1.a, eps));
        for (int cs = start; cs < end; cs += 32) {
          const int cnt = min(32, end - cs);
          const int my_pos = lane < cnt ? __ldg(pos + cs + lane) : 0;
          stage_issue<L0>(stage0, own0, s0, t0, my_pos, cnt, kb, lane);
          stage_issue<L1>(stage1, own1, s1, t1, my_pos, cnt, kb, lane);
          cp_async_wait_all();
          walk<L0, 2>(col0, own0, s0, cnt, neg_lr);
          walk<L1, 2>(col1, own1, s1, cnt, neg_lr);
        }
      }
      side_close<L0>(s0, t0, lane);
      side_close<L1>(s1, t1, lane);
    }
  }
}

template <int L0, int L1>
cudaError_t launch_walk(const int* pos, const int* seg, const int* rows,
                        long long segments, const TableArg& t0,
                        const TableArg& t1, int col_blocks, float neg_lr,
                        float eps, int combine, cudaStream_t s) {
  long long blocks = (segments + kWalkWarps - 1) / kWalkWarps;
  blocks = blocks < 1 ? 1 : (blocks > (1LL << 20) ? (1LL << 20) : blocks);
  tfos_adagrad_segment_walk<L0, L1>
      <<<static_cast<unsigned>(blocks), kWalkThreads, 0, s>>>(
          pos, seg, rows, segments, t0, t1, col_blocks, neg_lr, eps,
          combine);
  return cudaGetLastError();
}

}  // namespace

// Group the n flat ids (int32 when id_bytes is 4, int64 when 8) for a
// table of `vocab` rows.  Writes keys_out and pos_out (n int32 each: the
// wrapped ids grouped by row, in-range ones first in row order, each row's
// positions in batch order, then the out-of-range occurrences with key
// vocab, in batch order), seg_start (n + 1 int32: the segments' starts,
// then the in-range count in every later entry), seg_row (n int32: each
// segment's row; entries past the last segment undefined) and meta (2
// int32: the segment count, the in-range count).  keys_tmp and pos_tmp: n
// int32 each, scratch.  Takes 0 <= n < 2^31 and 0 <= vocab < 2^31.
// Returns the launch's error.
extern "C" int tfos_group_ids(const void* ids, int id_bytes, long long n,
                              long long vocab, void* keys_out, void* pos_out,
                              void* keys_tmp, void* pos_tmp, void* seg_start,
                              void* seg_row, void* meta, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || vocab < 0 || vocab > 0x7fffffffLL ||
      (id_bytes != 4 && id_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int bits = 0;
  while (bits < 31 && (vocab >> bits) != 0) ++bits;  // the largest key: vocab
  const int passes =
      bits <= kRadixBits ? 1 : (bits + kRadixBits - 1) / kRadixBits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* ko = static_cast<int*>(keys_out);
  auto* po = static_cast<int*>(pos_out);
  auto* kt = static_cast<int*>(keys_tmp);
  auto* pt = static_cast<int*>(pos_tmp);
  auto* seg = static_cast<int*>(seg_start);
  auto* rows = static_cast<int*>(seg_row);
  auto* m = static_cast<int*>(meta);
  const int v = static_cast<int>(vocab);
  static bool ready[2] = {false, false};  // the shared-memory opt-in, once
  cudaError_t err = cudaSuccess;
  if (id_bytes == 4) {
    if (!ready[0]) {
      err = cudaFuncSetAttribute(tfos_id_grouping<int32_t>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kGroupDynamicSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
      ready[0] = true;
    }
    tfos_id_grouping<int32_t>
        <<<kCluster, kGroupThreads, kGroupDynamicSmem, s>>>(
            static_cast<const int32_t*>(ids), n, v, passes, ko, po, kt, pt,
            seg, rows, m);
  } else {
    if (!ready[1]) {
      err = cudaFuncSetAttribute(tfos_id_grouping<int64_t>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kGroupDynamicSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
      ready[1] = true;
    }
    tfos_id_grouping<int64_t>
        <<<kCluster, kGroupThreads, kGroupDynamicSmem, s>>>(
            static_cast<const int64_t*>(ids), n, v, passes, ko, po, kt, pt,
            seg, rows, m);
  }
  return static_cast<int>(cudaGetLastError());
}

// Update one or two tables (ntables) whose ids share one grouping
// (tfos_group_ids' pos, seg_start and seg_row for n ids and their vocab).
// Table k: grads_k (n, dim_k) f32, row i the gradient of occurrence i;
// table_k and acc_k (vocab, dim_k) f32, updated in place.  combine: 1 sums
// a row's occurrences before squaring, 0 accumulates each.  Returns the
// launch's error.
extern "C" int tfos_adagrad_segments_f32(
    const void* pos, const void* seg_start, const void* seg_row, long long n,
    long long vocab, int ntables, const void* grads0, void* table0,
    void* acc0, int dim0, const void* grads1, void* table1, void* acc1,
    int dim1, float neg_lr, float eps, int combine, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || vocab < 0 || ntables < 1 ||
      ntables > 2 || dim0 <= 0 || (ntables == 2 && dim1 <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto vec = [](const void* g, int dim) {
    return dim % 32 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 ? 1 : 0;
  };
  TableArg a{static_cast<const float*>(grads0), static_cast<float*>(table0),
             static_cast<float*>(acc0), dim0, vec(grads0, dim0)};
  TableArg b{static_cast<const float*>(grads1), static_cast<float*>(table1),
             static_cast<float*>(acc1), ntables == 2 ? dim1 : 0,
             vec(grads1, dim1)};
  // a scalar table goes second, so a deep-and-wide pair is (column, scalar)
  if (ntables == 2 && a.dim == 1 && b.dim != 1) {
    const TableArg x = a;
    a = b;
    b = x;
  }
  int col_blocks = 1;
  if (a.dim > 1) col_blocks = max(col_blocks, (a.dim + 31) / 32);
  if (b.dim > 1) col_blocks = max(col_blocks, (b.dim + 31) / 32);
  const auto* p = static_cast<const int*>(pos);
  const auto* seg = static_cast<const int*>(seg_start);
  const auto* rows = static_cast<const int*>(seg_row);
  const long long segments = n < vocab ? n : vocab;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ntables == 1) {
    err = a.dim == 1
              ? launch_walk<kScalar, kNone>(p, seg, rows, segments, a, b,
                                            col_blocks, neg_lr, eps, combine,
                                            s)
              : launch_walk<kColumn, kNone>(p, seg, rows, segments, a, b,
                                            col_blocks, neg_lr, eps, combine,
                                            s);
  } else if (a.dim == 1) {
    err = launch_walk<kScalar, kScalar>(p, seg, rows, segments, a, b,
                                        col_blocks, neg_lr, eps, combine, s);
  } else if (b.dim == 1) {
    err = launch_walk<kColumn, kScalar>(p, seg, rows, segments, a, b,
                                        col_blocks, neg_lr, eps, combine, s);
  } else {
    err = launch_walk<kColumn, kColumn>(p, seg, rows, segments, a, b,
                                        col_blocks, neg_lr, eps, combine, s);
  }
  return static_cast<int>(err);
}
