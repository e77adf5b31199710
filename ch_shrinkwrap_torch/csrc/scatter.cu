// K2: windowed segment-sum of per-point rows onto faces (the A^T scatter),
// and K2s, the ordered segment sum that every other accumulation of the
// fit runs through.
//
// Replaces the JAX package's Pallas TPU kernel `_scatter_kernel`
// (ops/pallas_scatter.py:44, launched by `_call_scatter` :257) and its four
// modes:
//   mode 0 GIVEN  up to 12 given columns vals (N, C)
//                 (`windowed_segment_sum_pallas`, :358)
//   mode 1 AH     12 columns w_j * [res, 1]: col 4j+c = w_j res_c (c < 3),
//                 col 4j+3 = w_j  (`windowed_ah_pallas`, :402)
//   mode 2 AHW2   AH plus the 6 products w_j w_j' in columns 12..17, in
//                 the order w0w0 w1w1 w2w2 w0w1 w0w2 w1w2
//                 (`windowed_ahw2_pallas`, :445)
//   mode 3 W2     the 6 products alone (`windowed_w2_pallas`, :488)
// Routing is the TPU kernel's: a row goes to its face fid when fid lies in
// one of its block's windows [s, s + W), where s is the window start
// rounded down to 128 and clamped to [0, smax] (the TPU kernel's DMA
// alignment, done here rather than by the caller); otherwise it goes to
// face sub_ids[js] (the subsample slot K1 chose), or is dropped when
// discard_sub is set.  Targets at or beyond num_segments (pad faces of
// the 128-aligned table) are dropped.  K2s takes the targets as given
// (int32 or int64); one outside [0, num_segments) drops its row.
//
// The order of the sum.  Each segment's row is the float32 sum, from
// 0.0f (or from init for K2s), of its rows' values in ascending row
// index: the order of the plain version's index_add_ on the CPU.  So the
// result is a function of the inputs alone, equal to the plain version
// bit for bit, and the same on every run.  Products and sums are rounded
// one at a time (__fmul_rn, __fadd_rn), never contracted into an FMA.
// No atomic of any kind: every value is written by one thread.
//
// What bounds it on the H100.  Bytes: at 1e6 points, 36 B of inputs a
// row and 48 B of output a face in AH mode, about 0.017 ms.  Two things
// stood between the first ordered design and that bound: the ordering
// (a library sort of all 32 key bits with int64 values and a binary
// search, 18 device events a call), and a reduce whose time followed
// the longest segment, because one thread walked each segment as a
// chain of dependent loads (12 ms for 44,839 rows on one face).
//
// The design, one C call a wrapper call, every stage a kernel of this
// file (8 launches when num_segments needs 11-20 bits):
//  (1) a stable LSD radix ordering of the int32 keys (key = target, or
//      num_segments for a dropped row, so dropped rows sort past the
//      last segment).  Only bit_length(num_segments) bits are sorted, in
//      passes of at most 10 bits whose plan the host chooses
//      (cuda_scatter.digit_plan); values are int32 row indices.  A pass
//      is three atomic-free kernels over tiles of 4096 rows, each warp
//      ranking 512 contiguous rows 32 at a time:
//        hist     each warp counts its digits in a private shared-memory
//                 histogram: lanes of one digit find each other with
//                 __match_any_sync and the group's lowest lane adds the
//                 group's size; the tile's counts go to a tile x digit
//                 table.  The first pass computes the keys itself (K2's
//                 route, or the clamped targets) and writes them out;
//        scan     each digit's counts, prefix-summed over the tiles in
//                 tile (= row) order, and each digit's total;
//        scatter  a row's place is the digit's base (an exclusive scan
//                 of the totals), plus the digit's rows in earlier tiles,
//                 in earlier warps of its tile, in earlier steps of its
//                 warp, and in earlier lanes of its step
//                 (__popc(peers & lanemask_lt)).  Rows of one digit keep
//                 their order, so every pass is stable.  The tile is put
//                 in digit order in shared memory first, so a digit's
//                 rows leave in runs of consecutive addresses.
//  (2) segment_offsets: each position where the sorted key changes
//      writes the start of every segment it passes over (empty segments
//      get the next start), a warp at a time where the gap is long, so
//      every entry of offsets is written once, with no search.
//  (3) the reduce, a lane a segment, a warp 32 consecutive segments.  A
//      segment of at most 32 rows is walked by its lane, 4 or 8 rows'
//      loads in flight before their adds; the warp's rows then leave
//      together through shared memory.  A longer segment is taken by the
//      whole warp: lanes gather a batch of rows into registers while the
//      previous batch, its products formed and staged in shared memory,
//      is added column by column, lane c adding column c.  So a long
//      segment costs a few cycles a row (one dependent add a column),
//      not two dependent global loads.  Each output row is written once,
//      zeros (or init) where the segment is empty.  K2's table keeps its
//      row stride C rounded up to 4 (12, 20, 8, <= 12 for GIVEN) and is
//      written with 16-byte stores; the wrapper returns the first C
//      columns.
// Index arithmetic is 32-bit (the wrappers check N and the table size
// < 2^31).

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int LONG_ROWS = 32;     // longer segments are folded by a warp

// ---- the ordering ------------------------------------------------------

constexpr int RADIX_THREADS = 256;
constexpr int RADIX_WARPS = RADIX_THREADS / 32;
constexpr int RADIX_ITEMS = 16;   // rows a thread ranks in a pass
constexpr int RADIX_TILE = RADIX_THREADS * RADIX_ITEMS;
constexpr int RADIX_BITS_MAX = 10;
constexpr int DPT = (1 << RADIX_BITS_MAX) / RADIX_THREADS;   // digits a thread
constexpr int RADIX_MAX_PASSES = 4;
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int GAP_SMALL = 8;      // offsets a lane writes alone

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// K2's route: the row's face if it lies in one of its block's windows,
// else its subsample face, else (or past the table) num_segments
struct RouteKeys {
  const int* __restrict__ fid;
  const int* __restrict__ js;
  const int* __restrict__ starts;
  const int* __restrict__ sub_ids;
  int B, log2B, A, W, smax, nsub, S, discard_sub;   // log2B < 0: B no power of 2
};

// K2s's targets, clamped: outside [0, S) is num_segments
template <typename T>
struct TargetKeys {
  const T* __restrict__ t;
  int S;
  __device__ int operator()(int n) const {
    const T v = t[n];
    return (v >= 0 && v < (T)S) ? (int)v : S;
  }
};

struct ArrayKeys {
  const int* __restrict__ k;
  __device__ int operator()(int n) const { return k[n]; }
};

// the first row of this thread's RADIX_ITEMS rows, 32 apart: warp w of
// the tile ranks rows w*512 .. w*512 + 511
__device__ __forceinline__ int first_row() {
  return blockIdx.x * RADIX_TILE + (threadIdx.x >> 5) * (32 * RADIX_ITEMS) +
         (threadIdx.x & 31);
}

// the thread's keys, -1 past N
template <class Keys>
__device__ __forceinline__ void load_keys(const Keys& keys, int N,
                                          int (&key)[RADIX_ITEMS]) {
  const int base = first_row();
#pragma unroll
  for (int i = 0; i < RADIX_ITEMS; ++i) {
    const int n = base + 32 * i;
    key[i] = n < N ? keys(n) : -1;
  }
}

// the route of the thread's rows, window by window, so the loads of all
// its rows are in flight together
__device__ __forceinline__ void load_keys(const RouteKeys& k, int N,
                                          int (&key)[RADIX_ITEMS]) {
  const int base = first_row();
  int f[RADIX_ITEMS], st[RADIX_ITEMS];
  bool in[RADIX_ITEMS];
#pragma unroll
  for (int i = 0; i < RADIX_ITEMS; ++i) {
    const int n = base + 32 * i;
    f[i] = n < N ? k.fid[n] : 0;
    st[i] = n >= N ? 0 : (k.log2B >= 0 ? n >> k.log2B : n / k.B) * k.A;
    in[i] = false;
  }
  for (int a = 0; a < k.A; ++a) {
#pragma unroll
    for (int i = 0; i < RADIX_ITEMS; ++i) {
      const int s = min(max((k.starts[st[i] + a] / 128) * 128, 0), k.smax);
      const int off = f[i] - s;
      in[i] = in[i] || (off >= 0 && off < k.W);
    }
  }
#pragma unroll
  for (int i = 0; i < RADIX_ITEMS; ++i) {
    const int n = base + 32 * i;
    int target = in[i] ? f[i] : -1;
    if (n < N && !in[i] && !k.discard_sub) {
      const int j = k.js[n];
      if (j >= 0 && j < k.nsub) target = k.sub_ids[j];
    }
    key[i] = n >= N ? -1 : (target < 0 || target >= k.S) ? k.S : target;
  }
}

// Ranks the thread's keys by digit within its warp.  On return hist_w[d]
// is the count of digit d among the warp's rows and rank[i] the count of
// the warp's earlier rows with row i's digit.
__device__ __forceinline__ void warp_rank(const int (&key)[RADIX_ITEMS],
                                          int shift, int mask, int* hist_w,
                                          int (&rank)[RADIX_ITEMS]) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = lanemask_lt();
#pragma unroll
  for (int i = 0; i < RADIX_ITEMS; ++i) {
    const bool valid = key[i] >= 0;
    const int d = valid ? (key[i] >> shift) & mask : -1;
    const unsigned peers = __match_any_sync(FULL, d);
    const int cnt = valid ? hist_w[d] : 0;
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1) hist_w[d] = cnt + __popc(peers);
    __syncwarp();
    rank[i] = cnt + __popc(peers & lt);
  }
}

// Exclusive scan over the block of up to 1024 counts in digit order, the
// thread t holding digits t + 256 j (v in, ex out; a warp's lanes hold
// neighbouring digits, so their shared-memory rows have no bank
// conflicts); wsum: warp sums of its own.
__device__ __forceinline__ void block_scan(const int (&v)[DPT], int (&ex)[DPT],
                                           int (*wsum)[RADIX_WARPS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    inc[j] = v[j];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, inc[j], o);
      if (lane >= o) inc[j] += y;
    }
    if (lane == 31) wsum[j][warp] = inc[j];
  }
  __syncthreads();
  int base = 0;
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < RADIX_WARPS; ++w) {
      total += wsum[j][w];
      if (w < warp) before += wsum[j][w];
    }
    ex[j] = base + before + inc[j] - v[j];
    base += total;
  }
}

// the tile's digit counts into counts[tile * R + d]; with key_out, the
// keys too (the first pass, whose keys are computed)
template <class Keys>
__device__ __forceinline__ void hist_body(const Keys& keys, int N, int shift,
                                          int bits, int* __restrict__ key_out,
                                          int* __restrict__ counts) {
  extern __shared__ int smem[];
  const int R = 1 << bits;
  for (int e = threadIdx.x; e < RADIX_WARPS * R; e += RADIX_THREADS)
    smem[e] = 0;
  int key[RADIX_ITEMS], rank[RADIX_ITEMS];
  load_keys(keys, N, key);
  __syncthreads();
  warp_rank(key, shift, R - 1, smem + (threadIdx.x >> 5) * R, rank);
  if (key_out) {
    const int base = first_row();
#pragma unroll
    for (int i = 0; i < RADIX_ITEMS; ++i)
      if (key[i] >= 0) key_out[base + 32 * i] = key[i];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < R; d += RADIX_THREADS) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < RADIX_WARPS; ++w) c += smem[w * R + d];
    counts[(size_t)blockIdx.x * R + d] = c;
  }
}

// the first pass of K2: the route, fused with the histogram
__global__ void __launch_bounds__(RADIX_THREADS) windowed_route_hist_kernel(
    RouteKeys keys, int N, int shift, int bits, int* __restrict__ key_out,
    int* __restrict__ counts) {
  hist_body(keys, N, shift, bits, key_out, counts);
}

// the first pass of K2s and of the ordering alone: the clamped targets
template <typename T>
__global__ void __launch_bounds__(RADIX_THREADS) target_key_hist_kernel(
    TargetKeys<T> keys, int N, int shift, int bits, int* __restrict__ key_out,
    int* __restrict__ counts) {
  hist_body(keys, N, shift, bits, key_out, counts);
}

__global__ void __launch_bounds__(RADIX_THREADS) radix_hist_kernel(
    const int* __restrict__ key, int N, int shift, int bits,
    int* __restrict__ counts) {
  hist_body(ArrayKeys{key}, N, shift, bits, nullptr, counts);
}

// counts[t * R + d] <- the digit's count in tiles before t; totals[d] <-
// the digit's count.  A block takes 32 digits (a lane each) and its warps
// consecutive ranges of tiles.
__global__ void __launch_bounds__(SCAN_THREADS) radix_scan_kernel(
    int* __restrict__ counts, int T, int R, int* __restrict__ totals) {
  __shared__ int part[SCAN_WARPS][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = blockIdx.x * 32 + lane;
  const int per = (T + SCAN_WARPS - 1) / SCAN_WARPS;
  const int t0 = min(T, warp * per), t1 = min(T, t0 + per);
  int s = 0;
  if (d < R)
    for (int t = t0; t < t1; ++t) s += counts[(size_t)t * R + d];
  part[warp][lane] = s;
  __syncthreads();
  int run = 0;
  for (int w = 0; w < warp; ++w) run += part[w][lane];
  if (d >= R) return;
  if (warp == SCAN_WARPS - 1) totals[d] = run + s;
  for (int t = t0; t < t1; ++t) {
    const size_t e = (size_t)t * R + d;
    const int c = counts[e];
    counts[e] = run;
    run += c;
  }
}

// One stable pass: each row of the tile to its place in the digit order.
// The tile is first put in digit order in shared memory, so rows of one
// digit leave in runs of consecutive addresses.  perm_in null: the first
// pass, whose values are the row indices.
__global__ void __launch_bounds__(RADIX_THREADS) radix_scatter_kernel(
    const int* __restrict__ key_in, const int* __restrict__ perm_in, int N,
    int shift, int bits, const int* __restrict__ prefix,
    const int* __restrict__ totals, int* __restrict__ key_out,
    int* __restrict__ perm_out) {
  // [max(RADIX_WARPS R, 2 RADIX_TILE)]: the warps' histograms, then the
  // tile's keys and values in digit order; then [R]: a digit's global
  // place less its place in the tile
  extern __shared__ int smem[];
  __shared__ int wsum[2][DPT][RADIX_WARPS];
  const int R = 1 << bits, mask = R - 1;
  const int warp = threadIdx.x >> 5;
  int* hist = smem;
  int* delta = smem + max(RADIX_WARPS * R, 2 * RADIX_TILE);
  for (int e = threadIdx.x; e < RADIX_WARPS * R; e += RADIX_THREADS)
    hist[e] = 0;
  // this thread's digits t + 256 j: where they start in the whole order
  int v[DPT], dbase[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int d = threadIdx.x + RADIX_THREADS * j;
    v[j] = d < R ? totals[d] : 0;
  }
  block_scan(v, dbase, wsum[0]);
  int key[RADIX_ITEMS], rank[RADIX_ITEMS];
  load_keys(ArrayKeys{key_in}, N, key);
  warp_rank(key, shift, mask, hist + warp * R, rank);
  __syncthreads();
  // per digit: the warps' counts become their bases within the digit,
  // and the tile's count
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int d = threadIdx.x + RADIX_THREADS * j;
    int run = 0;
    if (d < R) {
#pragma unroll
      for (int w = 0; w < RADIX_WARPS; ++w) {
        const int c = hist[w * R + d];
        hist[w * R + d] = run;
        run += c;
      }
    }
    v[j] = run;
  }
  int lstart[DPT];
  block_scan(v, lstart, wsum[1]);
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int d = threadIdx.x + RADIX_THREADS * j;
    if (d < R) {
      delta[d] = dbase[j] + prefix[(size_t)blockIdx.x * R + d] - lstart[j];
#pragma unroll
      for (int w = 0; w < RADIX_WARPS; ++w) hist[w * R + d] += lstart[j];
    }
  }
  __syncthreads();
  int q[RADIX_ITEMS];
#pragma unroll
  for (int i = 0; i < RADIX_ITEMS; ++i)
    q[i] = key[i] >= 0 ? hist[warp * R + ((key[i] >> shift) & mask)] + rank[i]
                       : -1;
  __syncthreads();
  int* skey = smem;
  int* sval = smem + RADIX_TILE;
  const int base = first_row();
#pragma unroll
  for (int i = 0; i < RADIX_ITEMS; ++i) {
    if (q[i] < 0) continue;
    const int n = base + 32 * i;
    skey[q[i]] = key[i];
    sval[q[i]] = perm_in ? perm_in[n] : n;
  }
  __syncthreads();
  const int nt = min(RADIX_TILE, N - (int)blockIdx.x * RADIX_TILE);
  for (int e = threadIdx.x; e < nt; e += RADIX_THREADS) {
    const int k = skey[e];
    const int dst = e + delta[(k >> shift) & mask];
    key_out[dst] = k;
    perm_out[dst] = sval[e];
  }
}

// offsets[s] = the first position whose key is >= s, for s in [0, S]:
// position p (key k, previous key kp; p = N counts as key S) writes
// offsets[kp + 1 .. k]
__global__ void __launch_bounds__(THREADS) segment_offsets_kernel(
    const int* __restrict__ skey, int N, int S, int* __restrict__ offsets) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = -1;
  if (p <= N) {
    lo = (p > 0 ? skey[p - 1] : -1) + 1;
    hi = p < N ? skey[p] : S;
  }
  const bool big = hi - lo >= GAP_SMALL;
  if (!big)
    for (int s = lo; s <= hi; ++s) offsets[s] = p;
  unsigned todo = __ballot_sync(FULL, big);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const int l = __shfl_sync(FULL, lo, src);
    const int h = __shfl_sync(FULL, hi, src);
    const int q = __shfl_sync(FULL, p, src);
    for (int s = l + lane; s <= h; s += 32) offsets[s] = q;
  }
}

// ---- the reduce ----------------------------------------------------------

constexpr int STAGE_FLOATS = 1280;   // a warp's staging of a long segment
constexpr int FOLD_UNROLL = 8;       // staged rows a lane reads before it adds

// A long segment is folded a batch at a time: each lane gathers RPL rows'
// K inputs into registers, forms each row's P values (products rounded)
// and stages them in shared memory at an odd row stride PST (so the lanes'
// stores hit distinct banks); then lane c adds column c of the batch's
// rows in order.
template <int P>
struct Fold {
  static constexpr int PST = P | 1;
  static constexpr int RPL = STAGE_FLOATS / (32 * PST) < 8
                                 ? STAGE_FLOATS / (32 * PST) : 8;
  static constexpr int ROWS = 32 * RPL;
  static_assert(RPL >= 1, "staging too small");
};

// The long segment [beg, end) folded by the whole warp: acc (column c of
// the segment, from its initial value; c < 0: none) += that column of
// each row, in order.  The next batch's rows are in flight in registers
// while the current one is folded from shared memory.
template <int K, int P, class Src>
__device__ __forceinline__ void fold_long(const Src& src,
                                          const int* __restrict__ perm,
                                          int beg, int end, float* stage,
                                          int c, float& acc) {
  using F = Fold<P>;
  constexpr int RPL = F::RPL, ROWS = F::ROWS, PST = F::PST;
  const int lane = threadIdx.x & 31;
  int p[RPL];
  float x[RPL][K];
  auto load_perm = [&](int at) {
#pragma unroll
    for (int r = 0; r < RPL; ++r) {
      const int i = at + r * 32 + lane;
      p[r] = i < end ? perm[i] : -1;
    }
  };
  auto load_rows = [&]() {
#pragma unroll
    for (int r = 0; r < RPL; ++r) src.load(p[r], x[r]);
  };
  auto stage_rows = [&]() {
#pragma unroll
    for (int r = 0; r < RPL; ++r) {
      float y[P];
      src.values(x[r], y);
#pragma unroll
      for (int k = 0; k < P; ++k) stage[(r * 32 + lane) * PST + k] = y[k];
    }
  };
  load_perm(beg);
  load_rows();
  load_perm(beg + ROWS);
  stage_rows();
  __syncwarp();
  const float* col = stage + (c >= 0 ? c : 0);
  for (int at = beg; at < end; at += ROWS) {
    load_rows();                    // the next batch, in flight
    load_perm(at + 2 * ROWS);
    const int n = min(ROWS, end - at);
    int i = 0;
    for (; i + FOLD_UNROLL <= n; i += FOLD_UNROLL) {
      float v[FOLD_UNROLL];
#pragma unroll
      for (int u = 0; u < FOLD_UNROLL; ++u) v[u] = col[(i + u) * PST];
#pragma unroll
      for (int u = 0; u < FOLD_UNROLL; ++u) acc = __fadd_rn(acc, v[u]);
    }
    for (; i < n; ++i) acc = __fadd_rn(acc, col[i * PST]);
    __syncwarp();
    stage_rows();
    __syncwarp();
  }
}

// a mode's output columns (P, a multiple of 4), the columns it forms
// (PF: the pad columns of AHW2 stay zero) and the floats of a row's
// inputs it reads (K: w and res, w, or vals)
template <int MODE>
struct Mode {
  static constexpr int P = MODE == 2 ? 20 : MODE == 3 ? 8 : 12;
  static constexpr int PF = MODE == 2 ? 18 : MODE == 3 ? 6 : 12;
  static constexpr int K = MODE == 0 ? 12 : MODE == 3 ? 3 : 6;
};

// a row of a mode: its inputs (w then res, w, or vals; zeros for p < 0)
// and its values, each product rounded
template <int MODE>
struct ModeRows {
  static constexpr int K = Mode<MODE>::K;
  const float* __restrict__ w;
  const float* __restrict__ res;
  const float* __restrict__ vals;
  int C;
  __device__ __forceinline__ void load(int p, float (&x)[K]) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if constexpr (MODE == 0) {
        x[k] = (p >= 0 && k < C) ? vals[(size_t)p * C + k] : 0.0f;
      } else if constexpr (MODE == 3) {
        x[k] = p >= 0 ? w[3 * (size_t)p + k] : 0.0f;
      } else {
        x[k] = p < 0 ? 0.0f
               : k < 3 ? w[3 * (size_t)p + k] : res[3 * (size_t)p + k - 3];
      }
    }
  }
  template <int PY>
  __device__ __forceinline__ void values(const float (&x)[K],
                                         float (&y)[PY]) const {
    if constexpr (MODE == 0) {
#pragma unroll
      for (int c = 0; c < 12; ++c) y[c] = x[c];
    }
    if constexpr (MODE == 1 || MODE == 2) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
#pragma unroll
        for (int c = 0; c < 3; ++c) y[4 * j + c] = __fmul_rn(x[j], x[3 + c]);
        y[4 * j + 3] = x[j];
      }
    }
    if constexpr (MODE == 2 || MODE == 3) {
      constexpr int c0 = MODE == 2 ? 12 : 0;   // w0w0 w1w1 w2w2 w0w1 w0w2 w1w2
      y[c0 + 0] = __fmul_rn(x[0], x[0]);
      y[c0 + 1] = __fmul_rn(x[1], x[1]);
      y[c0 + 2] = __fmul_rn(x[2], x[2]);
      y[c0 + 3] = __fmul_rn(x[0], x[1]);
      y[c0 + 4] = __fmul_rn(x[0], x[2]);
      y[c0 + 5] = __fmul_rn(x[1], x[2]);
    }
  }
};

// K2: a lane a segment, a warp 32 consecutive segments.  A segment of at
// most LONG_ROWS rows is walked by its lane, U rows' loads in flight
// before their adds; the warp then folds its longer segments one by one.
template <int MODE>
__global__ void __launch_bounds__(THREADS) windowed_reduce_kernel(
    const float* __restrict__ w, const float* __restrict__ res,
    const float* __restrict__ vals, const int* __restrict__ perm,
    const int* __restrict__ offsets, int num_segments, int C, int Cp,
    float* __restrict__ out) {
  constexpr int P = Mode<MODE>::P, PF = Mode<MODE>::PF, K = Mode<MODE>::K;
  constexpr int U = K <= 6 ? 8 : 4;
  __shared__ __align__(16) float stage_all[THREADS / 32][STAGE_FLOATS + 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = blockIdx.x * THREADS + threadIdx.x;
  const ModeRows<MODE> src{w, res, vals, C};
  int beg = 0, end = 0;
  if (s < num_segments) {
    beg = offsets[s];
    end = offsets[s + 1];
  }
  const bool lng = end - beg > LONG_ROWS;
  if (s < num_segments && !lng) {
    float acc[P];
#pragma unroll
    for (int c = 0; c < P; ++c) acc[c] = 0.0f;
    for (int i = beg; i < end; i += U) {
      int p[U];
      float x[U][K], y[PF];
#pragma unroll
      for (int u = 0; u < U; ++u) p[u] = i + u < end ? perm[i + u] : -1;
#pragma unroll
      for (int u = 0; u < U; ++u) src.load(p[u], x[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i + u < end) {
          src.values(x[u], y);
#pragma unroll
          for (int c = 0; c < PF; ++c) acc[c] = __fadd_rn(acc[c], y[c]);
        }
      }
    }
    float4* o = reinterpret_cast<float4*>(stage_all[warp]) + lane * (Cp / 4);
#pragma unroll
    for (int q = 0; q < P / 4; ++q) {
      if (4 * q < Cp)
        o[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                           acc[4 * q + 3]);
    }
  }
  // the warp's rows leave together: 32 Cp consecutive floats, 16-byte
  // stores, but for the long segments' rows, which the warp writes below
  unsigned todo = __ballot_sync(FULL, lng);
  float* stage = stage_all[warp];
  __syncwarp();
  {
    const int q4 = Cp / 4, s0 = s - lane;
    const int n4 = min(32, num_segments - s0) * q4;
    const float4* st4 = reinterpret_cast<const float4*>(stage);
    float4* o4 = reinterpret_cast<float4*>(out + (size_t)s0 * Cp);
    for (int e = lane; e < n4; e += 32)
      if (!((todo >> (e / q4)) & 1)) o4[e] = st4[e];
  }
  __syncwarp();
  if (!todo) return;
  float* orow = stage + STAGE_FLOATS;
  const int ncol = MODE == 0 ? C : PF;   // the columns that add rows
  while (todo) {
    const int src_lane = __ffs(todo) - 1;
    todo &= todo - 1;
    const int sb = __shfl_sync(FULL, beg, src_lane);
    const int se = __shfl_sync(FULL, end, src_lane);
    const int seg = s - lane + src_lane;
    float acc = 0.0f;
    fold_long<K, PF>(src, perm, sb, se, stage, lane < ncol ? lane : -1, acc);
    orow[lane] = lane < ncol ? acc : 0.0f;
    __syncwarp();
    if (4 * lane < Cp)
      reinterpret_cast<float4*>(out + (size_t)seg * Cp)[lane] =
          reinterpret_cast<const float4*>(orow)[lane];
    __syncwarp();
  }
}

// K2s's rows: input k of row p is column c0 + k of the (N, C) rows
// (zeros for k >= CW or p < 0), its values the inputs themselves
template <int KMAX>
struct GivenRows {
  const float* __restrict__ rows;
  int C, c0, CW;
  bool vec;   // rows 16-byte aligned and C a multiple of 4: float4 loads
  __device__ __forceinline__ void load(int p, float (&x)[KMAX]) const {
    if (vec) {
#pragma unroll
      for (int k = 0; k < KMAX; k += 4) {
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (p >= 0 && k < CW)
          v = *reinterpret_cast<const float4*>(rows + (size_t)p * C + c0 + k);
        x[k] = v.x;
        x[k + 1] = v.y;
        x[k + 2] = v.z;
        x[k + 3] = v.w;
      }
      return;
    }
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
      x[k] = (p >= 0 && k < CW) ? rows[(size_t)p * C + c0 + k] : 0.0f;
  }
  __device__ __forceinline__ void values(const float (&x)[KMAX],
                                         float (&y)[KMAX]) const {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) y[k] = x[k];
  }
};

// K2s: a lane a segment as above, KMAX columns at a time
template <int KMAX>
__global__ void __launch_bounds__(THREADS) segment_reduce_kernel(
    const float* __restrict__ rows, const int* __restrict__ perm,
    const int* __restrict__ offsets, const float* __restrict__ init,
    int num_segments, int C, int vec, float* __restrict__ out) {
  constexpr int U = KMAX <= 4 ? 8 : 4;
  __shared__ float stage_all[THREADS / 32][STAGE_FLOATS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = blockIdx.x * THREADS + threadIdx.x;
  int beg = 0, end = 0;
  if (s < num_segments) {
    beg = offsets[s];
    end = offsets[s + 1];
  }
  const bool lng = end - beg > LONG_ROWS;
  if (s < num_segments && !lng) {
    for (int c0 = 0; c0 < C; c0 += KMAX) {
      const GivenRows<KMAX> src{rows, C, c0, min(KMAX, C - c0), vec != 0};
      const size_t o = (size_t)s * C + c0;
      float acc[KMAX];
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        acc[j] = (j < src.CW && init) ? init[o + j] : 0.0f;
      for (int i = beg; i < end; i += U) {
        int p[U];
        float x[U][KMAX];
#pragma unroll
        for (int u = 0; u < U; ++u) p[u] = i + u < end ? perm[i + u] : -1;
#pragma unroll
        for (int u = 0; u < U; ++u) src.load(p[u], x[u]);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (i + u < end) {
#pragma unroll
            for (int j = 0; j < KMAX; ++j) acc[j] = __fadd_rn(acc[j], x[u][j]);
          }
        }
      }
      // one chunk: the row waits in shared memory for the warp's rows
      float* dst = C <= KMAX ? stage_all[warp] + lane * C : out + o;
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (j < src.CW) dst[j] = acc[j];
    }
  }
  unsigned todo = __ballot_sync(FULL, lng);
  float* stage = stage_all[warp];
  if (C <= KMAX) {
    // the warp's rows leave together, but for the long segments' rows
    __syncwarp();
    const int s0 = s - lane;
    const int n = min(32, num_segments - s0) * C;
    for (int e = lane; e < n; e += 32)
      if (!((todo >> (e / C)) & 1)) out[(size_t)s0 * C + e] = stage[e];
    __syncwarp();
  }
  if (!todo) return;
  while (todo) {
    const int src_lane = __ffs(todo) - 1;
    todo &= todo - 1;
    const int sb = __shfl_sync(FULL, beg, src_lane);
    const int se = __shfl_sync(FULL, end, src_lane);
    const int seg = s - lane + src_lane;
    for (int c0 = 0; c0 < C; c0 += KMAX) {
      const GivenRows<KMAX> src{rows, C, c0, min(KMAX, C - c0), vec != 0};
      const size_t o = (size_t)seg * C + c0;
      const bool act = lane < src.CW;
      float acc = (act && init) ? init[o + lane] : 0.0f;
      fold_long<KMAX, KMAX>(src, perm, sb, se, stage, act ? lane : -1, acc);
      if (act) out[o + lane] = acc;
    }
  }
}

// ---- the host side ---------------------------------------------------------

struct Work {
  int* key;       // the sorted keys (the last pass's output)
  int* perm;      // the sorted row indices
  int* key_b;     // the other buffers of the passes
  int* perm_b;
  int* offsets;   // num_segments + 1
  int* totals;    // R
  int* counts;    // T x R
};

// The workspace: 4 N + (S + 1) + R + T R ints, R the widest digit's
// radix; 0 when it is too small or the plan is not one.
int carve(void* ws, long long ws_ints, int N, int S, const int* plan,
          int npass, Work& wk) {
  if (npass < 1 || npass > RADIX_MAX_PASSES) return 0;
  int R = 0, shift = 0;
  for (int p = 0; p < npass; ++p) {
    const int bits = plan[2 * p + 1];
    if (plan[2 * p] != shift || bits < 1 || bits > RADIX_BITS_MAX) return 0;
    shift += bits;
    R = max(R, 1 << bits);
  }
  if (shift < 31 && (S >> shift) != 0) return 0;   // keys in [0, S]
  const long long T = ((long long)N + RADIX_TILE - 1) / RADIX_TILE;
  const long long need = 4LL * N + S + 1 + R + T * R;
  if (ws_ints < need) return 0;
  int* w = (int*)ws;
  wk.key = w;
  wk.perm = w + N;
  wk.key_b = w + 2 * (size_t)N;
  wk.perm_b = w + 3 * (size_t)N;
  wk.offsets = w + 4 * (size_t)N;
  wk.totals = wk.offsets + S + 1;
  wk.counts = wk.totals + R;
  return 1;
}

// The passes and the offsets; hist0(T, smem, shift, bits, key_out, counts)
// launches the first pass's histogram.  The last pass writes wk.key and
// wk.perm.
template <class Hist0>
int order_rows(Hist0 hist0, int N, int S, const int* plan, int npass,
               const Work& wk, cudaStream_t st) {
  const int T = (N + RADIX_TILE - 1) / RADIX_TILE;
  int err;
  for (int p = 0; N > 0 && p < npass; ++p) {
    const int shift = plan[2 * p], bits = plan[2 * p + 1], R = 1 << bits;
    const bool last = (npass - 1 - p) % 2 == 0;   // writes wk.key
    int* kin = last ? wk.key_b : wk.key;
    int* pin = last ? wk.perm_b : wk.perm;
    int* kout = last ? wk.key : wk.key_b;
    int* pout = last ? wk.perm : wk.perm_b;
    const size_t hsm = (size_t)RADIX_WARPS * R * sizeof(int);
    const size_t ssm =
        (size_t)(max(RADIX_WARPS * R, 2 * RADIX_TILE) + R) * sizeof(int);
    if (p == 0)
      hist0(T, hsm, shift, bits, kin, wk.counts);
    else
      radix_hist_kernel<<<T, RADIX_THREADS, hsm, st>>>(kin, N, shift, bits,
                                                       wk.counts);
    if ((err = (int)cudaGetLastError())) return err;
    radix_scan_kernel<<<(R + 31) / 32, SCAN_THREADS, 0, st>>>(wk.counts, T,
                                                              R, wk.totals);
    if ((err = (int)cudaGetLastError())) return err;
    radix_scatter_kernel<<<T, RADIX_THREADS, ssm, st>>>(
        kin, p == 0 ? nullptr : pin, N, shift, bits, wk.counts, wk.totals,
        kout, pout);
    if ((err = (int)cudaGetLastError())) return err;
  }
  segment_offsets_kernel<<<N / THREADS + 1, THREADS, 0, st>>>(wk.key, N, S,
                                                              wk.offsets);
  return (int)cudaGetLastError();
}

template <typename T>
int order_targets(const void* target, int N, int S, const int* plan,
                  int npass, const Work& wk, cudaStream_t st) {
  const TargetKeys<T> keys{(const T*)target, S};
  return order_rows(
      [&](int nt, size_t smem, int shift, int bits, int* kout, int* counts) {
        target_key_hist_kernel<T><<<nt, RADIX_THREADS, smem, st>>>(
            keys, N, shift, bits, kout, counts);
      },
      N, S, plan, npass, wk, st);
}

template <int MODE>
void launch_reduce(const void* w, const void* res, const void* vals,
                   const Work& wk, int num_segments, int C, int Cp, void* out,
                   cudaStream_t stream) {
  const int blocks = (num_segments + THREADS - 1) / THREADS;
  windowed_reduce_kernel<MODE><<<blocks, THREADS, 0, stream>>>(
      (const float*)w, (const float*)res, (const float*)vals, wk.perm,
      wk.offsets, num_segments, C, Cp, (float*)out);
}

}  // namespace

// K2: route, order, reduce into out (num_segments, Cp)
extern "C" int csw_windowed_scatter(
    const void* fid, const void* js, const void* starts, const void* sub_ids,
    int N, int B, int A, int W, int smax, int nsub, int num_segments,
    int discard_sub, const void* w, const void* res, const void* vals,
    int mode, int C, int Cp, const int* plan, int npass, void* ws,
    long long ws_ints, void* out, void* stream) {
  if (num_segments <= 0) return 0;
  if (mode < 0 || mode > 3) return (int)cudaErrorInvalidValue;
  Work wk;
  if (!carve(ws, ws_ints, N, num_segments, plan, npass, wk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int log2B = 0;
  while ((1 << log2B) < B) ++log2B;
  const RouteKeys keys{(const int*)fid, (const int*)js, (const int*)starts,
                       (const int*)sub_ids, B, (1 << log2B) == B ? log2B : -1,
                       A, W, smax, nsub, num_segments, discard_sub};
  int err = order_rows(
      [&](int nt, size_t smem, int shift, int bits, int* kout, int* counts) {
        windowed_route_hist_kernel<<<nt, RADIX_THREADS, smem, st>>>(
            keys, N, shift, bits, kout, counts);
      },
      N, num_segments, plan, npass, wk, st);
  if (err) return err;
  switch (mode) {
    case 0:
      launch_reduce<0>(w, res, vals, wk, num_segments, C, Cp, out, st);
      break;
    case 1:
      launch_reduce<1>(w, res, vals, wk, num_segments, C, Cp, out, st);
      break;
    case 2:
      launch_reduce<2>(w, res, vals, wk, num_segments, C, Cp, out, st);
      break;
    default:
      launch_reduce<3>(w, res, vals, wk, num_segments, C, Cp, out, st);
      break;
  }
  return (int)cudaGetLastError();
}

// K2s: order the targets (int32, or int64 when target_64), reduce the
// (N, C) rows into out (num_segments, C) from init (or zeros)
extern "C" int csw_segment_sum(const void* rows, const void* target,
                               int target_64, int N, int num_segments, int C,
                               const void* init, const int* plan, int npass,
                               void* ws, long long ws_ints, void* out,
                               void* stream) {
  if (num_segments <= 0 || C <= 0) return 0;
  Work wk;
  if (!carve(ws, ws_ints, N, num_segments, plan, npass, wk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int err = target_64
                ? order_targets<long long>(target, N, num_segments, plan,
                                           npass, wk, st)
                : order_targets<int>(target, N, num_segments, plan, npass,
                                     wk, st);
  if (err) return err;
  const int blocks = (num_segments + THREADS - 1) / THREADS;
  const int vec = C % 4 == 0 && ((size_t)rows & 15) == 0;
  if (C <= 4)
    segment_reduce_kernel<4><<<blocks, THREADS, 0, st>>>(
        (const float*)rows, wk.perm, wk.offsets, (const float*)init,
        num_segments, C, vec, (float*)out);
  else
    segment_reduce_kernel<12><<<blocks, THREADS, 0, st>>>(
        (const float*)rows, wk.perm, wk.offsets, (const float*)init,
        num_segments, C, vec, (float*)out);
  return (int)cudaGetLastError();
}

// The ordering alone, into the workspace: perm at ws + N, offsets at
// ws + 4 N
extern "C" int csw_segment_order(const void* target, int target_64, int N,
                                 int num_segments, const int* plan, int npass,
                                 void* ws, long long ws_ints, void* stream) {
  if (num_segments <= 0) return 0;
  Work wk;
  if (!carve(ws, ws_ints, N, num_segments, plan, npass, wk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return target_64 ? order_targets<long long>(target, N, num_segments, plan,
                                              npass, wk, st)
                   : order_targets<int>(target, N, num_segments, plan,
                                        npass, wk, st);
}
