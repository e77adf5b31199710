// K2: windowed segment-sum of per-point rows onto faces (the A^T scatter),
// and the ordered segment sum that every other accumulation of the fit
// runs through.
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
// discard_sub is set.  This matters after the correspondence polish: a
// polished fid can lie outside every window, and then the row lands on
// sub_ids[js], not on fid.  Targets at or beyond num_segments (pad faces
// of the 128-aligned table) are dropped.
//
// The order of the sum.  Each face's row is the float32 sum, from 0.0f,
// of the mode's products for the rows routed to it, taken in ascending
// row index: the order in which the plain version's index_add_ adds them
// on the CPU.  So the result is a function of the inputs alone, equal to
// the plain version bit for bit, and the same on every run (the TPU's
// grid walks its blocks in order too).  Products and sums are rounded
// one at a time (__fmul_rn, __fadd_rn), never contracted into an FMA,
// as the plain version rounds the product before it adds it.  There is
// no float atomic anywhere.
//
// Three stages, each a launch:
//  (a) windowed_route_kernel writes each row's target face, and
//      num_segments for a dropped row, so dropped rows sort past the
//      last face and form no segment;
//  (b) a stable ordering of the rows by target, and each face's first
//      row in that order (the wrapper: torch.sort(stable=True) and
//      torch.searchsorted).  The ordering moves indices only and adds
//      nothing, so taking it from the library leaves every sum in this
//      file;
//  (c) windowed_reduce_kernel: one thread a face walks its segment of
//      the ordering in order, forms the mode's products from w and res
//      (or reads vals) and writes the face's padded row once, zeros
//      where the face has no rows.  That write replaces the separate
//      zero fill of the table an atomic kernel needs.
// The output table's row stride is C rounded up to 4 (12, 20, 8, or
// <= 12 for GIVEN), so every row is written with 16-byte stores; the
// wrapper returns the first C columns.
//
// Bound on the H100: bytes, about 0.017 ms at 1e6 points (36 B of
// inputs a row, 48 B of output a face in AH mode); the ordering adds a
// sort of N keys and the kernels re-read the index stream.  A segment is
// a serial chain of adds, so a long one (a face that collects the rows of
// a whole block) is a long chain; the loop loads the next four rows
// before it adds them, to keep the loads in flight.
//
// segment_sum_kernel is stage (c) for given float rows of any width:
// out[s, c] = init[s, c] (or 0) plus the rows whose target is s, in
// ascending row index, one thread an element of the table.  It replaces index_add_ (whose CUDA version adds with atomics)
// at every accumulation of the fit: the brute-force A^T scatter, the
// faces -> vertices fold without tables, the fold's and the curvature
// prior's overflow rows, vertex normals and areas.  Index arithmetic is
// 32-bit (the wrappers check N and the table size < 2^31).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;   // rows a segment walk loads before it adds

// registers a mode's row needs: its columns rounded up to 4
template <int MODE>
struct ModeCols {
  static constexpr int P = MODE == 2 ? 20 : MODE == 3 ? 8 : 12;
};

// floats of a row's inputs a mode reads: w and res, w, or vals
template <int MODE>
struct ModeIn {
  static constexpr int K = MODE == 0 ? 12 : MODE == 3 ? 3 : 6;
};

__global__ void __launch_bounds__(THREADS) windowed_route_kernel(
    const int* __restrict__ fid, const int* __restrict__ js,
    const int* __restrict__ starts, const int* __restrict__ sub_ids, int N,
    int B, int A, int W, int smax, int nsub, int num_segments,
    int discard_sub, int* __restrict__ key) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const int f = fid[n];
  const int* st = starts + (n / B) * A;
  int target = -1;
  for (int a = 0; a < A; ++a) {
    const int s = min(max((st[a] / 128) * 128, 0), smax);
    const int off = f - s;
    if (off >= 0 && off < W) {
      target = f;
      break;
    }
  }
  if (target < 0 && !discard_sub) {
    const int j = js[n];
    if (j >= 0 && j < nsub) target = sub_ids[j];
  }
  key[n] = (target < 0 || target >= num_segments) ? num_segments : target;
}

// the inputs of row n that the mode reads
template <int MODE>
__device__ __forceinline__ void load_row(const float* __restrict__ w,
                                         const float* __restrict__ res,
                                         const float* __restrict__ vals,
                                         int C, int n,
                                         float (&x)[ModeIn<MODE>::K]) {
  if constexpr (MODE == 0) {
    const float* vr = vals + (size_t)n * C;
#pragma unroll
    for (int c = 0; c < 12; ++c) x[c] = c < C ? vr[c] : 0.0f;
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) x[c] = w[3 * (size_t)n + c];
    if constexpr (MODE != 3) {
#pragma unroll
      for (int c = 0; c < 3; ++c) x[3 + c] = res[3 * (size_t)n + c];
    }
  }
}

// acc += the mode's products of one row, each product rounded, then
// added, column by column
template <int MODE>
__device__ __forceinline__ void add_row(const float (&x)[ModeIn<MODE>::K],
                                        float (&acc)[ModeCols<MODE>::P]) {
  if constexpr (MODE == 0) {
#pragma unroll
    for (int c = 0; c < 12; ++c) acc[c] = __fadd_rn(acc[c], x[c]);
  }
  if constexpr (MODE == 1 || MODE == 2) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        acc[4 * j + c] = __fadd_rn(acc[4 * j + c], __fmul_rn(x[j], x[3 + c]));
      acc[4 * j + 3] = __fadd_rn(acc[4 * j + 3], x[j]);
    }
  }
  if constexpr (MODE == 2 || MODE == 3) {
    constexpr int c0 = MODE == 2 ? 12 : 0;   // first W2 column
    acc[c0 + 0] = __fadd_rn(acc[c0 + 0], __fmul_rn(x[0], x[0]));
    acc[c0 + 1] = __fadd_rn(acc[c0 + 1], __fmul_rn(x[1], x[1]));
    acc[c0 + 2] = __fadd_rn(acc[c0 + 2], __fmul_rn(x[2], x[2]));
    acc[c0 + 3] = __fadd_rn(acc[c0 + 3], __fmul_rn(x[0], x[1]));
    acc[c0 + 4] = __fadd_rn(acc[c0 + 4], __fmul_rn(x[0], x[2]));
    acc[c0 + 5] = __fadd_rn(acc[c0 + 5], __fmul_rn(x[1], x[2]));
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) windowed_reduce_kernel(
    const float* __restrict__ w, const float* __restrict__ res,
    const float* __restrict__ vals, const long long* __restrict__ perm,
    const int* __restrict__ offsets, int num_segments, int C, int Cp,
    float* __restrict__ out) {
  constexpr int P = ModeCols<MODE>::P;
  constexpr int K = ModeIn<MODE>::K;
  const int s = blockIdx.x * THREADS + threadIdx.x;
  if (s >= num_segments) return;
  float acc[P];
#pragma unroll
  for (int c = 0; c < P; ++c) acc[c] = 0.0f;
  int i = offsets[s];
  const int end = offsets[s + 1];
  for (; i + UNROLL <= end; i += UNROLL) {
    float x[UNROLL][K];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      load_row<MODE>(w, res, vals, C, (int)perm[i + u], x[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) add_row<MODE>(x[u], acc);
  }
  for (; i < end; ++i) {
    float x[K];
    load_row<MODE>(w, res, vals, C, (int)perm[i], x);
    add_row<MODE>(x, acc);
  }
  float4* o = reinterpret_cast<float4*>(out + (size_t)s * Cp);
#pragma unroll
  for (int q = 0; q < P / 4; ++q) {
    if (4 * q < Cp)
      o[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                         acc[4 * q + 3]);
  }
}

__global__ void __launch_bounds__(THREADS) segment_sum_kernel(
    const float* __restrict__ rows, const long long* __restrict__ perm,
    const int* __restrict__ offsets, const float* __restrict__ init,
    int num_segments, int C, float* __restrict__ out) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= num_segments * C) return;
  const int s = e / C;
  const int c = e - s * C;
  float acc = init ? init[e] : 0.0f;
  int i = offsets[s];
  const int end = offsets[s + 1];
  for (; i + UNROLL <= end; i += UNROLL) {
    float x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) x[u] = rows[perm[i + u] * C + c];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc = __fadd_rn(acc, x[u]);
  }
  for (; i < end; ++i) acc = __fadd_rn(acc, rows[perm[i] * C + c]);
  out[e] = acc;
}

template <int MODE>
void launch_reduce(const void* w, const void* res, const void* vals,
                   const void* perm, const void* offsets, int num_segments,
                   int C, int Cp, void* out, cudaStream_t stream) {
  const int blocks = (num_segments + THREADS - 1) / THREADS;
  windowed_reduce_kernel<MODE><<<blocks, THREADS, 0, stream>>>(
      (const float*)w, (const float*)res, (const float*)vals,
      (const long long*)perm, (const int*)offsets, num_segments, C, Cp,
      (float*)out);
}

}  // namespace

extern "C" int csw_windowed_route(const void* fid, const void* js,
                                  const void* starts, const void* sub_ids,
                                  int N, int B, int A, int W, int smax,
                                  int nsub, int num_segments,
                                  int discard_sub, void* key,
                                  void* stream) {
  if (N <= 0) return 0;
  windowed_route_kernel<<<(N + THREADS - 1) / THREADS, THREADS, 0,
                          (cudaStream_t)stream>>>(
      (const int*)fid, (const int*)js, (const int*)starts,
      (const int*)sub_ids, N, B, A, W, smax, nsub, num_segments,
      discard_sub, (int*)key);
  return (int)cudaGetLastError();
}

extern "C" int csw_windowed_reduce(const void* w, const void* res,
                                   const void* vals, const void* perm,
                                   const void* offsets, int num_segments,
                                   int mode, int C, int Cp, void* out,
                                   void* stream) {
  if (num_segments <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      launch_reduce<0>(w, res, vals, perm, offsets, num_segments, C, Cp,
                       out, s);
      break;
    case 1:
      launch_reduce<1>(w, res, vals, perm, offsets, num_segments, C, Cp,
                       out, s);
      break;
    case 2:
      launch_reduce<2>(w, res, vals, perm, offsets, num_segments, C, Cp,
                       out, s);
      break;
    case 3:
      launch_reduce<3>(w, res, vals, perm, offsets, num_segments, C, Cp,
                       out, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int csw_segment_sum(const void* rows, const void* perm,
                               const void* offsets, const void* init,
                               int num_segments, int C, void* out,
                               void* stream) {
  if (num_segments <= 0 || C <= 0) return 0;
  segment_sum_kernel<<<(num_segments * C + THREADS - 1) / THREADS, THREADS,
                       0, (cudaStream_t)stream>>>(
      (const float*)rows, (const long long*)perm, (const int*)offsets,
      (const float*)init, num_segments, C, (float*)out);
  return (int)cudaGetLastError();
}
