// K2: windowed segment-sum of per-point rows onto faces (the A^T scatter).
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
// Bound on the H100: L2 atomics.  The bytes are few (36 B of inputs a
// row, 48 B of output a face in AH mode), but a row-per-thread kernel
// with scalar atomics issues C atomics a row (12e6 an iteration at 1e6
// points), and the 32 lanes of each atomic instruction hit 32 different
// face rows.  Two things cut that:
//  * warp pre-aggregation: the points are Hilbert-sorted, so lanes of a
//    warp often share a target face.  __match_any_sync groups the lanes
//    by target, and a shuffle tree (Westphal's peer reduction) sums each
//    group's row into its lowest lane before any atomic is issued;
//  * vector atomics: that lane adds the row with one float4 atomicAdd
//    per 4 columns (sm_90 and CUDA >= 12.1; there is no scalar fallback).
//    The output table's row stride is C rounded up to 4 (12, 20, 8, or
//    <= 12 for GIVEN), so every row is 16-byte aligned; the wrapper
//    returns the first C columns.
// The accumulation order is not deterministic, so results agree with the
// plain version to 1e-4 * max|ref|, not bit for bit.  Index arithmetic is
// 32-bit (the wrapper checks N < 2^31).

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;

// registers a mode's row needs: its columns rounded up to 4
template <int MODE>
struct ModeCols {
  static constexpr int P = MODE == 2 ? 20 : MODE == 3 ? 8 : 12;
};

template <int MODE>
__global__ void __launch_bounds__(THREADS) windowed_scatter_kernel(
    const float* __restrict__ w, const float* __restrict__ res,
    const float* __restrict__ vals, const int* __restrict__ fid,
    const int* __restrict__ js, const int* __restrict__ starts,
    const int* __restrict__ sub_ids, int N, int B, int A, int W, int smax,
    int nsub, int num_segments, int C, int Cp, int discard_sub,
    float* __restrict__ out) {
  constexpr int P = ModeCols<MODE>::P;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;

  // every lane takes part in the warp collectives below, so rows past N
  // carry target -1 instead of returning
  int target = -1;
  float v[P];
#pragma unroll
  for (int c = 0; c < P; ++c) v[c] = 0.0f;
  if (n < N) {
    const int f = fid[n];
    const int* st = starts + (n / B) * A;
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
    if (target >= num_segments) target = -1;
    if (target >= 0) {
      if (MODE == 0) {
        const float* vr = vals + (size_t)n * C;
#pragma unroll
        for (int c = 0; c < P; ++c) v[c] = c < C ? vr[c] : 0.0f;
      } else {
        const float w0 = w[3 * (size_t)n], w1 = w[3 * (size_t)n + 1],
                    w2 = w[3 * (size_t)n + 2];
        constexpr int c0 = MODE == 2 ? 12 : 0;   // first W2 column
        if (MODE == 1 || MODE == 2) {
          const float r0 = res[3 * (size_t)n], r1 = res[3 * (size_t)n + 1],
                      r2 = res[3 * (size_t)n + 2];
          const float wj[3] = {w0, w1, w2};
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            v[4 * j + 0] = wj[j] * r0;
            v[4 * j + 1] = wj[j] * r1;
            v[4 * j + 2] = wj[j] * r2;
            v[4 * j + 3] = wj[j];
          }
        }
        if (MODE == 2 || MODE == 3) {
          v[c0 + 0] = w0 * w0;
          v[c0 + 1] = w1 * w1;
          v[c0 + 2] = w2 * w2;
          v[c0 + 3] = w0 * w1;
          v[c0 + 4] = w0 * w2;
          v[c0 + 5] = w1 * w2;
        }
      }
    }
  }

  // sum the rows of the lanes that share a target into the lowest of
  // them: each round, a lane adds the partial sum of the next remaining
  // peer above it, and the peers at odd rank drop out
  const unsigned peers = __match_any_sync(FULL, target);
  const int leader = __ffs(peers) - 1;
  int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & (0xfffffffeu << lane);
  while (__any_sync(FULL, above)) {
    const int next = __ffs(above);
    const int srcl = next ? next - 1 : lane;
#pragma unroll
    for (int c = 0; c < P; ++c) {
      const float o = __shfl_sync(FULL, v[c], srcl);
      if (next) v[c] += o;
    }
    above &= __ballot_sync(FULL, !(rank & 1));
    rank >>= 1;
  }

  if (target >= 0 && lane == leader) {
    float4* o = reinterpret_cast<float4*>(out + (size_t)target * Cp);
#pragma unroll
    for (int q = 0; q < P / 4; ++q) {
      if (4 * q < Cp)
        atomicAdd(o + q, make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                                     v[4 * q + 3]));
    }
  }
}

template <int MODE>
void launch(const void* w, const void* res, const void* vals,
            const void* fid, const void* js, const void* starts,
            const void* sub_ids, int N, int B, int A, int W, int smax,
            int nsub, int num_segments, int C, int Cp, int discard_sub,
            void* out, cudaStream_t stream) {
  const int blocks = (N + THREADS - 1) / THREADS;
  windowed_scatter_kernel<MODE><<<blocks, THREADS, 0, stream>>>(
      (const float*)w, (const float*)res, (const float*)vals,
      (const int*)fid, (const int*)js, (const int*)starts,
      (const int*)sub_ids, N, B, A, W, smax, nsub, num_segments, C, Cp,
      discard_sub, (float*)out);
}

}  // namespace

extern "C" int csw_windowed_scatter(const void* w, const void* res,
                                    const void* vals, const void* fid,
                                    const void* js, const void* starts,
                                    const void* sub_ids, int N, int B,
                                    int A, int W, int smax, int nsub,
                                    int num_segments, int mode, int C,
                                    int Cp, int discard_sub, void* out,
                                    void* stream) {
  if (N <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      launch<0>(w, res, vals, fid, js, starts, sub_ids, N, B, A, W, smax,
                nsub, num_segments, C, Cp, discard_sub, out, s);
      break;
    case 1:
      launch<1>(w, res, vals, fid, js, starts, sub_ids, N, B, A, W, smax,
                nsub, num_segments, C, Cp, discard_sub, out, s);
      break;
    case 2:
      launch<2>(w, res, vals, fid, js, starts, sub_ids, N, B, A, W, smax,
                nsub, num_segments, C, Cp, discard_sub, out, s);
      break;
    case 3:
      launch<3>(w, res, vals, fid, js, starts, sub_ids, N, B, A, W, smax,
                nsub, num_segments, C, Cp, discard_sub, out, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
