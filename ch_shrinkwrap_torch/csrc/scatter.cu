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
// one of its block's windows [s0, s0 + W) (starts already rounded down to
// 128); otherwise it goes to face sub_ids[js] (the subsample slot K1
// chose), or is dropped when discard_sub is set.  This matters after the
// correspondence polish: a polished fid can lie outside every window, and
// then the row lands on sub_ids[js], not on fid.  Targets at or beyond
// num_segments (pad faces of the 128-aligned table) are dropped.
//
// Bound on the H100: atomics and bytes.  Each row reads 36 B of inputs
// (w, res, fid, js) and performs C fp32 atomicAdds (red.global.add) into a
// (num_segments, C) table that the wrapper zeroes; with Hilbert-sorted
// points and faces neighbouring threads hit neighbouring faces.  The
// accumulation order is not deterministic, so results agree with the
// plain version to 1e-4 * max|ref|, not bit for bit.
//
// First, simple design: one thread per point row, the row's columns formed
// in registers, one atomicAdd per column.

#include <cuda_runtime.h>

namespace {

__global__ void windowed_scatter_kernel(
    const float* __restrict__ w, const float* __restrict__ res,
    const float* __restrict__ vals, const int* __restrict__ fid,
    const int* __restrict__ js, const int* __restrict__ starts,
    const int* __restrict__ sub_ids, long long N, int B, int A, int W,
    int nsub, long long num_segments, int mode, int C, int discard_sub,
    float* __restrict__ out) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int f = fid[n];
  const int* st = starts + (n / B) * A;
  long long target = -1;
  for (int a = 0; a < A; ++a) {
    const int off = f - st[a];
    if (off >= 0 && off < W) {
      target = f;
      break;
    }
  }
  if (target < 0) {
    if (discard_sub) return;
    const int j = js[n];
    if (j < 0 || j >= nsub) return;
    target = sub_ids[j];
  }
  if (target < 0 || target >= num_segments) return;
  float* o = out + target * C;

  if (mode == 0) {
    const float* v = vals + n * C;
    for (int c = 0; c < C; ++c) atomicAdd(o + c, v[c]);
    return;
  }
  const float w0 = w[3 * n], w1 = w[3 * n + 1], w2 = w[3 * n + 2];
  int c0 = 0;
  if (mode == 1 || mode == 2) {
    const float r0 = res[3 * n], r1 = res[3 * n + 1], r2 = res[3 * n + 2];
    const float wj[3] = {w0, w1, w2};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      atomicAdd(o + 4 * j + 0, wj[j] * r0);
      atomicAdd(o + 4 * j + 1, wj[j] * r1);
      atomicAdd(o + 4 * j + 2, wj[j] * r2);
      atomicAdd(o + 4 * j + 3, wj[j]);
    }
    c0 = 12;
  }
  if (mode == 2 || mode == 3) {
    atomicAdd(o + c0 + 0, w0 * w0);
    atomicAdd(o + c0 + 1, w1 * w1);
    atomicAdd(o + c0 + 2, w2 * w2);
    atomicAdd(o + c0 + 3, w0 * w1);
    atomicAdd(o + c0 + 4, w0 * w2);
    atomicAdd(o + c0 + 5, w1 * w2);
  }
}

}  // namespace

extern "C" int csw_windowed_scatter(const void* w, const void* res,
                                    const void* vals, const void* fid,
                                    const void* js, const void* starts,
                                    const void* sub_ids, long long N, int B,
                                    int A, int W, int nsub,
                                    long long num_segments, int mode, int C,
                                    int discard_sub, void* out,
                                    void* stream) {
  if (N <= 0) return 0;
  const int threads = 256;
  const long long blocks = (N + threads - 1) / threads;
  windowed_scatter_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
      (const float*)w, (const float*)res, (const float*)vals,
      (const int*)fid, (const int*)js, (const int*)starts,
      (const int*)sub_ids, N, B, A, W, nsub, num_segments, mode, C,
      discard_sub, (float*)out);
  return (int)cudaGetLastError();
}
