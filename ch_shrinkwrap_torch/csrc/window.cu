// K1: windowed nearest-face search (min / argmin over candidate faces).
//
// Replaces the JAX package's Pallas TPU kernel `_window_kernel`
// (ops/pallas_kernels.py:26, wrapper `window_min_pallas` :118).  For each
// block of B (= 256) Hilbert-ordered points it scans the concatenation
//     [ A windows of W consecutive face centres | nsub subsample faces ]
// (A = 3, W = 2048, nsub = 1024 on the fit's path) and returns, per point,
// min_j (|c_j|^2 - 2 p.c_j) (the squared distance without |p|^2), the
// global face id of the winner, and js = max(j - A*W, 0), the subsample
// slot that K2 routes by.  Window starts arrive already rounded down to
// 128 and clamped (the TPU kernel's DMA alignment, kept because the
// outputs depend on it).  Pad faces carry c2 = 3.4e38.
//
// Bound on the H100: fp32 throughput.  At 1e6 points there are
// 1e6 * 7168 = 7.2e9 candidate evaluations per iteration, each 3 mul +
// 3 add/sub + 1 mul + compare/select.  The products are written with
// the _rn intrinsics so nvcc does not contract them into FMAs: the
// arithmetic is then bit-identical to the plain PyTorch version, and a
// near-tie argmin cannot flip between the two.  Tensor cores are not
// used: K is 3, and TF32 rounding would flip near-tie argmins.
//
// First, simple design: one CUDA block per point block, one thread per
// point; the block stages TILE candidates (x, y, z, c2) in shared memory
// at a time and every thread scans them in concatenation order, replacing
// its best only on a strict '<' so ties go to the first index, as
// torch.argmin and jnp.argmin do.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 512;

__global__ void window_min_kernel(const float* __restrict__ pts,   // (nb,3,B)
                                  const int* __restrict__ starts,  // (nb,A)
                                  const float4* __restrict__ cand, // (Fp_al)
                                  const float4* __restrict__ sub,  // (nsub)
                                  const int* __restrict__ sub_ids, // (nsub)
                                  int B, int A, int W, int nsub,
                                  float* __restrict__ d_out,       // (nb,B)
                                  int* __restrict__ fid_out,       // (nb,B)
                                  int* __restrict__ js_out) {      // (nb,B)
  __shared__ float4 tile[TILE];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const float* pb = pts + (size_t)b * 3 * B;
  const float px = pb[t], py = pb[B + t], pz = pb[2 * B + t];
  const int* st = starts + (size_t)b * A;
  const int n_win = A * W;
  const int n_cand = n_win + nsub;

  float best = INFINITY;
  int bj = 0;
  for (int base = 0; base < n_cand; base += TILE) {
    const int n = min(TILE, n_cand - base);
    for (int i = t; i < n; i += blockDim.x) {
      const int j = base + i;
      if (j < n_win) {
        const int a = j / W;
        tile[i] = cand[st[a] + (j - a * W)];
      } else {
        tile[i] = sub[j - n_win];
      }
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float4 c = tile[i];
      const float dot = __fadd_rn(__fadd_rn(__fmul_rn(px, c.x),
                                            __fmul_rn(py, c.y)),
                                  __fmul_rn(pz, c.z));
      const float d = __fsub_rn(c.w, __fmul_rn(2.0f, dot));
      if (d < best) {
        best = d;
        bj = base + i;
      }
    }
    __syncthreads();
  }

  int fid;
  if (bj < n_win) {
    const int a = bj / W;
    fid = st[a] + (bj - a * W);
  } else {
    fid = sub_ids[bj - n_win];
  }
  const size_t o = (size_t)b * B + t;
  d_out[o] = best;
  fid_out[o] = fid;
  js_out[o] = max(bj - n_win, 0);
}

}  // namespace

extern "C" int csw_window_min(const void* pts, const void* starts,
                              const void* cand4, const void* sub4,
                              const void* sub_ids, int nb, int B, int A,
                              int W, int nsub, void* d_out, void* fid_out,
                              void* js_out, void* stream) {
  if (nb <= 0) return 0;
  window_min_kernel<<<nb, B, 0, (cudaStream_t)stream>>>(
      (const float*)pts, (const int*)starts, (const float4*)cand4,
      (const float4*)sub4, (const int*)sub_ids, B, A, W, nsub,
      (float*)d_out, (int*)fid_out, (int*)js_out);
  return (int)cudaGetLastError();
}
