// K3: row gather out[r, c] = src[idx[r], c].
//
// Replaces the JAX package's Pallas TPU kernel `_gather_kernel`
// (ops/pallas_gather.py:111, wrappers `_ring_gather_impl` :504 and
// `ring_gather` :598), the sliding-ring gather of an f32 table of <= 16
// columns.  The TPU kernel kept a band of the table resident in VMEM and
// needed host-built DMA schedules and patch regions; on Hopper the table
// (a few MB at the fit's 231k padded vertices) sits in the 50 MB L2, so
// this kernel reads the index stream directly with no schedule.  The
// fit's callers: the face-corner gather f[faces], the one-ring
// neighbour gather of the curvature prior, the faces->vertices fold's
// incidence gather, and the search-direction gather S[faces].
//
// Bound on the H100: bytes.  It reads R indices (4 B each) and R*C
// source values and writes R*C values.  Pure data movement: the output
// equals the plain version exactly.
//
// First, simple design: one thread per output element (r, c), so
// neighbouring threads read neighbouring columns of one source row and
// write contiguous output.  An index outside [0, V) writes 0.

#include <cuda_runtime.h>

namespace {

__global__ void row_gather_kernel(const float* __restrict__ src,
                                  long long V, int C,
                                  const int* __restrict__ idx,
                                  long long total,
                                  float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long r = e / C;
  const int c = (int)(e - r * C);
  const long long i = idx[r];
  out[e] = (i >= 0 && i < V) ? src[i * C + c] : 0.0f;
}

}  // namespace

extern "C" int csw_row_gather(const void* src, long long V, int C,
                              const void* idx, long long R, void* out,
                              void* stream) {
  const long long total = R * (long long)C;
  if (total <= 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  row_gather_kernel<<<(unsigned)blocks, threads, 0,
                      (cudaStream_t)stream>>>(
      (const float*)src, V, C, (const int*)idx, total, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* csw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
