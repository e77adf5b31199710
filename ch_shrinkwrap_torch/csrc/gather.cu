// K3: row gather out[r, c] = src[idx[r], c], and the fused fold
// out[v, c] = sum_k care[v, k] * src[idx[v K + k], c].
//
// Replaces the JAX package's Pallas TPU kernel `_gather_kernel`
// (ops/pallas_gather.py:111, wrappers `_ring_gather_impl` :504 and
// `ring_gather` :598), the sliding-ring gather of an f32 table of <= 16
// columns, and, for the faces -> vertices fold, that gather together
// with the masked sum XLA ran after it (solver/shrinkwrap.py:500-510).
// The TPU kernel kept a band of the table resident in VMEM and needed
// host-built DMA schedules and patch regions; on Hopper the table (at
// most 35.8 MB at the fit's capacity) sits in the 50 MB L2, so these
// kernels read the index stream directly with no schedule.  The fit's
// callers: the face-corner gather f[faces] (C = 3), the one-ring
// neighbour gather of the curvature prior (C = 6), the search-direction
// gather S[faces] (C = 9), and the fold of the (3 Fp, 7) corner rows
// onto vertices through the incidence table (K = 8, C = 7).
//
// Bound on the H100: bytes.  The gather reads R indices and R*C source
// values and writes R*C values; the fold reads V*K indices and care
// bytes and the source rows once, and writes V*C values.  Design:
//  * a block handles a tile of 256 rows (or vertices).  It first loads
//    the tile's indices into shared memory, each index once, coalesced;
//  * its threads then walk the tile's elements (row, column) in order, so
//    neighbouring threads read neighbouring columns of one source row;
//    C is a template parameter, so the element -> (row, column) split is
//    a multiply and shift, with no 64-bit division;
//  * the tile is staged in shared memory and written out with coalesced
//    16-byte stores (a tile starts at a multiple of 256 rows, so its
//    output is 16-byte aligned whatever C is).
// The fold sums a vertex's K rows in registers in the order k = 0..K-1
// and writes each vertex row once, instead of writing and re-reading the
// (V, K, C) gathered intermediate.  An index outside [0, V) reads as a
// zero row.  The gather is pure data movement and equals the plain
// version exactly.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;   // rows (vertices) per block, = threads
constexpr int MAX_K = 16;   // rows a fold sums per vertex

// write the tile's ne floats to out with 16-byte stores
__device__ __forceinline__ void store_tile(const float* tile, int ne,
                                           float* out) {
  const int n4 = ne / 4;
  float4* o4 = reinterpret_cast<float4*>(out);
  const float4* t4 = reinterpret_cast<const float4*>(tile);
  for (int q = threadIdx.x; q < n4; q += TILE) o4[q] = t4[q];
  for (int e = 4 * n4 + threadIdx.x; e < ne; e += TILE) out[e] = tile[e];
}

template <int C>
__global__ void __launch_bounds__(TILE) row_gather_kernel(
    const float* __restrict__ src, int V, const int* __restrict__ idx,
    int R, float* __restrict__ out) {
  __shared__ int sidx[TILE];
  __shared__ __align__(16) float tile[TILE * C];
  const int r0 = blockIdx.x * TILE;
  const int nr = min(TILE, R - r0);
  const int t = threadIdx.x;
  if (t < nr) {
    const int i = idx[r0 + t];
    sidx[t] = (i >= 0 && i < V) ? i : -1;
  }
  __syncthreads();
  const int ne = nr * C;
  for (int e = t; e < ne; e += TILE) {
    const int r = e / C;
    const int i = sidx[r];
    tile[e] = i >= 0 ? src[(size_t)i * C + (e - r * C)] : 0.0f;
  }
  __syncthreads();
  store_tile(tile, ne, out + (size_t)r0 * C);
}

template <int C>
__global__ void __launch_bounds__(TILE) row_group_sum_kernel(
    const float* __restrict__ src, int V, const int* __restrict__ idx,
    const unsigned char* __restrict__ care, int K, int R,
    float* __restrict__ out) {
  __shared__ int sidx[TILE * MAX_K];
  __shared__ __align__(16) float tile[TILE * C];
  const int v0 = blockIdx.x * TILE;
  const int nv = min(TILE, R - v0);
  const int t = threadIdx.x;
  const size_t base = (size_t)v0 * K;
  for (int e = t; e < nv * K; e += TILE) {
    const int i = idx[base + e];
    sidx[e] = (care[base + e] && i >= 0 && i < V) ? i : -1;
  }
  __syncthreads();
  const int ne = nv * C;
  for (int e = t; e < ne; e += TILE) {
    const int v = e / C;
    const int c = e - v * C;
    const int* iv = sidx + v * K;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) {
      const int i = iv[k];
      if (i >= 0) acc += src[(size_t)i * C + c];
    }
    tile[e] = acc;
  }
  __syncthreads();
  store_tile(tile, ne, out + (size_t)v0 * C);
}

template <int C>
void launch_gather(const void* src, int V, const void* idx, int R,
                   void* out, cudaStream_t s) {
  row_gather_kernel<C><<<(R + TILE - 1) / TILE, TILE, 0, s>>>(
      (const float*)src, V, (const int*)idx, R, (float*)out);
}

template <int C>
void launch_group_sum(const void* src, int V, const void* idx,
                      const void* care, int K, int R, void* out,
                      cudaStream_t s) {
  row_group_sum_kernel<C><<<(R + TILE - 1) / TILE, TILE, 0, s>>>(
      (const float*)src, V, (const int*)idx, (const unsigned char*)care, K,
      R, (float*)out);
}

// dispatch a runtime column count 1..16 to the template instance
#define CSW_FOR_EACH_C(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) \
  X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

}  // namespace

extern "C" int csw_row_gather(const void* src, int V, int C,
                              const void* idx, int R, void* out,
                              void* stream) {
  if (R <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
#define CSW_CASE(c) \
    case c: launch_gather<c>(src, V, idx, R, out, s); break;
    CSW_FOR_EACH_C(CSW_CASE)
#undef CSW_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int csw_row_group_sum(const void* src, int V, int C,
                                 const void* idx, const void* care, int K,
                                 int R, void* out, void* stream) {
  if (R <= 0) return 0;
  if (K < 1 || K > MAX_K) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
#define CSW_CASE(c) \
    case c: launch_group_sum<c>(src, V, idx, care, K, R, out, s); break;
    CSW_FOR_EACH_C(CSW_CASE)
#undef CSW_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* csw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
