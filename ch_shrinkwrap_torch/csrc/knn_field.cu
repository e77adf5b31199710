// The seed's density field: for each query, the distance to its k-th
// nearest point among the points within `bound` of it, or 2*bound where
// fewer than k points lie within `bound`.
//
// Replaces no Pallas kernel.  The JAX package and the port's host route
// compute this field on one host core (native/topology.cpp,
// knn_field_native: a cell grid, a chessboard distance transform for
// rejection, and an expanding ring search that keeps a heap of k
// distances).  wrap_start evaluates it once a fit, at every node of its
// marching grid (49^3 = 117,649 queries over the 1e6-point cloud of the
// benchmark's cells), and on the host it took about a second of every
// fit.  The k-th smallest of a set is one value, whatever order the set
// is visited in, so the card returns the host engine's bits.
//
// Bound on the H100: neither bytes nor operations.  The cloud (16 MB as
// float4) sits in the 50 MB L2; a live query reads the few hundred to
// few thousand points of the cells its ball touches.  What costs is the
// number of distances a query evaluates and the passes of its
// selection, so the design keeps both small:
//  * binning: knn_bin_kernel gives each point its cell of a uniform grid
//    whose cell is about bound/4; the port's stable radix ordering
//    (csw_segment_order, ops/cuda_scatter.py radix_order) gives the
//    permutation and each cell's offset; knn_gather_kernel writes the
//    points in cell order as float4, so a column of cells (x, y, z0..z1)
//    is one contiguous run of points;
//  * rejection: one warp a query.  The warp first counts the points in
//    the cube of cells around the query's cell that holds every point
//    within `bound` (`nblock` cells each way, from the offsets alone,
//    one column a lane).  Fewer than k: 2*bound, no search.  The wrapper's
//    plain version counts the same cube, so the two report the same
//    queries as live;
//  * search: at the radii bound/4, bound/2, 3 bound/4 and bound (the last
//    threshold is bound*bound itself), the warp walks the columns of
//    cells whose box lies within the radius (a column a lane computes
//    its z range, then the warp runs over the column's points, a point a
//    lane), counts the points with d2 <= T and keeps their d2 in its
//    shared memory.  The first radius at which k points lie within holds
//    the answer: every point with d2 <= T lies in the cells walked (the
//    radius walked is the threshold's root plus a margin that covers
//    every rounding of the binning), and T <= bound*bound;
//  * selection: bisection on the bit pattern of d2 (non-negative float32
//    values order as their uint32 bits): 31 passes, each a count of the
//    kept values below a trial pattern, summed over the warp with
//    __reduce_add_sync.  The answer is the largest pattern with fewer
//    than k values below it, the k-th smallest exactly.  Where more
//    values lie within than the shared memory holds, the passes count
//    over the cells again instead.  Nothing is summed across warps or
//    blocks, so no step needs an atomic or a library ordering;
//  * arithmetic, as the host engine is compiled (g++ -O3 -march=native
//    contracts dx*dx + dy*dy + dz*dz into two FMAs): dx = q - p in
//    float32, d2 = fma(dz, dz, fma(dx, dx, dy*dy)), written with the
//    _rn intrinsics so that nvcc cannot contract it otherwise; the test
//    d2 <= bound*bound with the product in float32; the result
//    __fsqrt_rn of the k-th value, or 2*bound.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;        // queries a block, a warp each
constexpr int CAP = 2048;       // d2 values a warp keeps in shared memory
constexpr int STEPS = 4;        // search radii bound * j / STEPS
constexpr int BIN_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

struct Grid {
  float lox, loy, loz;  // the points' lowest corner
  float c;              // the cell's edge
  int nx, ny, nz;       // cells along each axis
};

// floor((v - lo) / c) clamped into [a, b] before it becomes an int
__device__ __forceinline__ int axis_cell(float v, float lo, float c, int a,
                                         int b) {
  const float f = floorf(__fdiv_rn(__fsub_rn(v, lo), c));
  return (int)fminf(fmaxf(f, (float)a), (float)b);
}

// the host engine's squared distance, bit for bit
__device__ __forceinline__ float dist2(float qx, float qy, float qz,
                                       float4 p) {
  const float dx = __fsub_rn(qx, p.x);
  const float dy = __fsub_rn(qy, p.y);
  const float dz = __fsub_rn(qz, p.z);
  return __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
}

// distance from v to the interval [b0, b0 + c] of one axis
__device__ __forceinline__ float axis_gap(float v, float b0, float c) {
  return fmaxf(0.0f, fmaxf(b0 - v, v - (b0 + c)));
}

// Calls visit(ok, d2) on every lane, for every point of every cell whose
// box lies within r of q (ok false on the lanes past a column's end).
template <class Visit>
__device__ __forceinline__ void scan_ball(const Grid& g,
                                          const int* __restrict__ offsets,
                                          const float4* __restrict__ pts,
                                          float qx, float qy, float qz,
                                          float r, int lane, Visit&& visit) {
  const int x0 = max(axis_cell(qx - r, g.lox, g.c, -1, g.nx), 0);
  const int x1 = min(axis_cell(qx + r, g.lox, g.c, -1, g.nx), g.nx - 1);
  const int y0 = max(axis_cell(qy - r, g.loy, g.c, -1, g.ny), 0);
  const int y1 = min(axis_cell(qy + r, g.loy, g.c, -1, g.ny), g.ny - 1);
  if (x0 > x1 || y0 > y1) return;
  const float r2 = r * r;
  const int span_y = y1 - y0 + 1;
  const int ncol = (x1 - x0 + 1) * span_y;
  for (int base = 0; base < ncol; base += 32) {
    const int col = base + lane;
    int s = 0, e = 0;
    if (col < ncol) {
      const int x = x0 + col / span_y;
      const int y = y0 + col % span_y;
      const float gx = axis_gap(qx, g.lox + x * g.c, g.c);
      const float gy = axis_gap(qy, g.loy + y * g.c, g.c);
      const float h2 = r2 - (gx * gx + gy * gy);
      if (h2 >= 0.0f) {
        const float h = sqrtf(h2);
        const int z0 = max(axis_cell(qz - h, g.loz, g.c, -1, g.nz), 0);
        const int z1 = min(axis_cell(qz + h, g.loz, g.c, -1, g.nz),
                           g.nz - 1);
        if (z0 <= z1) {
          const int cb = (x * g.ny + y) * g.nz;
          s = offsets[cb + z0];
          e = offsets[cb + z1 + 1];
        }
      }
    }
    unsigned todo = __ballot_sync(FULL, e > s);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const int cs = __shfl_sync(FULL, s, src);
      const int ce = __shfl_sync(FULL, e, src);
      for (int i0 = cs; i0 < ce; i0 += 32) {
        const int i = i0 + lane;
        const bool ok = i < ce;
        const float d2 = ok ? dist2(qx, qy, qz, pts[i]) : 0.0f;
        visit(ok, d2);
      }
    }
  }
}

// the k-th smallest of the n values in buf (uint32 patterns of
// non-negative floats): the largest pattern with fewer than k below it
__device__ unsigned select_kept(const unsigned* buf, int n, int k,
                                int lane) {
  unsigned ans = 0;
  for (int b = 30; b >= 0; --b) {
    const unsigned t = ans | (1u << b);
    unsigned below = 0;
    for (int i = lane; i < n; i += 32) below += buf[i] < t;
    if (__reduce_add_sync(FULL, below) < (unsigned)k) ans = t;
  }
  return ans;
}

__global__ void __launch_bounds__(BIN_THREADS) knn_bin_kernel(
    const float* __restrict__ pts, int N, Grid g, int* __restrict__ cell) {
  const int i = blockIdx.x * BIN_THREADS + threadIdx.x;
  if (i >= N) return;
  const float* p = pts + 3 * (size_t)i;
  const int x = axis_cell(p[0], g.lox, g.c, 0, g.nx - 1);
  const int y = axis_cell(p[1], g.loy, g.c, 0, g.ny - 1);
  const int z = axis_cell(p[2], g.loz, g.c, 0, g.nz - 1);
  cell[i] = (x * g.ny + y) * g.nz + z;
}

__global__ void __launch_bounds__(BIN_THREADS) knn_gather_kernel(
    const float* __restrict__ pts, const int* __restrict__ perm, int N,
    float4* __restrict__ sorted) {
  const int i = blockIdx.x * BIN_THREADS + threadIdx.x;
  if (i >= N) return;
  const float* p = pts + 3 * (size_t)perm[i];
  sorted[i] = make_float4(p[0], p[1], p[2], 0.0f);
}

__global__ void __launch_bounds__(WARPS * 32) knn_field_kernel(
    const float4* __restrict__ pts, const int* __restrict__ offsets,
    Grid g, int nblock, float margin, const float* __restrict__ queries,
    int Q, int k, float bound, float* __restrict__ out,
    unsigned char* __restrict__ live) {
  __shared__ unsigned kept[WARPS][CAP];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int q = blockIdx.x * WARPS + w;
  if (q >= Q) return;  // the whole warp
  unsigned* buf = kept[w];
  const float qx = queries[3 * (size_t)q];
  const float qy = queries[3 * (size_t)q + 1];
  const float qz = queries[3 * (size_t)q + 2];
  const float miss = __fmul_rn(2.0f, bound);

  // rejection: the points of the cube of cells that holds the ball
  const int cx = axis_cell(qx, g.lox, g.c, -(nblock + 1), g.nx + nblock);
  const int cy = axis_cell(qy, g.loy, g.c, -(nblock + 1), g.ny + nblock);
  const int cz = axis_cell(qz, g.loz, g.c, -(nblock + 1), g.nz + nblock);
  const int x0 = max(cx - nblock, 0), x1 = min(cx + nblock, g.nx - 1);
  const int y0 = max(cy - nblock, 0), y1 = min(cy + nblock, g.ny - 1);
  const int z0 = max(cz - nblock, 0), z1 = min(cz + nblock, g.nz - 1);
  unsigned in_cube = 0;
  if (x0 <= x1 && y0 <= y1 && z0 <= z1) {
    const int span_y = y1 - y0 + 1;
    const int ncol = (x1 - x0 + 1) * span_y;
    for (int col = lane; col < ncol; col += 32) {
      const int cb = ((x0 + col / span_y) * g.ny + y0 + col % span_y)
                     * g.nz;
      in_cube += offsets[cb + z1 + 1] - offsets[cb + z0];
    }
  }
  const bool reach = __reduce_add_sync(FULL, in_cube) >= (unsigned)k;
  if (live != nullptr && lane == 0) live[q] = reach;
  float result = miss;
  if (reach) {
    for (int j = 1; j <= STEPS; ++j) {
      float T;
      if (j < STEPS) {
        const float rj = __fdiv_rn(__fmul_rn(bound, (float)j),
                                   (float)STEPS);
        T = __fmul_rn(rj, rj);
      } else {
        T = __fmul_rn(bound, bound);
      }
      const float r = sqrtf(T) * (1.0f + 1.0f / 65536.0f) + margin;
      int n = 0;  // points with d2 <= T, the same on every lane
      scan_ball(g, offsets, pts, qx, qy, qz, r, lane,
                [&](bool ok, float d2) {
                  const bool in = ok && d2 <= T;
                  const unsigned m = __ballot_sync(FULL, in);
                  const int pos = n + __popc(m & ((1u << lane) - 1u));
                  if (in && pos < CAP) buf[pos] = __float_as_uint(d2);
                  n += __popc(m);
                });
      if (n < k) continue;
      __syncwarp();
      unsigned ans = 0;
      if (n <= CAP) {
        ans = select_kept(buf, n, k, lane);
      } else {
        for (int b = 30; b >= 0; --b) {
          const unsigned t = ans | (1u << b);
          unsigned below = 0;
          scan_ball(g, offsets, pts, qx, qy, qz, r, lane,
                    [&](bool ok, float d2) {
                      below += ok && d2 <= T && __float_as_uint(d2) < t;
                    });
          if (__reduce_add_sync(FULL, below) < (unsigned)k) ans = t;
        }
      }
      result = __fsqrt_rn(__uint_as_float(ans));
      break;
    }
  }
  if (lane == 0) out[q] = result;
}

Grid make_grid(float lox, float loy, float loz, float c, int nx, int ny,
               int nz) {
  Grid g;
  g.lox = lox;
  g.loy = loy;
  g.loz = loz;
  g.c = c;
  g.nx = nx;
  g.ny = ny;
  g.nz = nz;
  return g;
}

}  // namespace

extern "C" int csw_knn_bin(const void* pts, int N, float lox, float loy,
                           float loz, float c, int nx, int ny, int nz,
                           void* cell, void* stream) {
  if (N <= 0) return 0;
  if (nx < 1 || ny < 1 || nz < 1 || !(c > 0.0f))
    return (int)cudaErrorInvalidValue;
  knn_bin_kernel<<<(N + BIN_THREADS - 1) / BIN_THREADS, BIN_THREADS, 0,
                   (cudaStream_t)stream>>>(
      (const float*)pts, N, make_grid(lox, loy, loz, c, nx, ny, nz),
      (int*)cell);
  return (int)cudaGetLastError();
}

extern "C" int csw_knn_gather(const void* pts, const void* perm, int N,
                              void* sorted, void* stream) {
  if (N <= 0) return 0;
  knn_gather_kernel<<<(N + BIN_THREADS - 1) / BIN_THREADS, BIN_THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const float*)pts, (const int*)perm, N, (float4*)sorted);
  return (int)cudaGetLastError();
}

extern "C" int csw_knn_field(const void* sorted, const void* offsets,
                             float lox, float loy, float loz, float c,
                             int nx, int ny, int nz, int nblock,
                             float margin, const void* queries, int Q, int k,
                             float bound, void* out, void* live,
                             void* stream) {
  if (Q <= 0) return 0;
  if (nx < 1 || ny < 1 || nz < 1 || !(c > 0.0f) || nblock < 0 || k < 1)
    return (int)cudaErrorInvalidValue;
  knn_field_kernel<<<(Q + WARPS - 1) / WARPS, WARPS * 32, 0,
                     (cudaStream_t)stream>>>(
      (const float4*)sorted, (const int*)offsets,
      make_grid(lox, loy, loz, c, nx, ny, nz), nblock, margin,
      (const float*)queries, Q, k, bound, (float*)out,
      (unsigned char*)live);
  return (int)cudaGetLastError();
}
