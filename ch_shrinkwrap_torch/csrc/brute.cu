// Brute-force nearest face: min / argmin of |p - c|^2 over every face
// centre, for each point.
//
// Replaces no Pallas kernel: the JAX package's brute force
// (ops/correspondence.py nearest_face_bruteforce) is a jitted lax.scan over
// face chunks, which XLA fuses.  The port's plain PyTorch version
// (ops/cuda_brute.py brute_min_plain) emulates each float32 FMA in float64
// through about a dozen elementwise launches, some 19,400 kernels a search
// at the evaluation sweep's shape (~2e4 points, ~7e4 faces).  This kernel
// is the sweep's path: every caller of the brute force on a CUDA tensor
// (cg_block with corr_method 'brute' or 'auto' on small clouds, the
// diagnostics, the sharded fit's rank-local points) takes it.
//
// Arithmetic.  The reference is XLA's, which the plain version repeats:
//     p2 = fma(z, z, fma(y, y, x * x)), c2 likewise (BIG = 3.4e38 on a
//     masked face), dot = fma(z, Z, fma(y, Y, x * X)),
//     d2 = (p2 + c2) - 2 * dot.
// The face table is stored pre-scaled as (-2X, -2Y, -2Z, c2); scaling by
// -2 commutes exactly with rounding, so
//     d2 = (p2 + c2) + fma(z, -2Z, fma(y, -2Y, x * -2X))
// is bit-equal to the reference in five fp32 instructions (FMUL, 2 FFMA,
// 2 FADD).  Note the order: p2 + c2 is rounded first, unlike K1's
// c2 + dot with p2 added afterwards.  They are written as _rn intrinsics,
// so nvcc neither contracts nor reorders them.  Tensor cores are not used:
// K is 3, and TF32 rounding would flip near-tie argmins.
//
// The result is the lexicographic minimum of (d2, face id) over every face
// and the plain version's sentinel (BIG, 0): a strictly smaller d2, or an
// equal one with a lower id, replaces the best.  That is the plain
// version's torch.min (first index on ties within a chunk) and strict '<'
// across chunks, whatever order the pieces of the search finish in.  Then
// dist = sqrt(max(d2, 0)) and idx = the face id.  There are no NaNs on this
// path; fminf would drop one where torch.min keeps it.
//
// Bound on the H100: instruction issue.  One search of the sweep covers
// 19.7k points x 70,656 faces = 1.39e9 pairs at 8 fp32 operations each
// (an FFMA counted as two, and the FMNMX), 0.17 ms at 67 TFLOP/s.  Within
// a block the schedule is K1's (csrc/window.cu): a thread owns R = 4
// points in registers, G = 4 groups of 64 threads split each staged tile,
// face tiles are copied to shared memory with cp.async and double-
// buffered, and the argmin is lazy per chunk of K = 8 candidates.  Few
// points and many faces: a grid over point tiles alone would fill about 20
// of the 132 SMs, so the grid is point tiles x S face splits, with S
// chosen by the wrapper from N, Fp and the SM count.  Each block writes
// its points' bests, packed as (order-preserving bits of d2) << 32 | id,
// to its split's row of an (S, N) workspace, and a second pass takes each
// point's minimum over the S rows from the packed sentinel: no atomic,
// and the same result whatever order the blocks ran in.  Three launches
// a search: the table, the search, the merge.  On an H100 (80GB HBM3,
// 700 W) a search of the sweep's shape takes 0.38-0.41 ms, 78 registers
// and no spills; the split count barely moves it (0.41-0.45 ms from 6 to
// 69 splits).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int PB = 256;          // points per CUDA block
constexpr int NT = PB;           // threads per block
constexpr int R = 4;             // points per thread
constexpr int LANES = PB / R;    // threads sharing one candidate
constexpr int G = NT / LANES;    // thread groups, each 1/G of a tile
constexpr int K = 8;             // candidates per chunk of the argmin
constexpr int UNROLL = 2;        // chunks an iteration of the scan
constexpr int MINB = 3;          // blocks an SM the registers allow
constexpr int TILE = 1024;       // candidates staged at a time
constexpr int TG = TILE / G;     // a group's span of a tile
constexpr int EW = 256;          // threads a block of the prep and merge
constexpr float BIG = 3.4e38f;   // the plain version's sentinel and mask
static_assert(LANES % 32 == 0, "a group is whole warps");
static_assert(TG % K == 0, "a group's span is whole chunks");

// (d2, id) as one unsigned 64-bit key whose order is the lexicographic
// order: the float's bits mapped so that unsigned order is float order
__device__ __forceinline__ unsigned long long pack(float d, int j) {
  unsigned u = __float_as_uint(d);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)j;
}

__device__ __forceinline__ float unpack_d(unsigned long long v) {
  unsigned u = (unsigned)(v >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ float sumsq(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

// (p2 + c2) - 2 p.c from the pre-scaled row c = (-2X, -2Y, -2Z, c2), in
// XLA's order
__device__ __forceinline__ float dist2(float x, float y, float z, float p2,
                                      const float4 c) {
  return __fadd_rn(__fadd_rn(p2, c.w),
                   __fmaf_rn(z, c.z, __fmaf_rn(y, c.y, __fmul_rn(x, c.x))));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The face table (-2X, -2Y, -2Z, c2).
__global__ void brute_prep_kernel(const float* __restrict__ centers,
                                  const unsigned char* __restrict__ f_mask,
                                  int Fp, float4* __restrict__ table) {
  const int i = blockIdx.x * EW + threadIdx.x;
  if (i >= Fp) return;
  const float x = centers[3 * i];
  const float y = centers[3 * i + 1];
  const float z = centers[3 * i + 2];
  const float c2 = f_mask[i] ? sumsq(x, y, z) : BIG;
  table[i] = make_float4(__fmul_rn(x, -2.f), __fmul_rn(y, -2.f),
                         __fmul_rn(z, -2.f), c2);
}

// Stage faces [base, base + TILE) of the split into buf; slots past its end
// get (0, 0, 0, +inf), which never wins a strict '<'.
__device__ __forceinline__ void stage(float4* buf, int base,
                                      const float4* __restrict__ table,
                                      int n_cand) {
  for (int i = threadIdx.x; i < TILE; i += NT) {
    const int j = base + i;
    if (j < n_cand) {
      cp_async16(buf + i, table + j);
    } else {
      buf[i] = make_float4(0.f, 0.f, 0.f, INFINITY);
    }
  }
  cp_async_commit();
}

// Block (x, y): points [x * PB, x * PB + PB) against the y-th split of the
// faces, [y * span, min(y * span + span, Fp)); the bests go to row y of
// the workspace.
__global__ void __launch_bounds__(NT, MINB)
brute_min_kernel(const float* __restrict__ pts,        // (N,3)
                 const float4* __restrict__ table,     // (Fp) scaled
                 int N, int Fp, int span,
                 unsigned long long* __restrict__ part) {  // (S,N)
  __shared__ float4 tile[2][TILE];
  const int p0 = blockIdx.x * PB;
  const int f0 = blockIdx.y * span;
  const int n_cand = min(span, Fp - f0);
  const float4* tab = table + f0;
  const int lane = threadIdx.x % LANES;
  const int g = threadIdx.x / LANES;

  // point r of this thread is point p0 + r * LANES + lane
  float px[R], py[R], pz[R], p2[R], best[R];
  int bj[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = p0 + r * LANES + lane;
    const bool in = p < N;
    px[r] = in ? pts[3 * p] : 0.f;
    py[r] = in ? pts[3 * p + 1] : 0.f;
    pz[r] = in ? pts[3 * p + 2] : 0.f;
    p2[r] = sumsq(px[r], py[r], pz[r]);
    best[r] = BIG;
    bj[r] = 0;
  }

  const int n_tiles = (n_cand + TILE - 1) / TILE;
  stage(tile[0], 0, tab, n_cand);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      stage(tile[(t + 1) & 1], (t + 1) * TILE, tab, n_cand);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float4* buf = tile[t & 1] + g * TG;
    const int base = t * TILE + g * TG;
    // this group's real candidates in the tile; a ragged last chunk reads
    // the (0, 0, 0, +inf) slots behind them
    const int n = min(TG, n_cand - base);
#pragma unroll UNROLL
    for (int k0 = 0; k0 < n; k0 += K) {
      float d[K][R];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float4 c = buf[k0 + k];
#pragma unroll
        for (int r = 0; r < R; ++r)
          d[k][r] = dist2(px[r], py[r], pz[r], p2[r], c);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float m = d[0][r];
#pragma unroll
        for (int k = 1; k < K; ++k) m = fminf(m, d[k][r]);
        if (m < best[r]) {
          // first k of the chunk that holds the minimum
          int kk = K - 1;
#pragma unroll
          for (int k = K - 2; k >= 0; --k) {
            if (d[k][r] == m) kk = k;
          }
          best[r] = m;
          bj[r] = f0 + base + k0 + kk;
        }
      }
    }
    __syncthreads();
  }

  // merge the groups' bests, lexicographic on (d, id), through the tile
  float* md = reinterpret_cast<float*>(&tile[0][0]);  // (G, PB)
  int* mj = reinterpret_cast<int*>(md + G * PB);       // (G, PB)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    md[g * PB + r * LANES + lane] = best[r];
    mj[g * PB + r * LANES + lane] = bj[r];
  }
  __syncthreads();
  const int q = threadIdx.x;
  float bd = md[q];
  int bjj = mj[q];
#pragma unroll
  for (int h = 1; h < G; ++h) {
    const float dv = md[h * PB + q];
    const int jv = mj[h * PB + q];
    if (dv < bd || (dv == bd && jv < bjj)) {
      bd = dv;
      bjj = jv;
    }
  }
  const int p = p0 + q;
  if (p < N) part[(size_t)blockIdx.y * N + p] = pack(bd, bjj);
}

// Each point's minimum over the S splits' bests, from the sentinel.
__global__ void brute_merge_kernel(const unsigned long long* __restrict__ part,
                                   int N, int S, float* __restrict__ dist,
                                   int* __restrict__ idx) {
  const int i = blockIdx.x * EW + threadIdx.x;
  if (i >= N) return;
  unsigned long long v = pack(BIG, 0);
  for (int s = 0; s < S; ++s) {
    const unsigned long long w = part[(size_t)s * N + i];
    if (w < v) v = w;
  }
  dist[i] = __fsqrt_rn(fmaxf(unpack_d(v), 0.f));
  idx[i] = (int)(unsigned)(v & 0xffffffffull);
}

}  // namespace

// The schedule: points a block, faces staged at a time, a thread group's
// span of a tile, candidates a chunk, blocks an SM.
extern "C" void csw_brute_schedule(int* points, int* tile, int* group_span,
                                   int* chunk, int* per_sm) {
  *points = PB;
  *tile = TILE;
  *group_span = TG;
  *chunk = K;
  *per_sm = MINB;
}

// The faces of one split for `splits` asked: Fp / splits rounded up to
// whole tiles.
static int split_span(int Fp, int splits) {
  if (splits < 1) splits = 1;
  const int per = (Fp + splits - 1) / splits;
  return (per + TILE - 1) / TILE * TILE;
}

// The splits the grid takes for `splits` asked, the rows of the workspace.
extern "C" int csw_brute_splits(int Fp, int splits) {
  if (Fp <= 0) return 0;
  const int span = split_span(Fp, splits);
  return (Fp + span - 1) / span;
}

// part: the (csw_brute_splits(Fp, splits), N) workspace.
extern "C" int csw_brute_min(const void* pts, const void* centers,
                             const void* f_mask, int N, int Fp, int splits,
                             void* table, void* part, void* dist, void* idx,
                             void* stream) {
  if (N <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int S = csw_brute_splits(Fp, splits);
  if (S > 0) {
    brute_prep_kernel<<<(Fp + EW - 1) / EW, EW, 0, s>>>(
        (const float*)centers, (const unsigned char*)f_mask, Fp,
        (float4*)table);
    const dim3 grid((N + PB - 1) / PB, S);
    brute_min_kernel<<<grid, NT, 0, s>>>(
        (const float*)pts, (const float4*)table, N, Fp,
        split_span(Fp, splits), (unsigned long long*)part);
  }
  brute_merge_kernel<<<(N + EW - 1) / EW, EW, 0, s>>>(
      (const unsigned long long*)part, N, S, (float*)dist, (int*)idx);
  return (int)cudaGetLastError();
}
