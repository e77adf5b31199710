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
// outputs depend on it).  The argmin takes the first minimum in
// concatenation order, as torch.argmin and jnp.argmin do.
//
// Arithmetic.  The reference is XLA's: it forms the K = 3 dot product as
// the FMA chain fma(z, Z, fma(y, Y, x * X)) and then c2 - 2 * dot.  The
// face table arrives pre-scaled as (-2x, -2y, -2z, c2); scaling by -2
// commutes exactly with rounding, so
//     d = c2 + fma(z, -2Z, fma(y, -2Y, x * -2X))
// is bit-equal to the reference in four fp32 instructions (FMUL, FFMA,
// FFMA, FADD).  They are written as _rn intrinsics, so nvcc neither
// contracts nor reorders them, and the plain PyTorch version, which
// emulates each FMA with one rounding (utils/math.py fma_f32), agrees bit
// for bit.  Tensor cores are not used: K is 3, and TF32 rounding would
// flip near-tie argmins.
//
// Bound on the H100: instruction issue.  At 1e6 points there are
// 1e6 * 7168 = 7.2e9 point-candidate pairs a launch.  The design brings a
// pair to about 5.8 issued instructions (the four above, one FMNMX, and
// the amortised load, compare and branch):
//  * register blocking: a thread owns R = 4 points, so one broadcast
//    float4 shared-memory load serves four points;
//  * candidate split: the block's 256 threads form G = 4 groups of 64
//    (two warps); each group owns all 256 points and a contiguous quarter
//    of every staged tile.  At the end the groups' bests are merged
//    lexicographically on (d, j), which keeps the first-index rule
//    whatever order the groups saw the candidates in;
//  * lazy argmin: per chunk of K = 8 candidates the R x K distances stay
//    in registers and each point takes fminf over its chunk; only when
//    the chunk's minimum is strictly below the running best does the
//    thread rescan the chunk (in registers) for the first k with d == m.
//    Strict '<' across chunks and the first equal value within one give
//    the first index.  There are no NaNs on this path (pad faces carry
//    c2 = 3.4e38 and zero coordinates; staging slots past the end carry
//    c2 = +inf); fminf would drop a NaN where torch.argmin picks it;
//  * staging: TILE candidates (16 KB) at a time are copied into shared
//    memory with cp.async, double-buffered, so the next tile's copy runs
//    under the current tile's arithmetic.  32 KB of shared memory and at
//    most 85 registers a thread (79 used, no spills) let three blocks
//    share an SM; the chunk loop is unrolled twice.
// The schedule's constants were chosen among variants timed on an H100:
// R = 2 or 8, K = 4 or 16, and a chunk loop not unrolled or unrolled
// four times were all slower.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// The schedule (csw_window_schedule hands TILE, TG and K to the tests
// that place ties on its seams).
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
static_assert(LANES % 32 == 0, "a group is whole warps");
static_assert(TG % K == 0, "a group's span is whole chunks");

// |c|^2 - 2 p.c from the pre-scaled row c = (-2x, -2y, -2z, |c|^2), in
// XLA's FMA order
__device__ __forceinline__ float dist(float x, float y, float z,
                                     const float4 c) {
  return __fadd_rn(c.w, __fmaf_rn(z, c.z, __fmaf_rn(y, c.y,
                                                    __fmul_rn(x, c.x))));
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

// Stage candidates [base, base + TILE) of the concatenation into buf;
// slots past the end get (0, 0, 0, +inf), which never wins a strict '<'.
__device__ __forceinline__ void stage(float4* buf, int base,
                                      const int* __restrict__ st,
                                      const float4* __restrict__ cand,
                                      const float4* __restrict__ sub, int W,
                                      int n_win, int n_cand) {
  for (int i = threadIdx.x; i < TILE; i += NT) {
    const int j = base + i;
    if (j < n_win) {
      const int a = j / W;
      cp_async16(buf + i, cand + __ldg(st + a) + (j - a * W));
    } else if (j < n_cand) {
      cp_async16(buf + i, sub + (j - n_win));
    } else {
      buf[i] = make_float4(0.f, 0.f, 0.f, INFINITY);
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(NT, MINB)
window_min_kernel(const float* __restrict__ pts,     // (nb,3,B)
                  const int* __restrict__ starts,    // (nb,A)
                  const float4* __restrict__ cand,   // (Fp_al) scaled
                  const float4* __restrict__ sub,    // (nsub) scaled
                  const int* __restrict__ sub_ids,   // (nsub)
                  int B, int A, int W, int nsub,
                  float* __restrict__ d_out,         // (nb,B)
                  int* __restrict__ fid_out,         // (nb,B)
                  int* __restrict__ js_out) {        // (nb,B)
  __shared__ float4 tile[2][TILE];
  const int b = blockIdx.x;
  const int p0 = blockIdx.y * PB;  // this CUDA block's first point of b
  const int lane = threadIdx.x % LANES;
  const int g = threadIdx.x / LANES;
  const float* pb = pts + (size_t)b * 3 * B;
  const int* st = starts + (size_t)b * A;
  const int n_win = A * W;
  const int n_cand = n_win + nsub;

  // point r of this thread is point p0 + r * LANES + lane of the block
  float px[R], py[R], pz[R], best[R];
  int bj[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = p0 + r * LANES + lane;
    const bool in = p < B;
    px[r] = in ? pb[p] : 0.f;
    py[r] = in ? pb[B + p] : 0.f;
    pz[r] = in ? pb[2 * B + p] : 0.f;
    best[r] = INFINITY;
    bj[r] = 0;
  }

  const int n_tiles = (n_cand + TILE - 1) / TILE;
  stage(tile[0], 0, st, cand, sub, W, n_win, n_cand);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      stage(tile[(t + 1) & 1], (t + 1) * TILE, st, cand, sub, W, n_win,
            n_cand);
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
        for (int r = 0; r < R; ++r) d[k][r] = dist(px[r], py[r], pz[r], c);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float m = d[0][r];
#pragma unroll
        for (int k = 1; k < K; ++k) m = fminf(m, d[k][r]);
        if (m < best[r]) {
          // first k of the chunk that holds the minimum
          int kk = K - 1;
          float v = d[K - 1][r];
#pragma unroll
          for (int k = K - 2; k >= 0; --k) {
            if (d[k][r] == m) {
              kk = k;
              v = d[k][r];
            }
          }
          best[r] = v;
          bj[r] = base + k0 + kk;
        }
      }
    }
    __syncthreads();
  }

  // merge the groups' bests, lexicographic on (d, j), through the tile
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
  if (p >= B) return;
  int fid;
  if (bjj < n_win) {
    const int a = bjj / W;
    fid = st[a] + (bjj - a * W);
  } else {
    fid = sub_ids[bjj - n_win];
  }
  const size_t o = (size_t)b * B + p;
  d_out[o] = bd;
  fid_out[o] = fid;
  js_out[o] = max(bjj - n_win, 0);
}

}  // namespace

// The schedule's seams: candidates staged a tile at a time, a thread
// group's span of a tile, candidates a chunk.
extern "C" void csw_window_schedule(int* tile, int* group_span,
                                    int* chunk) {
  *tile = TILE;
  *group_span = TG;
  *chunk = K;
}

extern "C" int csw_window_min(const void* pts, const void* starts,
                              const void* cand4, const void* sub4,
                              const void* sub_ids, int nb, int B, int A,
                              int W, int nsub, void* d_out, void* fid_out,
                              void* js_out, void* stream) {
  if (nb <= 0 || B <= 0) return 0;
  const dim3 grid(nb, (B + PB - 1) / PB);
  window_min_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)pts, (const int*)starts, (const float4*)cand4,
      (const float4*)sub4, (const int*)sub_ids, B, A, W, nsub,
      (float*)d_out, (int*)fid_out, (int*)js_out);
  return (int)cudaGetLastError();
}
