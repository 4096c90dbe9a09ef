// Fused Woodbury epilogue of the PC-space likelihood for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package evaluates each PCA emulator's
// capacitance block with a Cholesky-Crout recurrence unrolled in jnp
// (gpbayestools_hic_tpu/ops/linalg.py:spd_qform_logdet, called from
// samplers/chain.py's block_ll), which XLA fuses into elementwise work.  The
// port evaluated it per emulator with the library (batched cholesky_ex,
// solve_triangular, where) and differentiated it with autograd: about 76
// launches an emulator a posterior call, forward and backward.  Here one
// launch evaluates every low-rank block of a call, and one elementwise
// launch is its backward (woodbury_bwd_kernel, the closed form below).
//
// For each block b (k_b principal components) and walker w:
//   v  = max(kdiag - qf, 0)   (the fused predict's variance epilogue), or v given
//   d  = gp_mean - p0
//   B  = M^-1 + diag(v)        (k x k, symmetric positive definite)
//   L  = chol(B),  z = L^-1 d,  alpha = B^-1 d = L^-T z
//   lp = -1/2 (z.z + const2) - 1/2 (logdet_c0_m + 2 sum_j log L_jj)
// and lp = -inf where a pivot is not positive and finite or lp is not finite.
// With a gradient the forward also saves alpha and diag(B^-1) (the squared
// column norms of L^-1), and the backward is, for the cotangent g of lp,
//   d/d gp_mean = -g alpha,   d/d v_i = g/2 (alpha_i^2 - (B^-1)_ii),
//   d/d qf_i = -d/d v_i where kdiag_i - qf_i >= 0, else 0,
// zero (never NaN) for a walker-block whose lp was -inf or whose g is not
// finite.
//
// Bound on the H100: at the PCSK cell's ranks (k = 24, 23, 11, 88, 13, 19,
// 24, 48, 88) a walker's nine factors with the diagonal of the inverse are
// ~1 MFLOP, 4 GFLOP a call at 4096 walkers: ~60 us at FP32's 67 TFLOP/s;
// the bytes (gp_mean, v, alpha, diag(B^-1)) ~22 MB, ~7 us.  The work is a
// chain of small dependent steps per matrix, so what holds it back is the
// latency of each step and the instruction rate, not the FP32 rate.  The
// design keeps each matrix where its steps are cheapest, and covers every
// block of a call in one grid so that the card is filled by all of them:
//
// - k <= 8 (the flagship's four PCs: 9 x 4096 matrices a call, one wave):
//   a thread per matrix, B, L and L^-1 in registers, no communication;
// - 9 <= k <= 32: a warp per matrix, lane r holding row r in registers (the
//   pattern of fused_mvn.cu's mvn_warp_kernel): the factor by right-looking
//   elimination of [[B, d], [d^T, 0]] (the last row ends as z and its corner
//   as -z.z), a shuffle per entry, no barrier; L^-1 with lane c holding
//   column c;
// - 33 <= k <= 128: a CTA per matrix, the augmented matrix in dynamic
//   shared memory (odd row stride: rows and columns are read without bank
//   conflicts), right-looking in panels of 8 columns with two CTA barriers
//   a panel: every thread factors the panel's 8 x 8 diagonal block in
//   registers, a thread a row substitutes the rows below it, and the
//   trailing update is rank 8 (one load of A[i][l] and its store for 8
//   FMAs); the columns of L^-1 then by forward substitution, four columns
//   side by side a warp (one load of L for four FMAs), rows over the lanes,
//   with no barrier (L is read-only by then).
//
// CTAs own segments of (block, walker tile), blocks of largest k first, so
// the long CTA-route matrices start first; within a CTA the route is
// uniform.  The block table (pointers, strides, k) is a kernel parameter
// (__grid_constant__), so the predict's outputs are read where they lie,
// with no copy or concatenation; a call with more blocks than the table
// holds is launched in chunks.  Dynamic shared memory follows the call's
// largest k (0 for the flagship, 32 KB at k = 88).  FP32 throughout (IEEE
// division and square root).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

// One low-rank block as the wrapper gives it (mirrored by
// ops/fused_woodbury.py::BlockArg).  At global scope: the extern "C" entry
// points take it, and a type of the anonymous namespace would hide them.
struct BlockArg {
  const float* mean;    // gp_mean: walker w, PC i at mean[w * mean_sw + i * mean_sk]
  const float* var;     // v, or the quadratic form qf where kdiag is set
  const float* kdiag;   // (k,) prior variances (v = max(kdiag - qf, 0)), or null
  const float* p0;      // (k,)
  const float* minv;    // (k, k), row-major
  const float* const2;  // scalar
  const float* logdet;  // scalar: log det C0' + log det M
  long long mean_sw, mean_sk, var_sw, var_sk;
  int k;
  int unused;
};

namespace {

constexpr int WB_THREADS = 128;       // threads of every CTA
constexpr int WARPS = WB_THREADS / 32;
constexpr int WB_MAX_BLOCKS = 32;     // blocks a launch takes (the table is a kernel parameter)
constexpr int WB_MAX_K = 128;         // largest k
constexpr int THREAD_MAX_K = 8;       // largest k of the thread-per-matrix route
constexpr int WARP_MAX_K = 32;        // largest k of the warp-per-matrix route
constexpr int CTA_PANEL = 8;        // CTA route: columns a panel (a rank-8 trailing update)
constexpr int CTA_COLS = 4;         // CTA route: columns of L^-1 a warp solves side by side
constexpr int BWD_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

struct Seg {            // a block as the forward kernel sees it
  BlockArg a;
  int col;              // the block's column of lp (its place in the call)
  int off;              // its first row of alpha and diag(B^-1): the earlier blocks' k summed
  int tile0;            // its first CTA
  int unused;
};

struct FwdParams {
  Seg seg[WB_MAX_BLOCKS];  // largest k first
  float* lp;               // (m, nb)
  float* alpha;            // (sum k, m), or null: no gradient
  float* dinv;             // (sum k, m), or null
  int nseg, m, nb;
};

struct BwdSeg {
  const float* var;
  const float* kdiag;
  long long var_sw, var_sk;
  int k, col, off, unused;
};

struct BwdParams {
  BwdSeg seg[WB_MAX_BLOCKS];
  const float* lp;         // (m, nb)
  const float* g;          // cotangent of lp: g[w * g_sw + col * g_sb]
  const float* alpha;      // (sum k, m)
  const float* dinv;
  float* gmean;            // (sum k, m): d/d gp_mean
  float* gvar;             // (sum k, m): d/d v, or d/d qf
  long long g_sw, g_sb;
  int m, nb;
};

__device__ __forceinline__ bool bad_pivot(float p) {
  return !(p > 0.f) || isinf(p);  // catches NaN too
}

// v of PC i at walker w; NaN stays NaN (as torch.clamp keeps it)
__device__ __forceinline__ float load_var(const BlockArg& a, long long w, int i) {
  const float x = a.var[w * a.var_sw + i * a.var_sk];
  if (a.kdiag == nullptr) return x;
  const float t = a.kdiag[i] - x;
  return t < 0.f ? 0.f : t;
}

__device__ __forceinline__ float load_d(const BlockArg& a, long long w, int i) {
  return a.mean[w * a.mean_sw + i * a.mean_sk] - a.p0[i];
}

__device__ __forceinline__ float lp_of(const BlockArg& a, float quad, float logdet_b,
                                       bool failed) {
  const float lp = -0.5f * (quad + *a.const2) - 0.5f * (*a.logdet + logdet_b);
  return (!failed && isfinite(lp)) ? lp : -CUDART_INF_F;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// ------------------------------------------------------ thread per matrix
//
// K >= k: rows and columns k .. K - 1 are the identity, d 0 there, so the
// padded matrix factors to the same L, z and diag(B^-1) on the first k.
template <int K, bool kGrad>
__device__ void thread_route(const FwdParams& p, const Seg& g, int w) {
  const BlockArg& a = g.a;
  const int k = a.k;
  float L[K][K], d[K], rd[K], z[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const bool in = i < k;
    d[i] = in ? load_d(a, w, i) : 0.f;
#pragma unroll
    for (int j = 0; j <= i; ++j) L[i][j] = in ? a.minv[i * k + j] : (i == j ? 1.f : 0.f);
    if (in) L[i][i] += load_var(a, w, i);
  }
  bool failed = false;
  float lg = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {  // Cholesky-Crout, row j's pivot then column j
    float s = L[j][j];
#pragma unroll
    for (int l = 0; l < j; ++l) s = fmaf(-L[j][l], L[j][l], s);
    failed = failed || bad_pivot(s);
    const float sq = sqrtf(s);
    rd[j] = 1.f / sq;
    L[j][j] = sq;
    lg += logf(sq);
#pragma unroll
    for (int i = j + 1; i < K; ++i) {
      float t = L[i][j];
#pragma unroll
      for (int l = 0; l < j; ++l) t = fmaf(-L[i][l], L[j][l], t);
      L[i][j] = t * rd[j];
    }
  }
  float quad = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i) {  // z = L^-1 d
    float t = d[i];
#pragma unroll
    for (int l = 0; l < i; ++l) t = fmaf(-L[i][l], z[l], t);
    z[i] = t * rd[i];
    quad = fmaf(z[i], z[i], quad);
  }
  p.lp[(long long)w * p.nb + g.col] = lp_of(a, quad, 2.f * lg, failed);
  if (!kGrad) return;
  float X[K][K];  // L^-1, lower
#pragma unroll
  for (int j = 0; j < K; ++j) {
    X[j][j] = rd[j];
#pragma unroll
    for (int i = j + 1; i < K; ++i) {
      float t = 0.f;
#pragma unroll
      for (int l = j; l < i; ++l) t = fmaf(-L[i][l], X[l][j], t);
      X[i][j] = t * rd[i];
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j >= k) break;
    float as = 0.f, ds = 0.f;
#pragma unroll
    for (int i = j; i < K; ++i) {
      as = fmaf(X[i][j], z[i], as);
      ds = fmaf(X[i][j], X[i][j], ds);
    }
    const long long o = (long long)(g.off + j) * p.m + w;
    p.alpha[o] = failed ? 0.f : as;
    p.dinv[o] = failed ? 0.f : ds;
  }
}

// -------------------------------------------------------- warp per matrix
//
// Lane r holds row r of the augmented matrix [[B, d], [d^T, 0]]: x[q] for
// q <= r, and its d entry.  Lanes k .. 31 hold identity rows.
template <int KR, bool kGrad>
__device__ void warp_route(const FwdParams& p, const Seg& g, int w) {
  const BlockArg& a = g.a;
  const int k = a.k;
  const int lane = threadIdx.x & 31;
  const bool in = lane < k;
  float x[KR];
#pragma unroll
  for (int q = 0; q < KR; ++q)
    x[q] = (in && q <= lane) ? a.minv[lane * k + q] : (q == lane ? 1.f : 0.f);
  if (in) {
    const float v = load_var(a, w, lane);
#pragma unroll
    for (int q = 0; q < KR; ++q)
      if (q == lane) x[q] += v;
  }
  float dr = in ? load_d(a, w, lane) : 0.f;  // A[n][lane]
  float myrd = 1.f, lg = 0.f, ynn = 0.f;     // 1 / L[lane][lane], log L[lane][lane]; A[n][n]
  bool failed = false;
#pragma unroll
  for (int j = 0; j < KR; ++j) {
    if (j >= k) break;
    const float pj = __shfl_sync(FULL, x[j], j);
    const float yj = __shfl_sync(FULL, dr, j);
    float colj[KR];  // A[q][j] from lane q
#pragma unroll
    for (int q = j + 1; q < KR; ++q) colj[q] = __shfl_sync(FULL, x[j], q);
    if (bad_pivot(pj)) {  // the same pj in every lane: a uniform exit
      failed = true;
      break;
    }
    const float rp = 1.f / pj;
    const float sr = x[j] * rp;  // this row's multiplier A[r][j] / p_j
    const float sn = yj * rp;    // the d row's
#pragma unroll
    for (int q = j + 1; q < KR; ++q) x[q] = fmaf(-sr, colj[q], x[q]);
    if (lane > j) dr = fmaf(-sn, x[j], dr);
    ynn = fmaf(-sn, yj, ynn);
    // column j of the factor: L[r][j] = A[r][j] / sqrt(p_j), L[j][j] = sqrt(p_j)
    const float sq = sqrtf(pj), rs = 1.f / sq;
    if (lane == j) {
      myrd = rs;
      lg = logf(sq);
    }
    x[j] = (lane == j) ? sq : x[j] * rs;
  }
  const float logdet_b = 2.f * warp_sum(in && !failed ? lg : 0.f);
  if (lane == 0) p.lp[(long long)w * p.nb + g.col] = lp_of(a, -ynn, logdet_b, failed);
  if (!kGrad) return;
  float as = 0.f, ds = 0.f;
  if (!failed) {
    const float zr = in ? dr * myrd : 0.f;  // z[lane]
    float xc[KR];  // column `lane` of L^-1
#pragma unroll
    for (int r = 0; r < KR; ++r) {
      if (r >= k) break;
      const float rdr = __shfl_sync(FULL, myrd, r);
      float t = (lane == r) ? 1.f : 0.f;
#pragma unroll
      for (int j = 0; j < r; ++j) t = fmaf(-__shfl_sync(FULL, x[j], r), xc[j], t);
      xc[r] = t * rdr;
    }
#pragma unroll
    for (int r = 0; r < KR; ++r) {
      if (r >= k) break;
      const float zb = __shfl_sync(FULL, zr, r);
      as = fmaf(xc[r], zb, as);
      ds = fmaf(xc[r], xc[r], ds);
    }
  }
  if (in) {
    const long long o = (long long)(g.off + lane) * p.m + w;
    p.alpha[o] = as;
    p.dinv[o] = ds;
  }
}

// --------------------------------------------------------- CTA per matrix

__host__ __device__ constexpr int cta_ld(int k) { return (k + 1) | 1; }

__host__ __device__ constexpr int cta_floats(int k) {
  return (k + 1) * cta_ld(k) + k + WARPS;
}

template <bool kGrad>
__device__ void cta_route(const FwdParams& p, const Seg& g, int w, float* A) {
  const BlockArg& a = g.a;
  const int k = a.k, ld = cta_ld(k);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* rd = A + (k + 1) * ld;  // 1 / L[j][j]
  float* red = rd + k;           // a partial sum per warp
  for (int e = tid; e < k * k; e += WB_THREADS) {
    const int i = e / k, j = e - i * k;
    A[i * ld + j] = a.minv[e] + (i == j ? load_var(a, w, i) : 0.f);
  }
  if (tid < k) A[k * ld + tid] = load_d(a, w, tid);
  if (tid == 0) A[k * ld + k] = 0.f;
  __syncthreads();
  bool failed = false;
  for (int j0 = 0; j0 < k; j0 += CTA_PANEL) {
    const int pw = min(CTA_PANEL, k - j0), c1 = j0 + pw;
    // the panel's diagonal block, factored in registers by every thread (the
    // same numbers everywhere, so a bad pivot is a uniform exit); rows past
    // pw of a last, narrower panel are the identity
    float D[CTA_PANEL][CTA_PANEL], rdd[CTA_PANEL];
#pragma unroll
    for (int r = 0; r < CTA_PANEL; ++r)
#pragma unroll
      for (int c = 0; c <= r; ++c)
        D[r][c] = (r < pw) ? A[(j0 + r) * ld + j0 + c] : (r == c ? 1.f : 0.f);
    bool bad = false;
#pragma unroll
    for (int c = 0; c < CTA_PANEL; ++c) {
      float s = D[c][c];
#pragma unroll
      for (int l = 0; l < c; ++l) s = fmaf(-D[c][l], D[c][l], s);
      bad = bad || bad_pivot(s);
      const float sq = sqrtf(s);
      rdd[c] = 1.f / sq;
      D[c][c] = sq;
#pragma unroll
      for (int r = c + 1; r < CTA_PANEL; ++r) {
        float t = D[r][c];
#pragma unroll
        for (int l = 0; l < c; ++l) t = fmaf(-D[r][l], D[c][l], t);
        D[r][c] = t * rdd[c];
      }
    }
    if (bad) {
      failed = true;
      break;
    }
    // the panel's rows below its block, the d row included: a thread a row,
    // L[i][j0 + c] by substitution against the block
    for (int i = c1 + tid; i <= k; i += WB_THREADS) {
      float r[CTA_PANEL];
#pragma unroll
      for (int c = 0; c < CTA_PANEL; ++c) {
        if (c < pw) {
          float t = A[i * ld + j0 + c];
#pragma unroll
          for (int l = 0; l < c; ++l) t = fmaf(-r[l], D[c][l], t);
          r[c] = t * rdd[c];
          A[i * ld + j0 + c] = r[c];
        }
      }
    }
    __syncthreads();
    if (tid == 0) {  // the block's factor in place; nothing below reads it
#pragma unroll
      for (int r = 0; r < CTA_PANEL; ++r) {
        if (r < pw) {
          rd[j0 + r] = rdd[r];
#pragma unroll
          for (int c = 0; c <= r; ++c) A[(j0 + r) * ld + j0 + c] = D[r][c];
        }
      }
    }
    // the trailing update by the panel, the d row and its corner included:
    // A[i][l] -= sum_c L[i][j0 + c] L[l][j0 + c], c1 <= l <= i <= k; a warp
    // a row, the lanes along it
    for (int i = c1 + warp; i <= k; i += WARPS) {
      float li[CTA_PANEL];
#pragma unroll
      for (int c = 0; c < CTA_PANEL; ++c) li[c] = c < pw ? A[i * ld + j0 + c] : 0.f;
      for (int l = c1 + lane; l <= i; l += 32) {
        const float* pl = A + l * ld + j0;
        float t = A[i * ld + l];
#pragma unroll
        for (int c = 0; c < CTA_PANEL; ++c)
          if (c < pw) t = fmaf(-li[c], pl[c], t);
        A[i * ld + l] = t;
      }
    }
    __syncthreads();
  }
  float lg = 0.f;
  if (!failed)
    for (int i = tid; i < k; i += WB_THREADS) lg += logf(A[i * ld + i]);
  lg = warp_sum(lg);
  if (lane == 0) red[warp] = lg;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int q = 0; q < WARPS; ++q) s += red[q];
    p.lp[(long long)w * p.nb + g.col] = lp_of(a, -A[k * ld + k], 2.f * s, failed);
  }
  if (!kGrad) return;
  // columns c0 .. c0 + CTA_COLS - 1 of L^-1 by forward substitution of
  // L x = e_c, side by side (one load of L serves them all); lane s of the
  // warp holds rows c0 + s + 32 q
  for (int c0 = warp * CTA_COLS; c0 < k; c0 += WARPS * CTA_COLS) {
    float acc[CTA_COLS][4], xv[CTA_COLS][4];
#pragma unroll
    for (int n = 0; n < CTA_COLS; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[n][q] = (q == 0 && lane == n) ? 1.f : 0.f;
        xv[n][q] = 0.f;
      }
    if (!failed) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll 1
        for (int s = 0; s < 32; ++s) {
          const int l = c0 + 32 * q + s;
          if (l >= k) break;
          const float rdl = rd[l];
          float xl[CTA_COLS];
#pragma unroll
          for (int n = 0; n < CTA_COLS; ++n) {
            xl[n] = __shfl_sync(FULL, acc[n][q], s) * rdl;
            if (lane == s) xv[n][q] = xl[n];
          }
#pragma unroll
          for (int q2 = q; q2 < 4; ++q2) {
            const int r = c0 + lane + 32 * q2;
            if (r > l && r < k) {
              const float lrl = A[r * ld + l];
#pragma unroll
              for (int n = 0; n < CTA_COLS; ++n) acc[n][q2] = fmaf(-lrl, xl[n], acc[n][q2]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int n = 0; n < CTA_COLS; ++n) {
      float as = 0.f, ds = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = c0 + lane + 32 * q;
        if (r < k) {
          as = fmaf(xv[n][q], A[k * ld + r], as);
          ds = fmaf(xv[n][q], xv[n][q], ds);
        }
      }
      as = warp_sum(as);
      ds = warp_sum(ds);
      if (lane == 0 && c0 + n < k) {
        const long long o = (long long)(g.off + c0 + n) * p.m + w;
        p.alpha[o] = as;
        p.dinv[o] = ds;
      }
    }
  }
}

// -------------------------------------------------------------- kernels

template <bool kGrad>
__global__ void __launch_bounds__(WB_THREADS)
woodbury_fwd_kernel(const __grid_constant__ FwdParams p) {
  extern __shared__ __align__(16) float smem[];
  int s = 0;
  while (s + 1 < p.nseg && (int)blockIdx.x >= p.seg[s + 1].tile0) ++s;
  const Seg& g = p.seg[s];
  const int k = g.a.k;
  const int tile = (int)blockIdx.x - g.tile0;
  if (k <= THREAD_MAX_K) {
    const int w = tile * WB_THREADS + (int)threadIdx.x;
    if (w >= p.m) return;
    if (k <= 4)
      thread_route<4, kGrad>(p, g, w);
    else
      thread_route<8, kGrad>(p, g, w);
  } else if (k <= WARP_MAX_K) {
    const int w = tile * WARPS + (int)(threadIdx.x >> 5);
    if (w >= p.m) return;  // the whole warp
    if (k <= 16)
      warp_route<16, kGrad>(p, g, w);
    else
      warp_route<32, kGrad>(p, g, w);
  } else {
    cta_route<kGrad>(p, g, tile, smem);
  }
}

__global__ void __launch_bounds__(BWD_THREADS)
woodbury_bwd_kernel(const __grid_constant__ BwdParams p) {
  const BwdSeg& s = p.seg[blockIdx.y];
  const long long e = (long long)blockIdx.x * BWD_THREADS + threadIdx.x;
  if (e >= (long long)s.k * p.m) return;
  const int i = (int)(e / p.m);
  const long long w = e - (long long)i * p.m;
  const float lp = p.lp[w * p.nb + s.col];
  const float gg = p.g[w * p.g_sw + s.col * p.g_sb];
  const bool ok = isfinite(lp) && isfinite(gg);
  const long long o = (long long)(s.off + i) * p.m + w;
  const float al = p.alpha[o];
  float gm = ok ? -gg * al : 0.f;
  float gv = ok ? 0.5f * gg * fmaf(al, al, -p.dinv[o]) : 0.f;
  if (s.kdiag != nullptr) {  // through v = max(kdiag - qf, 0)
    const float t = s.kdiag[i] - s.var[w * s.var_sw + i * s.var_sk];
    gv = (t >= 0.f) ? -gv : 0.f;
  }
  p.gmean[o] = gm;
  p.gvar[o] = gv;
}

// walkers one CTA of the forward takes at this k
int per_cta(int k) { return k <= THREAD_MAX_K ? WB_THREADS : (k <= WARP_MAX_K ? WARPS : 1); }

int cta_bytes(int k) { return k <= WARP_MAX_K ? 0 : 4 * cta_floats(k); }

bool bad_table(const BlockArg* blocks, int nblocks, int m) {
  if (nblocks < 1 || nblocks > WB_MAX_BLOCKS || m < 1) return true;
  for (int b = 0; b < nblocks; ++b)
    if (blocks[b].k < 1 || blocks[b].k > WB_MAX_K) return true;
  return false;
}

}  // namespace

extern "C" {

// The limits the wrapper routes and chunks by, and the table entry's size.
int fused_woodbury_max_k() { return WB_MAX_K; }
int fused_woodbury_max_blocks() { return WB_MAX_BLOCKS; }
int fused_woodbury_arg_bytes() { return (int)sizeof(BlockArg); }

// One forward launch over blocks[0 .. nblocks): block b writes column
// col0 + b of lp (m, nb) and, where alpha and dinv are given (a gradient
// follows), rows off0 + (the k of blocks before b) onwards of both
// (sum k, m) arrays.
int fused_woodbury_fwd(const BlockArg* blocks, int nblocks, int col0, int nb, int off0, int m,
                       float* lp, float* alpha, float* dinv, void* stream) {
  if (bad_table(blocks, nblocks, m) || col0 < 0 || col0 + nblocks > nb)
    return (int)cudaErrorInvalidValue;
  FwdParams p;
  int order[WB_MAX_BLOCKS], offs[WB_MAX_BLOCKS];
  int off = off0, kmax = 0;
  for (int b = 0; b < nblocks; ++b) {
    order[b] = b;
    offs[b] = off;
    off += blocks[b].k;
    kmax = blocks[b].k > kmax ? blocks[b].k : kmax;
  }
  for (int b = 1; b < nblocks; ++b)  // largest k first, stable
    for (int c = b; c > 0 && blocks[order[c]].k > blocks[order[c - 1]].k; --c) {
      const int t = order[c];
      order[c] = order[c - 1];
      order[c - 1] = t;
    }
  int tiles = 0;
  for (int s = 0; s < nblocks; ++s) {
    const int b = order[s];
    p.seg[s].a = blocks[b];
    p.seg[s].col = col0 + b;
    p.seg[s].off = offs[b];
    p.seg[s].tile0 = tiles;
    p.seg[s].unused = 0;
    tiles += (m + per_cta(blocks[b].k) - 1) / per_cta(blocks[b].k);
  }
  p.lp = lp;
  p.alpha = alpha;
  p.dinv = dinv;
  p.nseg = nblocks;
  p.m = m;
  p.nb = nb;
  const bool grad = alpha != nullptr && dinv != nullptr;
  const int bytes = cta_bytes(kmax);
  auto kernel = grad ? woodbury_fwd_kernel<true> : woodbury_fwd_kernel<false>;
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<tiles, WB_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// One backward launch over the same blocks: the cotangent g of lp (its
// strides g_sw, g_sb), the forward's lp, alpha and dinv; writes rows
// off0 + ... of gmean and gvar (sum k, m).
int fused_woodbury_bwd(const BlockArg* blocks, int nblocks, int col0, int nb, int off0, int m,
                       const float* lp, const float* g, long long g_sw, long long g_sb,
                       const float* alpha, const float* dinv, float* gmean, float* gvar,
                       void* stream) {
  if (bad_table(blocks, nblocks, m) || col0 < 0 || col0 + nblocks > nb)
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  int off = off0, kmax = 0;
  for (int b = 0; b < nblocks; ++b) {
    p.seg[b].var = blocks[b].var;
    p.seg[b].kdiag = blocks[b].kdiag;
    p.seg[b].var_sw = blocks[b].var_sw;
    p.seg[b].var_sk = blocks[b].var_sk;
    p.seg[b].k = blocks[b].k;
    p.seg[b].col = col0 + b;
    p.seg[b].off = off;
    p.seg[b].unused = 0;
    off += blocks[b].k;
    kmax = blocks[b].k > kmax ? blocks[b].k : kmax;
  }
  p.lp = lp;
  p.g = g;
  p.alpha = alpha;
  p.dinv = dinv;
  p.gmean = gmean;
  p.gvar = gvar;
  p.g_sw = g_sw;
  p.g_sb = g_sb;
  p.m = m;
  p.nb = nb;
  const long long n = (long long)kmax * m;
  const dim3 grid((unsigned)((n + BWD_THREADS - 1) / BWD_THREADS), (unsigned)nblocks);
  woodbury_bwd_kernel<<<grid, BWD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
