// Fused batched MVN log-likelihood for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
//   gpbayestools_hic_tpu/ops/pallas_mvn.py:_mvn_kernel
//
// For each matrix of the batch (y (n,), C (n, n) symmetric):
//   lp = -1/2 y^T C^-1 y - sum_k log L_kk,   C = L L^T
// by symmetric elimination of the augmented matrix A = [[C, y], [y^T, 0]]:
// for each pivot k < n
//   p = A[k][k];  logdet_half += 1/2 log p;
//   A[i][j] -= A[i][k] A[j][k] / p     for k < j <= i <= n   (row n holds y)
// and at the end lp = 1/2 A[n][n] - logdet_half.  The pivots are the
// squared Cholesky diagonal and A[n][n] ends as -y^T C^-1 y, so there is no
// separate triangular solve.  Only the lower triangle is touched.  A pivot
// that is not positive and finite means C is not positive definite: the
// elimination stops there and lp = -inf (the sampler's rejection); a
// non-finite lp is written as -inf too.
//
// Nothing of the TPU layout is kept (no lane padding to 128, no identity
// block, no (b, 128) output, no batch chunks sized for VMEM).  The work is
// sequential in k, so one warp, thread block or cluster owns one matrix
// and the batch fills the card.  All routes are the reference's blocked
// right-looking form
// (pallas_mvn.py:_mvn_kernel, PANEL 32): factor a panel of columns, then
// apply its cumulative trailing update
//     A[i][j] -= sum_k P[i][k] P[j][k] / p_k      (k in the panel, j <= i)
// as one matrix product.  Trailing entries at or left of the panel go
// stale and are never read again: a later step only reads columns > k.
// Two routes, picked by the wrapper from n:
//
// - the shared-memory route, n <= fused_mvn_smem_max_n() (319), the
//   generic likelihood's nine blocks per posterior call (n = 12 to 170, at
//   a half-ensemble of 512 walkers or 1024).  Measured on the H100
//   (PERF.md, tools/torch_mvn_variants.py --route smem), the earlier
//   design (a block per matrix, three block barriers per 16-column panel)
//   lost its time to: the factoring warp's pivot chain, which nothing
//   overlapped (27% of the time at n = 170, 45% at n = 73); at n <= 28 the
//   fixed cost of a block per matrix (a launch that only loads took 2-3 us
//   of 5-12); at n = 73, three blocks per SM where the matrix would let
//   more in; and the triangle's load (18% at n = 170), each element's
//   packed index computed with a square root.  Two kernels, by n:
//   * mvn_warp_kernel, n <= WARP_MAX_N (32; every matrix that fits one
//     warp's lanes, six of the flagship's nine blocks): one warp per
//     matrix, four per block, no block barrier, no shared memory: lane r
//     reads row r straight into registers and holds the y row as column n
//     (the pivot chain per pivot is two shuffles, a reciprocal and two
//     FMAs, one panel for the whole matrix).  Answers the fixed cost per
//     matrix; the SM's other warps (20 to 36 matrices per SM) overlap each
//     warp's loads with their chains.
//   * mvn_smem_kernel, larger n: the lower triangle of the augmented
//     matrix packed in the block's shared memory (A[i][j] at i(i+1)/2 +
//     j), beside a copy of the current panel; n = 170 takes 73.9 KB, so
//     three blocks share an SM (256 threads); below n = 128, 128 threads
//     and up to six blocks per SM (answers the occupancy at n = 73).  Only
//     the lower triangle of cov is read from device memory, once, by
//     asynchronous copies (cp.async), a row per warp and an entry per
//     lane, coalesced and without index arithmetic (answers the load);
//     panel 0's diagonal block is factored from device memory while they
//     land.  Per panel of SMEM_PANEL columns, two block barriers:
//       1. the rows below the panel's diagonal block, a thread per row, by
//          the substitution x_j -= sum_{k<j} x_k D[j][k] / p_k against the
//          factored block, written as Cholesky entries L[i][k] = x_k /
//          sqrt(p_k) into the panel copy (16-byte rows);
//       2. the trailing update A -= L L^T in warp tiles of 16 x 32, 4 x 4
//          outputs per thread, both operands read four panel columns at a
//          time.  Its first tile is the next panel's diagonal block
//          (warp 1's); as soon as it is written, warp 1 signals warp 0 by
//          a named barrier, and warp 0 factors that block, right-looking,
//          lane r holding row r, the chain per pivot a shuffle, a
//          reciprocal and two FMAs, while the other warps apply the rest
//          (look-ahead: the chain leaves the critical path, answers the
//          factoring warp's chain).
//     A bad pivot raises a flag in shared memory; every thread reads it
//     after the next barrier and leaves.  FP32 FMA throughout.
//   Each matrix's result depends on that matrix alone, at any b and any
//   place in the batch.  Neither kernel uses a mechanism that is Hopper's
//   own: those tried measured no faster (PERF.md) -- one matrix over a
//   2-CTA cluster with DSMEM (at n = 170 and 73, four to nine times
//   slower) and the warp kernel's matrices brought by TMA
//   (1-d tensor maps, a two-stage mbarrier ring per warp: equal at n = 28,
//   4-6% slower at n = 12, also at b = 16384, where each warp takes
//   several; a box must start 16-byte aligned, so n a multiple of 4 only).
//   Nor did other panel widths, tile widths, thread counts or blocks per
//   SM.
// - mvn_wide_kernel, larger n (320 and up, any n; the wrapper's route
//   "panel"; the stitched 544 x 544 likelihood): the trailing matrix in a
//   scratch copy in device memory, one thread-block cluster of C = 1 .. 8
//   CTAs per matrix (8 at small b, to fill the card; 1 at b = 512 and
//   2048), 64-column panels: every CTA factors the panel's 64 x 64 diagonal
//   block in 16-column steps, the rows below stream through shared memory
//   in chunks dealt out over the cluster, then ONE trailing update per
//   panel in 64 x 64 tiles dealt out over the cluster, operands through a
//   cp.async ring, the product in 3xTF32 on the tensor cores (the
//   section's note below).
//
// Each entry launches on the caller's stream, allocates nothing (the
// wrapper allocates the output, and the wide route's scratch), and returns
// the launch's error.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int SMEM_PANEL = 16;     // panel width of the shared-memory route
constexpr int SMEM_TILE_COLS = 4;  // its trailing update's columns per thread (4 rows each)
constexpr int SMEM_LIMIT = 232448; // bytes of shared memory one block may use

__device__ __forceinline__ bool bad_pivot(float p) {
  return !(p > 0.f) || isinf(p);   // catches NaN too
}

// offset of row i in the packed lower triangle
__host__ __device__ constexpr int tri(int i) { return i * (i + 1) / 2; }

// x rounded up to whole float4s
__host__ __device__ constexpr int align4(int x) { return (x + 3) & ~3; }

// the packed triangle of rows 0 .. n1 - 1, rounded up to whole float4s
__host__ __device__ constexpr int tri_aligned(int n1) { return align4(tri(n1)); }

// shared memory of the blocked route: the triangle, the panel's Cholesky
// rows and diagonal block (row stride SMEM_PANEL + 4), 1 / sqrt(p) and the
// flag
__host__ __device__ constexpr long long smem_bytes(int n) {
  return ((long long)tri_aligned(n + 1) + (long long)(n + 1 + SMEM_PANEL) * (SMEM_PANEL + 4) +
          SMEM_PANEL + 1) * 4;
}

// ------------------------------------------------------------------ warp route
//
// n <= WARP_MAX_N: one warp per matrix, WARP_WARPS matrices per block, no
// block barrier and no shared memory.  Lane r reads row r of C (its
// entries up to the diagonal) and y_r straight into registers; the y
// row's last entry A[n][n] is the same in every lane.  Pivot j: p and
// column j by shuffle, then every row's columns right of j and the y row
// by FMA (the y row's update is A[n][q] -= (y_j / p) A[q][j], the rank-1
// update of the augmented matrix's row n, held as column n by the lanes).
// The other warps of the SM (20 to 36 matrices per SM at the flagship's
// sizes) overlap each warp's loads with their chains.
constexpr int WARP_MAX_N = 32;  // largest n of the warp route
constexpr int WARP_WARPS = 4;   // warps, one matrix each, per block

// Diagnostic builds set kSmemPhaseClock: thread 0 of every block of the
// shared-memory route (and thread 32, warp 1) then add the SM clock cycles
// they spend in each phase to g_smem_phase (fused_mvn_smem_phase_cycles
// reads and clears them).
constexpr bool kSmemPhaseClock = false;
// phases: load and panel 0's factoring, barrier A, substitution, barrier B,
// trailing update (warp 1) or look-ahead factoring (warp 0), exit
constexpr int kSmemPhases = 6;
__device__ unsigned long long g_smem_phase[2 * kSmemPhases + 1];

template <int kRows>
__global__ void __launch_bounds__(32 * WARP_WARPS)
mvn_warp_kernel(const float* __restrict__ y,    // (b, n)
                const float* __restrict__ cov,  // (b, n, n)
                float* __restrict__ out,        // (b,)
                int b, int n) {
  const int lane = threadIdx.x & 31;
  const int mat = blockIdx.x * WARP_WARPS + (threadIdx.x >> 5);
  if (mat >= b) return;  // the whole warp
  float x[kRows];        // row r of C
  const float* c = cov + ((size_t)mat * n + lane) * n;
#pragma unroll
  for (int q = 0; q < kRows; ++q) x[q] = (q <= lane && lane < n) ? c[q] : 0.f;
  float yr = (lane < n) ? y[(size_t)mat * n + lane] : 0.f;  // A[n][r]
  float mine = 1.f, ynn = 0.f;  // lane r's pivot p_r; A[n][n]
  bool failed = false;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (j >= n) break;
    const float p = __shfl_sync(0xffffffffu, x[j], j);
    const float yj = __shfl_sync(0xffffffffu, yr, j);
    float colj[kRows];  // A[q][j] from lane q
#pragma unroll
    for (int q = j + 1; q < kRows; ++q) colj[q] = __shfl_sync(0xffffffffu, x[j], q);
    if (bad_pivot(p)) {  // the same p in every lane: a uniform exit
      failed = true;
      break;
    }
    if (lane == j) mine = p;
    const float rp = __frcp_rn(p);
    const float sr = x[j] * rp;  // this row's multiplier A[r][j] / p_j
    const float sn = yj * rp;    // the y row's, A[n][j] / p_j
#pragma unroll
    for (int q = j + 1; q < kRows; ++q) x[q] = fmaf(-sr, colj[q], x[q]);
    if (lane > j) yr = fmaf(-sn, x[j], yr);
    ynn = fmaf(-sn, yj, ynn);
  }
  float lg = (lane < n && !failed) ? 0.5f * logf(mine) : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) lg += __shfl_xor_sync(0xffffffffu, lg, o);
  if (lane == 0) {
    const float lp = 0.5f * ynn - lg;
    out[mat] = (!failed && isfinite(lp)) ? lp : -CUDART_INF_F;
  }
}

// ------------------------------------------------------------ block route
//
// asynchronous global -> shared copies; ok == false zero-fills the target.
// The 16-byte copy caches in L2 only (.cg), so it sees what other CTAs of
// the cluster wrote; the 4-byte one (.ca) is used on read-only inputs only.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// bar.sync / bar.arrive on a named barrier of nthreads threads
__device__ __forceinline__ void named_bar_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(nthreads) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int nthreads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(nthreads) : "memory");
}

// The packed lower triangle of the augmented matrix into a by asynchronous
// copies: warp w of nw takes rows w, w + nw, ..., a lane per entry
// (coalesced, no index arithmetic, no registers held); A[n][n] = 0.
__device__ __forceinline__ void copy_triangle(float* a, const float* __restrict__ cov_b,
                                              const float* __restrict__ y_b, int n, int warp,
                                              int nw, int lane) {
  for (int i = warp; i <= n; i += nw) {
    const float* src = i < n ? cov_b + (size_t)i * n : y_b;
    float* dst = a + tri(i);
    for (int j = lane; j <= i; j += 32) {
      const bool ok = i < n || j < n;
      cp_async4(dst + j, ok ? src + j : y_b, ok);
    }
  }
}

//
// One panel's diagonal block, factored by warp 0, right-looking: lane r
// holds row c0 + r of the block (rows = min(P, n + 1 - c0) rows, pw of them
// pivots) and takes the pivot and the other rows' column j by shuffle, so
// the chain per pivot is a shuffle, a reciprocal and two FMAs; the
// logarithms and 1 / sqrt(p) come after it, one lane per pivot.  Writes the
// block's scaled rows dg[r LD + q] = A[c0 + r][c0 + q] / p_q (q < r), isq =
// 1 / sqrt(p) and the bad-pivot flag, and adds the logarithms to warp 0's
// logdet_half.  Panel 0's block (c0 == 0) is read from device memory while
// the triangle's copies land, a later one from shared memory once the
// previous panel's update of it is written.  No early exit at a bad pivot
// (the chain stays free of branches); whatever follows it is discarded.
__device__ __forceinline__ void smem_factor_block(float* a, const float* __restrict__ cov_b,
                                                  const float* __restrict__ y_b, float* dg,
                                                  float* isq, int* bad, int c0, int n,
                                                  float& logdet_half) {
  constexpr int P = SMEM_PANEL, LD = P + 4;
  const int lane = threadIdx.x & 31;
  const int pw = min(P, n - c0), rows = min(P, n + 1 - c0);
  const int i = c0 + lane;  // this lane's row
  float x[P];
  if (c0 == 0) {
#pragma unroll
    for (int q = 0; q < P; ++q)
      x[q] = (q <= lane && lane < rows) ? (i < n ? cov_b[(size_t)i * n + q] : y_b[q]) : 0.f;
  } else {
    const float* row = a + tri(lane < rows ? i : c0) + c0;
#pragma unroll
    for (int q = 0; q < P; ++q) x[q] = (q <= lane && lane < rows) ? row[q] : 0.f;
  }
  float mine = 1.f;  // lane r's pivot p_r
  bool failed = false;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (j >= pw) break;
    const float p = __shfl_sync(0xffffffffu, x[j], j);
    float colj[P];  // A[q][j] from lane q
#pragma unroll
    for (int q = j + 1; q < P; ++q) colj[q] = __shfl_sync(0xffffffffu, x[j], q);
    failed |= bad_pivot(p);
    if (lane == j) mine = p;
    const float s = x[j] * __frcp_rn(p);  // this row's multiplier A[r][j] / p_j
    if (lane > j && lane < pw) dg[lane * LD + j] = s;
#pragma unroll
    for (int q = j + 1; q < P; ++q) x[q] = fmaf(-s, colj[q], x[q]);
  }
  if (lane < pw) isq[lane] = 1.f / sqrtf(mine);
  float lg = (lane < pw) ? 0.5f * logf(mine) : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) lg += __shfl_xor_sync(0xffffffffu, lg, o);
  logdet_half += lg;  // a bad pivot's panel ends the matrix anyway
  if (lane == 0) *bad = failed;
}

// Blocked elimination in shared memory, n > WARP_MAX_N (the route's header
// note), P = SMEM_PANEL columns per panel, two block barriers per panel:
//   -- barrier A: panel k's diagonal block is factored (dg, isq, the flag),
//      and the previous panel's trailing update is written;
//   1. every thread finishes a row below the block by substitution and
//      writes its Cholesky entries into the panel copy l;
//   -- barrier B: the whole panel is in l;
//   2. warp 0 applies panel k's update to block k + 1 and factors it
//      (look-ahead), while the other warps apply the trailing update to the
//      rest, a warp per tile of P rows x TC columns, 4 x 4 outputs per
//      thread, operands as float4 from l.
// Panel 0's block is factored by warp 0 from device memory while the other
// warps load the triangle.  Shared memory, in floats: the packed triangle
// (A[i][j] at tri(i) + j); the panel's rows c1 .. n as Cholesky entries
// l[(i - c1) LD + q] = A[i][c0 + q] / sqrt(p_q) (16-byte rows, zero past the
// panel's width); the diagonal block's scaled rows dg; the panel's
// 1 / sqrt(p); the bad-pivot flag.
template <int kThreads>
__global__ void __launch_bounds__(kThreads, kThreads == 256 ? 3 : 6)
mvn_smem_kernel(const float* __restrict__ y,    // (b, n)
                const float* __restrict__ cov,  // (b, n, n)
                float* __restrict__ out,        // (b,)
                int n) {
  constexpr int P = SMEM_PANEL, LD = P + 4;
  constexpr int TY = P / 4, TX = 32 / TY;
  // trailing columns per thread; a tile at least P wide, so that the next
  // panel's diagonal block is one tile (tile 0)
  constexpr int CW = SMEM_TILE_COLS * TX >= P ? SMEM_TILE_COLS : P / TX;
  constexpr int TC = CW * TX;  // warp tile: P x TC
  constexpr int NW = kThreads / 32;
  static_assert(P % 4 == 0 && P <= 32 && 32 % P == 0 && TY * TX == 32,
                "whole float4 columns, one warp's lanes");
  extern __shared__ __align__(16) float a[];  // rows 0 .. n of the lower triangle, packed
  const int n1 = n + 1;
  float* l = a + tri_aligned(n1);
  float* dg = l + (size_t)n1 * LD;
  float* isq = dg + P * LD;
  int* bad = reinterpret_cast<int*>(isq + P);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* cov_b = cov + (size_t)blockIdx.x * n * n;
  const float* y_b = y + (size_t)blockIdx.x * n;
  long long clock_last = kSmemPhaseClock ? clock64() : 0, clock_acc[kSmemPhases] = {};
  auto phase = [&](int i) {
    if (kSmemPhaseClock && (tid == 0 || tid == 32)) {
      const long long now = clock64();
      clock_acc[i] += now - clock_last;
      clock_last = now;
    }
  };

  copy_triangle(a, cov_b, y_b, n, warp, NW, lane);
  float logdet_half = 0.f;  // warp 0's sum
  if (warp == 0) smem_factor_block(a, cov_b, y_b, dg, isq, bad, 0, n, logdet_half);
  cp_async_wait_all();
  phase(0);
  const int npan = (n + P - 1) / P, nblk = (n1 + P - 1) / P;
  for (int k = 0; k < npan; ++k) {
    const int c0 = k * P, pw = min(P, n - c0), c1 = c0 + pw;
    __syncthreads();  // A
    phase(1);
    if (*bad) break;  // every thread reads the same flag: a uniform exit

    // 1. the panel's rows below it, a thread per row: the substitution
    // against the factored block (its scaled rows read four at a time, a
    // broadcast), then the row's Cholesky entries into l
    for (int i = c1 + tid; i <= n; i += kThreads) {
      const float* row = a + tri(i) + c0;
      float x[P];
#pragma unroll
      for (int q = 0; q < P; ++q) x[q] = (q < pw) ? row[q] : 0.f;
#pragma unroll
      for (int j = 1; j < P; ++j) {
        if (j >= pw) break;
#pragma unroll
        for (int k0 = 0; k0 < j; k0 += 4) {
          const float4 d4 = *reinterpret_cast<const float4*>(dg + j * LD + k0);
          x[j] = fmaf(-x[k0], d4.x, x[j]);
          if (k0 + 1 < j) x[j] = fmaf(-x[k0 + 1], d4.y, x[j]);
          if (k0 + 2 < j) x[j] = fmaf(-x[k0 + 2], d4.z, x[j]);
          if (k0 + 3 < j) x[j] = fmaf(-x[k0 + 3], d4.w, x[j]);
        }
      }
      float* lr = l + (size_t)(i - c1) * LD;
#pragma unroll
      for (int q = 0; q < P; q += 4) {
        const float4 s4 = *reinterpret_cast<const float4*>(isq + q);
        *reinterpret_cast<float4*>(lr + q) =
            make_float4(q < pw ? x[q] * s4.x : 0.f, q + 1 < pw ? x[q + 1] * s4.y : 0.f,
                        q + 2 < pw ? x[q + 2] * s4.z : 0.f, q + 3 < pw ? x[q + 3] * s4.w : 0.f);
      }
    }
    phase(2);
    __syncthreads();  // B
    phase(3);

    // 2. look-ahead: block k + 1 (rows [c1, c1 + P), a whole panel past
    // this one) is the first trailing tile, warp 1's; warp 0 factors it as
    // soon as warp 1 has written it, while the others apply the rest
    const bool ahead = k + 1 < npan;
    if (ahead && warp == 0) {
      named_bar_sync(1, 64);
      smem_factor_block(a, cov_b, y_b, dg, isq, bad, c1, n, logdet_half);
    } else {
      // trailing update of rows i >= c1, columns [c1, i]: A[i][j] -= sum_q
      // L[i][q] L[j][q].  The tiles of the row blocks from the one that
      // holds c1 on, counted block by block (a block's tiles: its columns
      // [c1, its last row] in TC-wide pieces; block k + 1 has one, tile 0),
      // a warp per tile (not warp 0 when it looks ahead)
      const int tx = lane % TX, ty = lane / TX;
      int tile = ahead ? warp - 1 : warp;
      const int step = ahead ? NW - 1 : NW;
      int t = c1 / P, before = 0;  // current row block, tiles before it
      for (; tile >= 0; tile += step) {
        for (; t < nblk; ++t) {
          const int rmax = min((t + 1) * P, n1) - 1;
          const int nct = (rmax >= c1) ? (rmax - c1) / TC + 1 : 0;
          if (tile < before + nct) break;
          before += nct;
        }
        if (t >= nblk) break;
        const int rb = t * P, j0 = c1 + (tile - before) * TC;
        int lu[4], lc[CW];  // rows of l
#pragma unroll
        for (int q = 0; q < 4; ++q) lu[q] = (min(max(rb + ty + TY * q, c1), n) - c1) * LD;
#pragma unroll
        for (int c = 0; c < CW; ++c) lc[c] = (min(j0 + tx + TX * c, n) - c1) * LD;
        float acc[4][CW];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int c = 0; c < CW; ++c) acc[q][c] = 0.f;
#pragma unroll
        for (int q4 = 0; q4 < P; q4 += 4) {
          if (q4 >= pw) break;
          float4 u[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) u[q] = *reinterpret_cast<const float4*>(l + lu[q] + q4);
#pragma unroll
          for (int c = 0; c < CW; ++c) {
            const float4 v = *reinterpret_cast<const float4*>(l + lc[c] + q4);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              acc[q][c] = fmaf(u[q].x, v.x, acc[q][c]);
              acc[q][c] = fmaf(u[q].y, v.y, acc[q][c]);
              acc[q][c] = fmaf(u[q].z, v.z, acc[q][c]);
              acc[q][c] = fmaf(u[q].w, v.w, acc[q][c]);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = rb + ty + TY * q;
          if (i < c1 || i > n) continue;
          float* arow = a + tri(i);
#pragma unroll
          for (int c = 0; c < CW; ++c) {
            const int j = j0 + tx + TX * c;
            if (j <= i) arow[j] -= acc[q][c];
          }
        }
        if (ahead && tile == 0) named_bar_arrive(1, 64);  // block k + 1 is written
      }
    }
    phase(4);
  }
  __syncthreads();
  if (tid == 0) {
    const float lp = 0.5f * a[tri(n) + n] - logdet_half;
    out[blockIdx.x] = (!*bad && isfinite(lp)) ? lp : -CUDART_INF_F;
  }
  phase(5);
  if (kSmemPhaseClock && (tid == 0 || tid == 32)) {
    for (int i = 0; i < kSmemPhases; ++i)
      atomicAdd(&g_smem_phase[(tid / 32) * kSmemPhases + i], (unsigned long long)clock_acc[i]);
    if (tid == 0) atomicAdd(&g_smem_phase[2 * kSmemPhases], 1ull);
  }
}

// threads of the block route: 128 (6 blocks per SM) below n = 128, where
// the trailing matrix gives four warps enough tiles, else 256 (3 per SM)
constexpr int smem_threads(int n) { return n < 128 ? 128 : 256; }

using SmemKernel = void (*)(const float*, const float*, float*, int);

SmemKernel smem_kernel(int n) {
  return smem_threads(n) == 256 ? mvn_smem_kernel<256> : mvn_smem_kernel<128>;
}

// Shared memory for one block, and the whole L1/shared array as shared
// memory: without the carveout the runtime may size it for one block only.
template <class K>
cudaError_t prepare_smem(K kernel, int bytes) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && bytes > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return e;
}

// ------------------------------ tensor cores and the split cluster barrier

// round to the nearest TF32 value, ties away from zero (cvt.rna.tf32.f32
// for every finite input, in two integer operations)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo to ~2^-22: both halves are TF32 values
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a b for one 16 x 8 x 8 TF32 tile, FP32 accumulation
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the split cluster barrier: arrive (releasing this thread's writes) and
// wait (acquiring everyone's)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ------------------------------------------------------------------ wide route
//
// n past the shared-memory route (320 and up, the stitched 544 x 544
// likelihood among them): the trailing matrix lives in a scratch copy in
// device memory (rows of n + 1 floats rounded up to whole float4s), and
// one thread-block cluster of C CTAs eliminates one matrix in wide panels
// [c0, c1) of WIDE_PANEL = P columns:
//   1. every rank loads the panel's top rows c0 .. c1 - 1 (its P x P
//      diagonal block) and factors them in 16-column steps, in the
//      shared-memory route's order: one warp factors the step's 16 x 16
//      diagonal block with shuffles, a thread per row finishes the top
//      rows below it by substitution, and the step's update goes to the
//      panel's later columns only.  Every rank does the same work on the
//      same data (the block is small), so nothing crosses CTAs, every rank
//      meets a bad pivot at the same step, and every rank keeps each
//      step's factored block and the top rows' Cholesky entries;
//   2. the rows below, c1 .. n, in chunks of WIDE_CHUNK rows dealt out
//      round-robin over the ranks: a chunk goes into shared memory, a
//      thread per row takes it through all the steps (substitution against
//      the kept blocks, update of the later columns against the top rows),
//      and its Cholesky entries L[i][c0 .. c1) go back to the scratch at
//      those columns (dead there: no later step reads a column left of its
//      pivot).  Shared memory does not grow with n, so the route takes
//      every n;
//   3. ONE trailing update per panel, A[i][j] -= sum_q L[i][q] L[j][q] for
//      c1 <= j <= i <= n, in 64 x 64 tiles dealt out round-robin over the
//      cluster's ranks; each tile's L rows and scratch entries come through
//      a double-buffered cp.async ring, and the product runs on the tensor
//      cores in 3xTF32 (each operand split into TF32 hi + lo, three mma.sync
//      per step into a fresh fragment, FP32 promotion per 8-wide k-step:
//      the recipe of fused_predict.cu's fwd_tc_kernel).
// So each scratch entry is read and written once per P columns, the panel
// has no cluster barrier per step, and a small batch still fills the card:
// C is the smallest that makes b C cover the card's SMs, up to
// WIDE_MAX_CLUSTER.  Where the batch has more CTAs than the card has SMs,
// the kernel is built for two CTAs per SM (at most 128 registers), so one
// CTA's serial steps overlap another's trailing update.  The first panel
// reads cov and y directly, so the scratch needs no initialisation; cov is
// not written.  Bound on the H100: at (512, 1088) the n^3 / 3 flops of the
// elimination (3.3 ms at the FP32 peak; the trailing update's share in three
// TF32 passes 1.3 ms), and the scratch traffic, 4 (n + 1)^3 / (3 P) bytes per
// matrix (4.1 ms at P = 64).
// Measured slower and taken out (PERF.md): the matrix held whole in the
// shared memory of a 4-CTA cluster (n 320-766), the other ranks' rows
// through distributed shared memory.  Its 30 clusters at once, each matrix's
// pivot chain and its cluster barriers (about 1.3k cycles each) set its
// pace: at n = 544, 3.7 ms against this route's 2.1 at b = 512 and 14.4
// against 8.0 at b = 2048, wide / cluster 0.37-0.86 at every b >= 512 from
// n = 320 to 687 (faster only at b <= 16, 0.11-0.54 ms against 0.17-0.86).

constexpr int WIDE_PANEL = 64;        // P: columns per panel, one trailing pass each
constexpr int WIDE_STEP = 16;         // columns per factoring step
constexpr int WIDE_THREADS = 256;     // threads per CTA: 8 warps of 16 x 32 per tile
constexpr int WIDE_TILE = 64;         // trailing-update tile: 64 x 64 outputs
constexpr int WIDE_CHUNK = 256;       // rows below the panel per chunk in shared memory
constexpr int WIDE_MAX_CLUSTER = 8;   // largest cluster the route uses (the portable limit)
constexpr int WIDE_LOADS = 8;         // global loads in flight per thread in the row loads
constexpr int WIDE_STAGES = 2;        // depth of the trailing update's cp.async ring
constexpr int SM_SMEM = 233472;       // bytes of shared memory per SM, 1 KB per CTA reserved
// the trailing update's product: 3xTF32 on the tensor cores (true) or FP32
// FMA (false; PERF.md has both)
constexpr bool kWideTensorCores = true;
constexpr int WLD = WIDE_PANEL + 4;   // row stride of panel rows and L tiles (16-byte rows)
constexpr int WSLD = WIDE_TILE + 4;   // row stride of a scratch tile
constexpr int WDLD = WIDE_STEP + 4;   // row stride of a step's diagonal block
constexpr int WDG = WIDE_STEP * WDLD + WIDE_STEP;  // floats of a step's block, then its isq
// floats per ring stage (a tile column's L rows, the tile's entries) and
// per stage with its row buffer (a tile row's L rows)
constexpr int WIDE_STAGE = WIDE_TILE * WLD + WIDE_TILE * WSLD;
constexpr int WIDE_RING = WIDE_STAGES * (WIDE_STAGE + WIDE_TILE * WLD);
static_assert(WIDE_PANEL % WIDE_STEP == 0 && WIDE_STEP == 16, "whole steps of 16 columns");
static_assert(WIDE_TILE == 64 && WIDE_THREADS == 256, "8 warps of 16 x 32 outputs");

// floats of the part that stays put through a panel: every step's factored
// block and its isq, and the bad-pivot flag
__host__ __device__ constexpr int wide_fixed() { return (WIDE_PANEL / WIDE_STEP) * WDG + 4; }

// dynamic shared memory per CTA, the same at every n: the fixed part, then
// the panel's top rows and a chunk of the rows below, or the trailing
// update's ring stages, which reuse the same memory
__host__ __device__ constexpr int wide_bytes() {
  return 4 * (wide_fixed() + ((WIDE_PANEL + WIDE_CHUNK) * WLD > WIDE_RING
                                  ? (WIDE_PANEL + WIDE_CHUNK) * WLD
                                  : WIDE_RING));
}
static_assert(wide_bytes() <= SMEM_LIMIT, "one CTA's shared memory");

// floats of one matrix's scratch (n + 1 rows), its row stride, entry (i, j)
__host__ __device__ constexpr int wide_ld(int n) { return align4(n + 1); }
__host__ __device__ constexpr long long wide_scratch(int n) {
  return (long long)(n + 1) * wide_ld(n);
}
__device__ __forceinline__ size_t wide_at(int i, int j, int ld) { return (size_t)i * ld + j; }

// the cluster size at batch b on a card of `sms` SMs: the smallest that
// makes b C cover the SMs, at most WIDE_MAX_CLUSTER
inline int wide_cluster_size(int b, int sms) {
  return max(1, min((sms + b - 1) / b, WIDE_MAX_CLUSTER));
}

// CTAs per SM the kernel is built for: two where the batch has more CTAs
// than the card has SMs and two CTAs' shared memory fit an SM, else one
// (which may use all the registers it wants)
inline int wide_ctas_per_sm(int b, int c, int sms) {
  return ((long long)b * c > sms && 2 * (wide_bytes() + 1024) <= SM_SMEM) ? 2 : 1;
}

// One step's diagonal block (rows and columns [cs, cs + sw) of the panel,
// row cs + lane at rows[lane WLD]), factored by one warp, right-looking with
// shuffles as in smem_factor_block: its scaled rows and 1 / sqrt(p) go
// to dgb (dg, then isq), a bad pivot raises *bad.  Adds the block's
// logarithms to the warp's logdet_half.
__device__ __forceinline__ void factor_wide_block(const float* rows, int sw, float* dgb,
                                                  int* bad, float& logdet_half) {
  constexpr int S = WIDE_STEP, LD = WDLD;
  float* dg = dgb;
  float* isq = dgb + S * LD;
  const int lane = threadIdx.x & 31;
  float x[S];
#pragma unroll
  for (int q = 0; q < S; ++q) x[q] = (q <= lane && lane < sw) ? rows[lane * WLD + q] : 0.f;
  float mine = 1.f;
  bool failed = false;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    if (j >= sw) break;
    float colj[S];
    const float p = __shfl_sync(0xffffffffu, x[j], j);
#pragma unroll
    for (int q = j + 1; q < S; ++q) colj[q] = __shfl_sync(0xffffffffu, x[j], q);
    failed |= bad_pivot(p);
    if (lane == j) mine = p;
    const float s = x[j] * __frcp_rn(p);
    if (lane > j && lane < sw) dg[lane * LD + j] = s;
#pragma unroll
    for (int q = j + 1; q < S; ++q) x[q] = fmaf(-s, colj[q], x[q]);
  }
  if (lane < sw) isq[lane] = 1.f / sqrtf(mine);
  float lg = (lane < sw) ? 0.5f * logf(mine) : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) lg += __shfl_xor_sync(0xffffffffu, lg, o);
  logdet_half += lg;
  if (failed && lane == 0) *bad = 1;
}

// One row's columns [cs, cs + sw) of a step (x = row[0 .. S)): substitution
// against the step's block dgb, then scaled to Cholesky entries, in place
__device__ __forceinline__ void wide_substitute(float* row, const float* dgb, int sw) {
  constexpr int S = WIDE_STEP, DLD = WDLD;
  const float* isq = dgb + S * DLD;
  float x[S];
#pragma unroll
  for (int q = 0; q < S; q += 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + q);
    x[q] = v.x, x[q + 1] = v.y, x[q + 2] = v.z, x[q + 3] = v.w;
  }
#pragma unroll
  for (int j = 1; j < S; ++j) {
    if (j >= sw) break;
#pragma unroll
    for (int q = 0; q < j; q += 4) {
      const float4 d4 = *reinterpret_cast<const float4*>(dgb + j * DLD + q);
      x[j] = fmaf(-x[q], d4.x, x[j]);
      if (q + 1 < j) x[j] = fmaf(-x[q + 1], d4.y, x[j]);
      if (q + 2 < j) x[j] = fmaf(-x[q + 2], d4.z, x[j]);
      if (q + 3 < j) x[j] = fmaf(-x[q + 3], d4.w, x[j]);
    }
  }
#pragma unroll
  for (int q = 0; q < S; q += 4) {
    const float4 s4 = *reinterpret_cast<const float4*>(isq + q);
    *reinterpret_cast<float4*>(row + q) =
        make_float4(q < sw ? x[q] * s4.x : 0.f, q + 1 < sw ? x[q + 1] * s4.y : 0.f,
                    q + 2 < sw ? x[q + 2] * s4.z : 0.f, q + 3 < sw ? x[q + 3] * s4.w : 0.f);
  }
}

// One row's update by a step (its Cholesky entries row[cs .. cs + S)) in
// the panel columns [jb, jb + jn), jn <= S: row[j] -= sum_q row[cs + q]
// top[j][cs + q], against the top rows' Cholesky entries (entries right of
// the diagonal are updated too, and never read)
__device__ __forceinline__ void wide_update(float* row, const float* top, int cs, int jb,
                                            int jn) {
  constexpr int S = WIDE_STEP, LD = WLD;
  float4 u[S / 4];
#pragma unroll
  for (int q = 0; q < S / 4; ++q) u[q] = *reinterpret_cast<const float4*>(row + cs + 4 * q);
  float acc[S];
#pragma unroll
  for (int jj = 0; jj < S; ++jj) {
    acc[jj] = 0.f;
    if (jj < jn) {
#pragma unroll
      for (int q = 0; q < S / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(top + (jb + jj) * LD + cs + 4 * q);
        acc[jj] = fmaf(u[q].x, v.x, acc[jj]);
        acc[jj] = fmaf(u[q].y, v.y, acc[jj]);
        acc[jj] = fmaf(u[q].z, v.z, acc[jj]);
        acc[jj] = fmaf(u[q].w, v.w, acc[jj]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < S; q += 4) {
    float4 w = *reinterpret_cast<float4*>(row + jb + q);
    w.x -= acc[q], w.y -= acc[q + 1], w.z -= acc[q + 2], w.w -= acc[q + 3];
    *reinterpret_cast<float4*>(row + jb + q) = w;
  }
}

// Rows i0 .. i0 + rows - 1 of the panel [c0, c0 + pw) into dst (stride
// WLD), zero right of the diagonal and past pw: from cov and y in the first
// panel, else from the scratch; WIDE_LOADS loads in flight per thread
__device__ __forceinline__ void wide_load_rows(float* dst, const float* a, const float* cov_b,
                                               const float* y_b, int n, int ld, int c0, int pw,
                                               int i0, int rows) {
  constexpr int P = WIDE_PANEL, LD = WLD;
  const int tid = threadIdx.x;
  if (c0 > 0 && pw == P) {
    constexpr int Q = P / 4;
    for (int e0 = tid; e0 < rows * Q; e0 += WIDE_LOADS * WIDE_THREADS) {
      float4 v[WIDE_LOADS];
#pragma unroll
      for (int u = 0; u < WIDE_LOADS; ++u) {
        const int e = e0 + u * WIDE_THREADS;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < rows * Q) {
          const int i = i0 + e / Q, j = c0 + (e % Q) * 4;
          if (j <= i) v[u] = __ldcg(reinterpret_cast<const float4*>(a + wide_at(i, j, ld)));
        }
      }
#pragma unroll
      for (int u = 0; u < WIDE_LOADS; ++u) {
        const int e = e0 + u * WIDE_THREADS;
        if (e < rows * Q) *reinterpret_cast<float4*>(dst + (e / Q) * LD + (e % Q) * 4) = v[u];
      }
    }
  } else {
    for (int e0 = tid; e0 < rows * P; e0 += WIDE_LOADS * WIDE_THREADS) {
      float v[WIDE_LOADS];
#pragma unroll
      for (int u = 0; u < WIDE_LOADS; ++u) {
        const int e = e0 + u * WIDE_THREADS;
        v[u] = 0.f;
        if (e < rows * P) {
          const int i = i0 + e / P, q = e % P, j = c0 + q;
          if (q < pw && j <= i)
            v[u] = c0 > 0 ? __ldcg(a + wide_at(i, j, ld))
                          : (i < n ? cov_b[(size_t)i * n + j] : y_b[j]);
        }
      }
#pragma unroll
      for (int u = 0; u < WIDE_LOADS; ++u) {
        const int e = e0 + u * WIDE_THREADS;
        if (e < rows * P) dst[(e / P) * LD + e % P] = v[u];
      }
    }
  }
}

// One panel's trailing update (step 3 of the route's note): this rank's
// tiles t = r, r + C, ... of the lower triangle of rows / columns [c1, n]
// (row by row, so consecutive tiles mostly share their row), through a
// ring of WIDE_STAGES stages in ring[] (the loads of the next
// WIDE_STAGES - 1 tiles in flight while one is computed).  The L rows come
// from the scratch's columns [c0, c0 + pw): a tile row's once, into the
// next of WIDE_STAGES row buffers, when the rank's tiles enter that row,
// a tile column's with each tile.  The tile's entries come from the
// scratch, or from cov and y in the first panel.
__device__ __forceinline__ void wide_trailing(float* ring, float* a, const float* cov_b,
                                              const float* y_b, int n, int ld, int c0, int pw,
                                              int C, int r) {
  constexpr int P = WIDE_PANEL, T = WIDE_TILE, LD = WLD, SLD = WSLD;
  const int n1 = n + 1, c1 = c0 + pw, m = n1 - c1;
  const int nt = (m + T - 1) / T, ntile = tri(nt);
  const bool first = c0 == 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, wm = warp >> 1, wn = warp & 1;
  // the tile's entries as 16-byte copies where rows and columns allow
  const bool vec16 = (c1 % 4 == 0) && (!first || n % 4 == 0);

  auto tile_of = [&](int t, int& i0, int& j0) {
    int ti = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
    ti += (tri(ti + 1) <= t) - (tri(ti) > t);
    i0 = c1 + ti * T;
    j0 = c1 + (t - tri(ti)) * T;
  };

  // L rows i0 .. i0 + T - 1 into dst (zero past row n and past column pw)
  auto load_rows = [&](float* dst, int i0) {
    if (pw == P) {
      for (int c = tid; c < T * (P / 4); c += WIDE_THREADS) {
        const int rr = c / (P / 4), q = (c % (P / 4)) * 4, i = i0 + rr;
        const bool ok = i <= n;
        cp_async16(dst + rr * LD + q, ok ? a + wide_at(i, c0 + q, ld) : a, ok);
      }
    } else {  // the last panel: synchronous loads through L2
      for (int e = tid; e < T * P; e += WIDE_THREADS) {
        const int rr = e / P, q = e % P, i = i0 + rr;
        dst[rr * LD + q] = (i <= n && q < pw) ? __ldcg(a + wide_at(i, c0 + q, ld)) : 0.f;
      }
    }
  };

  // a stage: the tile column's L rows, then the tile's entries
  auto load = [&](float* st, int t) {
    int i0, j0;
    tile_of(t, i0, j0);
    float* sc = st + T * LD;
    load_rows(st, j0);
    // the tile's entries, lower triangle only
    if (vec16) {
      for (int c = tid; c < T * (T / 4); c += WIDE_THREADS) {
        const int rr = c / (T / 4), q = (c % (T / 4)) * 4, i = i0 + rr, j = j0 + q;
        const bool ok = i <= n && j <= i && (!first || i < n || j < n);
        const float* src = !ok ? a
                           : !first ? a + wide_at(i, j, ld)
                           : i < n ? cov_b + (size_t)i * n + j : y_b + j;
        cp_async16(sc + rr * SLD + q, src, ok);
      }
    } else if (first) {
      for (int e = tid; e < T * T; e += WIDE_THREADS) {
        const int rr = e / T, q = e % T, i = i0 + rr, j = j0 + q;
        const bool ok = i <= n && j <= i && (i < n || j < n);
        const float* src = !ok ? cov_b : i < n ? cov_b + (size_t)i * n + j : y_b + j;
        cp_async4(sc + rr * SLD + q, src, ok);
      }
    } else {  // the last panel's unaligned columns: synchronous loads through L2
      for (int e = tid; e < T * T; e += WIDE_THREADS) {
        const int rr = e / T, q = e % T, i = i0 + rr, j = j0 + q;
        sc[rr * SLD + q] = (i <= n && j <= i) ? __ldcg(a + wide_at(i, j, ld)) : 0.f;
      }
    }
  };

  auto compute = [&](const float* li, const float* st, int t) {
    int i0, j0;
    tile_of(t, i0, j0);
    const float* lk = st;
    const float* sc = st + T * LD;
    // fragment element e of n-tile ni: row wm 16 + g + 8 (e >> 1), column
    // wn 32 + ni 8 + 2 t4 + (e & 1)
    float acc[4][4];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;
    // a diagonal tile's warp above the diagonal has nothing to do
    const bool idle = i0 == j0 && wn * 32 > wm * 16 + 15;
    if (!idle) {
      if constexpr (kWideTensorCores) {
#pragma unroll 2
        for (int kk = 0; kk < P / 8; ++kk) {
          if (kk * 8 >= pw) break;
          const float* ar = li + (wm * 16 + g) * LD + kk * 8 + t4;
          uint32_t ah[4], al[4];
          split_tf32(ar[0], ah[0], al[0]);
          split_tf32(ar[8 * LD], ah[1], al[1]);
          split_tf32(ar[4], ah[2], al[2]);
          split_tf32(ar[8 * LD + 4], ah[3], al[3]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const float* br = lk + (wn * 32 + ni * 8 + g) * LD + kk * 8 + t4;
            uint32_t bh[2], bl[2];
            split_tf32(br[0], bh[0], bl[0]);
            split_tf32(br[4], bh[1], bl[1]);
            // the tensor cores' sums are not rounded to nearest: each step's
            // products go into a fresh fragment, then into acc in FP32
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(part, al, bh);  // small terms first
            mma_tf32(part, ah, bl);
            mma_tf32(part, ah, bh);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[ni][e] += part[e];
          }
        }
      } else {
        for (int q = 0; q < pw; ++q) {
          const float a0 = li[(wm * 16 + g) * LD + q], a1 = li[(wm * 16 + g + 8) * LD + q];
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int cb = wn * 32 + ni * 8 + 2 * t4;
            const float b0 = lk[cb * LD + q], b1 = lk[(cb + 1) * LD + q];
            acc[ni][0] = fmaf(a0, b0, acc[ni][0]);
            acc[ni][1] = fmaf(a0, b1, acc[ni][1]);
            acc[ni][2] = fmaf(a1, b0, acc[ni][2]);
            acc[ni][3] = fmaf(a1, b1, acc[ni][3]);
          }
        }
      }
    }
    // two neighbouring columns per store where both are in the triangle
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = wm * 16 + g + 8 * h, cc = wn * 32 + ni * 8 + 2 * t4;
        const int i = i0 + rr, j = j0 + cc;
        if (i > n || j > i) continue;
        const float v0 = sc[rr * SLD + cc] - acc[ni][2 * h];
        float* dst = a + wide_at(i, j, ld);
        if (j + 1 <= i && (j & 1) == 0) {
          *reinterpret_cast<float2*>(dst) =
              make_float2(v0, sc[rr * SLD + cc + 1] - acc[ni][2 * h + 1]);
        } else {
          dst[0] = v0;
          if (j + 1 <= i) dst[1] = sc[rr * SLD + cc + 1] - acc[ni][2 * h + 1];
        }
      }
  };

  // A tile row's L rows go to the next row buffer (of NS, in turn) when a
  // tile of a new row is issued; the buffer it overwrites was issued NS
  // rows ago, for a tile computed before this iteration's barrier.
  constexpr int NS = WIDE_STAGES;
  float* rows = ring;                 // NS row buffers of T x LD
  float* stages = ring + NS * T * LD; // NS stages of WIDE_STAGE
  int row_issued = -1, buf = NS - 1;  // the last issued tile row, its buffer
  unsigned bufs = 0;                  // row buffer of the tile in stage s: 4 bits at 4 s
  auto issue = [&](int s, int t) {
    int i0, j0;
    tile_of(t, i0, j0);
    if (i0 != row_issued) {
      row_issued = i0;
      buf = (buf + 1) % NS;
      load_rows(rows + buf * T * LD, i0);
    }
    bufs = (bufs & ~(0xFu << (4 * s))) | ((unsigned)buf << (4 * s));
    load(stages + s * WIDE_STAGE, t);
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (r + s * C < ntile) issue(s, r + s * C);
    cp_async_commit();
  }
  for (int it = 0, t = r; t < ntile; ++it, t += C) {
    const int ahead = t + (NS - 1) * C;
    if (ahead < ntile) issue((it + NS - 1) % NS, ahead);
    cp_async_commit();
    cp_async_wait<NS - 1>();
    __syncthreads();  // this tile's stage and row buffer have landed, for every thread
    const int s = it % NS;
    compute(rows + ((bufs >> (4 * s)) & 0xFu) * T * LD, stages + s * WIDE_STAGE, t);
    __syncthreads();  // its stage may be refilled
  }
  cp_async_wait<0>();
}


// The wide route (the section's note): one matrix per cluster of C CTAs,
// built for kCtasPerSm CTAs per SM.  Per panel two cluster barriers: C
// after the panel's Cholesky rows are in the scratch, D after the trailing
// update.  A bad pivot is met by every rank at the same step of phase 1;
// all ranks leave the panel loop there, and every exit goes through the
// final cluster barrier.
template <int kCtasPerSm>
__global__ void __launch_bounds__(WIDE_THREADS, kCtasPerSm)
mvn_wide_kernel(const float* __restrict__ y,    // (b, n)
                const float* __restrict__ cov,  // (b, n, n)
                float* __restrict__ scratch,    // (b, wide_scratch(n)), uninitialised
                float* __restrict__ out,        // (b,)
                int n) {
  constexpr int P = WIDE_PANEL, S = WIDE_STEP, LD = WLD;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int mat = blockIdx.x / C;
  extern __shared__ __align__(16) float sm[];
  float* dgs = sm;                          // step s's block at dgs + s WDG
  int* bad = reinterpret_cast<int*>(sm + wide_fixed() - 4);
  float* top = sm + wide_fixed();           // the panel's top rows c0 .. c1 - 1 (stride LD)
  float* pan = top + P * LD;                // a chunk of the rows below (stride LD)
  float* ring = top;                        // the trailing update's ring, over both
  const int n1 = n + 1, ld = wide_ld(n);
  const int tid = threadIdx.x, warp = tid >> 5;
  const float* cov_b = cov + (size_t)mat * n * n;
  const float* y_b = y + (size_t)mat * n;
  float* a = scratch + (size_t)mat * wide_scratch(n);

  if (tid == 0) *bad = 0;
  __syncthreads();

  float logdet_half = 0.f;  // warp 0's sum over the diagonal blocks (the same in every rank)
  for (int c0 = 0; c0 < n; c0 += P) {
    const int pw = min(P, n - c0), c1 = c0 + pw, nsteps = (pw + S - 1) / S;

    // 1. the top rows in steps of S columns [cs, cs1) (offsets in the panel)
    wide_load_rows(top, a, cov_b, y_b, n, ld, c0, pw, c0, pw);
    __syncthreads();
    for (int s = 0; s < nsteps; ++s) {
      const int cs = s * S, sw = min(S, pw - cs), cs1 = cs + sw;
      float* dgb = dgs + s * WDG;
      if (warp == 0) factor_wide_block(top + cs * LD + cs, sw, dgb, bad, logdet_half);
      __syncthreads();
      if (*bad) break;  // the same flag in every thread of every rank
      for (int lr = cs1 + tid; lr < pw; lr += WIDE_THREADS)
        wide_substitute(top + lr * LD + cs, dgb, sw);
      __syncthreads();
      // the step's update of the top rows below it, S columns per item
      const int nch = (pw - cs1 + S - 1) / S;
      for (int e = tid; e < (pw - cs1) * nch; e += WIDE_THREADS) {
        const int lr = cs1 + e / nch, jb = cs1 + (e % nch) * S;
        wide_update(top + lr * LD, top, cs, jb, min(S, pw - jb));
      }
      __syncthreads();
    }
    if (*bad) break;

    // 2. this rank's chunks of the rows below, a thread per row through
    // every step, then their Cholesky entries into the scratch
    for (int i0 = c1 + r * WIDE_CHUNK; i0 < n1; i0 += C * WIDE_CHUNK) {
      const int rows = min(WIDE_CHUNK, n1 - i0);
      wide_load_rows(pan, a, cov_b, y_b, n, ld, c0, pw, i0, rows);
      __syncthreads();
      for (int lr = tid; lr < rows; lr += WIDE_THREADS) {
        float* row = pan + lr * LD;
        for (int s = 0; s < nsteps; ++s) {
          const int cs = s * S, sw = min(S, pw - cs);
          wide_substitute(row + cs, dgs + s * WDG, sw);
          for (int jb = cs + sw; jb < pw; jb += S) wide_update(row, top, cs, jb, min(S, pw - jb));
        }
      }
      __syncthreads();
      for (int e = tid; e < rows * (P / 4); e += WIDE_THREADS) {
        const int lr = e / (P / 4), q = (e % (P / 4)) * 4;
        if (q >= pw) continue;
        const float* src = pan + lr * LD + q;
        float* dst = a + wide_at(i0 + lr, c0 + q, ld);
        if (q + 4 <= pw) {
          __stcg(reinterpret_cast<float4*>(dst), *reinterpret_cast<const float4*>(src));
        } else {
          for (int k = 0; k < pw - q; ++k) __stcg(dst + k, src[k]);
        }
      }
      __syncthreads();  // the chunk may be refilled
    }
    __threadfence();
    cluster_arrive();  // barrier C: the panel is in device memory; top and pan become the ring
    cluster_wait();

    // 3. the trailing update
    wide_trailing(ring, a, cov_b, y_b, n, ld, c0, pw, C, r);
    __threadfence();
    cluster_arrive();  // barrier D: the trailing matrix is written
    cluster_wait();
  }

  cluster.sync();  // every rank leaves the panel loop at the same panel
  if (r == 0 && tid == 0) {
    const float lp = 0.5f * __ldcg(a + wide_at(n, n, ld)) - logdet_half;
    out[mat] = (!*bad && isfinite(lp)) ? lp : -CUDART_INF_F;
  }
}

using WideKernel = void (*)(const float*, const float*, float*, float*, int);

WideKernel wide_kernel(int ctas_per_sm) {
  return ctas_per_sm == 2 ? mvn_wide_kernel<2> : mvn_wide_kernel<1>;
}

// the card's SM count (the current device), -1 if it cannot be asked
int device_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  return sms;
}

// The wide route's launch at batch b: the cluster size, the kernel built for
// the CTAs per SM the batch asks for, its shared memory (the whole L1/shared
// array as shared memory).  The card's SM count comes from the device.
struct WideLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  WideKernel kernel;
  cudaError_t err;
  WideLaunch(int b, int sms, cudaStream_t stream)
      : attr(), cfg(),
        kernel(wide_kernel(wide_ctas_per_sm(b, wide_cluster_size(b, sms), sms))) {
    const int c = wide_cluster_size(b, sms);  // b clusters of c CTAs
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3((unsigned)b * c);
    cfg.blockDim = dim3(WIDE_THREADS);
    cfg.dynamicSmemBytes = wide_bytes();
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 wide_bytes());
  }
};

using WarpKernel = void (*)(const float*, const float*, float*, int, int);

WarpKernel warp_kernel(int n) { return n <= 16 ? mvn_warp_kernel<16> : mvn_warp_kernel<32>; }

}  // namespace

extern "C" {

// Largest n each route takes (its shared-memory need within one block's limit).
int fused_mvn_smem_max_n() {
  int n = 1;
  while (smem_bytes(n + 1) <= SMEM_LIMIT) ++n;
  return n;
}

// Panel width of the shared-memory route (where its panel boundaries fall).
int fused_mvn_smem_panel() { return SMEM_PANEL; }

// Matrices of the shared-memory route that one SM holds at once at this n
// (warps of the warp route, blocks of the block route: its occupancy, for
// the measurement scripts); -1 if it cannot be asked.
int fused_mvn_smem_matrices_per_sm(int n) {
  if (n < 1 || smem_bytes(n) > SMEM_LIMIT) return -1;
  if (n <= WARP_MAX_N) {
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, warp_kernel(n), 32 * WARP_WARPS,
                                                      0) != cudaSuccess)
      return -1;
    return blocks * WARP_WARPS;
  }
  const int bytes = (int)smem_bytes(n);
  int blocks = 0;
  if (prepare_smem(smem_kernel(n), bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, smem_kernel(n), smem_threads(n),
                                                    bytes) != cudaSuccess)
    return -1;
  return blocks;
}

// Diagnostic builds (kSmemPhaseClock): g_smem_phase since the last call
// (the cycles thread 0 and thread 32 of the block route's blocks spent in
// each phase, summed over blocks, then the blocks counted); clears it.
int fused_mvn_smem_phase_cycles(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_smem_phase, sizeof(g_smem_phase));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[2 * kSmemPhases + 1] = {};
  return (int)cudaMemcpyToSymbol(g_smem_phase, zero, sizeof(zero));
}

int fused_mvn_loglike_smem(const float* y, const float* cov, float* out,
                           int b, int n, void* stream) {
  if (b < 1 || n < 1 || smem_bytes(n) > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= WARP_MAX_N) {
    warp_kernel(n)<<<(b + WARP_WARPS - 1) / WARP_WARPS, 32 * WARP_WARPS, 0, s>>>(y, cov, out, b,
                                                                               n);
    return (int)cudaGetLastError();
  }
  const int bytes = (int)smem_bytes(n);
  const cudaError_t e = prepare_smem(smem_kernel(n), bytes);
  if (e != cudaSuccess) return (int)e;
  smem_kernel(n)<<<b, smem_threads(n), bytes, s>>>(y, cov, out, n);
  return (int)cudaGetLastError();
}

// Wide route ("panel" in the wrapper and the registry): its panel width,
// the card's SM count, the cluster size and the CTAs per SM the kernel is
// built for at batch b, the dynamic shared memory per CTA (the same at
// every n), the floats of one matrix's scratch, and the clusters the card
// holds at once at batch b (-1 where it cannot be asked).  It takes every
// n >= 1.
int fused_mvn_panel_width() { return WIDE_PANEL; }

int fused_mvn_panel_sms() { return device_sms(); }

int fused_mvn_panel_cluster(int b) {
  const int sms = device_sms();
  return b < 1 || sms < 1 ? -1 : wide_cluster_size(b, sms);
}

int fused_mvn_panel_ctas_per_sm(int b) {
  const int sms = device_sms();
  return b < 1 || sms < 1 ? -1 : wide_ctas_per_sm(b, wide_cluster_size(b, sms), sms);
}

int fused_mvn_panel_bytes() { return wide_bytes(); }

long long fused_mvn_panel_scratch(int n) { return n < 1 ? -1 : wide_scratch(n); }

int fused_mvn_panel_active(int b) {
  const int sms = device_sms();
  if (b < 1 || sms < 1) return -1;
  WideLaunch w(b, sms, 0);
  int clusters = 0;
  if (w.err != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&clusters, w.kernel, &w.cfg) != cudaSuccess)
    return -1;
  return clusters;
}

// scratch: (b, fused_mvn_panel_scratch(n)) floats, uninitialised
int fused_mvn_loglike_panel(const float* y, const float* cov, float* scratch,
                            float* out, int b, int n, void* stream) {
  const int sms = device_sms();
  if (b < 1 || n < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  WideLaunch w(b, sms, static_cast<cudaStream_t>(stream));
  if (w.err != cudaSuccess) return (int)w.err;
  const cudaError_t e = cudaLaunchKernelEx(&w.cfg, w.kernel, y, cov, scratch, out, n);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
