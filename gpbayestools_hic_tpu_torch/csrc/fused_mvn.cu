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
// sequential in k, so one thread block (or one cluster) owns one matrix
// and the batch fills the card.  All routes are the reference's blocked
// right-looking form
// (pallas_mvn.py:_mvn_kernel, PANEL 32): factor a panel of columns, then
// apply its cumulative trailing update
//     A[i][j] -= sum_k P[i][k] P[j][k] / p_k      (k in the panel, j <= i)
// as one matrix product.  Trailing entries at or left of the panel go
// stale and are never read again: a later step only reads columns > k.
// Three routes, picked by the wrapper from n:
//
// - mvn_smem_kernel, n <= fused_mvn_smem_max_n() (319): the lower triangle
//   of the augmented matrix lives packed in the block's shared memory
//   (A[i][j] at i(i+1)/2 + j), beside a copy of the current panel;
//   n = 170 takes 73.9 KB, so three blocks share an SM's 227 KB and hide
//   each other's barriers.  Only the lower triangle of cov is read from
//   device memory, once, with several loads in flight per thread.  Bound
//   on the H100 at n = 170: n^3/3 FP32 flops, 0.026 ms per 1024 matrices,
//   against 0.018 ms for the bytes.  What held the rank-1 form back was
//   shared-memory traffic (each trailing entry read and written once per
//   pivot) and a block barrier per pivot.  Per panel of SMEM_PANEL columns
//   the kernel
//     1. factors the panel's diagonal block in one warp, right-looking:
//        lane r holds row c0 + r in registers and takes the pivot and the
//        other rows' column j by shuffle, so the chain per pivot is a
//        shuffle, a reciprocal and two FMAs, with no shared memory and no
//        barrier in it; the logarithms and 1 / sqrt(p) come after it, one
//        lane per pivot;
//     2. finishes the panel's rows below it, a thread per row, by the
//        substitution x_j -= sum_{k<j} x_k D[j][k] / p_k against the
//        factored block (read four entries at a time, a broadcast), and
//        writes them as Cholesky entries L[i][k] = x_k / sqrt(p_k) into the
//        panel copy, whose 16-byte rows make the trailing update one
//        symmetric product L L^T with no scaling in its loop;
//     3. applies the trailing update in 32 x 32 tiles, four tiles at a
//        time, 4 x 4 outputs per thread in registers, both operands read
//        four panel columns at a time (a warp's rows at a stride of
//        SMEM_PANEL + 4 floats fall in distinct banks): each trailing entry
//        is read and written once per panel, and there are three block
//        barriers per panel instead of one per pivot.
//   A bad pivot is found by the factoring warp, which raises a flag in
//   shared memory; every thread reads it after the next barrier and leaves.
//   FP32 FMA throughout (1.7 GFLOP per 1024 matrices at n = 170 does not
//   need the tensor cores).
// - mvn_cluster_kernel, n <= fused_mvn_cluster_max_n() (766; the stitched
//   544 x 544 likelihood, 1.19 MB per matrix, 595 KB as a packed triangle):
//   the matrix too large for one SM's shared memory is held in the shared
//   memory of a thread-block cluster of C = 2 .. 8 CTAs (4 at n = 544, one
//   per SM), rows dealt out block-cyclically in 16-row blocks, and
//   eliminated in the shared-memory route's order: per 16-column panel the
//   diagonal block's owner factors it in one warp and copies it to the
//   other CTAs through distributed shared memory (DSMEM), every CTA
//   finishes its rows below it and writes their Cholesky entries into every
//   CTA's panel copy, and every CTA applies the trailing update to its own
//   rows out of its own shared memory; two cluster barriers per panel.  cov
//   is read from device memory once and there is no scratch.  The owner of
//   the next diagonal block updates and factors it while the others do the
//   trailing update (look-ahead).  At n = 544 the card holds 30 clusters of
//   four at once (cudaOccupancyMaxActiveClusters, H100 SXM), so 512
//   matrices take 18 rounds of 34 panels; the chain of the warp's pivots
//   and the cluster barriers, not the FMAs, set the pace (bound by FP32
//   operations: 0.41 ms per 512 matrices; the route takes about 4.9).
// - mvn_panel_kernel, larger n (up to 1759): blocked right-looking
//   elimination.  A 32-column panel of
//   the rows below it is held in shared memory (545 x 33 floats = 72 KB),
//   factored there with the rank-1 loop, and its cumulative trailing update
//       A[i][j] -= sum_k P[i][k] P[j][k] / p_k
//   is applied to a scratch copy of the matrix in device memory in 64 x 64
//   tiles, 4 x 4 outputs per thread in registers, both operands read from
//   the shared panel.  The scratch is read and written once per panel
//   (n / 32 times in all) instead of once per pivot; the route is bound by
//   FP32 operations (n^3/3 flops per matrix).  The first panel
//   reads cov and y directly, so the scratch needs no initialisation.
//
// Each entry launches on the caller's stream, allocates nothing (the
// wrapper allocates the output, and the panel route's scratch), and returns
// the launch's error.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int SMEM_PANEL = 16;     // panel width of the shared-memory route
constexpr int NT = 256;            // threads per block (panel route)
constexpr int PANEL = 32;          // panel width (panel route)
constexpr int PLD = PANEL + 1;     // panel row stride (odd: no bank conflicts)
constexpr int TILE = 64;           // trailing-update tile, 16 x 16 threads x (4 x 4)
constexpr int SMEM_LIMIT = 232448; // bytes of shared memory one block may use

// entry (i, j), j <= i, of the augmented matrix [[C, y], [y^T, 0]]
__device__ __forceinline__ float aug_entry(const float* __restrict__ cov,
                                           const float* __restrict__ y,
                                           int n, int i, int j) {
  if (i < n) return cov[(size_t)i * n + j];
  return (j < n) ? y[j] : 0.f;
}

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

__host__ __device__ constexpr long long panel_bytes(int n) {
  return ((long long)(n + 1) * PLD + PANEL) * 4;
}

// Entries [e_begin, e_end) of the packed lower triangle of the augmented
// matrix into dst: entry e of the triangle is A[i][e - tri(i)] and lands in
// dst[e - e_begin].  Each thread keeps kLoads global loads in flight (one
// latency per batch, not per row), neighbouring threads read neighbouring
// entries of a row.
template <int kLoads = 8>
__device__ __forceinline__ void load_packed_rows(float* dst, const float* __restrict__ cov_b,
                                                 const float* __restrict__ y_b, int n,
                                                 int e_begin, int e_end) {
  const int nthreads = blockDim.x;
  for (int e0 = e_begin + threadIdx.x; e0 < e_end; e0 += kLoads * nthreads) {
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * nthreads;
      v[u] = 0.f;
      if (e < e_end) {
        int i = (int)((sqrtf(8.f * e + 1.f) - 1.f) * 0.5f);  // row of e, then exact
        i += (tri(i + 1) <= e) - (tri(i) > e);
        const int j = e - tri(i);
        if (i < n) v[u] = cov_b[(size_t)i * n + j];
        else if (j < n) v[u] = y_b[j];
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * nthreads;
      if (e < e_end) dst[e - e_begin] = v[u];
    }
  }
}

// The whole packed lower triangle of the augmented matrix into a.
__device__ __forceinline__ void load_triangle(float* a, const float* __restrict__ cov_b,
                                              const float* __restrict__ y_b, int n) {
  load_packed_rows(a, cov_b, y_b, n, 0, tri(n + 1));
}

// Blocked elimination in shared memory (the route's header note above),
// P = SMEM_PANEL columns per panel.  Shared memory, in floats: the packed triangle; the
// panel's rows c1 .. n as Cholesky entries l[(i - c1) LD + q] =
// A[i][c0 + q] / sqrt(p_q) (16-byte rows, zero past the panel's width); the
// diagonal block's scaled rows dg[r LD + q] = A[c0 + r][c0 + q] / p_q,
// q < r; the panel's 1 / sqrt(p); the bad-pivot flag.
__global__ void __launch_bounds__(256, 3)
mvn_smem_kernel(const float* __restrict__ y,    // (b, n)
                const float* __restrict__ cov,  // (b, n, n)
                float* __restrict__ out,        // (b,)
                int n) {
  constexpr int P = SMEM_PANEL, LD = P + 4;
  static_assert(P % 4 == 0 && P <= 32, "whole float4 columns, one warp's lanes");
  extern __shared__ __align__(16) float a[];  // rows 0 .. n of the lower triangle, packed
  const int n1 = n + 1;
  float* l = a + tri_aligned(n1);
  float* dg = l + (size_t)n1 * LD;
  float* isq = dg + P * LD;
  int* bad = reinterpret_cast<int*>(isq + P);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* cov_b = cov + (size_t)blockIdx.x * n * n;
  const float* y_b = y + (size_t)blockIdx.x * n;

  load_triangle(a, cov_b, y_b, n);
  if (tid == 0) *bad = 0;

  float logdet_half = 0.f;  // warp 0's sum
  for (int c0 = 0; c0 < n; c0 += P) {
    const int pw = min(P, n - c0), c1 = c0 + pw;
    __syncthreads();  // the load or the previous trailing update is written

    // 1. the diagonal block, one warp, right-looking: lane r holds row
    // c0 + r in registers; at pivot j it takes p_j and the other rows'
    // column j by shuffle and updates its columns right of j.  The chain
    // per pivot is a shuffle, a reciprocal and two FMAs; the logarithms and
    // 1 / sqrt(p) come after, a lane each.
    if (warp == 0) {
      float x[P];
#pragma unroll
      for (int q = 0; q < P; ++q) x[q] = (q <= lane && lane < pw) ? a[tri(c0 + lane) + c0 + q] : 0.f;
      float mine = 1.f;  // lane r's pivot p_r
#pragma unroll
      for (int j = 0; j < P; ++j) {
        if (j >= pw) break;
        const float p = __shfl_sync(0xffffffffu, x[j], j);  // lane j's diagonal
        if (bad_pivot(p)) {  // the same p in every lane
          if (lane == 0) *bad = 1;
          break;
        }
        if (lane == j) mine = p;
        const float s = x[j] * __frcp_rn(p);  // this row's multiplier A[r][j] / p_j
        if (lane > j && lane < pw) dg[lane * LD + j] = s;
        // A[r][q] -= A[r][j] A[q][j] / p_j with A[q][j] from lane q (past
        // the row's end the entries are never read)
#pragma unroll
        for (int q = j + 1; q < P; ++q) x[q] = fmaf(-s, __shfl_sync(0xffffffffu, x[j], q), x[q]);
      }
      if (lane < pw) isq[lane] = 1.f / sqrtf(mine);
      float lg = (lane < pw) ? 0.5f * logf(mine) : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) lg += __shfl_xor_sync(0xffffffffu, lg, o);
      logdet_half += lg;  // a bad pivot's panel ends the matrix anyway
    }
    __syncthreads();
    if (*bad) break;  // every thread reads the same flag: a uniform exit

    // 2. the panel's rows below it, a thread per row: the substitution
    // against the factored block (its scaled rows read four at a time, a
    // broadcast), then the row's Cholesky entries into l
    for (int i = c1 + tid; i <= n; i += nthreads) {
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
    __syncthreads();

    // 3. trailing update of rows / columns [c1, n], A[i][j] -= sum_q
    // L[i][q] L[j][q], in 32 x 32 tiles of the lower triangle, a group of
    // 64 threads per tile, 4 x 4 outputs per thread (rows ty + 8 r, columns
    // tx + 8 c), both operands read from l four columns at a time (a warp's
    // 8 rows at a 16-byte stride of LD fall in distinct banks)
    const int m = n1 - c1;
    const int nt = (m + 31) / 32, ntile = tri(nt);
    const int tx = tid & 7, ty = (tid >> 3) & 7;
    for (int t = tid >> 6; t < ntile; t += nthreads >> 6) {
      int ti = 0;
      while (tri(ti + 1) <= t) ++ti;
      const int r0 = ti * 32 + ty, s0 = (t - tri(ti)) * 32 + tx;
      int lu[4], lv[4];  // rows of l
#pragma unroll
      for (int r = 0; r < 4; ++r) lu[r] = min(r0 + 8 * r, m - 1) * LD;
#pragma unroll
      for (int c = 0; c < 4; ++c) lv[c] = min(s0 + 8 * c, m - 1) * LD;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll
      for (int q = 0; q < P; q += 4) {
        if (q >= pw) break;
        float4 u[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) u[r] = *reinterpret_cast<const float4*>(l + lu[r] + q);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float4 v = *reinterpret_cast<const float4*>(l + lv[c] + q);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[r][c] = fmaf(u[r].x, v.x, acc[r][c]);
            acc[r][c] = fmaf(u[r].y, v.y, acc[r][c]);
            acc[r][c] = fmaf(u[r].z, v.z, acc[r][c]);
            acc[r][c] = fmaf(u[r].w, v.w, acc[r][c]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ri = r0 + 8 * r;
        if (ri >= m) break;
        float* row = a + tri(c1 + ri) + c1;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int rj = s0 + 8 * c;
          if (rj <= ri) row[rj] -= acc[r][c];
        }
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    const float lp = 0.5f * a[tri(n) + n] - logdet_half;
    out[blockIdx.x] = (!*bad && isfinite(lp)) ? lp : -CUDART_INF_F;
  }
}

// threads per block: whole groups of 64 for the trailing tiles, at most
// 256 (four tiles at a time); enough for the panel rows of a mid-size n
constexpr int smem_threads(int n) {
  return n < 32 ? 64 : n < 64 ? 128 : 256;
}

// Shared memory for one block, and the whole L1/shared array as shared
// memory: without the carveout the runtime may size it for one block only.
cudaError_t prepare_smem(int bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      mvn_smem_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && bytes > 48 * 1024)
    e = cudaFuncSetAttribute(
        mvn_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return e;
}

// ---------------------------------------------------------------- cluster route
//
// One thread-block cluster of C CTAs (C = cluster_size(n), the smallest of
// 2 .. 8 whose shared memory holds the matrix) per matrix.  Rows of the
// augmented matrix are dealt out block-cyclically in P-row blocks: rows
// [kP, kP + P) belong to rank k mod C, so every rank keeps work up to the
// last panels.  Each rank keeps its rows packed (row by row, the lower
// triangle only) behind a table of where each row starts; all ranks keep
// the same "common" part at the same offsets, so that a rank can address
// another's with map_shared_rank: the panel copy of Cholesky entries
// (rows c1 .. n, stride P + 4), the factored diagonal block and its
// 1 / sqrt(p), the reduction slots and the bad-pivot flag.

constexpr int CLUSTER_PANEL = 16;    // panel width = row-block height of the cluster route
constexpr int CLUSTER_THREADS = 512; // threads per CTA (cluster route)
constexpr int CLUSTER_MAX = 8;       // largest cluster the route uses (the portable limit)
constexpr int CLUSTER_LOADS = 8;     // global loads in flight per thread in the load

// floats of the part every rank keeps at the same offsets: the panel copy
// l (n1 rows of P + 4), two buffers of the diagonal block dg (P rows of
// P + 4) and its isq (P), CLUSTER_MAX + 1 reduction slots and two flags,
// padded to a whole float4
__host__ __device__ constexpr int cluster_common(int n1) {
  return n1 * (CLUSTER_PANEL + 4) + 2 * (CLUSTER_PANEL * (CLUSTER_PANEL + 4) + CLUSTER_PANEL) +
         align4(CLUSTER_MAX + 3);
}

// rows and packed-triangle floats of rank r in a cluster of c
__host__ __device__ inline void cluster_share(int n1, int c, int r, int& rows, int& floats) {
  rows = floats = 0;
  for (int i0 = r * CLUSTER_PANEL; i0 < n1; i0 += c * CLUSTER_PANEL) {
    const int i1 = min(i0 + CLUSTER_PANEL, n1);
    rows += i1 - i0;
    floats += tri(i1) - tri(i0);
  }
}

// dynamic shared memory per CTA: the common part, then the largest rank's
// row table and packed rows
inline long long cluster_bytes(int n, int c) {
  const int n1 = n + 1;
  int worst = 0;
  for (int r = 0; r < c; ++r) {
    int rows, floats;
    cluster_share(n1, c, r, rows, floats);
    worst = max(worst, align4(rows) + align4(floats));
  }
  return 4LL * (cluster_common(n1) + worst);
}

// the smallest cluster whose shared memory holds the matrix; -1 if none
inline int cluster_size(int n) {
  for (int c = 2; c <= CLUSTER_MAX; ++c)
    if (cluster_bytes(n, c) <= SMEM_LIMIT) return c;
  return -1;
}

// Diagnostic builds set kPhaseClock: thread 0 of every CTA then adds the
// SM clock cycles it spends in each phase of the cluster kernel to
// g_cluster_phase, then the CTAs counted, then the cycles of the parts of
// the diagonal block's factoring (fused_mvn_cluster_phase_cycles reads and
// clears them).
constexpr bool kPhaseClock = false;
// phases: load, barrier A, substitution, its broadcast, barrier B, trailing
// update, CTA barrier, look-ahead factoring (with its update), exit
constexpr int kPhases = 9;
// parts of the factoring: rows and update, pivots, logarithms, broadcast
constexpr int kFactorParts = 4;
__device__ unsigned long long g_cluster_phase[kPhases + 1 + kFactorParts];

// the pivot loop of factor_diagonal_block takes each column of the block
// by shuffles, all issued before the column's FMAs (false), or through
// shared memory (true: one store and P / 4 broadcast loads per column;
// measured 1.5% slower at n = 544, PERF.md)
constexpr bool kPivotColumnInSmem = false;
// the factored block reaches the other ranks in one copy after the pivot
// loop (false), or entry by entry as the loop makes it (true: remote
// stores in the chain of pivots; measured 47% slower at n = 544, PERF.md)
constexpr bool kBroadcastInLoop = false;

// One panel's diagonal block, factored by one warp of its owner out of the
// owner's rows (the shared-memory route's right-looking shuffle code, lane
// r holding row r); its scaled rows, 1 / sqrt(p) (buffer dgb: dg then isq)
// and a bad pivot (flag *bad) are then copied into every rank of the
// cluster.  Adds the block's logarithms to lane 0's logdet_half.  There is
// no early exit at a bad pivot (the same p in every lane): the chain stays
// free of branches, and whatever follows a bad pivot is discarded.
//
// With lprev (look-ahead), the previous panel's update of the block is
// applied first, as the rows are read: lprev holds that panel's Cholesky
// rows from the block's first row on, the owner's own, and each entry gets
// the same sum in the same order as a trailing tile would give it.  Rows
// of the block past the panel (the y row, at the last panel) are written
// back updated.
__device__ __forceinline__ void factor_diagonal_block(
    const cooperative_groups::cluster_group& cluster, float* a, const int* rowstart,
    const float* lprev, float* dgb, int* bad, int k, int n, int C, int r,
    float& logdet_half) {
  constexpr int P = CLUSTER_PANEL, LD = P + 4;
  float* dg = dgb;
  float* isq = dgb + P * LD;
  const int lane = threadIdx.x & 31;
  const int c0 = k * P, pw = min(P, n - c0), rows = min(P, n + 1 - c0);
  long long clock_last = kPhaseClock ? clock64() : 0;
  auto part = [&](int i) {
    if (kPhaseClock && threadIdx.x == 0) {
      const long long now = clock64();
      atomicAdd(&g_cluster_phase[kPhases + 1 + i], (unsigned long long)(now - clock_last));
      clock_last = now;
    }
  };
  float* row = (lane < rows) ? a + rowstart[(k / C) * P + lane] + c0 : a;
  float x[P];
#pragma unroll
  for (int q = 0; q < P; ++q) x[q] = (q <= lane && lane < rows) ? row[q] : 0.f;
  if (lprev != nullptr && lane < rows) {
    float4 u[P / 4];
#pragma unroll
    for (int q = 0; q < P / 4; ++q) u[q] = *reinterpret_cast<const float4*>(lprev + lane * LD + 4 * q);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < P / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(lprev + j * LD + 4 * q);
        acc = fmaf(u[q].x, v.x, acc);
        acc = fmaf(u[q].y, v.y, acc);
        acc = fmaf(u[q].z, v.z, acc);
        acc = fmaf(u[q].w, v.w, acc);
      }
      if (j <= lane) x[j] -= acc;
    }
    if (lane >= pw) {
#pragma unroll
      for (int q = 0; q < P; ++q)
        if (q <= lane) row[q] = x[q];
    }
  }
  part(0);
  float mine = 1.f;  // lane r's pivot p_r
  bool failed = false;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (j >= pw) break;
    float p, colj[P];  // the pivot and column j, A[q][j] from lane q
    if constexpr (kPivotColumnInSmem) {
      // column j through isq, unused until the end
      if (lane < P) isq[lane] = x[j];
      __syncwarp();
#pragma unroll
      for (int q = 0; q < P; q += 4) {
        const float4 c4 = *reinterpret_cast<const float4*>(isq + q);
        colj[q] = c4.x, colj[q + 1] = c4.y, colj[q + 2] = c4.z, colj[q + 3] = c4.w;
      }
      __syncwarp();
      p = colj[j];
    } else {
      p = __shfl_sync(0xffffffffu, x[j], j);
#pragma unroll
      for (int q = j + 1; q < P; ++q) colj[q] = __shfl_sync(0xffffffffu, x[j], q);
    }
    failed |= bad_pivot(p);
    if (lane == j) mine = p;
    const float s = x[j] * __frcp_rn(p);
    if (lane > j && lane < pw) {
      dg[lane * LD + j] = s;
      if constexpr (kBroadcastInLoop)
        for (int d = 1; d < C; ++d) cluster.map_shared_rank(dg, (r + d) % C)[lane * LD + j] = s;
    }
#pragma unroll
    for (int q = j + 1; q < P; ++q) x[q] = fmaf(-s, colj[q], x[q]);
  }
  part(1);
  if (lane < pw) isq[lane] = 1.f / sqrtf(mine);
  float lg = (lane < pw) ? 0.5f * logf(mine) : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) lg += __shfl_xor_sync(0xffffffffu, lg, o);
  logdet_half += lg;  // a bad pivot's panel ends the matrix anyway
  __syncwarp();
  part(2);
  for (int d = 1; d < C; ++d) {
    const int dst = (r + d) % C;
    if constexpr (kBroadcastInLoop) {
      if (lane < pw) cluster.map_shared_rank(isq, dst)[lane] = isq[lane];
    } else {
      float4* rdg = reinterpret_cast<float4*>(cluster.map_shared_rank(dgb, dst));
      const float4* ldg = reinterpret_cast<const float4*>(dgb);
      for (int e = lane; e < (P * LD + P) / 4; e += 32) rdg[e] = ldg[e];
    }
    if (failed && lane == 0) *cluster.map_shared_rank(bad, dst) = 1;
  }
  if (failed && lane == 0) *bad = 1;
  part(3);
}

// the split cluster barrier: arrive (releasing this thread's writes, shared
// memory of other ranks included) and wait (acquiring everyone's)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Blocked elimination of one matrix per cluster (the route's note in the
// file header).  Per panel [c0, c1) of block k, owner k mod C, two cluster
// barriers:
//   -- barrier A: the panel's factored diagonal block (dg, isq and the flag
//      in buffer k mod 2) is in every rank, and every rank is done with the
//      previous panel's trailing update (so l may be rewritten);
//   1. every rank finishes its own rows below the block by substitution and
//      writes their Cholesky entries into every rank's panel copy l;
//   -- barrier B: the whole panel is in every rank, and nobody reads the
//      previous buffer of dg any more;
//   2. every rank applies the trailing update to its own rows i >= c1,
//      columns [c1, i], in warp tiles of P rows x (512 / P) columns, 4 x 4
//      outputs per thread, operands as float4 from its local l.
// Look-ahead: the owner of the next block k + 1 holds all the Cholesky rows
// panel k's update of that block needs, its own, and its warp 0 computes
// them in the substitution.  Right after it, that warp arrives at barrier B,
// applies the update as it reads the block, factors block k + 1 and copies
// it into buffer (k + 1) mod 2 of every rank (factor_diagonal_block) while
// the cluster passes barrier B and the other warps do the trailing update,
// which skips that block.  So the serial factoring leaves the chain of barriers.
// Panel 0's block is factored before the loop.
// Only the broadcasts and the final reduction touch another rank's shared
// memory.  A bad pivot reaches every rank's flag before the barrier A that
// starts its panel; all ranks leave the loop there together, and every exit
// goes through the final cluster barrier, after which no rank touches
// another's memory.
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
mvn_cluster_kernel(const float* __restrict__ y,    // (b, n)
                   const float* __restrict__ cov,  // (b, n, n)
                   float* __restrict__ out,        // (b,)
                   int n) {
  constexpr int P = CLUSTER_PANEL, LD = P + 4, DGB = P * LD + P;
  constexpr int TY = P / 4, TX = 32 / TY, TC = 4 * TX;  // warp tile: P x TC
  static_assert(P % 4 == 0 && P <= 32 && 32 % P == 0 && TY * TX == 32,
                "whole float4 columns, one warp's lanes");
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int mat = blockIdx.x / C;
  extern __shared__ __align__(16) float sm[];
  const int n1 = n + 1;
  float* l = sm;               // l[(i - c1) LD + q] = L[i][c0 + q], i >= c1
  float* dgs = l + n1 * LD;    // two buffers: dg[r LD + q] = A[c0 + r][c0 + q] / p_q, q < r, then isq
  float* red = dgs + 2 * DGB;  // rank 0's: logdet halves by rank, then A[n][n]
  int* bad = reinterpret_cast<int*>(red + CLUSTER_MAX + 1);  // two flags
  int nrows, nfloats;
  cluster_share(n1, C, r, nrows, nfloats);
  int* rowstart = reinterpret_cast<int*>(sm + cluster_common(n1));  // by local row
  float* a = sm + cluster_common(n1) + align4(nrows);                // this rank's rows
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const float* cov_b = cov + (size_t)mat * n * n;
  const float* y_b = y + (size_t)mat * n;
  long long clock_last = kPhaseClock ? clock64() : 0, clock_acc[kPhases] = {};
  auto phase = [&](int i) {
    if (kPhaseClock && tid == 0) {
      const long long now = clock64();
      clock_acc[i] += now - clock_last;
      clock_last = now;
    }
  };

  // local row lr is global row ((lr / P) C + r) P + lr % P: local block t
  // is global block t C + r, its rows packed one after another
  const int nlb = (nrows + P - 1) / P;
  for (int lr = tid; lr < nrows; lr += nthreads) {
    const int t = lr / P;
    int base = 0;
    for (int s = 0; s < t; ++s) {
      const int i0 = (s * C + r) * P;
      base += tri(min(i0 + P, n1)) - tri(i0);
    }
    const int i0 = (t * C + r) * P;
    rowstart[lr] = base + tri(i0 + lr % P) - tri(i0);
  }
  {
    int base = 0;
    for (int t = 0; t < nlb; ++t) {
      const int i0 = (t * C + r) * P, e0 = tri(i0), e1 = tri(min(i0 + P, n1));
      load_packed_rows<CLUSTER_LOADS>(a + base, cov_b, y_b, n, e0, e1);
      base += e1 - e0;
    }
  }
  if (tid < 2) bad[tid] = 0;
  cluster.sync();  // rows and table written; every rank has started (DSMEM is live)
  phase(0);

  float logdet_half = 0.f;  // thread 0's sum over the diagonal blocks this rank owns
  const int npan = (n + P - 1) / P;
  if (r == 0 && warp == 0)
    factor_diagonal_block(cluster, a, rowstart, nullptr, dgs, bad, 0, n, C, r, logdet_half);
  for (int k = 0; k < npan; ++k) {
    const int c0 = k * P, pw = min(P, n - c0), c1 = c0 + pw;
    const float* dg = dgs + (k & 1) * DGB;
    const float* isq = dg + P * LD;
    cluster_arrive();  // A
    cluster_wait();
    phase(1);
    if (bad[k & 1]) break;  // the same flag in every rank: a uniform exit

    // 1. this rank's rows below the block: substitution against dg, then
    // their Cholesky entries into every rank's l
    const int t0 = (k > r) ? (k - r + C - 1) / C : 0;  // first local block at or after k
    for (int lr = t0 * P + tid; lr < nrows; lr += nthreads) {
      const int i = ((lr / P) * C + r) * P + lr % P;
      if (i < c1) continue;
      const float* row = a + rowstart[lr] + c0;
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
      float4 lv[P / 4];
#pragma unroll
      for (int q = 0; q < P; q += 4) {
        const float4 s4 = *reinterpret_cast<const float4*>(isq + q);
        lv[q / 4] = make_float4(q < pw ? x[q] * s4.x : 0.f, q + 1 < pw ? x[q + 1] * s4.y : 0.f,
                                q + 2 < pw ? x[q + 2] * s4.z : 0.f,
                                q + 3 < pw ? x[q + 3] * s4.w : 0.f);
      }
      phase(2);
      // every rank's copy, its own through the local pointer, the others
      // from the next rank on (so that the ranks do not all write to the
      // same one at once)
      for (int d = 0; d < C; ++d) {
        const int dst = (r + d) % C;
        float* ld = (d == 0) ? l : cluster.map_shared_rank(l, dst);
        float4* dl = reinterpret_cast<float4*>(ld + (i - c1) * LD);
#pragma unroll
        for (int q = 0; q < P / 4; ++q) dl[q] = lv[q];
      }
    }
    phase(3);
    // the next block's owner: block k + 1 is its first local block from t0
    // on, so its rows were warp 0's (lanes 0 .. P - 1) in the loop above
    const bool ahead = k + 1 < npan && r == (k + 1) % C;
    cluster_arrive();  // B
    if (ahead && warp == 0) {  // look-ahead
      __syncwarp();
      factor_diagonal_block(cluster, a, rowstart, l, dgs + ((k + 1) & 1) * DGB,
                            bad + ((k + 1) & 1), k + 1, n, C, r, logdet_half);
      phase(7);
    }
    cluster_wait();
    phase(4);

    // 2. trailing update of this rank's rows i >= c1, columns [c1, i]:
    // A[i][j] -= sum_q L[i][q] L[j][q].  The tiles of the local blocks from
    // t0 on (from t0 + 1 on for the next block's owner: block k + 1 is
    // done), counted block by block (a block's tiles: its columns [c1, its
    // last row] in TC-wide pieces), a warp per tile; the next block's
    // owner leaves its warp 0 out.
    const int tx = lane % TX, ty = lane / TX;
    int tile = ahead ? warp - 1 : warp;
    const int step = ahead ? nwarps - 1 : nwarps;
    int t = ahead ? t0 + 1 : t0, before = 0;  // current local block, tiles of the blocks before it
    for (; tile >= 0; tile += step) {
      for (; t < nlb; ++t) {
        const int rmax = min((t * C + r + 1) * P, n1) - 1;
        const int nct = (rmax >= c1) ? (rmax - c1) / TC + 1 : 0;
        if (tile < before + nct) break;
        before += nct;
      }
      if (t >= nlb) break;
      const int rb = (t * C + r) * P, j0 = c1 + (tile - before) * TC;
      int lu[4], lc[4];  // rows of l
#pragma unroll
      for (int q = 0; q < 4; ++q) lu[q] = (min(max(rb + ty + TY * q, c1), n) - c1) * LD;
#pragma unroll
      for (int c = 0; c < 4; ++c) lc[c] = (min(j0 + tx + TX * c, n) - c1) * LD;
      float acc[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[q][c] = 0.f;
#pragma unroll
      for (int q4 = 0; q4 < P; q4 += 4) {
        if (q4 >= pw) break;
        float4 u[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) u[q] = *reinterpret_cast<const float4*>(l + lu[q] + q4);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
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
        float* arow = a + rowstart[t * P + ty + TY * q];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + tx + TX * c;
          if (j <= i) arow[j] -= acc[q][c];
        }
      }
    }
    phase(5);
    __syncthreads();  // the next substitution reads rows other warps updated
    phase(6);
  }

  // the logdet halves of every rank and A[n][n] from its owner into rank
  // 0's slots; this cluster barrier is every rank's last touch of another's
  // memory (on the bad-pivot exit too)
  if (tid == 0) {
    float* red0 = cluster.map_shared_rank(red, 0);
    red0[r] = logdet_half;
    if ((n / P) % C == r) red0[CLUSTER_MAX] = a[rowstart[(n / P / C) * P + n % P] + n];
  }
  cluster.sync();
  if (r == 0 && tid == 0) {
    float half = 0.f;
    for (int s = 0; s < C; ++s) half += red[s];
    const float lp = 0.5f * red[CLUSTER_MAX] - half;
    out[mat] = (!(bad[0] | bad[1]) && isfinite(lp)) ? lp : -CUDART_INF_F;
  }
  phase(8);
  if (kPhaseClock && tid == 0) {
    for (int i = 0; i < kPhases; ++i) atomicAdd(&g_cluster_phase[i], (unsigned long long)clock_acc[i]);
    atomicAdd(&g_cluster_phase[kPhases], 1ull);
  }
}

// Shared memory for one CTA of the cluster route, and the whole L1/shared
// array as shared memory.
cudaError_t prepare_cluster(int bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      mvn_cluster_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        mvn_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return e;
}

// launch configuration of the cluster route: b clusters of c CTAs
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  ClusterLaunch(int b, int c, int bytes, cudaStream_t stream) : attr(), cfg() {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3((unsigned)b * c);
    cfg.blockDim = dim3(CLUSTER_THREADS);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

__global__ void __launch_bounds__(NT)
mvn_panel_kernel(const float* __restrict__ y,    // (b, n)
                 const float* __restrict__ cov,  // (b, n, n)
                 float* scratch,                 // (b, n + 1, n + 1), uninitialised
                 float* __restrict__ out,        // (b,)
                 int n) {
  extern __shared__ float sm[];
  const int n1 = n + 1;
  float* pan = sm;                          // pan[r * PLD + q] = A[c0 + r][c0 + q]
  float* inv_piv = sm + (size_t)n1 * PLD;   // 1 / p_k of the current panel
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* cov_b = cov + (size_t)blockIdx.x * n * n;
  const float* y_b = y + (size_t)blockIdx.x * n;
  float* a = scratch + (size_t)blockIdx.x * n1 * n1;  // row-major, lower triangle

  float logdet_half = 0.f;
  bool ok = true;
  for (int c0 = 0; c0 < n; c0 += PANEL) {
    const int pw = min(PANEL, n - c0);   // panel columns [c0, c1)
    const int c1 = c0 + pw;
    const int nr = n1 - c0;              // panel rows c0 .. n
    const bool first = (c0 == 0);        // nothing is in the scratch yet

    __syncthreads();  // the previous trailing update is written and its panel consumed
    for (int e = tid; e < nr * pw; e += NT) {
      const int r = e / pw, q = e - r * pw;
      const int i = c0 + r, j = c0 + q;
      float v = 0.f;
      if (j <= i) v = first ? aug_entry(cov_b, y_b, n, i, j) : a[(size_t)i * n1 + j];
      pan[r * PLD + q] = v;
    }

    // factor the panel in shared memory: a thread per row, rank-1 per pivot
    for (int k = 0; k < pw; ++k) {
      __syncthreads();
      const float p = pan[k * PLD + k];
      if (bad_pivot(p)) {  // uniform across the block
        ok = false;
        break;
      }
      logdet_half += 0.5f * logf(p);
      const float inv_p = 1.f / p;
      if (tid == 0) inv_piv[k] = inv_p;
      for (int r = k + 1 + tid; r < nr; r += NT) {
        float* row = pan + r * PLD;
        const float s = row[k] * inv_p;
        const int qmax = min(r, pw - 1);
        for (int q = k + 1; q <= qmax; ++q)
          row[q] = fmaf(-s, pan[q * PLD + k], row[q]);
      }
    }
    if (!ok) break;
    __syncthreads();  // the panel and its pivots are final

    // trailing update of rows/cols [c1, n]: A[i][j] -= sum_k P[i][k] P[j][k] / p_k
    const int m = n1 - c1;
    for (int i0 = 0; i0 < m; i0 += TILE) {
      int ra[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) ra[r] = (pw + min(i0 + ty + 16 * r, m - 1)) * PLD;
      for (int j0 = 0; j0 <= i0; j0 += TILE) {
        int rb[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) rb[c] = (pw + min(j0 + tx + 16 * c, m - 1)) * PLD;
        float acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
        for (int k = 0; k < pw; ++k) {
          const float ip = inv_piv[k];
          float av[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) av[r] = pan[ra[r] + k];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = pan[rb[c] + k] * ip;
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int ri = i0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int rj = j0 + tx + 16 * c;
            if (ri < m && rj <= ri) {
              const int i = c1 + ri, j = c1 + rj;
              const size_t off = (size_t)i * n1 + j;
              const float cur = first ? aug_entry(cov_b, y_b, n, i, j) : a[off];
              a[off] = cur - acc[r][c];
            }
          }
        }
      }
    }
  }
  __syncthreads();  // the last trailing update wrote A[n][n]
  if (tid == 0) {
    float lp = -CUDART_INF_F;
    if (ok) lp = 0.5f * a[(size_t)n * n1 + n] - logdet_half;
    out[blockIdx.x] = isfinite(lp) ? lp : -CUDART_INF_F;
  }
}

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

int fused_mvn_panel_max_n() {
  return (int)((SMEM_LIMIT / 4 - PANEL) / PLD) - 1;
}

// Blocks of the shared-memory route that one SM holds at this n (its
// occupancy, for the measurement scripts); -1 if it cannot be asked.
int fused_mvn_smem_blocks_per_sm(int n) {
  if (n < 1 || smem_bytes(n) > SMEM_LIMIT) return -1;
  const int bytes = (int)smem_bytes(n);
  int blocks = 0;
  if (prepare_smem(bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, mvn_smem_kernel, smem_threads(n), bytes) != cudaSuccess)
    return -1;
  return blocks;
}

int fused_mvn_loglike_smem(const float* y, const float* cov, float* out,
                           int b, int n, void* stream) {
  if (b < 1 || n < 1 || smem_bytes(n) > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int bytes = (int)smem_bytes(n);
  const cudaError_t e = prepare_smem(bytes);
  if (e != cudaSuccess) return (int)e;
  mvn_smem_kernel<<<b, smem_threads(n), bytes, static_cast<cudaStream_t>(stream)>>>(
      y, cov, out, n);
  return (int)cudaGetLastError();
}

// Cluster route: its panel width, the cluster size and the dynamic shared
// memory per CTA at this n (-1 where the route does not take n), its
// largest n.
int fused_mvn_cluster_panel() { return CLUSTER_PANEL; }

int fused_mvn_cluster_size(int n) { return n < 1 ? -1 : cluster_size(n); }

int fused_mvn_cluster_bytes(int n) {
  const int c = fused_mvn_cluster_size(n);
  return c < 0 ? -1 : (int)cluster_bytes(n, c);
}

int fused_mvn_cluster_max_n() {
  int n = 1;
  while (cluster_size(n + 1) > 0) ++n;
  return n;
}

// Clusters of the cluster route the card holds at once at this n
// (cudaOccupancyMaxActiveClusters); -1 if it cannot be asked.
int fused_mvn_cluster_active(int n) {
  const int c = fused_mvn_cluster_size(n);
  if (c < 0) return -1;
  const int bytes = (int)cluster_bytes(n, c);
  if (prepare_cluster(bytes) != cudaSuccess) return -1;
  ClusterLaunch launch(132, c, bytes, 0);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, mvn_cluster_kernel, &launch.cfg) != cudaSuccess)
    return -1;
  return clusters;
}

// Diagnostic builds (kPhaseClock): g_cluster_phase since the last call
// (the cycles thread 0 of the cluster route's CTAs spent in each phase,
// summed over CTAs, the CTAs counted, the parts of the factoring); clears
// it.
int fused_mvn_cluster_phase_cycles(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_cluster_phase, sizeof(g_cluster_phase));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[kPhases + 1 + kFactorParts] = {};
  return (int)cudaMemcpyToSymbol(g_cluster_phase, zero, sizeof(zero));
}

int fused_mvn_loglike_cluster(const float* y, const float* cov, float* out,
                              int b, int n, void* stream) {
  const int c = fused_mvn_cluster_size(n);
  if (b < 1 || c < 0) return (int)cudaErrorInvalidValue;
  const int bytes = (int)cluster_bytes(n, c);
  cudaError_t e = prepare_cluster(bytes);
  if (e != cudaSuccess) return (int)e;
  ClusterLaunch launch(b, c, bytes, static_cast<cudaStream_t>(stream));
  e = cudaLaunchKernelEx(&launch.cfg, mvn_cluster_kernel, y, cov, out, n);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int fused_mvn_loglike_panel(const float* y, const float* cov, float* scratch,
                            float* out, int b, int n, void* stream) {
  if (b < 1 || n < 1 || panel_bytes(n) > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int bytes = (int)panel_bytes(n);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mvn_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  mvn_panel_kernel<<<b, NT, bytes, static_cast<cudaStream_t>(stream)>>>(
      y, cov, scratch, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
