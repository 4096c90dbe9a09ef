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
// sequential in k, so one thread block owns one matrix and the batch fills
// the card.  Both routes are the reference's blocked right-looking form
// (pallas_mvn.py:_mvn_kernel, PANEL 32): factor a panel of columns, then
// apply its cumulative trailing update
//     A[i][j] -= sum_k P[i][k] P[j][k] / p_k      (k in the panel, j <= i)
// as one matrix product.  Trailing entries at or left of the panel go
// stale and are never read again: a later step only reads columns > k.
// Two routes, picked by the wrapper from n:
//
// - mvn_smem_kernel, n <= fused_mvn_smem_max_n() (318): the lower triangle
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
// - mvn_panel_kernel, larger n (the stitched 544 x 544 likelihood: 1.19 MB
//   per matrix): blocked right-looking elimination.  A 32-column panel of
//   the rows below it is held in shared memory (545 x 33 floats = 72 KB),
//   factored there with the rank-1 loop, and its cumulative trailing update
//       A[i][j] -= sum_k P[i][k] P[j][k] / p_k
//   is applied to a scratch copy of the matrix in device memory in 64 x 64
//   tiles, 4 x 4 outputs per thread in registers, both operands read from
//   the shared panel.  The scratch is read and written once per panel
//   (n / 32 times in all) instead of once per pivot; at n = 544 the route
//   is bound by FP32 operations (n^3/3 flops per matrix).  The first panel
//   reads cov and y directly, so the scratch needs no initialisation.
//
// Each entry launches on the caller's stream, allocates nothing (the
// wrapper allocates the output and the scratch), and returns
// cudaGetLastError().

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

// the packed triangle of rows 0 .. n1 - 1, rounded up to whole float4s
__host__ __device__ constexpr int tri_aligned(int n1) { return (tri(n1) + 3) & ~3; }

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

// The packed lower triangle of the augmented matrix into a: entry e of the
// triangle is A[i][e - tri(i)].  Each thread keeps kLoads global loads in
// flight (one latency per batch, not per row), neighbouring threads read
// neighbouring entries of a row.
__device__ __forceinline__ void load_triangle(float* a, const float* __restrict__ cov_b,
                                              const float* __restrict__ y_b, int n) {
  constexpr int kLoads = 8;
  const int total = tri(n + 1), nthreads = blockDim.x;
  for (int e0 = threadIdx.x; e0 < total; e0 += kLoads * nthreads) {
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * nthreads;
      v[u] = 0.f;
      if (e < total) {
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
      if (e < total) a[e] = v[u];
    }
  }
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
