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
// sequential in k with a barrier per pivot, so one thread block owns one
// matrix and the batch fills the card.  Two routes, picked by the wrapper
// from n:
//
// - mvn_smem_kernel, n <= 339: the lower triangle of the augmented matrix
//   lives packed in the block's shared memory (A[i][j] at i(i+1)/2 + j;
//   n = 170: 59 KB, so three blocks share an SM's 227 KB and hide each
//   other's barrier and shared-memory latency).  Only the lower triangle
//   of cov is read from device memory, once, which is the bound at these
//   sizes: n^3/3 flops against 4 n^2 bytes is below the card's FP32 ridge
//   (~20 flop/byte) for n < ~240.  In a pivot step a warp owns rows and its
//   lanes own columns; each lane keeps its columns' A[j][k] in registers
//   for the whole step, so a row update is one broadcast load, then
//   load-FMA-store triples.  Rows are contiguous, and the
//   column reads A[j][k] for 32 consecutive j fall into 32 distinct banks
//   (triangular numbers are a complete residue system modulo 32).  What
//   the rank-1 form leaves is shared-memory traffic: every trailing entry
//   is read and written once per pivot, n^3/3 accesses per matrix, and that
//   is what the kernel's time follows; a blocked update over several
//   pivots in registers is the next step.
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

constexpr int NT = 256;            // threads per block (panel route)
constexpr int PANEL = 32;          // panel width
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

__host__ __device__ constexpr long long smem_bytes(int n) {
  return (long long)tri(n + 1) * 4;
}

__host__ __device__ constexpr long long panel_bytes(int n) {
  return ((long long)(n + 1) * PLD + PANEL) * 4;
}

// T: column slots per lane, 32 * T >= n + 1.  Up to T = 6 (n <= 191, at
// most 74 KB) three blocks fit an SM, so registers are capped for that.
template <int T>
__global__ void __launch_bounds__(256, T <= 6 ? 3 : 1)
mvn_smem_kernel(const float* __restrict__ y,    // (b, n)
                const float* __restrict__ cov,  // (b, n, n)
                float* __restrict__ out,        // (b,)
                int n) {
  extern __shared__ float a[];  // rows 0 .. n of the lower triangle, packed
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const float* cov_b = cov + (size_t)blockIdx.x * n * n;
  const float* y_b = y + (size_t)blockIdx.x * n;

  for (int i = warp; i <= n; i += nwarps) {
    float* row = a + tri(i);
    if (i < n) {
      for (int j = lane; j <= i; j += 32) row[j] = cov_b[(size_t)i * n + j];
    } else {
      for (int j = lane; j < n; j += 32) row[j] = y_b[j];
      if (lane == 0) row[n] = 0.f;
    }
  }

  float logdet_half = 0.f;
  bool ok = true;
  for (int k = 0; k < n; ++k) {
    __syncthreads();  // step k - 1 wrote column k and the pivot
    const float p = a[tri(k) + k];
    if (bad_pivot(p)) {  // the same p in every thread: a uniform exit
      ok = false;
      break;
    }
    logdet_half += 0.5f * logf(p);
    const float inv_p = 1.f / p;
    // this lane's columns j = k + 1 + lane + 32 t of column k, held for the
    // whole step (column k is only read in step k)
    float c[T];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int j = k + 1 + lane + 32 * t;
      c[t] = (j <= n) ? a[tri(j) + k] : 0.f;
    }
    for (int i = k + 1 + warp; i <= n; i += nwarps) {
      float* row = a + tri(i);
      const float s = row[k] * inv_p;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        if (k + 1 + 32 * t > i) break;  // uniform in the warp: the row ends
        const int j = k + 1 + lane + 32 * t;
        if (j <= i) row[j] = fmaf(-s, c[t], row[j]);
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    const float lp = 0.5f * a[tri(n) + n] - logdet_half;
    out[blockIdx.x] = (ok && isfinite(lp)) ? lp : -CUDART_INF_F;
  }
}

using SmemKernel = void (*)(const float*, const float*, float*, int);

// the instantiation with enough column slots for n + 1 columns
SmemKernel smem_kernel_for(int n) {
  const int slots = (n + 1 + 31) / 32;
  if (slots <= 1) return mvn_smem_kernel<1>;
  if (slots <= 2) return mvn_smem_kernel<2>;
  if (slots <= 4) return mvn_smem_kernel<4>;
  if (slots <= 6) return mvn_smem_kernel<6>;
  if (slots <= 8) return mvn_smem_kernel<8>;
  return mvn_smem_kernel<11>;  // n + 1 <= 340 <= 352
}

// enough warps to cover the rows of a pivot step, at most 8 (more warps
// only add column loads: the step is bound by shared-memory traffic)
constexpr int smem_threads(int n) {
  return n < 16 ? 32 : n < 32 ? 64 : n < 64 ? 128 : 256;
}

// Shared memory for one block, and the whole L1/shared array as shared
// memory: without the carveout the runtime may size it for one block only.
cudaError_t prepare_smem(SmemKernel kernel, int bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && bytes > 48 * 1024)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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

int fused_mvn_panel_max_n() {
  return (int)((SMEM_LIMIT / 4 - PANEL) / PLD) - 1;
}

// Blocks of the shared-memory route that one SM holds at this n (its
// occupancy, for the measurement scripts); -1 if it cannot be asked.
int fused_mvn_smem_blocks_per_sm(int n) {
  if (n < 1 || smem_bytes(n) > SMEM_LIMIT) return -1;
  const SmemKernel kernel = smem_kernel_for(n);
  const int bytes = (int)smem_bytes(n);
  int blocks = 0;
  if (prepare_smem(kernel, bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, smem_threads(n), bytes) != cudaSuccess)
    return -1;
  return blocks;
}

int fused_mvn_loglike_smem(const float* y, const float* cov, float* out,
                           int b, int n, void* stream) {
  if (b < 1 || n < 1 || smem_bytes(n) > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const SmemKernel kernel = smem_kernel_for(n);
  const int bytes = (int)smem_bytes(n);
  const cudaError_t e = prepare_smem(kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<b, smem_threads(n), bytes, static_cast<cudaStream_t>(stream)>>>(y, cov, out, n);
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
