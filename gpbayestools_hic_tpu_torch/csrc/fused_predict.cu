// Fused GP PC-predict, forward and backward, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels
//   gpbayestools_hic_tpu/ops/pallas_predict.py:_fwd_kernel       (forward)
//   gpbayestools_hic_tpu/ops/pallas_predict.py:_bwd_kernel_fast  (backward)
//
// Per GP k (a batch of b GPs sharing n training inputs) and m queries:
//   qs_j   = xq_j * inv_ls_k                           (scaled query)
//   z_lj   = -0.5 * sum_d (xs_ld - qs_jd)^2            (direct differences)
//   k*_lj  = amp_k * exp(min(z_lj, 0))
//   v      = G k*,  G = L^-1 lower triangular (n, n)
//   mean_j = alpha^T k*_j,   qf_j = sum_i v_ij^2
// and the query cotangent of (mean, qf):
//   ct_k*  = G^T (2 v ct_qf) + alpha ct_mean
//   ct_z   = k* ct_k*  where z < 0
//   ct_xq_jd = inv_ls_kd * sum_l ct_z_lj (xs_ld - qs_jd)     (per GP)
//
// Both kernels are contractions of length n over the (n, n) factor G:
// 2 n^2 m FMAs-worth of FP32 work per GP, against n^2 * 4 bytes of G.  At
// the flagship shape (n = 1000, m = 1024) that is ~2 GFLOP per GP against
// 4 MB, i.e. ~500 FLOP/byte: the kernels are bound by FP32 operations, not
// by memory.  The design keeps G and k* out of device memory round trips:
// k* is never materialized in device memory (each block recomputes the k*
// chunk it needs from xs and the query tile, ~(3d+1)/(2*BI) of the product's
// work), G is lower triangular so each block skips the tiles that are
// zero (about half of the product), and every product accumulates in FP32
// registers (4x4 outputs per thread) from shared-memory tiles.
//
// The augmented row trick of the TPU kernel is kept in index form only:
// row n of the contraction operand is alpha (so the block holding row n
// produces the mean), rows past n are zero.  No padding lives in memory.
//
// Cross-block reductions (qf over row blocks, ct_xq over training-row
// blocks) go through per-block partial sums and a second, deterministic
// pass (no float atomics).
//
// Each entry launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int BI = 64;    // output rows per block (rows of v / of ct_k*)
constexpr int BJ = 64;    // queries (walkers) per block
constexpr int BL = 32;    // contraction chunk
constexpr int DMAX = 32;  // largest supported input dimension
constexpr int NT = 256;   // 16 x 16 threads, each owns 4 x 4 outputs

__global__ void __launch_bounds__(NT)
fwd_kernel(const float* __restrict__ xs,      // (b, n, d)
           const float* __restrict__ xq,      // (m, d)
           const float* __restrict__ inv_ls,  // (b, d)
           const float* __restrict__ G,       // (b, n, n)
           const float* __restrict__ alpha,   // (b, n)
           const float* __restrict__ amp,     // (b,)
           float* __restrict__ mean,          // (b, m)
           float* __restrict__ qf_part,       // (b, nrb, m)
           float* __restrict__ v,             // (b, n, m) or nullptr
           int n, int m, int d, int nrb) {
  const int k = blockIdx.z;
  const int rb = blockIdx.y;
  const int i0 = rb * BI;
  const int j0 = blockIdx.x * BJ;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  __shared__ float qs_s[BJ][DMAX + 1];
  __shared__ float xs_s[BL][DMAX + 1];
  __shared__ float g_s[BL][BI + 1];   // g_s[l][i] = Gaug[i0 + i, l0 + l]
  __shared__ float k_s[BL][BJ];       // k_s[l][j] = k*[l0 + l, j0 + j]

  const float* xs_k = xs + (size_t)k * n * d;
  const float* g_k = G + (size_t)k * n * n;
  const float* a_k = alpha + (size_t)k * n;
  const float amp_k = amp[k];

  for (int e = tid; e < BJ * d; e += NT) {
    const int jj = e / d, dd = e % d, j = j0 + jj;
    qs_s[jj][dd] = (j < m) ? xq[(size_t)j * d + dd] * inv_ls[k * d + dd] : 0.f;
  }

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  // Rows [i0, i0 + BI) of the lower-triangular G have no entries past
  // column i0 + BI - 1; the alpha row (i == n) needs every column.
  const int l_end = min(n, i0 + BI);
  for (int l0 = 0; l0 < l_end; l0 += BL) {
    __syncthreads();  // the previous chunk's tiles are consumed
    for (int e = tid; e < BL * d; e += NT) {
      const int ll = e / d, dd = e % d, l = l0 + ll;
      xs_s[ll][dd] = (l < n) ? xs_k[(size_t)l * d + dd] : 0.f;
    }
    for (int e = tid; e < BI * BL; e += NT) {
      const int ii = e / BL, ll = e % BL, i = i0 + ii, l = l0 + ll;
      float g = 0.f;
      if (l < n) {
        if (i < n) g = g_k[(size_t)i * n + l];
        else if (i == n) g = a_k[l];
      }
      g_s[ll][ii] = g;
    }
    __syncthreads();
    for (int e = tid; e < BL * BJ; e += NT) {
      const int ll = e / BJ, jj = e % BJ;
      float d2 = 0.f;
      for (int dd = 0; dd < d; ++dd) {
        const float t = xs_s[ll][dd] - qs_s[jj][dd];
        d2 = fmaf(t, t, d2);
      }
      k_s[ll][jj] = (l0 + ll < n) ? amp_k * expf(fminf(-0.5f * d2, 0.f)) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int ll = 0; ll < BL; ++ll) {
      float a[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = g_s[ll][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = k_s[ll][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
    }
  }

  // epilogue: v rows and the masked quadratic form (G rows only), the mean
  // from the alpha row
  float qpart[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      const float val = acc[r][c];
      if (i < n) {
        qpart[c] = fmaf(val, val, qpart[c]);
        if (v != nullptr && j < m) v[((size_t)k * n + i) * m + j] = val;
      } else if (i == n && j < m) {
        mean[(size_t)k * m + j] = val;
      }
    }
  }
  __syncthreads();  // k_s is reused as the reduction buffer
  float(*red)[BJ] = k_s;
#pragma unroll
  for (int c = 0; c < 4; ++c) red[ty][tx + 16 * c] = qpart[c];
  __syncthreads();
  if (tid < BJ) {
    float s = 0.f;
    for (int t = 0; t < 16; ++t) s += red[t][tid];
    const int j = j0 + tid;
    if (j < m) qf_part[((size_t)k * nrb + rb) * m + j] = s;
  }
}

__global__ void __launch_bounds__(NT)
bwd_kernel(const float* __restrict__ xs,      // (b, n, d)
           const float* __restrict__ xq,      // (m, d)
           const float* __restrict__ inv_ls,  // (b, d)
           const float* __restrict__ G,       // (b, n, n)
           const float* __restrict__ alpha,   // (b, n)
           const float* __restrict__ amp,     // (b,)
           const float* __restrict__ v,       // (b, n, m)
           const float* __restrict__ ct_mean, // (b, m)
           const float* __restrict__ ct_qf,   // (b, m)
           float* __restrict__ ct_part,       // (b, nlb, m, d)
           int n, int m, int d, int nlb) {
  const int k = blockIdx.z;
  const int lb = blockIdx.y;
  const int l0 = lb * BI;
  const int j0 = blockIdx.x * BJ;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  __shared__ float qs_s[BJ][DMAX + 1];
  __shared__ float xs_s[BI][DMAX + 1];
  __shared__ float ctm_s[BJ], ctq_s[BJ];
  // two contraction tiles during the loop, the ct_z tile afterwards
  __shared__ float buf[BL * BI + BL * BJ];
  float(*g_s)[BI] = reinterpret_cast<float(*)[BI]>(buf);            // [BL][BI]
  float(*c_s)[BJ] = reinterpret_cast<float(*)[BJ]>(buf + BL * BI);  // [BL][BJ]
  float(*cz_s)[BJ] = reinterpret_cast<float(*)[BJ]>(buf);           // [BI][BJ]

  const float* xs_k = xs + (size_t)k * n * d;
  const float* g_k = G + (size_t)k * n * n;
  const float* a_k = alpha + (size_t)k * n;
  const float* v_k = v + (size_t)k * n * m;
  const float amp_k = amp[k];

  for (int e = tid; e < BJ * d; e += NT) {
    const int jj = e / d, dd = e % d, j = j0 + jj;
    qs_s[jj][dd] = (j < m) ? xq[(size_t)j * d + dd] * inv_ls[k * d + dd] : 0.f;
  }
  for (int e = tid; e < BI * d; e += NT) {
    const int ll = e / d, dd = e % d, l = l0 + ll;
    xs_s[ll][dd] = (l < n) ? xs_k[(size_t)l * d + dd] : 0.f;
  }
  if (tid < BJ) {
    const int j = j0 + tid;
    ctm_s[tid] = (j < m) ? ct_mean[(size_t)k * m + j] : 0.f;
    ctq_s[tid] = (j < m) ? ct_qf[(size_t)k * m + j] : 0.f;
  }

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  // ct_k*[l, j] = sum_i Gaug[i, l] ct_v[i, j]; G is lower triangular, so
  // only rows i >= l0 contribute; row n is alpha against ct_mean.
  for (int i0 = l0; i0 <= n; i0 += BL) {
    __syncthreads();
    for (int e = tid; e < BL * BI; e += NT) {
      const int ii = e / BI, ll = e % BI, i = i0 + ii, l = l0 + ll;
      float g = 0.f;
      if (l < n) {
        if (i < n) g = g_k[(size_t)i * n + l];
        else if (i == n) g = a_k[l];
      }
      g_s[ii][ll] = g;
    }
    for (int e = tid; e < BL * BJ; e += NT) {
      const int ii = e / BJ, jj = e % BJ, i = i0 + ii, j = j0 + jj;
      float cv = 0.f;
      if (j < m) {
        if (i < n) cv = 2.f * v_k[(size_t)i * m + j] * ctq_s[jj];
        else if (i == n) cv = ctm_s[jj];
      }
      c_s[ii][jj] = cv;
    }
    __syncthreads();
#pragma unroll 8
    for (int ii = 0; ii < BL; ++ii) {
      float a[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = g_s[ii][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = c_s[ii][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
    }
  }

  // ct_z = k* ct_k* where z < 0, recomputing k* from xs and the query tile
  float cz[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int ll = ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int jj = tx + 16 * c;
      float d2 = 0.f;
      for (int dd = 0; dd < d; ++dd) {
        const float t = xs_s[ll][dd] - qs_s[jj][dd];
        d2 = fmaf(t, t, d2);
      }
      const float z = -0.5f * d2;
      const float kst = amp_k * expf(fminf(z, 0.f));
      cz[r][c] = (z < 0.f && l0 + ll < n) ? kst * acc[r][c] : 0.f;
    }
  }
  __syncthreads();  // the contraction tiles are consumed; buf becomes cz_s
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) cz_s[ty + 16 * r][tx + 16 * c] = cz[r][c];
  __syncthreads();

  // ct_xq[j, dd] partial over this block's training rows
  for (int e = tid; e < BJ * d; e += NT) {
    const int jj = e % BJ, dd = e / BJ, j = j0 + jj;
    const float q = qs_s[jj][dd];
    float s = 0.f;
    for (int ll = 0; ll < BI; ++ll) s = fmaf(cz_s[ll][jj], xs_s[ll][dd] - q, s);
    if (j < m) {
      ct_part[(((size_t)k * nlb + lb) * m + j) * d + dd] = s * inv_ls[k * d + dd];
    }
  }
}

// out[k, t] = sum_r part[k, r, t]  (fixed order: deterministic)
__global__ void rowsum_kernel(const float* __restrict__ part,
                              float* __restrict__ out,
                              int nparts, long long inner, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long k = idx / inner, t = idx % inner;
  const float* p = part + k * nparts * inner + t;
  float s = 0.f;
  for (int r = 0; r < nparts; ++r) s += p[r * inner];
  out[idx] = s;
}

int launch_rowsum(const float* part, float* out, int b, int nparts,
                  long long inner, cudaStream_t stream) {
  const long long total = (long long)b * inner;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  rowsum_kernel<<<blocks, threads, 0, stream>>>(part, out, nparts, inner, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of the contraction output handled by one block: the wrapper sizes
// the partial-sum buffers from it (nrb = ceil((n + 1) / BI) forward,
// nlb = ceil(n / BI) backward).
int fused_predict_row_block() { return BI; }

int fused_predict_max_dim() { return DMAX; }

int fused_predict_fwd(const float* xs, const float* xq, const float* inv_ls,
                      const float* G, const float* alpha, const float* amp,
                      float* mean, float* qf_part, float* qf, float* v,
                      int b, int n, int m, int d, void* stream) {
  if (d < 1 || d > DMAX || n < 1 || m < 1 || b < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nrb = (n + 1 + BI - 1) / BI;
  const dim3 grid((m + BJ - 1) / BJ, nrb, b);
  fwd_kernel<<<grid, NT, 0, s>>>(xs, xq, inv_ls, G, alpha, amp, mean, qf_part,
                                 v, n, m, d, nrb);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_rowsum(qf_part, qf, b, nrb, m, s);
}

int fused_predict_bwd(const float* xs, const float* xq, const float* inv_ls,
                      const float* G, const float* alpha, const float* amp,
                      const float* v, const float* ct_mean, const float* ct_qf,
                      float* ct_part, float* ct_q,
                      int b, int n, int m, int d, void* stream) {
  if (d < 1 || d > DMAX || n < 1 || m < 1 || b < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nlb = (n + BI - 1) / BI;
  const dim3 grid((m + BJ - 1) / BJ, nlb, b);
  bwd_kernel<<<grid, NT, 0, s>>>(xs, xq, inv_ls, G, alpha, amp, v, ct_mean,
                                 ct_qf, ct_part, n, m, d, nlb);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_rowsum(ct_part, ct_q, b, nlb, (long long)m * d, s);
}

}  // extern "C"
