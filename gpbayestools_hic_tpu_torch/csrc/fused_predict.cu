// Fused GP PC-predict, forward and backward, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels
//   gpbayestools_hic_tpu/ops/pallas_predict.py:_fwd_kernel       (forward)
//   gpbayestools_hic_tpu/ops/pallas_predict.py:_bwd_kernel_fast  (backward,
//       grad_precision="default")
//   gpbayestools_hic_tpu/ops/pallas_predict.py:_bwd_kernel       (backward,
//       grad_precision="high" / "highest")
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
// All three are length-n contractions over the (n, n) factor G: n(n+1) m
// flops per GP with the triangle skipped, against 4 n^2 bytes of G, so at
// the flagship shape (b = 4, n = 1000, d = 17, m = 1024) they are bound by
// operations, not by memory.  The entries and their precision contracts:
//
// - fused_predict_fwd (kstar_kernel + fwd_tc_kernel): the value path,
//   FP32-class accuracy for good.  var = kdiag - qf cancels, so one TF32 or
//   bf16 pass (2^-11 / 2^-9 relative) is not allowed on v = [G; alpha] k*.
//   The product runs on the tensor cores in 3xTF32 (hi*hi + hi*lo + lo*hi,
//   hi = tf32_rna(x), lo = tf32_rna(x - hi), FP32 accumulation; the dropped
//   lo*lo term is O(2^-22)).  Bound on the H100: 3 n(n+1) m b flops at 495
//   TFLOP/s TF32 plus the k* build at 67 TFLOP/s FP32, ~0.028 ms.
//   k* (FP32, direct differences; never on the tensor cores: the
//   augmented-matmul form of z cancels) is built once per call by a
//   pre-pass into a (b, n, mp) scratch (16 MB at the flagship, L2-resident)
//   instead of by every row tile.  The mean comes from alpha as row n of
//   the product; qf is a masked sum of v^2 over the G rows only.
// - fused_predict_bwd (bwd_tc_kernel): grad_precision="default".  Its
//   cotangent product G^T v MAY drop below FP32 (the TPU kernel ran it in
//   one bf16 pass; the accept step uses the exact value, so a cheap
//   gradient is legal): it runs on the tensor cores in ONE TF32 pass (rna
//   rounding of G and v, FP32 accumulation; 2^-11 against the TPU's 2^-9).
//   The column scale 2 ct_qf, the alpha ct_mean term, the k* recompute and
//   z < 0 mask, ct_z and the query contraction (in its difference form
//   sum_l ct_z (xs - qs); the split form xs^T ct_z - qs sum ct_z cancels)
//   stay FP32 FMA.  Bound: one TF32 pass plus those FP32 parts, ~0.015 ms.
// - fused_predict_bwd_high (bwd_tc_kernel with three passes):
//   grad_precision="high" / "highest".  The same cotangent at FP32-class
//   accuracy, for good: G^T v runs on the tensor cores in 3xTF32, G and v
//   split into TF32 halves as their fragments are read, each 8-deep step's
//   hi*hi + hi*lo + lo*hi summed into a fresh fragment that is added to
//   the accumulator in FP32 (the forward's promotion); the rest is FP32 FMA
//   as in the fast backward.  The TPU kernel ran both cotangent products in
//   3-pass bf16 (_dot3), so this is stricter than the reference.  Bound:
//   three TF32 passes plus the FP32 parts, ~0.031 ms.
//
// The tensor-core kernels (fwd_tc_kernel, bwd_tc_kernel) share one design:
// - mma.sync.m16n8k8 TF32 from shared memory, 8 warps per block, each warp
//   a 32 x 32 slice of a 128 x 64 output tile (rows x walkers), two blocks
//   per SM (<= 128 registers, no spills; one for the backward at ragged
//   shapes, whose 4-byte copies need more registers);
// - an asynchronous tile pipeline: a ring of STAGES shared-memory stages
//   filled by cp.async (16-byte copies when rows are 16-byte aligned,
//   4-byte copies otherwise; ragged edges zero-filled), one barrier per
//   32-row stage, so the copies of stage kt + 2 fly while stage kt is
//   multiplied;
// - padded row strides put every fragment read in 32 distinct banks; G^T,
//   the backward's A operand, is read as fragments straight from a tile of
//   G's rows (mma.sync takes any fragment order, so G needs no transposed
//   copy, which wgmma's K-major-only TF32 operands would);
// - operands are rounded / split into TF32 halves as fragments are read:
//   splitting G once in device memory doubles its bytes and its shared-
//   memory tiles and measured slower on the H100; the rounding is the
//   integer form of cvt.rna.tf32.f32 (same bits, and faster here;
//   tools/torch_predict_variants.py times both choices);
// - the tensor cores' FP32 accumulation inside an mma is not rounded to
//   nearest, and over n / 8 = 125 chained steps that bias cost the forward
//   7e-5 of its mean; each step's three products therefore go into a fresh
//   fragment that is added to the accumulator in FP32 (forward at 6e-6 of
//   float64, as the FP32 plain path);
// - triangular balance: row tile r of the forward contracts (r + 1) * 128
//   columns of G, and the last one (which holds the alpha row) all n.  A
//   block takes the pair of row tiles (r, R - 1 - r), so every block does
//   the same work and the grid is one even wave; a warp skips the 8-wide
//   contraction steps in which its 32 rows of G are all zero;
// - cross-block reductions (qf over row tiles, ct_xq over training-row
//   tiles) go through per-block partial sums and a second, deterministic
//   pass (rowsum_kernel).  No float atomics.
// What holds them back on the H100 (PERF.md): mma.sync issues at a fraction
// of the wgmma rate, and the ring's copies and the products add up instead
// of overlapping; in the one-pass backward the FP32 epilogue is about a
// third of the time, in the three-pass one the products lead.
//
// The augmented row trick of the TPU kernel is kept in index form only
// (forward: row n of the contraction operand is alpha, rows past n are
// zero); no padding lives in G.
//
// Each entry launches on the caller's stream, allocates nothing (the
// wrapper allocates outputs and the scratch that fused_predict_scratch
// sizes), and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DMAX = 32;  // largest supported input dimension

// ------------------------------------------------------------ helpers

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

// round to the nearest TF32 value, ties away from zero: the result of
// cvt.rna.tf32.f32 for every finite input, in two integer operations
// (cvt.rna is slower in the forward on the H100)
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

// asynchronous global -> shared copies; ok == false zero-fills the target
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

// ------------------------------------------------ tensor-core kernels (1, 2)

constexpr int TM = 128;      // output rows per tile (rows of v / of ct_k*)
constexpr int TN = 64;       // walkers per tile
constexpr int TK = 32;       // contraction rows per pipeline stage
constexpr int STAGES = 3;    // cp.async ring depth
constexpr int TC_NT = 256;   // 8 warps: 4 along rows x 2 along walkers
constexpr int A_FWD_LD = TK + 4;   // forward A tile [TM][TK]: G rows
constexpr int A_BWD_LD = TM + 8;   // backward A tile [TK][TM]: G rows = A^T
constexpr int B_LD = TN + 8;       // B tile [TK][TN]: k* or v rows
constexpr int FWD_STAGE = TM * A_FWD_LD + TK * B_LD;   // floats per stage
constexpr int BWD_STAGE = TK * A_BWD_LD + TK * B_LD;
constexpr int XS_LD = DMAX + 4;   // rows of xs / qs, read 4 dimensions at a time
constexpr int CZ_LD = TN + 1;
constexpr int FWD_SMEM = STAGES * FWD_STAGE * 4;                  // 82,944 B
constexpr int BWD_SMEM = (STAGES * BWD_STAGE + TN * XS_LD + TN * DMAX) * 4;  // 97,280 B
constexpr int RED_LD = 17;  // the query contraction's partials, [4][TN][RED_LD]
static_assert(TM * XS_LD + TM * CZ_LD + 4 * TN * RED_LD <= STAGES * BWD_STAGE,
              "the query contraction's partials fit in the drained ring");
static_assert(4 * TN <= STAGES * FWD_STAGE, "qf reduction buffer");

// The cp.async ring: stage kt is copied while stages kt - 2, kt - 1 are
// consumed; one barrier per stage.  load(stage, kt) issues the copies of
// contraction tile kt, compute(stage, kt) consumes it.
template <int kStage, class Load, class Compute>
__device__ __forceinline__ void run_ring(float* ring, int ktiles, Load load,
                                         Compute compute) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(ring + s * kStage, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();              // ... everyone's; stage kt - 1 is consumed
    const int nxt = kt + STAGES - 1;
    if (nxt < ktiles) load(ring + (nxt % STAGES) * kStage, nxt);
    cp_async_commit();
    compute(ring + (kt % STAGES) * kStage, kt);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring may be reused
}

// Rows [l0, l0 + kRows) of xs_k into xs_s (row stride XS_LD), zero-padded
// to d4 (d rounded up to 4), so that the difference loops read float4s and
// the padding adds 0.  kChunk loads per thread are in flight at once (one
// latency per chunk, not per row group); a small kChunk spares registers.
template <int kRows, int kNT, int kChunk>
__device__ __forceinline__ void load_rows(float* xs_s, const float* xs_k, int l0, int n,
                                          int d) {
  constexpr int kPer = kRows * DMAX / kNT;
  static_assert(kRows * DMAX % kNT == 0 && kPer % kChunk == 0, "whole passes");
  const int d4 = (d + 3) & ~3;
#pragma unroll 1
  for (int r0 = 0; r0 < kPer; r0 += kChunk) {
    float val[kChunk];
#pragma unroll
    for (int r = 0; r < kChunk; ++r) {
      const int e = threadIdx.x + (r0 + r) * kNT, ll = e / DMAX, dd = e % DMAX, l = l0 + ll;
      val[r] = (l < n && dd < d) ? xs_k[(size_t)l * d + dd] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kChunk; ++r) {
      const int e = threadIdx.x + (r0 + r) * kNT, ll = e / DMAX, dd = e % DMAX;
      if (dd < d4) xs_s[ll * XS_LD + dd] = val[r];
    }
  }
}

// The scaled queries [q0, q0 + TN) of GP k into qs_s, padded like load_rows.
template <int kNT>
__device__ __forceinline__ void load_queries(float* qs_s, const float* xq, const float* il_k,
                                             int q0, int m, int d) {
  const int d4 = (d + 3) & ~3;
  float val[TN * DMAX / kNT];
#pragma unroll
  for (int r = 0; r < TN * DMAX / kNT; ++r) {
    const int e = threadIdx.x + r * kNT, jj = e / DMAX, dd = e % DMAX, j = q0 + jj;
    val[r] = (j < m && dd < d) ? xq[(size_t)j * d + dd] * il_k[dd] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < TN * DMAX / kNT; ++r) {
    const int e = threadIdx.x + r * kNT, jj = e / DMAX, dd = e % DMAX;
    if (dd < d4) qs_s[jj * XS_LD + dd] = val[r];
  }
}

// k*[k, l, j] = amp_k exp(min(z, 0)) for j < m, 0 for m <= j < mp: one
// 64 x 64 tile per block, 16 rows x 1 walker per thread
constexpr int KS_L = 64, KS_R = KS_L / 4;

__global__ void __launch_bounds__(256, 4)
kstar_kernel(const float* __restrict__ xs,      // (b, n, d)
             const float* __restrict__ xq,      // (m, d)
             const float* __restrict__ inv_ls,  // (b, d)
             const float* __restrict__ amp,     // (b,)
             float* __restrict__ kst,           // (b, n, mp)
             int n, int m, int mp, int d) {
  __shared__ __align__(16) float xs_s[KS_L * XS_LD];
  __shared__ __align__(16) float qs_s[TN * XS_LD];
  const int k = blockIdx.z, l0 = blockIdx.y * KS_L, j0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  load_rows<KS_L, 256, KS_L * DMAX / 256>(xs_s, xs + (size_t)k * n * d, l0, n, d);
  load_queries<256>(qs_s, xq, inv_ls + k * d, j0, m, d);
  __syncthreads();
  const int jj = tid % TN, lr = tid / TN;  // a warp shares lr: xs_s broadcasts
  float d2[KS_R];
#pragma unroll
  for (int r = 0; r < KS_R; ++r) d2[r] = 0.f;
  for (int dd = 0; dd < d; dd += 4) {
    const float4 q = *reinterpret_cast<const float4*>(qs_s + jj * XS_LD + dd);
#pragma unroll
    for (int r = 0; r < KS_R; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(xs_s + (lr + 4 * r) * XS_LD + dd);
      float t = x.x - q.x;
      d2[r] = fmaf(t, t, d2[r]);
      t = x.y - q.y;
      d2[r] = fmaf(t, t, d2[r]);
      t = x.z - q.z;
      d2[r] = fmaf(t, t, d2[r]);
      t = x.w - q.w;
      d2[r] = fmaf(t, t, d2[r]);
    }
  }
  const float amp_k = amp[k];
  const int j = j0 + jj;
#pragma unroll
  for (int r = 0; r < KS_R; ++r) {
    const int l = l0 + lr + 4 * r;
    if (l < n && j < mp) {
      kst[((size_t)k * n + l) * mp + j] =
          (j < m) ? amp_k * expf(fminf(-0.5f * d2[r], 0.f)) : 0.f;
    }
  }
}

// v = [G; alpha] k* in 3xTF32 for the row tiles (R - 1 - p, p) of one
// (GP, walker tile); the mean from row n, qf partial over both tiles.
template <bool kVec>  // 16-byte aligned rows of G and alpha: 16-byte copies
__global__ void __launch_bounds__(TC_NT, 2)
fwd_tc_kernel(const float* __restrict__ G,       // (b, n, n)
              const float* __restrict__ alpha,   // (b, n)
              const float* __restrict__ kst,     // (b, n, mp)
              float* __restrict__ mean,          // (b, m)
              float* __restrict__ qf_part,       // (b, npairs, m)
              float* __restrict__ v,             // (b, n, m) or nullptr
              int n, int m, int mp, int nrb, int npairs) {
  extern __shared__ __align__(16) float smem[];
  const int k = blockIdx.z, p = blockIdx.y, j0 = blockIdx.x * TN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const float* g_k = G + (size_t)k * n * n;
  const float* a_k = alpha + (size_t)k * n;
  const float* kst_k = kst + (size_t)k * n * mp;
  float qf_acc = 0.f;  // thread tid < TN: column j0 + tid over both row tiles

  const int ntiles = (nrb - 1 - p == p) ? 1 : 2;
  for (int s = 0; s < ntiles; ++s) {
    const int i0 = (s == 0 ? nrb - 1 - p : p) * TM;
    // rows [i0, i0 + TM) of the lower-triangular G have no entries past
    // column i0 + TM - 1; the alpha row (i == n) needs every column
    const int ktiles = (min(n, i0 + TM) + TK - 1) / TK;
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

    auto load = [&](float* st, int kt) {
      const int l0 = kt * TK;
      float* As = st;
      float* Bs = st + TM * A_FWD_LD;
      if constexpr (kVec) {
        for (int c = tid; c < TM * TK / 4; c += TC_NT) {
          const int row = c / (TK / 4), col = (c % (TK / 4)) * 4;
          const int i = i0 + row, l = l0 + col;
          const bool ok = l < n && i <= n;
          const float* src = !ok ? g_k : (i < n ? g_k + (size_t)i * n + l : a_k + l);
          cp_async16(As + row * A_FWD_LD + col, src, ok);
        }
      } else {
        for (int e = tid; e < TM * TK; e += TC_NT) {
          const int row = e / TK, col = e % TK;
          const int i = i0 + row, l = l0 + col;
          const bool ok = l < n && i <= n;
          const float* src = !ok ? g_k : (i < n ? g_k + (size_t)i * n + l : a_k + l);
          cp_async4(As + row * A_FWD_LD + col, src, ok);
        }
      }
      for (int c = tid; c < TK * TN / 4; c += TC_NT) {
        const int row = c / (TN / 4), col = (c % (TN / 4)) * 4;
        const int l = l0 + row, j = j0 + col;
        const bool ok = l < n && j < mp;  // mp % 4 == 0: whole chunks
        cp_async16(Bs + row * B_LD + col, ok ? kst_k + (size_t)l * mp + j : kst_k, ok);
      }
    };

    const int row_last = i0 + wm * 32 + 31;  // this warp's last row
    auto compute = [&](const float* st, int kt) {
      const float* As = st;
      const float* Bs = st + TM * A_FWD_LD;
#pragma unroll
      for (int kk = 0; kk < TK / 8; ++kk) {
        // columns past the warp's last row are zero in G (not in alpha)
        if (row_last < n && kt * TK + kk * 8 > row_last) break;
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            split_tf32(Bs[(kk * 8 + t + 4 * h) * B_LD + wn * 32 + ni * 8 + g],
                       bh[ni][h], bl[ni][h]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float* ar = As + (wm * 32 + mi * 16 + g) * A_FWD_LD + kk * 8 + t;
          uint32_t ah[4], al[4];
          split_tf32(ar[0], ah[0], al[0]);
          split_tf32(ar[8 * A_FWD_LD], ah[1], al[1]);
          split_tf32(ar[4], ah[2], al[2]);
          split_tf32(ar[8 * A_FWD_LD + 4], ah[3], al[3]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            // the tensor cores' sums are not rounded to nearest: each
            // step's products go into a fresh fragment, then into acc
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(part, al, bh[ni]);   // small terms first
            mma_tf32(part, ah, bl[ni]);
            mma_tf32(part, ah, bh[ni]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[e];
          }
        }
      }
    };
    run_ring<FWD_STAGE>(smem, ktiles, load, compute);

    // epilogue: v rows and the masked quadratic form (G rows only), the
    // mean from the alpha row.  Fragment element e of tile (mi, ni) is
    // row g + 8 (e >> 1), column 2 t + (e & 1).
    float qp[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) qp[ni][0] = qp[ni][1] = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int i = i0 + wm * 32 + mi * 16 + g + 8 * rh;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int j = j0 + wn * 32 + ni * 8 + 2 * t;
          const float v0 = acc[mi][ni][2 * rh], v1 = acc[mi][ni][2 * rh + 1];
          if (i < n) {
            qp[ni][0] = fmaf(v0, v0, qp[ni][0]);
            qp[ni][1] = fmaf(v1, v1, qp[ni][1]);
            if (v != nullptr) {
              float* out = v + ((size_t)k * n + i) * m + j;
              if (j + 1 < m && (m & 1) == 0) {
                *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
              } else {
                if (j < m) out[0] = v0;
                if (j + 1 < m) out[1] = v1;
              }
            }
          } else if (i == n) {
            if (j < m) mean[(size_t)k * m + j] = v0;
            if (j + 1 < m) mean[(size_t)k * m + j + 1] = v1;
          }
        }
      }
    // sum over the 8 row groups g of the warp, then over the 4 row warps
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = qp[ni][h];
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        x += __shfl_xor_sync(0xffffffffu, x, 8);
        x += __shfl_xor_sync(0xffffffffu, x, 16);
        qp[ni][h] = x;
      }
    float* red = smem;  // [4][TN]; the ring has drained
    if (g == 0) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) red[wm * TN + wn * 32 + ni * 8 + 2 * t + h] = qp[ni][h];
    }
    __syncthreads();
    if (tid < TN) qf_acc += (red[tid] + red[TN + tid]) + (red[2 * TN + tid] + red[3 * TN + tid]);
    __syncthreads();  // red is the ring of the next row tile
  }
  if (tid < TN && j0 + tid < m) qf_part[((size_t)k * npairs + p) * m + j0 + tid] = qf_acc;
}

// ct_k* = 2 ct_qf G^T v + alpha ct_mean for the training-row tiles
// (p, R - 1 - p) of one (GP, walker tile), then ct_z and the query
// cotangent in FP32; ct_part holds the pair's partial sum.
// kPasses: 1 = G^T v in one TF32 pass (fused_predict_bwd); 3 = 3xTF32 with
// each step's products promoted to FP32 (fused_predict_bwd_high).
// kVec: 16-byte aligned rows of G and v, 16-byte copies, two blocks per SM.
// Otherwise (ragged n or m) 4-byte copies, whose addressing needs more than
// the 128 registers that two blocks per SM leave: one block per SM.
template <bool kVec, int kPasses>
__global__ void __launch_bounds__(TC_NT, kVec ? 2 : 1)
bwd_tc_kernel(const float* __restrict__ xs,      // (b, n, d)
              const float* __restrict__ xq,      // (m, d)
              const float* __restrict__ inv_ls,  // (b, d)
              const float* __restrict__ G,       // (b, n, n)
              const float* __restrict__ alpha,   // (b, n)
              const float* __restrict__ amp,     // (b,)
              const float* __restrict__ v,       // (b, n, m)
              const float* __restrict__ ct_mean, // (b, m)
              const float* __restrict__ ct_qf,   // (b, m)
              float* __restrict__ ct_part,       // (b, npairs, m, d)
              int n, int m, int d, int nlb, int npairs) {
  extern __shared__ __align__(16) float smem[];
  float* qs_s = smem + STAGES * BWD_STAGE;  // [TN][XS_LD], the whole block
  float* cq_s = qs_s + TN * XS_LD;          // [TN][d]: the pair's query cotangent
  float* xs_s = smem;                       // [TM][XS_LD] once the ring drained
  float* cz_s = smem + TM * XS_LD;          // [TM][CZ_LD] likewise
  const int k = blockIdx.z, p = blockIdx.y, j0 = blockIdx.x * TN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const float* xs_k = xs + (size_t)k * n * d;
  const float* g_k = G + (size_t)k * n * n;
  const float* a_k = alpha + (size_t)k * n;
  const float* v_k = v + (size_t)k * n * m;
  const float amp_k = amp[k];

  load_queries<TC_NT>(qs_s, xq, inv_ls + k * d, j0, m, d);
  for (int e = tid; e < TN * d; e += TC_NT) cq_s[e] = 0.f;
  // the query contraction: column jq, row group lg of each tile; the
  // thread adds the 4 groups' sums of dimensions lg, lg + 4, ... to cq_s
  const int jq = tid % TN, lg = tid / TN;

  const int ntiles = (nlb - 1 - p == p) ? 1 : 2;
  for (int s = 0; s < ntiles; ++s) {
    const int l0 = (s == 0 ? p : nlb - 1 - p) * TM;
    // G is lower triangular: only rows i >= l0 reach columns l >= l0
    const int ktiles = (n - l0 + TK - 1) / TK;
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

    auto load = [&](float* st, int kt) {
      const int i0 = l0 + kt * TK;
      float* Gs = st;
      float* Vs = st + TK * A_BWD_LD;
      if constexpr (kVec) {
        for (int c = tid; c < TK * TM / 4; c += TC_NT) {
          const int row = c / (TM / 4), col = (c % (TM / 4)) * 4;
          const int i = i0 + row, l = l0 + col;
          const bool ok = i < n && l < n;
          cp_async16(Gs + row * A_BWD_LD + col, ok ? g_k + (size_t)i * n + l : g_k, ok);
        }
        for (int c = tid; c < TK * TN / 4; c += TC_NT) {
          const int row = c / (TN / 4), col = (c % (TN / 4)) * 4;
          const int i = i0 + row, j = j0 + col;
          const bool ok = i < n && j < m;
          cp_async16(Vs + row * B_LD + col, ok ? v_k + (size_t)i * m + j : v_k, ok);
        }
      } else {
        for (int e = tid; e < TK * TM; e += TC_NT) {
          const int row = e / TM, col = e % TM;
          const int i = i0 + row, l = l0 + col;
          const bool ok = i < n && l < n;
          cp_async4(Gs + row * A_BWD_LD + col, ok ? g_k + (size_t)i * n + l : g_k, ok);
        }
        for (int e = tid; e < TK * TN; e += TC_NT) {
          const int row = e / TN, col = e % TN;
          const int i = i0 + row, j = j0 + col;
          const bool ok = i < n && j < m;
          cp_async4(Vs + row * B_LD + col, ok ? v_k + (size_t)i * m + j : v_k, ok);
        }
      }
    };

    const int col_first = l0 + wm * 32;  // this warp's first row of ct_k*
    auto compute = [&](const float* st, int kt) {
      const float* Gs = st;
      const float* Vs = st + TK * A_BWD_LD;
#pragma unroll
      for (int kk = 0; kk < TK / 8; ++kk) {
        // rows i < l of G are zero in column l
        if (l0 + kt * TK + kk * 8 + 7 < col_first) continue;
        if constexpr (kPasses == 1) {
          uint32_t bf[4][2];
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              bf[ni][h] = tf32_rna(Vs[(kk * 8 + t + 4 * h) * B_LD + wn * 32 + ni * 8 + g]);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            // A[l][i] = G[i][l]: fragment rows are columns of the G tile
            const float* gr = Gs + (kk * 8 + t) * A_BWD_LD + wm * 32 + mi * 16 + g;
            const uint32_t af[4] = {tf32_rna(gr[0]), tf32_rna(gr[8]),
                                    tf32_rna(gr[4 * A_BWD_LD]),
                                    tf32_rna(gr[4 * A_BWD_LD + 8])};
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], af, bf[ni]);
          }
        } else {
          static_assert(kPasses == 3, "one or three TF32 passes");
          uint32_t vh[4][2], vl[4][2];
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              split_tf32(Vs[(kk * 8 + t + 4 * h) * B_LD + wn * 32 + ni * 8 + g],
                         vh[ni][h], vl[ni][h]);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const float* gr = Gs + (kk * 8 + t) * A_BWD_LD + wm * 32 + mi * 16 + g;
            uint32_t gh[4], gl[4];
            split_tf32(gr[0], gh[0], gl[0]);
            split_tf32(gr[8], gh[1], gl[1]);
            split_tf32(gr[4 * A_BWD_LD], gh[2], gl[2]);
            split_tf32(gr[4 * A_BWD_LD + 8], gh[3], gl[3]);
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
              // a fresh fragment per step, added in FP32 (the tensor
              // cores' own sums are not rounded to nearest)
              float step[4] = {0.f, 0.f, 0.f, 0.f};
              mma_tf32(step, gl, vh[ni]);
              mma_tf32(step, gh, vl[ni]);
              mma_tf32(step, gh, vh[ni]);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mi][ni][e] += step[e];
            }
          }
        }
      }
    };
    run_ring<BWD_STAGE>(smem, ktiles, load, compute);

    // epilogue, FP32: recompute z for this thread's 4 rows x 8 columns
    load_rows<TM, TC_NT, 4>(xs_s, xs_k, l0, n, d);  // acc is live: 4 loads at a time
    __syncthreads();
    float d2[2][2][4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) d2[mi][rh][ni][0] = d2[mi][rh][ni][1] = 0.f;
    for (int dd = 0; dd < d; dd += 4) {
      float4 xr[2][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh)
          xr[mi][rh] = *reinterpret_cast<const float4*>(
              xs_s + (wm * 32 + mi * 16 + g + 8 * rh) * XS_LD + dd);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 q = *reinterpret_cast<const float4*>(
              qs_s + (wn * 32 + ni * 8 + 2 * t + h) * XS_LD + dd);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int rh = 0; rh < 2; ++rh) {
              const float4 x = xr[mi][rh];
              float& acc2 = d2[mi][rh][ni][h];
              float df = x.x - q.x;
              acc2 = fmaf(df, df, acc2);
              df = x.y - q.y;
              acc2 = fmaf(df, df, acc2);
              df = x.z - q.z;
              acc2 = fmaf(df, df, acc2);
              df = x.w - q.w;
              acc2 = fmaf(df, df, acc2);
            }
        }
    }
    float cq2[4][2], cm[4][2];  // this thread's 8 walker columns
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + wn * 32 + ni * 8 + 2 * t + h;
        cq2[ni][h] = (j < m) ? 2.f * ct_qf[(size_t)k * m + j] : 0.f;
        cm[ni][h] = (j < m) ? ct_mean[(size_t)k * m + j] : 0.f;
      }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int ll = wm * 32 + mi * 16 + g + 8 * rh, l = l0 + ll;
        const float a_l = (l < n) ? a_k[l] : 0.f;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float ctk = fmaf(cq2[ni][h], acc[mi][ni][2 * rh + h], a_l * cm[ni][h]);
            const float z = -0.5f * d2[mi][rh][ni][h];
            const float kst = amp_k * expf(fminf(z, 0.f));
            cz_s[ll * CZ_LD + wn * 32 + ni * 8 + 2 * t + h] =
                (z < 0.f && l < n) ? kst * ctk : 0.f;
          }
      }
    __syncthreads();
    // ct_xq[jq, :] over the 32 rows of group lg, 16 dimensions at a time in
    // registers, xs rows read 4 dimensions at a time (a warp shares lg and
    // the row: broadcast); the 4 groups' partials meet in red
    float* red = cz_s + TM * CZ_LD;  // [4][TN][RED_LD]
#pragma unroll
    for (int half = 0; half < DMAX / 16; ++half) {
      const int h0 = 16 * half;
      if (h0 >= d) break;
      float s_d[16], q_d[16];
#pragma unroll
      for (int dd = 0; dd < 16; dd += 4) {
        const float4 q = (h0 + dd < d)
            ? *reinterpret_cast<const float4*>(qs_s + jq * XS_LD + h0 + dd)
            : make_float4(0.f, 0.f, 0.f, 0.f);
        q_d[dd] = q.x;
        q_d[dd + 1] = q.y;
        q_d[dd + 2] = q.z;
        q_d[dd + 3] = q.w;
        s_d[dd] = s_d[dd + 1] = s_d[dd + 2] = s_d[dd + 3] = 0.f;
      }
      for (int ll = lg * 32; ll < lg * 32 + 32; ++ll) {
        const float c = cz_s[ll * CZ_LD + jq];
#pragma unroll
        for (int dd = 0; dd < 16; dd += 4) {
          if (h0 + dd < d) {
            const float4 x = *reinterpret_cast<const float4*>(xs_s + ll * XS_LD + h0 + dd);
            s_d[dd] = fmaf(c, x.x - q_d[dd], s_d[dd]);
            s_d[dd + 1] = fmaf(c, x.y - q_d[dd + 1], s_d[dd + 1]);
            s_d[dd + 2] = fmaf(c, x.z - q_d[dd + 2], s_d[dd + 2]);
            s_d[dd + 3] = fmaf(c, x.w - q_d[dd + 3], s_d[dd + 3]);
          }
        }
      }
#pragma unroll
      for (int dd = 0; dd < 16; ++dd) red[(lg * TN + jq) * RED_LD + dd] = s_d[dd];
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int dd = lg + 4 * r;  // this thread's dimension h0 + dd
        if (h0 + dd < d) {
          cq_s[jq * d + h0 + dd] += (red[jq * RED_LD + dd] + red[(TN + jq) * RED_LD + dd]) +
                                    (red[(2 * TN + jq) * RED_LD + dd] +
                                     red[(3 * TN + jq) * RED_LD + dd]);
        }
      }
      __syncthreads();  // red is rewritten by the next half
    }
    __syncthreads();  // xs_s and cz_s are the ring of the next row tile
  }
  // cq_s is complete: the tile loop ended on a barrier
  for (int e = tid; e < TN * d; e += TC_NT) {
    const int jj = e / d, dd = e % d;
    if (j0 + jj < m) {
      ct_part[(((size_t)k * npairs + p) * m + j0 + jj) * d + dd] = cq_s[e] * inv_ls[k * d + dd];
    }
  }
}

int fwd_pairs(int n) { return ((n + 1 + TM - 1) / TM + 1) / 2; }
int bwd_pairs(int n) { return ((n + TM - 1) / TM + 1) / 2; }
int kstar_ld(int m) { return (m + 3) / 4 * 4; }

bool bad_shape(int b, int n, int m, int d) {
  return d < 1 || d > DMAX || n < 1 || m < 1 || b < 1;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// both backward entries: the tensor-core backward with kPasses TF32 passes
template <int kPasses>
int launch_bwd(const float* xs, const float* xq, const float* inv_ls,
               const float* G, const float* alpha, const float* amp,
               const float* v, const float* ct_mean, const float* ct_qf,
               float* scratch, float* ct_q, int b, int n, int m, int d, void* stream) {
  if (bad_shape(b, n, m, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nlb = (n + TM - 1) / TM, npairs = bwd_pairs(n);
  const dim3 grid((m + TN - 1) / TN, npairs, b);
  const bool vec = n % 4 == 0 && m % 4 == 0 && aligned16(G) && aligned16(v);
  auto kernel = vec ? bwd_tc_kernel<true, kPasses> : bwd_tc_kernel<false, kPasses>;
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      BWD_SMEM);
  if (err != 0) return err;
  kernel<<<grid, TC_NT, BWD_SMEM, s>>>(xs, xq, inv_ls, G, alpha, amp, v, ct_mean, ct_qf,
                                       scratch, n, m, d, nlb, npairs);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_rowsum(scratch, ct_q, b, npairs, (long long)m * d, s);
}

}  // namespace

extern "C" {

int fused_predict_max_dim() { return DMAX; }

// Floats of scratch the wrapper allocates for an entry (0 = fused_predict_fwd,
// 1 = fused_predict_bwd, 2 = fused_predict_bwd_high): the per-block partial
// sums, and for the forward the k* buffer (b, n, mp) before them.
long long fused_predict_scratch(int entry, int b, int n, int m, int d) {
  if (entry == 0) {
    return (long long)b * n * kstar_ld(m) + (long long)b * fwd_pairs(n) * m;
  }
  return (long long)b * bwd_pairs(n) * m * d;
}

int fused_predict_fwd(const float* xs, const float* xq, const float* inv_ls,
                      const float* G, const float* alpha, const float* amp,
                      float* mean, float* qf, float* v, float* scratch,
                      int b, int n, int m, int d, void* stream) {
  if (bad_shape(b, n, m, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mp = kstar_ld(m);
  float* kst = scratch;
  float* qf_part = scratch + (size_t)b * n * mp;
  const dim3 kgrid((mp + TN - 1) / TN, (n + KS_L - 1) / KS_L, b);
  kstar_kernel<<<kgrid, 256, 0, s>>>(xs, xq, inv_ls, amp, kst, n, m, mp, d);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;

  const int nrb = (n + 1 + TM - 1) / TM, npairs = fwd_pairs(n);
  const dim3 grid((m + TN - 1) / TN, npairs, b);
  const bool vec = n % 4 == 0 && aligned16(G) && aligned16(alpha);
  auto kernel = vec ? fwd_tc_kernel<true> : fwd_tc_kernel<false>;
  err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  FWD_SMEM);
  if (err != 0) return err;
  kernel<<<grid, TC_NT, FWD_SMEM, s>>>(G, alpha, kst, mean, qf_part, v, n, m, mp,
                                       nrb, npairs);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_rowsum(qf_part, qf, b, npairs, m, s);
}

int fused_predict_bwd(const float* xs, const float* xq, const float* inv_ls,
                      const float* G, const float* alpha, const float* amp,
                      const float* v, const float* ct_mean, const float* ct_qf,
                      float* scratch, float* ct_q,
                      int b, int n, int m, int d, void* stream) {
  return launch_bwd<1>(xs, xq, inv_ls, G, alpha, amp, v, ct_mean, ct_qf, scratch, ct_q,
                       b, n, m, d, stream);
}

int fused_predict_bwd_high(const float* xs, const float* xq, const float* inv_ls,
                           const float* G, const float* alpha, const float* amp,
                           const float* v, const float* ct_mean, const float* ct_qf,
                           float* scratch, float* ct_q,
                           int b, int n, int m, int d, void* stream) {
  return launch_bwd<3>(xs, xq, inv_ls, G, alpha, amp, v, ct_mean, ct_qf, scratch, ct_q,
                       b, n, m, d, stream);
}

}  // extern "C"
