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
// - fused_predict_fwd (kstar_kernel + fwd_wgmma_kernel + rowsum_kernel):
//   the value path, FP32-class accuracy for good.  var = kdiag - qf
//   cancels, so one TF32 or bf16 pass (2^-11 / 2^-9 relative) is not
//   allowed on v = [G; alpha] k*.  The product runs on the tensor cores in
//   3xTF32 (hi*hi + hi*lo + lo*hi, hi = tf32_rna(x), lo = tf32_rna(x - hi),
//   FP32 accumulation; the dropped lo*lo term is O(2^-22)).  Bound on the
//   H100: 3 n(n+1) m b flops at 495 TFLOP/s TF32 plus the k* build at 67
//   TFLOP/s FP32, ~0.028 ms.  k* (FP32, direct differences; never on the
//   tensor cores: the augmented-matmul form of z cancels) is built once per
//   call by a pre-pass into a buffer that the wrapper keeps beside the
//   saved v.  The mean comes from alpha as row n of the product; qf is a
//   masked sum of v^2 over the G rows only.
// - fused_predict_bwd (bwd_wgmma_kernel + rowsum_kernel):
//   grad_precision="default".  Its cotangent product G^T v MAY drop below
//   FP32 (the TPU kernel ran it in one bf16 pass; the accept step uses the
//   exact value, so a cheap gradient is legal): it runs on the tensor cores
//   in ONE TF32 pass (both operands rounded to nearest TF32, FP32
//   accumulation; 2^-11 against the TPU's 2^-9).  The row scale 2 ct_qf,
//   the alpha ct_mean term, ct_z = k* ct_k* with the forward's k*, and the
//   query contraction (in its difference form sum_l ct_z (xs - qs); the
//   split form xs^T ct_z - qs sum ct_z cancels) stay FP32 FMA.  Bound: one
//   TF32 pass plus those FP32 parts, ~0.015 ms.
// - fused_predict_bwd_high (bwd_high_kernel + rowsum_kernel):
//   grad_precision="high" / "highest".  The same cotangent at FP32-class
//   accuracy, for good: G^T v on the tensor cores in 3xTF32 (v^T split into
//   TF32 halves in shared memory, G^T's halves in the kernel factor), each
//   ring stage's products summed into a fresh accumulator that is added to
//   the running sum in FP32; the rest FP32 FMA as in the fast backward,
//   with the forward's k*.  The TPU kernel ran both cotangent products in
//   3-pass bf16 (_dot3), so this is stricter than the reference.  Bound:
//   three TF32 passes plus the FP32 parts, ~0.031 ms.
//
// All three product kernels (fwd_wgmma_kernel, bwd_wgmma_kernel,
// bwd_high_kernel) share one Hopper design; the two backwards are one body
// (bwd_body) that differs only in the product and its operands:
// - walkers on the M side of the product, so that both operands of both
//   products are K-major, the only layout wgmma takes for TF32:
//     forward   v^T[j, i]       = sum_l k*^T[j, l] [G; alpha][i, l]
//     backward  (G^T v)^T[j, l] = sum_i v^T[j, i] G^T[l, i]
//   kstar_kernel writes k*^T (walkers x training rows), the forward writes
//   its saved v as v^T, and build_fused_state keeps the kernels' copy of
//   the factor (the "kernel factor", (b, 4, n + 1, ld)): [G; alpha] split
//   into its TF32 halves (planes 0, 1) and G^T split likewise (plane 2 the
//   hi half, G^T rounded to nearest TF32; plane 3 the lo half, which only
//   the three-pass backward reads), every row padded to ld = n rounded up
//   to 4 floats, the 16-byte row stride TMA needs.  The 2 ct_qf column scale of the old layout is a row
//   scale in the backward's epilogue.  (The other way, A from registers,
//   would read G^T as fragments from G's rows, as the sm_80 kernels did,
//   but puts every operand element through the registers of each
//   consumer; the transposed copy costs 4 MB a GP per plane, once.)
// - a ring of shared-memory stages (32 contraction steps = one 128-byte
//   swizzle row of floats per tile row; 4 stages) filled by TMA
//   (cp.async.bulk.tensor, 128-byte swizzle, ragged edges zero-filled by
//   the hardware) and tracked by mbarriers: a full barrier per stage that
//   the copies complete, an empty barrier per stage that the consumers
//   release.  One producer warpgroup, one thread of which keeps the copies
//   of the next stages in flight; one or two consumer warpgroups, each the
//   64 walkers x TN (128) rows of one wgmma.mma_async m64n128k8 TF32
//   product with both operands in shared memory and FP32 sums in
//   registers.  The tensor-map descriptor of the kernel factor is encoded
//   once per fused state (the wrapper caches it); those of the per-call
//   k*^T and v^T buffers are encoded per call on the host, by a pure host
//   function obtained through cudaGetDriverEntryPoint (no -lcuda).
//   setmaxnreg is not used: the consumers fit in the 168 registers that
//   three warpgroups leave, without spills;
// - 3xTF32 (forward, three-pass backward): the tensor cores read a float32
//   operand as TF32 by dropping its low 13 bits, so the halves must exist
//   as data: the factor's in the kernel factor, the per-call operand's (k*
//   in the forward, v^T in the backward) split in shared memory by the
//   warpgroup that reads the landed stage (hi in place, lo into a tile of
//   its own: one raw plane in device memory, not two; SPLIT_IN_SMEM);
// - FP32 promotion (forward, three-pass backward): the tensor cores' FP32
//   accumulation inside an
//   mma is not rounded to nearest (chained over all 125 steps of the
//   flagship's contraction it cost 7e-5 of the mean), so each ring stage's
//   12 products (4 steps x 3 passes) go into a fresh accumulator (scale-d
//   = 0) that is added to the running sum in FP32: a promotion interval of
//   one stage, 32 contraction steps (PROMOTE; the three-pass backward
//   always one stage).  Each stage therefore waits
//   for its products; with a longer
//   interval the products of one stage stay in flight while the next is
//   split, but ptxas then serializes the wgmmas (its note C7518), and it
//   measured slower;
// - rounding (fast backward): G^T is rounded to nearest TF32 once, in the
//   kernel factor; each landed v^T stage is rounded in place in shared
//   memory by the warpgroup that reads it, while the previous stage's
//   products run (one wgmma group kept in flight), so both operands are
//   rounded to nearest, not truncated;
// - k* (both backwards): the forward's k*^T, not a recompute of z (which
//   cost the sm_80 backwards a third of their time).  The plain backward's
//   z < 0 mask is not needed: z = 0 only where xs_l = qs_j in every
//   dimension, and there the query contraction multiplies by 0;
// - triangular balance: a block takes the pair of row tiles (r, R - 1 - r)
//   of one (GP, walker tile), so every block does the same work; a tile
//   contracts only the columns its rows reach (the alpha row all n);
// - walker count: BM = 128 walkers per block (two consumer warpgroups)
//   unless the grid would fill less than half the SMs, then BM = 64 (one),
//   which doubles the blocks at m = 256.  The choice never changes a sum:
//   each walker's row is summed in the same order whatever BM or m, so a
//   walker's values do not depend on the walkers beside it;
// - cross-block reductions (qf over row tiles, ct_xq over training-row
//   tiles) go through per-block partial sums and a second, deterministic
//   pass (rowsum_kernel).  No float atomics.
// What holds them back on the H100 (PERF.md; tools/torch_predict_variants.py
// times the knobs and a few diagnostics): in the forward, the k* pre-pass
// (0.020 of 0.071 ms) and, in fwd_wgmma_kernel, products that do not
// overlap the ring's copies and splits (without its products the forward
// takes 0.051 ms); in the fast backward, the query contraction (about 70
// FP32 instructions per element; 0.020 of 0.050 ms), which no product
// overlaps, then the rounding pass and the products (0.005 ms each).
//
// In the three-pass backward a stage holds v^T's tile and both halves of
// G^T's (48 KB at 128 walkers), and v^T's lo half needs a tile of its own.
// The ring is two stages deep (HIGH_STAGES): a third fits beside the
// epilogue's buffers but measured slower at 1024 walkers on the H100 and
// no faster at 256 (tools/torch_predict_variants.py, high_stages_3).  A stage's
// products are waited for before the FP32 promotion, and a warpgroup
// barrier follows, so that no warp splits the next stage into the lo tile
// while another warp's products may still read it.

// Each entry launches on the caller's stream, allocates nothing (the
// wrapper allocates outputs and the scratch that fused_predict_scratch
// sizes), and returns cudaGetLastError() (or FP_ERR_TMA when a tensor-map
// descriptor cannot be encoded).

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int DMAX = 32;  // largest supported input dimension
constexpr int FP_ERR_TMA = 7001;  // a tensor-map descriptor could not be encoded

// --------------------------------------------- design knobs (Hopper kernels)
constexpr int FWD_STAGES = 4;          // forward ring depth
constexpr int BWD_STAGES = 4;          // fast backward ring depth
constexpr int HIGH_STAGES = 2;         // three-pass backward ring depth
constexpr int PROMOTE = 1;             // ring stages chained into a fresh sum before the FP32 add
constexpr bool SPLIT_IN_SMEM = true;   // k*: split in shared memory (true) or by kstar_kernel
constexpr int TN = 128;                // rows of [G; alpha] / of G^T per tile (wgmma N), 64 or 128

constexpr int BK = 32;                 // contraction steps per ring stage (128 bytes of floats)
constexpr int KST_PLANES = SPLIT_IN_SMEM ? 1 : 2;
constexpr int FACTOR_PLANES = 4;       // planes of the kernel factor per GP
constexpr int XS_LD = DMAX + 4;        // rows of xs / qs, read 4 dimensions at a time
constexpr int CQ_LD = DMAX + 1;
static_assert(TN == 64 || TN == 128, "wgmma tiles of 64 or 128 rows");

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
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ float tf32_round(float x) { return __uint_as_float(tf32_rna(x)); }

// x = hi + lo to ~2^-22: both halves are TF32 values
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// ------------------------------------- Hopper: mbarriers, TMA, wgmma, barriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// the barriers' initialisation, visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// wait for the completion of the barrier's phase of this parity; a wait
// that never ends traps (an error the wrapper raises), it does not hang
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (tries > (1u << 26)) __trap();
  }
}

// one 3-d tile of a tensor map into shared memory; completes on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// generic-proxy writes to shared memory, visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(nthreads) : "memory");
}

// wgmma descriptor of a K-major tile with 128-byte swizzle (rows of 128
// bytes, 8-row atoms 1024 bytes apart); the tile starts 1024-aligned
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return (uint64_t)((smem_u32(tile) >> 4) & 0x3FFF) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (+)= a b for one 64 x 64 x 8 TF32 tile, A and B from shared memory (K-major,
// 128-byte swizzle); scale_d = 0 writes a fresh sum
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// the same for a 64 x 128 x 8 tile
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tile(float (&d)[64], uint64_t da, uint64_t db, int sc) {
  wgmma_n128(d, da, db, sc);
}
__device__ __forceinline__ void wgmma_tile(float (&d)[32], uint64_t da, uint64_t db, int sc) {
  wgmma_n64(d, da, db, sc);
}

// ------------------------------------------------------ row and query tiles

// Rows [l0, l0 + kRows) of xs_k into xs_s (row stride XS_LD), zero-padded
// to d4 (d rounded up to 4), so that the difference loops read float4s and
// the padding adds 0.  kChunk loads per thread are in flight at once (one
// latency per chunk, not per row group); a small kChunk spares registers.
template <int kRows, int kNT, int kChunk>
__device__ __forceinline__ void load_rows(float* xs_s, const float* xs_k, int l0, int n,
                                          int d, int tid) {
  constexpr int kPer = kRows * DMAX / kNT;
  static_assert(kRows * DMAX % kNT == 0 && kPer % kChunk == 0, "whole passes");
  const int d4 = (d + 3) & ~3;
#pragma unroll 1
  for (int r0 = 0; r0 < kPer; r0 += kChunk) {
    float val[kChunk];
#pragma unroll
    for (int r = 0; r < kChunk; ++r) {
      const int e = tid + (r0 + r) * kNT, ll = e / DMAX, dd = e % DMAX, l = l0 + ll;
      val[r] = (l < n && dd < d) ? xs_k[(size_t)l * d + dd] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kChunk; ++r) {
      const int e = tid + (r0 + r) * kNT, ll = e / DMAX, dd = e % DMAX;
      if (dd < d4) xs_s[ll * XS_LD + dd] = val[r];
    }
  }
}

// The scaled queries [q0, q0 + kRows) of GP k into qs_s, padded like load_rows.
template <int kRows, int kNT>
__device__ __forceinline__ void load_queries(float* qs_s, const float* xq, const float* il_k,
                                             int q0, int m, int d, int tid) {
  const int d4 = (d + 3) & ~3;
  constexpr int kPer = kRows * DMAX / kNT;
  float val[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int e = tid + r * kNT, jj = e / DMAX, dd = e % DMAX, j = q0 + jj;
    val[r] = (j < m && dd < d) ? xq[(size_t)j * d + dd] * il_k[dd] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int e = tid + r * kNT, jj = e / DMAX, dd = e % DMAX;
    if (dd < d4) qs_s[jj * XS_LD + dd] = val[r];
  }
}

// ---------------------------------------------------------- k* (pre-pass)

// k*^T[h, k, j, l] for j < m, l < n: amp_k exp(min(z, 0)), one raw plane
// (split into TF32 halves, h = 0 hi and h = 1 lo, when not SPLIT_IN_SMEM).
// One KS_L x KS_J tile (training rows x walkers) per block; a thread takes
// one training row and KS_R walkers KS_G apart, so that the rows of k*^T
// are written along l and a warp reads one query row at a time
// (broadcast).
constexpr int KS_L = 64, KS_J = 64;
constexpr int KS_G = 256 / KS_L, KS_R = KS_J / KS_G;

__global__ void __launch_bounds__(256, 4)
kstar_kernel(const float* __restrict__ xs,      // (b, n, d)
             const float* __restrict__ xq,      // (m, d)
             const float* __restrict__ inv_ls,  // (b, d)
             const float* __restrict__ amp,     // (b,)
             float* __restrict__ kst,           // (KST_PLANES, b, m, ld)
             int b, int n, int m, int ld, int d) {
  __shared__ __align__(16) float xs_s[KS_L * XS_LD];
  __shared__ __align__(16) float qs_s[KS_J * XS_LD];
  const int k = blockIdx.z, l0 = blockIdx.x * KS_L, j0 = blockIdx.y * KS_J;
  const int tid = threadIdx.x;
  load_rows<KS_L, 256, KS_L * DMAX / 256>(xs_s, xs + (size_t)k * n * d, l0, n, d, tid);
  load_queries<KS_J, 256>(qs_s, xq, inv_ls + k * d, j0, m, d, tid);
  __syncthreads();
  const int ll = tid % KS_L, jr = tid / KS_L;  // a warp shares jr
  float d2[KS_R];
#pragma unroll
  for (int r = 0; r < KS_R; ++r) d2[r] = 0.f;
  for (int dd = 0; dd < d; dd += 4) {
    const float4 x = *reinterpret_cast<const float4*>(xs_s + ll * XS_LD + dd);
#pragma unroll
    for (int r = 0; r < KS_R; ++r) {
      const float4 q = *reinterpret_cast<const float4*>(qs_s + (jr + KS_G * r) * XS_LD + dd);
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
  const int l = l0 + ll;
  if (l >= n) return;
  const size_t plane = (size_t)b * m * ld;
#pragma unroll
  for (int r = 0; r < KS_R; ++r) {
    const int j = j0 + jr + KS_G * r;
    if (j < m) {
      const float val = amp_k * expf(fminf(-0.5f * d2[r], 0.f));
      float* out = kst + ((size_t)k * m + j) * ld + l;
      if constexpr (SPLIT_IN_SMEM) {
        out[0] = val;
      } else {
        uint32_t hi, lo;
        split_tf32(val, hi, lo);
        out[0] = __uint_as_float(hi);
        out[plane] = __uint_as_float(lo);
      }
    }
  }
}

// ------------------------------------------- Hopper kernels (1: forward, 2: fast backward)

// Shared-memory layout of a block with kCons consumer warpgroups (BM =
// 64 kCons walkers); every tile starts 1024-aligned (the swizzle atom).
// A stage of the forward holds the k*^T tile (raw, or its hi and lo halves)
// and the [G; alpha] tile's halves.  k*'s lo half, when the consumers split
// it, goes to one of two tiles per warpgroup after the ring, by the parity
// of the stage (the previous stage's products may still be reading the
// other).
template <int kCons>
struct Fwd {
  static constexpr int BM = 64 * kCons;
  static constexpr int A_BYTES = BM * BK * 4;  // one half of a k*^T tile
  static constexpr int B_BYTES = TN * BK * 4;  // one half of a [G; alpha] tile
  static constexpr int STAGE = KST_PLANES * A_BYTES + 2 * B_BYTES;
  static constexpr int B_OFF = KST_PLANES * A_BYTES;  // [G; alpha] hi, then lo
  static constexpr int TX = STAGE;                    // bytes the copies bring
  static constexpr int ALO_OFF = FWD_STAGES * STAGE;  // the split k*'s lo tiles
  static constexpr int BAR_OFF = ALO_OFF + (SPLIT_IN_SMEM ? 2 * A_BYTES : 0);
  static constexpr int SMEM = BAR_OFF + 2 * FWD_STAGES * 8 + 1024;
  static_assert(SMEM <= 232448, "forward ring fits in shared memory");
};

// The backwards' layout (kHigh: the three-pass one).  A stage holds the
// v^T tile and G^T's tile (rounded to nearest TF32), and for the three-pass
// backward also G^T's lo tile (plane 3 of the kernel factor); v^T's lo half
// goes to one tile per warpgroup after the ring.
template <int kCons, bool kHigh>
struct Bwd {
  static constexpr int STAGES = kHigh ? HIGH_STAGES : BWD_STAGES;
  static constexpr int BM = 64 * kCons;
  static constexpr int A_BYTES = BM * BK * 4;  // a v^T tile
  static constexpr int B_BYTES = TN * BK * 4;  // a G^T tile (one half)
  static constexpr int STAGE = A_BYTES + (kHigh ? 2 : 1) * B_BYTES;
  static constexpr int RING = STAGES * STAGE;
  // after the ring: v^T's lo tile (three-pass), xs rows of the tile, scaled
  // queries, the query cotangent of the pair, alpha of the tile, the barriers
  static constexpr int ALO_OFF = RING;
  static constexpr int XS_OFF = ALO_OFF + (kHigh ? A_BYTES : 0);
  static constexpr int QS_OFF = XS_OFF + TN * XS_LD * 4;
  static constexpr int CQ_OFF = QS_OFF + BM * XS_LD * 4;
  static constexpr int AL_OFF = CQ_OFF + BM * CQ_LD * 4;
  static constexpr int BAR_OFF = AL_OFF + TN * 4;
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;
  static_assert(SMEM <= 232448, "backward ring and epilogue fit in shared memory");
};

// *x = hi, *lo = lo of the four floats at x (in shared memory)
__device__ __forceinline__ void split4(float4* x, float4* lo) {
  float4 v = *x, l;
  uint32_t h, r;
  split_tf32(v.x, h, r); v.x = __uint_as_float(h); l.x = __uint_as_float(r);
  split_tf32(v.y, h, r); v.y = __uint_as_float(h); l.y = __uint_as_float(r);
  split_tf32(v.z, h, r); v.z = __uint_as_float(h); l.z = __uint_as_float(r);
  split_tf32(v.w, h, r); v.w = __uint_as_float(h); l.w = __uint_as_float(r);
  *x = v;
  *lo = l;
}

// the four floats at x rounded to nearest TF32 in place
__device__ __forceinline__ void round4(float4* x) {
  float4 v = *x;
  v.x = tf32_round(v.x);
  v.y = tf32_round(v.y);
  v.z = tf32_round(v.z);
  v.w = tf32_round(v.w);
  *x = v;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

// v^T = k*^T [G; alpha]^T in 3xTF32 for the row tiles (R - 1 - p, p) of one
// (GP, walker tile); the mean from row n, the qf partial over both tiles.
template <int kCons>
__global__ void __launch_bounds__(128 * (kCons + 1), 1)
fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_kst,  // k*^T planes {n, m, KST_PLANES b}
                 const __grid_constant__ CUtensorMap tm_fac,  // kernel factor {n, n + 1, 4 b}
                 float* __restrict__ mean,      // (b, m)
                 float* __restrict__ qf_part,   // (b, npairs, m)
                 float* __restrict__ vt,        // (b, m, ld) or nullptr
                 int b, int n, int m, int ld, int nrb, int npairs) {
  using C = Fwd<kCons>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + FWD_STAGES;
  const int k = blockIdx.z, p = blockIdx.y, j0 = blockIdx.x * C::BM;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < FWD_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kCons);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int ntiles = (nrb - 1 - p == p) ? 1 : 2;

  if (wg == kCons) {
    // producer: one thread keeps the ring's copies in flight
    if (threadIdx.x == 128 * kCons) {
      int it = 0;
      for (int s = 0; s < ntiles; ++s) {
        const int i0 = (s == 0 ? nrb - 1 - p : p) * TN;
        // rows [i0, i0 + TN) of the lower-triangular G have no entries past
        // column i0 + TN - 1; the alpha row (i == n) needs every column
        const int ktiles = (min(n, i0 + TN) + BK - 1) / BK;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int slot = it % FWD_STAGES;
          mbar_wait(&empty[slot], ((it / FWD_STAGES) & 1) ^ 1);
          uint8_t* st = smem + slot * C::STAGE;
          mbar_expect_tx(&full[slot], C::TX);
          tma_load_3d(st, &tm_kst, &full[slot], kt * BK, j0, k);
          if constexpr (!SPLIT_IN_SMEM)
            tma_load_3d(st + C::A_BYTES, &tm_kst, &full[slot], kt * BK, j0, b + k);
          tma_load_3d(st + C::B_OFF, &tm_fac, &full[slot], kt * BK, i0, FACTOR_PLANES * k);
          tma_load_3d(st + C::B_OFF + C::B_BYTES, &tm_fac, &full[slot], kt * BK, i0,
                      FACTOR_PLANES * k + 1);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg takes walkers [64 wg, 64 wg + 64) of the tile.
  // Accumulator element 4c + 2h + e of a thread is walker row jl + 8h,
  // column 8c + 2t + e of the tile.
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int jl = wg * 64 + warp * 16 + g;
  float qf_acc[2] = {0.f, 0.f};
  int it = 0;
  for (int s = 0; s < ntiles; ++s) {
    const int i0 = (s == 0 ? nrb - 1 - p : p) * TN;
    const int ktiles = (min(n, i0 + TN) + BK - 1) / BK;
    float acc[TN / 2], part[TN / 2];
#pragma unroll
    for (int e = 0; e < TN / 2; ++e) acc[e] = part[e] = 0.f;
    int prev = -1;  // the slot whose products are in flight
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int slot = it % FWD_STAGES;
      mbar_wait(&full[slot], (it / FWD_STAGES) & 1);
      uint8_t* st = smem + slot * C::STAGE;
      float* a_hi = reinterpret_cast<float*>(st) + wg * 64 * BK;
      float* a_lo = reinterpret_cast<float*>(
                        SPLIT_IN_SMEM ? smem + C::ALO_OFF + (kt & 1) * C::A_BYTES : st + C::A_BYTES) +
                    wg * 64 * BK;
      if constexpr (SPLIT_IN_SMEM) {
        // this warpgroup's 64 rows of the raw k*^T stage -> hi in place, lo,
        // element by element (the swizzle moves whole 16-byte chunks, so
        // positions need no decoding), while the previous stage's products
        // run
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split4(reinterpret_cast<float4*>(a_hi) + tid + 128 * q,
                 reinterpret_cast<float4*>(a_lo) + tid + 128 * q);
        fence_proxy_async();
        named_bar_sync(1 + wg, 128);
      }
      const uint64_t dah = sw128_desc(a_hi), dal = sw128_desc(a_lo);
      const uint64_t dbh = sw128_desc(st + C::B_OFF);
      const uint64_t dbl = sw128_desc(st + C::B_OFF + C::B_BYTES);
      const bool fresh = kt % PROMOTE == 0;
      const bool flush = kt % PROMOTE == PROMOTE - 1 || kt == ktiles - 1;
      fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        // 32 bytes per 8-deep step inside the swizzled rows; small terms first
        wgmma_tile(part, dal + 2 * kk, dbh + 2 * kk, (fresh && kk == 0) ? 0 : 1);
        wgmma_tile(part, dah + 2 * kk, dbl + 2 * kk, 1);
        wgmma_tile(part, dah + 2 * kk, dbh + 2 * kk, 1);
      }
      wgmma_commit();
      if (flush) {
        wgmma_wait<0>();
        fence_regs(part);
        if (prev >= 0) mbar_arrive(&empty[prev]);
        mbar_arrive(&empty[slot]);
        prev = -1;
        // the tensor cores' sums are not rounded to nearest: the group's
        // products went into a fresh sum, promoted here in FP32
#pragma unroll
        for (int e = 0; e < TN / 2; ++e) acc[e] += part[e];
      } else {
        // this stage's products stay in flight while the next stage is
        // split; the previous stage's are done
        wgmma_wait<1>();
        if (prev >= 0) mbar_arrive(&empty[prev]);
        prev = slot;
      }
    }

    // epilogue: v^T rows (zeros past n in the padded row), the masked
    // quadratic form (G rows only), the mean from the alpha row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + jl + 8 * h;
      float q = 0.f;
#pragma unroll
      for (int c = 0; c < TN / 8; ++c) {
        const int i = i0 + 8 * c + 2 * t;
        const float v0 = acc[4 * c + 2 * h], v1 = acc[4 * c + 2 * h + 1];
        if (i < n) q = fmaf(v0, v0, q);
        if (i + 1 < n) q = fmaf(v1, v1, q);
        if (j < m) {
          if (vt != nullptr && i < ld) {
            *reinterpret_cast<float2*>(vt + ((size_t)k * m + j) * ld + i) =
                make_float2(i < n ? v0 : 0.f, i + 1 < n ? v1 : 0.f);
          }
          if (i == n) mean[(size_t)k * m + j] = v0;
          if (i + 1 == n) mean[(size_t)k * m + j] = v1;
        }
      }
      q += __shfl_xor_sync(0xffffffffu, q, 1);
      q += __shfl_xor_sync(0xffffffffu, q, 2);
      qf_acc[h] += q;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = j0 + jl + 8 * h;
    if (t == 0 && j < m) qf_part[((size_t)k * npairs + p) * m + j] = qf_acc[h];
  }
}

// (G^T v)^T for the training-row tiles (p, R - 1 - p) of one (GP, walker
// tile): in one TF32 pass (fast backward), or in 3xTF32 with each ring
// stage's products promoted to the FP32 sum (kHigh, the three-pass
// backward); then ct_k* = 2 ct_qf (G^T v) + alpha ct_mean, ct_z and the
// query cotangent in FP32; ct_part holds the pair's partial sum.
template <int kCons, bool kHigh>
__device__ __forceinline__ void bwd_body(
    const CUtensorMap* tm_v, const CUtensorMap* tm_fac, const float* __restrict__ xs,
    const float* __restrict__ xq, const float* __restrict__ inv_ls,
    const float* __restrict__ alpha, const float* __restrict__ kst,
    const float* __restrict__ ct_mean, const float* __restrict__ ct_qf,
    float* __restrict__ ct_part, int b, int n, int m, int d, int ld, int nlb, int npairs) {
  using C = Bwd<kCons, kHigh>;
  constexpr int NC = 128 * kCons;  // consumer threads
  constexpr int S = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* xs_s = reinterpret_cast<float*>(smem + C::XS_OFF);  // [TN][XS_LD]
  float* qs_s = reinterpret_cast<float*>(smem + C::QS_OFF);  // [BM][XS_LD]
  float* cq_s = reinterpret_cast<float*>(smem + C::CQ_OFF);  // [BM][CQ_LD]
  float* al_s = reinterpret_cast<float*>(smem + C::AL_OFF);  // [TN]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + S;
  const int k = blockIdx.z, p = blockIdx.y, j0 = blockIdx.x * C::BM;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int ntiles = (nlb - 1 - p == p) ? 1 : 2;
  const int kend = (n + BK - 1) / BK;

  if (wg == kCons) {
    if (threadIdx.x == NC) {
      int it = 0;
      for (int s = 0; s < ntiles; ++s) {
        const int l0 = (s == 0 ? p : nlb - 1 - p) * TN;
        // G is lower triangular: only rows i >= l0 reach columns l >= l0
        for (int kt = l0 / BK; kt < kend; ++kt, ++it) {
          const int slot = it % S;
          mbar_wait(&empty[slot], ((it / S) & 1) ^ 1);
          uint8_t* st = smem + slot * C::STAGE;
          mbar_expect_tx(&full[slot], C::STAGE);
          tma_load_3d(st, tm_v, &full[slot], kt * BK, j0, k);
          tma_load_3d(st + C::A_BYTES, tm_fac, &full[slot], kt * BK, l0, FACTOR_PLANES * k + 2);
          if constexpr (kHigh)
            tma_load_3d(st + C::A_BYTES + C::B_BYTES, tm_fac, &full[slot], kt * BK, l0,
                        FACTOR_PLANES * k + 3);
        }
      }
    }
    return;
  }

  const int tid = threadIdx.x;  // consumers are threads [0, NC)
  const int wtid = tid % 128, warp = wtid / 32, lane = wtid % 32;
  const int g = lane / 4, t = lane % 4;
  const int jl = wg * 64 + warp * 16 + g;  // rows jl, jl + 8 of the walker tile
  const float* xs_k = xs + (size_t)k * n * d;
  load_queries<C::BM, NC>(qs_s, xq, inv_ls + k * d, j0, m, d, tid);
  for (int e = tid; e < C::BM * CQ_LD; e += NC) cq_s[e] = 0.f;
  float ctq2[2], ctm[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = j0 + jl + 8 * h;
    ctq2[h] = (j < m) ? 2.f * ct_qf[(size_t)k * m + j] : 0.f;
    ctm[h] = (j < m) ? ct_mean[(size_t)k * m + j] : 0.f;
  }
  named_bar_sync(3, NC);

  int it = 0;
  for (int s = 0; s < ntiles; ++s) {
    const int l0 = (s == 0 ? p : nlb - 1 - p) * TN;
    float acc[TN / 2];
#pragma unroll
    for (int e = 0; e < TN / 2; ++e) acc[e] = 0.f;
    int prev = -1;
    for (int kt = l0 / BK; kt < kend; ++kt, ++it) {
      const int slot = it % S;
      mbar_wait(&full[slot], (it / S) & 1);
      uint8_t* st = smem + slot * C::STAGE;
      float* a = reinterpret_cast<float*>(st) + wg * 64 * BK;
      const uint64_t db = sw128_desc(st + C::A_BYTES);
      if constexpr (kHigh) {
        // this warpgroup's 64 rows of v^T -> hi in place, lo into its tile
        // (the tensor cores would drop the low bits); G^T's halves are
        // planes 2 and 3 of the kernel factor
        float* alo = reinterpret_cast<float*>(smem + C::ALO_OFF) + wg * 64 * BK;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split4(reinterpret_cast<float4*>(a) + wtid + 128 * q,
                 reinterpret_cast<float4*>(alo) + wtid + 128 * q);
        fence_proxy_async();
        named_bar_sync(1 + wg, 128);
        const uint64_t dah = sw128_desc(a), dal = sw128_desc(alo);
        const uint64_t dbl = sw128_desc(st + C::A_BYTES + C::B_BYTES);
        float part[TN / 2];
        fence_regs(part);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
          // the stage's 12 products into a fresh sum, small terms first
          wgmma_tile(part, dal + 2 * kk, db + 2 * kk, kk == 0 ? 0 : 1);
          wgmma_tile(part, dah + 2 * kk, dbl + 2 * kk, 1);
          wgmma_tile(part, dah + 2 * kk, db + 2 * kk, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
        // every warp's products are done before the lo tile is rewritten
        named_bar_sync(1 + wg, 128);
        mbar_arrive(&empty[slot]);
        // the tensor cores' sums are not rounded to nearest: promoted here
        // in FP32, every stage (32 contraction steps, whatever m)
#pragma unroll
        for (int e = 0; e < TN / 2; ++e) acc[e] += part[e];
      } else {
        // round this warpgroup's 64 rows of v^T to nearest TF32 in place (the
        // tensor cores would drop the low bits); G^T is rounded in memory
#pragma unroll
        for (int q = 0; q < 4; ++q) round4(reinterpret_cast<float4*>(a) + wtid + 128 * q);
        fence_proxy_async();
        named_bar_sync(1 + wg, 128);
        const uint64_t da = sw128_desc(a);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) wgmma_tile(acc, da + 2 * kk, db + 2 * kk, 1);
        wgmma_commit();
        // keep this stage's products in flight; the previous stage's are done
        wgmma_wait<1>();
        fence_regs(acc);
        if (prev >= 0) mbar_arrive(&empty[prev]);
        prev = slot;
      }
    }
    // the forward's k* for this thread's 2 rows x (TN / 4) columns, loaded
    // while the last products finish (k*^T rows are walkers; hi + lo when
    // kstar_kernel split it in device memory)
    float kv[TN / 2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + jl + 8 * h;
      const float* kr = kst + ((size_t)k * m + min(j, m - 1)) * ld + l0 + 2 * t;
#pragma unroll
      for (int c = 0; c < TN / 8; ++c) {
        const int l = l0 + 8 * c + 2 * t;
        float2 v2 = make_float2(0.f, 0.f);
        if (j < m && l < ld) {
          v2 = *reinterpret_cast<const float2*>(kr + 8 * c);
          if constexpr (KST_PLANES == 2) {
            const float2 lo = *reinterpret_cast<const float2*>(kr + 8 * c + (size_t)b * m * ld);
            v2.x += lo.x;
            v2.y += lo.y;
          }
        }
        kv[4 * c + 2 * h] = v2.x;
        kv[4 * c + 2 * h + 1] = v2.y;
      }
    }
    if constexpr (!kHigh) {
      wgmma_wait<0>();
      fence_regs(acc);
      if (prev >= 0) mbar_arrive(&empty[prev]);
    }

    // epilogue, FP32: the tile's xs rows and alpha
    load_rows<TN, NC, 4>(xs_s, xs_k, l0, n, d, tid);  // acc is live: 4 loads at a time
    for (int e = tid; e < TN; e += NC) al_s[e] = (l0 + e < n) ? alpha[(size_t)k * n + l0 + e] : 0.f;
    named_bar_sync(3, NC);
    // ct_z = k* ct_k* in place of the product.  The plain backward's z < 0
    // mask is not needed: z = 0 only where xs_l = qs_j in every dimension,
    // and there the query contraction multiplies by xs_l - qs_j = 0
#pragma unroll
    for (int c = 0; c < TN / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ll = 8 * c + 2 * t + e;
        const float a_l = al_s[ll];
        const bool in = l0 + ll < n;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int idx = 4 * c + 2 * h + e;
          const float ctk = fmaf(ctq2[h], acc[idx], a_l * ctm[h]);
          acc[idx] = in ? kv[idx] * ctk : 0.f;
        }
      }
    // ct_xq[j, :] over the tile's columns, 4 dimensions at a time (the
    // padding of xs and qs to d4 adds 0), in the difference form; the
    // quad's four column sets meet by shuffles
    for (int d0 = 0; d0 < d; d0 += 4) {
      float4 qa[2], sa[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        qa[h] = *reinterpret_cast<const float4*>(qs_s + (jl + 8 * h) * XS_LD + d0);
        sa[h] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int c = 0; c < TN / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 x = *reinterpret_cast<const float4*>(xs_s + (8 * c + 2 * t + e) * XS_LD + d0);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float cz = acc[4 * c + 2 * h + e];
            sa[h].x = fmaf(cz, x.x - qa[h].x, sa[h].x);
            sa[h].y = fmaf(cz, x.y - qa[h].y, sa[h].y);
            sa[h].z = fmaf(cz, x.z - qa[h].z, sa[h].z);
            sa[h].w = fmaf(cz, x.w - qa[h].w, sa[h].w);
          }
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* v4 = reinterpret_cast<float*>(&sa[h]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          v4[u] += __shfl_xor_sync(0xffffffffu, v4[u], 1);
          v4[u] += __shfl_xor_sync(0xffffffffu, v4[u], 2);
        }
        if (t == 0) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (d0 + u < d) cq_s[(jl + 8 * h) * CQ_LD + d0 + u] += v4[u];
        }
      }
    }
    named_bar_sync(3, NC);  // xs_s and al_s are the next tile's
  }
  const float* il_k = inv_ls + (size_t)k * d;
  for (int e = tid; e < C::BM * d; e += NC) {
    const int jj = e / d, dd = e % d;
    if (j0 + jj < m) {
      ct_part[(((size_t)k * npairs + p) * m + j0 + jj) * d + dd] = cq_s[jj * CQ_LD + dd] * il_k[dd];
    }
  }
}

#define BWD_PARAMS                                                                          \
  const __grid_constant__ CUtensorMap tm_v,   /* v^T {n, m, b} */                           \
      const __grid_constant__ CUtensorMap tm_fac, /* kernel factor {n, n + 1, 4 b} */       \
      const float* __restrict__ xs,               /* (b, n, d) */                           \
      const float* __restrict__ xq,               /* (m, d) */                              \
      const float* __restrict__ inv_ls,           /* (b, d) */                              \
      const float* __restrict__ alpha,            /* (b, n) */                              \
      const float* __restrict__ kst,              /* k*^T planes (KST_PLANES, b, m, ld) */  \
      const float* __restrict__ ct_mean,          /* (b, m) */                              \
      const float* __restrict__ ct_qf,            /* (b, m) */                              \
      float* __restrict__ ct_part,                /* (b, npairs, m, d) */                   \
      int b, int n, int m, int d, int ld, int nlb, int npairs
#define BWD_ARGS \
  &tm_v, &tm_fac, xs, xq, inv_ls, alpha, kst, ct_mean, ct_qf, ct_part, b, n, m, d, ld, nlb, npairs

// kernel 2: the fast backward, one TF32 pass
template <int kCons>
__global__ void __launch_bounds__(128 * (kCons + 1), 1) bwd_wgmma_kernel(BWD_PARAMS) {
  bwd_body<kCons, false>(BWD_ARGS);
}

// kernel 3: the three-pass backward, 3xTF32 with FP32 promotion per stage
template <int kCons>
__global__ void __launch_bounds__(128 * (kCons + 1), 1) bwd_high_kernel(BWD_PARAMS) {
  bwd_body<kCons, true>(BWD_ARGS);
}

// ------------------------------------------------------------ host side

int factor_ld(int n) { return (n + 3) / 4 * 4; }
int fwd_pairs(int n) { return ((n + 1 + TN - 1) / TN + 1) / 2; }
int bwd_pairs(int n) { return ((n + TN - 1) / TN + 1) / 2; }

bool bad_shape(int b, int n, int m, int d) {
  return d < 1 || d > DMAX || n < 1 || m < 1 || b < 1;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn lookup_encode() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                       &q) != cudaSuccess)
    return nullptr;
#else
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q) !=
      cudaSuccess)
    return nullptr;
#endif
  return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(fn) : nullptr;
}

// A float32 tensor of `planes` planes of `rows` rows of `cols` floats (row
// stride ld floats, plane stride rows * ld), read in boxes of BK columns x
// box_rows rows with 128-byte swizzle; out-of-range elements read as 0.
int encode_planes(CUtensorMap* map, const float* base, int cols, int rows, int planes, int ld,
                  int box_rows) {
  static const EncodeTiledFn encode = lookup_encode();
  if (encode == nullptr || !aligned16(base)) return FP_ERR_TMA;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 4, (cuuint64_t)rows * ld * 4};
  const cuuint32_t box[3] = {(cuuint32_t)BK, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base),
                            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : FP_ERR_TMA;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms;
}

// one consumer warpgroup per block (64 walkers) where two would leave more
// than half the SMs idle; the sums are the same either way
bool one_consumer(long long blocks128) { return 2 * blocks128 <= sm_count(); }

template <class Kernel, class... Args>
int launch(Kernel kernel, dim3 grid, int threads, int smem, cudaStream_t s, Args... args) {
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  kernel<<<grid, threads, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

// Either backward (kHigh: the three-pass one): the product kernel, then
// the sum over its training-row tile pairs.
template <bool kHigh>
int launch_bwd(const float* xs, const float* xq, const float* inv_ls, const void* kf_desc,
               const float* alpha, const float* vt, const float* kst, const float* ct_mean,
               const float* ct_qf, float* scratch, float* ct_q, int b, int n, int m, int d,
               void* stream) {
  if (bad_shape(b, n, m, d) || !aligned16(kst)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ld = factor_ld(n);
  const int nlb = (n + TN - 1) / TN, npairs = bwd_pairs(n);
  const bool one = one_consumer((long long)((m + 127) / 128) * npairs * b);
  const int bm = one ? 64 : 128;
  CUtensorMap tm_fac, tm_v;
  memcpy(&tm_fac, kf_desc, sizeof(tm_fac));
  int err = encode_planes(&tm_v, vt, n, m, b, ld, bm);
  if (err != 0) return err;
  const dim3 grid((m + bm - 1) / bm, npairs, b);
  if constexpr (kHigh) {
    err = one ? launch(bwd_high_kernel<1>, grid, 256, Bwd<1, true>::SMEM, s, tm_v, tm_fac, xs,
                       xq, inv_ls, alpha, kst, ct_mean, ct_qf, scratch, b, n, m, d, ld, nlb,
                       npairs)
              : launch(bwd_high_kernel<2>, grid, 384, Bwd<2, true>::SMEM, s, tm_v, tm_fac, xs,
                       xq, inv_ls, alpha, kst, ct_mean, ct_qf, scratch, b, n, m, d, ld, nlb,
                       npairs);
  } else {
    err = one ? launch(bwd_wgmma_kernel<1>, grid, 256, Bwd<1, false>::SMEM, s, tm_v, tm_fac, xs,
                       xq, inv_ls, alpha, kst, ct_mean, ct_qf, scratch, b, n, m, d, ld, nlb,
                       npairs)
              : launch(bwd_wgmma_kernel<2>, grid, 384, Bwd<2, false>::SMEM, s, tm_v, tm_fac, xs,
                       xq, inv_ls, alpha, kst, ct_mean, ct_qf, scratch, b, n, m, d, ld, nlb,
                       npairs);
  }
  if (err != 0) return err;
  return launch_rowsum(scratch, ct_q, b, npairs, (long long)m * d, s);
}

}  // namespace

extern "C" {

int fused_predict_max_dim() { return DMAX; }

// Row stride (floats) of the kernel factor and of the saved v^T: n rounded
// up to 4, the 16-byte stride TMA needs.
int fused_predict_ld(int n) { return factor_ld(n); }

// Floats of scratch the wrapper allocates for an entry (0 = fused_predict_fwd,
// 1 = fused_predict_bwd, 2 = fused_predict_bwd_high): the per-block partial
// sums.
long long fused_predict_scratch(int entry, int b, int n, int m, int d) {
  if (entry == 0) return (long long)b * fwd_pairs(n) * m;
  if (entry == 1) return (long long)b * bwd_pairs(n) * m * d;
  return (long long)b * bwd_pairs(n) * m * d;
}

// Planes of the forward's k*^T buffer (KST_PLANES, b, m, ld): 1 = k*, 2 =
// its TF32 halves.
int fused_predict_kst_planes() { return KST_PLANES; }

// Planes of the kernel factor per GP (b, FACTOR_PLANES, n + 1, ld).
int fused_predict_factor_planes() { return FACTOR_PLANES; }

// The tensor-map descriptor (128 bytes, into out) of a kernel factor
// (b, 4, n + 1, ld); the wrapper encodes it once per fused state.
int fused_predict_encode_factor(const float* kf, int b, int n, void* out) {
  if (b < 1 || n < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int err = encode_planes(&map, kf, n, n + 1, FACTOR_PLANES * b, factor_ld(n), TN);
  if (err == 0) memcpy(out, &map, sizeof(map));
  return err;
}

// kst: the k*^T planes (KST_PLANES, b, m, ld) this call writes, which the
// fast backward reads; vt: v^T (b, m, ld) or nullptr.
int fused_predict_fwd(const float* xs, const float* xq, const float* inv_ls,
                      const void* kf_desc, const float* amp,
                      float* mean, float* qf, float* vt, float* kst, float* scratch,
                      int b, int n, int m, int d, void* stream) {
  if (bad_shape(b, n, m, d) || !aligned16(kst)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ld = factor_ld(n);
  float* qf_part = scratch;
  const dim3 kgrid((n + KS_L - 1) / KS_L, (m + KS_J - 1) / KS_J, b);
  kstar_kernel<<<kgrid, 256, 0, s>>>(xs, xq, inv_ls, amp, kst, b, n, m, ld, d);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;

  CUtensorMap tm_fac, tm_kst;
  memcpy(&tm_fac, kf_desc, sizeof(tm_fac));
  const int nrb = (n + 1 + TN - 1) / TN, npairs = fwd_pairs(n);
  const bool one = one_consumer((long long)((m + 127) / 128) * npairs * b);
  const int bm = one ? 64 : 128;
  err = encode_planes(&tm_kst, kst, n, m, KST_PLANES * b, ld, bm);
  if (err != 0) return err;
  const dim3 grid((m + bm - 1) / bm, npairs, b);
  err = one ? launch(fwd_wgmma_kernel<1>, grid, 256, Fwd<1>::SMEM, s, tm_kst, tm_fac, mean,
                     qf_part, vt, b, n, m, ld, nrb, npairs)
            : launch(fwd_wgmma_kernel<2>, grid, 384, Fwd<2>::SMEM, s, tm_kst, tm_fac, mean,
                     qf_part, vt, b, n, m, ld, nrb, npairs);
  if (err != 0) return err;
  return launch_rowsum(qf_part, qf, b, npairs, m, s);
}

// vt, kst: the forward's v^T and k*^T planes of these inputs.
int fused_predict_bwd(const float* xs, const float* xq, const float* inv_ls,
                      const void* kf_desc, const float* alpha,
                      const float* vt, const float* kst, const float* ct_mean,
                      const float* ct_qf, float* scratch, float* ct_q,
                      int b, int n, int m, int d, void* stream) {
  return launch_bwd<false>(xs, xq, inv_ls, kf_desc, alpha, vt, kst, ct_mean, ct_qf, scratch,
                           ct_q, b, n, m, d, stream);
}

// The same arguments; G^T's lo half from plane 3 of the kernel factor.
int fused_predict_bwd_high(const float* xs, const float* xq, const float* inv_ls,
                           const void* kf_desc, const float* alpha,
                           const float* vt, const float* kst, const float* ct_mean,
                           const float* ct_qf, float* scratch, float* ct_q,
                           int b, int n, int m, int d, void* stream) {
  return launch_bwd<true>(xs, xq, inv_ls, kf_desc, alpha, vt, kst, ct_mean, ct_qf, scratch,
                          ct_q, b, n, m, d, stream);
}

}  // extern "C"
