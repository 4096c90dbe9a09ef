"""PyTorch port: the fused MVN log-likelihood module against the JAX package.

On the CPU the port's wrapper takes the kernel's plain version (the same
elimination as a column loop of batched torch ops); the CUDA kernel is
held against that plain version by tests/test_torch_cuda_kernels.py
(skipped without a GPU) and by ``chip_smoke.py`` on the card.  The JAX
Pallas kernel runs in interpret mode, as tests/test_pallas.py runs it.
Inputs come from numpy seeds and go through both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpbayestools_hic_tpu.ops.pallas_mvn as pm
from gpbayestools_hic_tpu.ops.linalg import mvn_loglike_batch as j_mvn_loglike_batch
from gpbayestools_hic_tpu_torch.ops import fused_mvn as fm
from gpbayestools_hic_tpu_torch.ops import registry
from gpbayestools_hic_tpu_torch.ops.linalg import mvn_loglike_batch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in
    parallel worker processes, where multi-threaded torch ops on every
    worker oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pm, "INTERPRET", True)


def _problem(b, n, seed, dtype=np.float32, bad=None):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, n, n)).astype(dtype)
    cov = a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=dtype)
    if bad is not None:
        cov[bad] = -np.eye(n, dtype=dtype)
    y = rng.normal(size=(b, n)).astype(dtype)
    return y, cov


@pytest.mark.parametrize("b,n", [(4, 1), (4, 2), (4, 3), (4, 7), (2, 60), (8, 130)])
def test_plain_and_batch_match_jax_pallas_and_xla(b, n):
    """float32, the (b, n) cases of tests/test_pallas.py (n not a multiple
    of 8 included): the plain elimination and the library path against the
    JAX Pallas kernel (interpret mode) and the JAX XLA path, rtol 2e-4 as
    there (float32 elimination vs float32 Cholesky, different order)."""
    y, cov = _problem(b, n, seed=n)
    j_pallas = np.asarray(pm.mvn_loglike_pallas(jnp.asarray(y), jnp.asarray(cov)))
    j_xla = np.asarray(j_mvn_loglike_batch(jnp.asarray(y), jnp.asarray(cov)))
    yt, ct = torch.tensor(y), torch.tensor(cov)
    for got in (fm.fused_mvn_loglike_plain(yt, ct), mvn_loglike_batch(yt, ct),
                fm.mvn_loglike_fused(yt, ct), fm.mvn_loglike_best(yt, ct)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), j_pallas, rtol=2e-4)
        np.testing.assert_allclose(got.numpy(), j_xla, rtol=2e-4)


def _blocked_elimination(y: torch.Tensor, cov: torch.Tensor, panel: int) -> torch.Tensor:
    """The shared-memory kernel's blocked order, in plain torch (on no path):
    per panel of ``panel`` columns, (1) the diagonal block eliminated pivot
    by pivot (right-looking, as the kernel's factoring warp does), (2) the
    rows below it finished by substitution against the block's scaled rows
    D[j][k] / p_k, (3) the trailing update A -= L L^T with the panel's
    Cholesky entries L[i][k] = P[i][k] / sqrt(p_k).  A matrix whose pivot is
    not positive and finite gives -inf; the others never see it."""
    b, n = y.shape
    a = torch.zeros((b, n + 1, n + 1), dtype=cov.dtype)
    a[:, :n, :n] = cov
    a[:, n, :n] = y
    a = torch.tril(a)
    logdet_half = torch.zeros((b,), dtype=cov.dtype)
    ok = torch.ones((b,), dtype=torch.bool)
    for c0 in range(0, n, panel):
        c1 = min(c0 + panel, n)
        pw = c1 - c0
        x = a[:, c0:c1, c0:c1].clone()
        dg = torch.zeros((b, pw, pw), dtype=cov.dtype)
        for j in range(pw):
            p = x[:, j, j]
            ok &= (p > 0) & ~torch.isinf(p)
            s = x[:, :, j] / p[:, None]
            dg[:, :, j] = s
            x[:, j + 1:, j + 1:] -= torch.tril(s[:, j + 1:, None] * x[:, None, j + 1:, j])
        piv = torch.diagonal(x, dim1=1, dim2=2)
        logdet_half = logdet_half + 0.5 * torch.log(piv).sum(-1)
        rows = a[:, c1:, c0:c1].clone()
        for j in range(1, pw):
            rows[:, :, j] -= (rows[:, :, :j] * dg[:, j, None, :j]).sum(-1)
        chol = rows / torch.sqrt(piv)[:, None, :]
        a[:, c1:, c1:] -= torch.tril(torch.bmm(chol, chol.transpose(1, 2)))
    lp = 0.5 * a[:, n, n] - logdet_half
    return torch.where(ok & torch.isfinite(lp), lp, torch.full_like(lp, -torch.inf))


#: the kernel's panel width (csrc/fused_mvn.cu SMEM_PANEL), and the others
#: it was measured against
PANEL = 16
PANELS = (8, 16, 32)


def _warp_elimination(y: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """The shared-memory route's warp kernel (n <= fm.WARP_MAX_N), in plain
    torch (on no path): the augmented matrix eliminated pivot by pivot,
    right-looking (one panel, the whole matrix), lane r's row r updated as
    A[r][q] = fma(-A[r][j] / p_j, A[q][j], A[r][q]) and the y row, held as
    column n, as A[n][r] = fma(-A[n][j] / p_j, A[r][j], A[n][r]); each FMA
    rounded once (its exact product in float64).  A matrix whose pivot is
    not positive and finite gives -inf; the others never see it."""
    b, n = y.shape

    def fma(a, b_, c):
        return (a.double() * b_.double() + c.double()).to(cov.dtype)

    x = torch.tril(cov.clone())
    yr = y.clone()
    ynn = torch.zeros((b,), dtype=cov.dtype)
    logdet_half = torch.zeros((b,), dtype=cov.dtype)
    ok = torch.ones((b,), dtype=torch.bool)
    for j in range(n):
        p = x[:, j, j].clone()
        ok &= (p > 0) & ~torch.isinf(p)
        rp = 1.0 / p
        s = x[:, :, j] * rp[:, None]          # every row's multiplier
        sn = yr[:, j] * rp                     # the y row's
        col = x[:, :, j].clone()
        x[:, j + 1:, j + 1:] = torch.tril(fma(-s[:, j + 1:, None], col[:, None, j + 1:],
                                              x[:, j + 1:, j + 1:]))
        yj = yr[:, j].clone()
        yr[:, j + 1:] = fma(-sn[:, None], col[:, j + 1:], yr[:, j + 1:])
        ynn = fma(-sn, yj, ynn)
        logdet_half = logdet_half + 0.5 * torch.log(torch.where(p > 0, p, torch.ones_like(p)))
    lp = 0.5 * ynn - logdet_half
    return torch.where(ok & torch.isfinite(lp), lp, torch.full_like(lp, -torch.inf))


def _smem_route(y: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """The shared-memory route's arithmetic and order: the warp kernel's up
    to fm.WARP_MAX_N, the block kernel's past it (its look-ahead gives each
    entry of the next diagonal block the sum a trailing tile would give)."""
    if y.shape[1] <= fm.WARP_MAX_N:
        return _warp_elimination(y, cov)
    return _blocked_elimination(y, cov, PANEL)


@pytest.mark.parametrize("n", [1, 12, 14, 16, 17, 21, 28, 31, 32, 33, 73, 170, 319])
def test_smem_route_matches_jax_pallas_and_f64(n):
    """The shared-memory route as the kernels run it (warp kernel to n = 32,
    block kernel past it) against the JAX Pallas kernel (interpret mode)
    and the float64 plain elimination, rtol 2e-4 (the JAX package's own
    kernel tolerance): the flagship's block sizes, both sides of the warp
    kernel's limit and of the panel boundaries, and the route's largest n."""
    y, cov = _problem(2 if n > 100 else 4, n, seed=500 + n)
    j_pallas = np.asarray(pm.mvn_loglike_pallas(jnp.asarray(y), jnp.asarray(cov)))
    yt, ct = torch.tensor(y), torch.tensor(cov)
    want64 = fm.fused_mvn_loglike_plain(yt.double(), ct.double()).numpy()
    got = _smem_route(yt, ct)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), j_pallas, rtol=2e-4)
    np.testing.assert_allclose(got.numpy(), want64, rtol=2e-4)


@pytest.mark.parametrize("n,where", [(12, "first"), (12, "mid"), (12, "end"), (28, "first"),
                                     (28, "mid"), (28, "end"), (32, "end"), (73, "first"),
                                     (73, "mid_panel"), (73, "panel_end")])
def test_smem_route_bad_pivot_beside_healthy_matrices(n, where):
    """A bad pivot at the first pivot, mid-matrix (mid-panel) or at the
    matrix's (a panel's) last pivot, in a matrix that shares a warp-kernel
    block (four matrices) with healthy ones: -inf there, as in the JAX
    Pallas kernel; the other matrices keep their values bit for bit."""
    b, bad = 8, 1
    k = {"first": 0, "mid": n // 2, "end": n - 1, "mid_panel": PANEL + PANEL // 2,
         "panel_end": 2 * PANEL - 1}[where]
    y, cov = _problem(b, n, seed=600 + n)
    clean = _smem_route(torch.tensor(y), torch.tensor(cov))
    cov[bad, k, k] = -1.0
    j = np.asarray(pm.mvn_loglike_pallas(jnp.asarray(y), jnp.asarray(cov)))
    got = _smem_route(torch.tensor(y), torch.tensor(cov))
    assert j[bad] == -np.inf and got[bad] == -torch.inf
    keep = np.arange(b) != bad
    np.testing.assert_array_equal(got.numpy()[keep], clean.numpy()[keep])
    np.testing.assert_allclose(got.numpy()[keep], j[keep], rtol=2e-4)


@pytest.mark.parametrize("n", [1, PANEL - 1, PANEL, PANEL + 1, 2 * PANEL + 1, 73, 170])
def test_blocked_order_matches_jax_pallas_and_plain(n):
    """The shared-memory kernel's blocked elimination, emulated in float32
    at each measured panel width, against the JAX Pallas kernel (interpret
    mode) and the plain elimination, rtol 2e-4 (the JAX package's own
    kernel tolerance): n on both sides of the panel boundaries, the
    flagship's 73- and 170-observable blocks."""
    y, cov = _problem(3, n, seed=40 + n)
    j_pallas = np.asarray(pm.mvn_loglike_pallas(jnp.asarray(y), jnp.asarray(cov)))
    yt, ct = torch.tensor(y), torch.tensor(cov)
    plain = fm.fused_mvn_loglike_plain(yt, ct).numpy()
    for panel in PANELS:
        got = _blocked_elimination(yt, ct, panel)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), j_pallas, rtol=2e-4)
        np.testing.assert_allclose(got.numpy(), plain, rtol=2e-4)


@pytest.mark.parametrize("where", ["mid_panel", "panel_end"])
def test_blocked_order_bad_pivot_inside_a_panel(where):
    """A pivot that goes bad in the middle of the second panel, or at its
    last column (the earlier pivots stay good: only the leading minors up
    to it see the planted diagonal), gives -inf there; the other matrices
    of the batch keep the values they have without it, as in the JAX
    Pallas kernel."""
    n, bad = 60, 2
    k = PANEL + PANEL // 2 if where == "mid_panel" else 2 * PANEL - 1
    y, cov = _problem(5, n, seed=7)
    clean = _blocked_elimination(torch.tensor(y), torch.tensor(cov), PANEL)
    cov[bad, k, k] = -1.0
    j = np.asarray(pm.mvn_loglike_pallas(jnp.asarray(y), jnp.asarray(cov)))
    assert j[bad] == -np.inf
    keep = np.arange(5) != bad
    for panel in PANELS:
        got = _blocked_elimination(torch.tensor(y), torch.tensor(cov), panel)
        assert got[bad] == -torch.inf
        assert torch.isfinite(got[keep]).all()
        np.testing.assert_allclose(got.numpy()[keep], j[keep], rtol=2e-4)
    got = _blocked_elimination(torch.tensor(y), torch.tensor(cov), PANEL)
    np.testing.assert_array_equal(got.numpy()[keep], clean.numpy()[keep])


def test_routes_tile_every_n_once():
    """The two routes' n ranges tile every n >= 1 with no gap and no
    overlap: shared memory, then the wide route ("panel"), which has no
    largest n and takes the stitched 544 x 544 matrix."""
    limits = fm.route_limits()
    assert list(limits) == ["smem", "panel"]
    ranges = list(limits.values())
    assert ranges[0][0] == 1 and ranges[-1][1] is None
    for (lo, hi), (nxt, _) in zip(ranges, ranges[1:]):
        assert lo <= hi and nxt == hi + 1
    assert limits["smem"][1] == 319
    assert limits["panel"][0] <= 544


def test_plain_f64_matches_jax_xla_f64():
    """In float64 the elimination and the Cholesky agree to 1e-11 (the two
    are the same factorization in a different order)."""
    y, cov = _problem(5, 40, seed=1, dtype=np.float64)
    want = np.asarray(j_mvn_loglike_batch(jnp.asarray(y), jnp.asarray(cov)))
    yt, ct = torch.tensor(y), torch.tensor(cov)
    np.testing.assert_allclose(fm.fused_mvn_loglike_plain(yt, ct).numpy(), want, rtol=1e-11)
    np.testing.assert_allclose(mvn_loglike_batch(yt, ct).numpy(), want, rtol=1e-11)


@pytest.mark.parametrize("kind", ["negative", "zero_pivot", "nan"])
def test_nonpd_in_batch_gives_neg_inf_and_leaves_the_rest(kind):
    """A bad matrix in the middle of a batch: -inf there (negative pivot ->
    NaN through log, zero pivot -> +-inf, NaN input), the other entries
    equal to the batch without it (exactly: batched ops are per matrix),
    never a raise.  Same answers as the JAX Pallas kernel."""
    y, cov = _problem(5, 12, seed=2)
    clean = fm.fused_mvn_loglike_plain(torch.tensor(y), torch.tensor(cov))
    if kind == "negative":
        cov[2] = -np.eye(12, dtype=np.float32)
    elif kind == "zero_pivot":
        cov[2, 0, :] = 0.0
        cov[2, :, 0] = 0.0
    else:
        cov[2, 3, 3] = np.nan
    yt, ct = torch.tensor(y), torch.tensor(cov)
    j = np.asarray(pm.mvn_loglike_pallas(jnp.asarray(y), jnp.asarray(cov)))
    assert j[2] == -np.inf
    keep = np.arange(5) != 2
    for f in (fm.fused_mvn_loglike_plain, mvn_loglike_batch, fm.mvn_loglike_best):
        got = f(yt, ct)
        assert got[2] == -torch.inf
        if f is fm.fused_mvn_loglike_plain:
            np.testing.assert_array_equal(got.numpy()[keep], clean.numpy()[keep])
        np.testing.assert_allclose(got.numpy()[keep], j[keep], rtol=2e-4)


def test_gradients_match_jax():
    """The closed-form backward of the fused op and autograd through the
    library path against the JAX Pallas op's VJP and JAX autodiff through
    XLA (float32: rtol 1e-3, atol 1e-5, the tolerance of
    tests/test_pallas.py; float64 port paths against each other: 1e-9)."""
    y, cov = _problem(2, 10, seed=3)
    jy, jc = jnp.asarray(y), jnp.asarray(cov)
    g_pl = jax.grad(lambda a, c: jnp.sum(pm.mvn_loglike_pallas(a, c)), argnums=(0, 1))(jy, jc)
    g_xla = jax.grad(lambda a, c: jnp.sum(j_mvn_loglike_batch(a, c)), argnums=(0, 1))(jy, jc)
    for f in (fm.mvn_loglike_fused, mvn_loglike_batch):
        yt = torch.tensor(y, requires_grad=True)
        ct = torch.tensor(cov, requires_grad=True)
        gy, gc = torch.autograd.grad(f(yt, ct).sum(), (yt, ct))
        for ref in (g_pl, g_xla):
            np.testing.assert_allclose(gy.numpy(), np.asarray(ref[0]), rtol=1e-3, atol=1e-5)
            np.testing.assert_allclose(gc.numpy(), np.asarray(ref[1]), rtol=1e-3, atol=1e-5)
    y64, c64 = _problem(3, 9, seed=4, dtype=np.float64)
    grads = []
    for f in (fm.mvn_loglike_fused, mvn_loglike_batch):
        yt = torch.tensor(y64, requires_grad=True)
        ct = torch.tensor(c64, requires_grad=True)
        grads.append(torch.autograd.grad(f(yt, ct).sum(), (yt, ct)))
    np.testing.assert_allclose(grads[0][0].numpy(), grads[1][0].numpy(), rtol=1e-9)
    np.testing.assert_allclose(grads[0][1].numpy(), grads[1][1].numpy(), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("entry", ["mvn_loglike_fused", "mvn_loglike_batch"])
def test_nonpd_gradient_is_zero_not_nan(entry):
    """The -inf element contributes a ZERO gradient (a NaN would ride
    through every later leapfrog update); the healthy element of the same
    batch keeps its gradient, equal to the JAX op's (rtol 1e-3)."""
    n = 8
    rng = np.random.default_rng(5)
    a = rng.normal(size=(n, n)).astype(np.float32)
    cov = np.stack([a @ a.T + n * np.eye(n, dtype=np.float32), -np.eye(n, dtype=np.float32)])
    y = rng.normal(size=(2, n)).astype(np.float32)
    f = getattr(fm, entry, None) or mvn_loglike_batch
    yt, ct = torch.tensor(y, requires_grad=True), torch.tensor(cov, requires_grad=True)
    lp = f(yt, ct)
    assert lp[1] == -torch.inf
    gy, gc = torch.autograd.grad(torch.where(torch.isfinite(lp), lp, 0.0).sum(), (yt, ct))
    assert torch.isfinite(gy).all() and torch.isfinite(gc).all()
    np.testing.assert_array_equal(gy.numpy()[1], 0.0)
    np.testing.assert_array_equal(gc.numpy()[1], 0.0)

    def jloss(a, c):
        v = pm.mvn_loglike_pallas(a, c)
        return jnp.sum(jnp.where(jnp.isfinite(v), v, 0.0))

    jgy, jgc = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(y), jnp.asarray(cov))
    np.testing.assert_allclose(gy.numpy()[0], np.asarray(jgy)[0], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(gc.numpy()[0], np.asarray(jgc)[0], rtol=1e-3, atol=1e-5)
    # a non-finite incoming cotangent is sanitized too
    lp = f(yt, ct)
    gy2, _ = torch.autograd.grad(lp, (yt, ct), grad_outputs=torch.tensor([1.0, np.inf]))
    assert torch.isfinite(gy2).all()


def test_cpu_path_counts_no_launches_and_kernels_are_registered():
    """CPU tensors take the plain version, so no launch is counted; the
    two routes of the kernel stand in the registry with their source."""
    registry.reset_launch_counts()
    y, cov = _problem(3, 6, seed=6)
    fm.mvn_loglike_best(torch.tensor(y), torch.tensor(cov))
    fm.fused_mvn_loglike(torch.tensor(y), torch.tensor(cov))
    assert all(v == 0 for v in registry.LAUNCH_COUNTS.values())
    for name in ("fused_mvn_loglike", "fused_mvn_loglike_panel"):
        source, replaces = registry.KERNELS[name]
        assert source.endswith("csrc/fused_mvn.cu") and replaces.endswith("pallas_mvn.py:61")
    assert not any("cluster" in name for name in registry.KERNELS)
    assert set(registry.KERNELS) == set(registry.LAUNCH_COUNTS)


def test_kernel_source_calls_no_library_factorization():
    """The CUDA source is self-contained: no cuSOLVER / cuBLAS / ATen."""
    from gpbayestools_hic_tpu_torch.ops import _build

    src = (_build._PKG_DIR / _build.SOURCES["fused_mvn"]).read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    for word in ("cusolver", "cublas", "torch", "ATen", "potrf"):
        assert word not in code, word
    assert "__global__" in code and "smem_kernel(n)<<<" in code and "mvn_smem_kernel<256>" in code
    # the shared-memory route's warp kernel up to WARP_MAX_N; the block
    # kernel's triangle copied in by cp.async
    assert "warp_kernel(n)<<<" in code and "mvn_warp_kernel<16>" in code
    assert f"constexpr int WARP_MAX_N = {fm.WARP_MAX_N};" in code
    assert "cp.async.ca.shared.global" in code and "copy_triangle(" in code
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in code
    # one matrix per cluster only on the wide route: no cluster-resident
    # matrix, no distributed shared memory
    assert "cudaLaunchKernelEx" in code and "cudaLaunchAttributeClusterDimension" in code
    assert "map_shared_rank" not in code and "mvn_cluster_kernel" not in code
    # the panel widths the blocked-order tests and the layout mirror use are the kernel's
    assert f"constexpr int SMEM_PANEL = {PANEL};" in code
    assert f"constexpr int SMEM_PANEL = {fm.SMEM_PANEL};" in code
    assert f"constexpr int SMEM_LIMIT = {fm.SMEM_LIMIT};" in code
    # the wide route: launched as clusters, its layout constants mirrored,
    # the trailing update on the tensor cores through a cp.async ring
    assert "cudaLaunchKernelEx(&w.cfg, w.kernel" in code
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in code
    assert "cp.async.cg.shared.global" in code
    assert "constexpr bool kWideTensorCores = true;" in code
    for name in ("WIDE_PANEL", "WIDE_STEP", "WIDE_TILE", "WIDE_CHUNK", "WIDE_MAX_CLUSTER",
                 "WIDE_THREADS", "WIDE_STAGES", "SM_SMEM"):
        assert f"constexpr int {name} = {getattr(fm, name)};" in code, name
    # built for one and for two CTAs per SM, the card's SM count read from
    # the device, no cluster past the portable size
    assert "mvn_wide_kernel<2>" in code and "mvn_wide_kernel<1>" in code
    assert "cudaDevAttrMultiProcessorCount" in code
    assert "NonPortableClusterSizeAllowed" not in code


def test_mvn_variant_tool_edits_apply_to_the_source():
    """tools/torch_mvn_variants.py times the shared-memory route at other
    panel widths by editing SMEM_PANEL in csrc/fused_mvn.cu, and the wide
    route's variants by edits of their own: every edit must still
    apply (once), give every measured width once, change the source, and
    the diagnostics must be among the edits."""
    import importlib.util

    from gpbayestools_hic_tpu_torch.ops import _build

    path = _build._PKG_DIR.parent / "tools" / "torch_mvn_variants.py"
    spec = importlib.util.spec_from_file_location("torch_mvn_variants", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = (_build._PKG_DIR / _build.SOURCES["fused_mvn"]).read_text()
    variants = tool.variant_sources(src)
    assert variants["kept"] == src
    widths = {name: int(tool.WIDTH_LINE.findall(text)[0]) for name, text in variants.items()}
    assert set(widths.values()) == set(PANELS)
    for name, text in variants.items():
        if name in tool.EDITS:  # edits of the committed width, which they change
            assert widths[name] == PANEL and text != src, name
        elif name != "kept":
            assert tool.WIDTH_LINE.sub("", text) == tool.WIDTH_LINE.sub("", src), name
    assert set(tool.DIAGNOSTIC) <= set(tool.EDITS)
    assert "phase_clock" in variants and "no_lookahead" in variants
    wide = tool.variant_sources(src, route="panel")
    assert wide["kept"] == src
    assert set(wide) == {"kept", *tool.PANEL_EDITS}
    for name in tool.PANEL_EDITS:
        assert wide[name] != src, name
    assert set(tool.PANEL_DIAGNOSTIC) == {"wide_no_top_steps", "wide_no_row_steps",
                                          "wide_no_trailing", "wide_loads_only",
                                          "wide_no_products"}
    assert "constexpr int WIDE_STAGES = 3;" in wide["stages_3"]
    assert "  return 1;" in wide["one_cta_per_sm"]
    assert f"constexpr int WIDE_STAGES = {fm.WIDE_STAGES};" in src
    for width in (32, 128):
        assert f"constexpr int WIDE_PANEL = {width};" in wide[f"wpanel_{width}"]
    assert "constexpr bool kWideTensorCores = false;" in wide["fma_trailing"]
    assert "NonPortableClusterSizeAllowed" in wide["cluster_16"]
    # the stitched 544 x 544 likelihood of a half-ensemble is a wide-route case
    assert tool.PANEL_CASES == ((16, 767), (512, 1088), (512, 544))


# ------------------------------------------------------------- the wide route


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value, ties away from zero (the
    kernel's tf32_rna: add half a TF32 unit to the bits, cut 13 bits)."""
    v = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    v = (v + 0x1000) & 0xFFFFE000
    v = torch.where(v >= 2**31, v - 2**32, v)
    return v.to(torch.int32).view(torch.float32)


def _product_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b^T (a (B, m, k), b (B, l, k), float32) as the kernel's 3xTF32
    mma.sync computes it: per 8-wide k-step, each operand split into TF32
    hi + lo, lo hi + hi lo + hi hi (the products exact, FP32 sums) into a
    fresh fragment, then added to the FP32 accumulator."""
    acc = torch.zeros((a.shape[0], a.shape[1], b.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        ah = _tf32(a[..., k0:k0 + 8])
        al = _tf32(a[..., k0:k0 + 8] - ah)
        bh = _tf32(b[..., k0:k0 + 8])
        bl = _tf32(b[..., k0:k0 + 8] - bh)
        part = torch.bmm(al, bh.transpose(1, 2))
        part = part + torch.bmm(ah, bl.transpose(1, 2))
        part = part + torch.bmm(ah, bh.transpose(1, 2))
        acc = acc + part
    return acc


def _wide_elimination(y: torch.Tensor, cov: torch.Tensor, panel: int = fm.WIDE_PANEL,
                      tensor_cores: bool = True) -> torch.Tensor:
    """The wide route's arithmetic order in plain torch (on no path): per
    panel of ``panel`` columns (rows c0 .. n), 16-column steps as in the
    shared-memory route (the step's diagonal block eliminated
    pivot by pivot, the rows below finished by substitution and scaled to
    Cholesky entries, the step's update applied to the panel's later
    columns only), then one trailing update A -= L L^T of the rows and
    columns past the panel, in 3xTF32 (``tensor_cores``) or FP32."""
    b, n = y.shape
    s = fm.WIDE_STEP
    a = torch.zeros((b, n + 1, n + 1), dtype=cov.dtype)
    a[:, :n, :n] = cov
    a[:, n, :n] = y
    a = torch.tril(a)
    logdet_half = torch.zeros((b,), dtype=cov.dtype)
    ok = torch.ones((b,), dtype=torch.bool)
    for c0 in range(0, n, panel):
        pw = min(panel, n - c0)
        pan = a[:, c0:, c0:c0 + pw].clone()  # the panel's rows c0 .. n
        for s0 in range(0, pw, s):
            s1 = min(s0 + s, pw)
            sw = s1 - s0
            x = pan[:, s0:s1, s0:s1].clone()
            dg = torch.zeros((b, sw, sw), dtype=cov.dtype)
            for j in range(sw):
                p = x[:, j, j]
                ok &= (p > 0) & ~torch.isinf(p)
                m = x[:, :, j] / p[:, None]
                dg[:, :, j] = m
                x[:, j + 1:, j + 1:] -= torch.tril(m[:, j + 1:, None] * x[:, None, j + 1:, j])
            piv = torch.diagonal(x, dim1=1, dim2=2)
            logdet_half = logdet_half + 0.5 * torch.log(piv).sum(-1)
            rows = pan[:, s1:, s0:s1].clone()
            for j in range(1, sw):
                rows[:, :, j] -= (rows[:, :, :j] * dg[:, j, None, :j]).sum(-1)
            chol = rows / torch.sqrt(piv)[:, None, :]
            pan[:, s1:, s0:s1] = chol
            if s1 < pw:  # the step's update, the panel's later columns only
                pan[:, s1:, s1:pw] -= torch.bmm(chol, chol[:, :pw - s1].transpose(1, 2))
        lp_rows = pan[:, pw:, :]  # Cholesky rows c1 .. n
        prod = (_product_3xtf32(lp_rows, lp_rows) if tensor_cores
                else torch.bmm(lp_rows, lp_rows.transpose(1, 2)))
        a[:, c0 + pw:, c0 + pw:] -= torch.tril(prod)
    lp = 0.5 * a[:, n, n] - logdet_half
    return torch.where(ok & torch.isfinite(lp), lp, torch.full_like(lp, -torch.inf))


def test_tf32_rounding_is_the_kernels():
    """_tf32 keeps 10 mantissa bits, rounds half away from zero, and hi + lo
    carries a float32 to about 2^-22."""
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-12, -(1.0 + 2**-11), 3.14159265, -2.5e-7])
    t = _tf32(x)
    assert t[0] == 1.0 and t[1] == 1.0 + 2**-10 and t[2] == 1.0 and t[3] == -(1.0 + 2**-10)
    hi = _tf32(x)
    lo = _tf32(x - hi)
    assert torch.all((hi + lo - x).abs() <= 2**-21 * x.abs())
    assert torch.all((t.view(torch.int32) & 0x1FFF) == 0)


WIDE = fm.WIDE_PANEL


@pytest.mark.parametrize("n", [1, 15, 16, 17, WIDE - 1, WIDE, WIDE + 1, 2 * WIDE + 1,
                               320, 321, 383, 384, 385, 543, 544, 545, 687])
def test_wide_order_matches_jax_pallas_and_f64(n):
    """The wide route's order emulated in float32 (wide panels of 16-column
    steps, the trailing update in 3xTF32 and in FP32) against the JAX
    Pallas kernel (interpret mode) and the float64 plain elimination, rtol
    2e-4: n on both sides of the 16-column and the panel boundaries, one n
    past two panels, and the stitched sizes the route takes past the
    shared-memory route: its first n, both sides of a later panel
    boundary, the stitched 544 and one column either side, and 687."""
    y, cov = _problem(3, n, seed=500 + n)
    j_pallas = np.asarray(pm.mvn_loglike_pallas(jnp.asarray(y), jnp.asarray(cov)))
    yt, ct = torch.tensor(y), torch.tensor(cov)
    want64 = fm.fused_mvn_loglike_plain(yt.double(), ct.double()).numpy()
    for tensor_cores in (True, False):
        got = _wide_elimination(yt, ct, tensor_cores=tensor_cores)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), j_pallas, rtol=2e-4)
        np.testing.assert_allclose(got.numpy(), want64, rtol=2e-4)


@pytest.mark.parametrize("k", [WIDE + 8, WIDE - 1, WIDE])
def test_wide_order_bad_pivot(k):
    """A pivot that goes bad inside a 16-column step of the second panel,
    at the first panel's last column, or at the second panel's first: -inf
    there, as in the JAX Pallas kernel; the other matrices keep exactly the
    values they have without it."""
    n, bad = 2 * WIDE + 5, 1
    y, cov = _problem(3, n, seed=77)
    clean = _wide_elimination(torch.tensor(y), torch.tensor(cov))
    cov[bad, k, k] = -1.0
    j = np.asarray(pm.mvn_loglike_pallas(jnp.asarray(y), jnp.asarray(cov)))
    assert j[bad] == -np.inf
    got = _wide_elimination(torch.tensor(y), torch.tensor(cov))
    keep = np.arange(3) != bad
    assert got[bad] == -torch.inf and torch.isfinite(got[keep]).all()
    np.testing.assert_array_equal(got.numpy()[keep], clean.numpy()[keep])
    np.testing.assert_allclose(got.numpy()[keep], j[keep], rtol=2e-4)


@pytest.mark.parametrize("k", [0, 8, WIDE - 1, WIDE, 4 * WIDE + 24, 8 * WIDE + 15, 543])
def test_wide_order_bad_pivot_at_the_stitched_size(k):
    """n = 544: a pivot that goes bad at the first pivot, inside the first
    16-column step, at the first panel's last column or the second's first,
    inside a step of a middle panel, at a step's end in the last (half)
    panel, or at the last pivot gives -inf there, as in the JAX Pallas
    kernel; the other matrices keep exactly the values they have without
    it."""
    n, bad = 544, 1
    y, cov = _problem(3, n, seed=544)
    clean = _wide_elimination(torch.tensor(y), torch.tensor(cov))
    cov[bad, k, k] = -1.0
    j = np.asarray(pm.mvn_loglike_pallas(jnp.asarray(y), jnp.asarray(cov)))
    assert j[bad] == -np.inf
    got = _wide_elimination(torch.tensor(y), torch.tensor(cov))
    keep = np.arange(3) != bad
    assert got[bad] == -torch.inf and torch.isfinite(got[keep]).all()
    np.testing.assert_array_equal(got.numpy()[keep], clean.numpy()[keep])
    np.testing.assert_allclose(got.numpy()[keep], j[keep], rtol=2e-4)


@pytest.mark.parametrize("b,n,c,k", [(2048, 544, 1, 2), (512, 544, 1, 2), (16, 544, 8, 1),
                                     (1, 320, 8, 1)])
def test_wide_layout_at_the_stitched_size(b, n, c, k):
    """The stitched likelihood's batches on 132 SMs: a half-ensemble of
    2048 or 512 walkers takes one CTA a matrix, built for two per SM (264
    matrices at once); 16 matrices, or one, take clusters of eight.  The
    scratch is n + 1 rows of whole float4s a matrix: 2,446,622,720 bytes
    at (2048, 544)."""
    lay = fm.wide_layout(b, n, 132)
    assert (lay.c, lay.ctas_per_sm, lay.p) == (c, k, fm.WIDE_PANEL)
    assert lay.scratch == (n + 1) * ((n + 4) // 4 * 4)
    if (b, n) == (2048, 544):
        assert 4 * b * lay.scratch == 2_446_622_720


def test_wide_layout_picks_the_cluster_from_b_and_n():
    """C is the smallest that makes b C cover the card's SMs, up to 8 (8 at
    (16, 767) on 132 SMs: b C = 128; 1 at (512, 1088)), whatever n; the
    kernel is built for two CTAs per SM where b C exceeds the SMs, else
    one.  The SM count is the card's: 114 SMs (an H100 PCIe) give other
    clusters than 132."""
    assert fm.wide_layout(16, 767, 132)[:2] == (8, 1)
    assert fm.wide_layout(512, 1088, 132)[:2] == (1, 2)
    assert fm.wide_layout(2, 2048, 132)[:2] == fm.wide_layout(1, 4096, 132)[:2] == (8, 1)
    assert fm.wide_layout(130, 1000, 132)[:2] == (2, 2)
    assert fm.wide_layout(20, 767, 132).c == 7 and fm.wide_layout(20, 767, 114).c == 6
    for sms in (114, 132):
        for b in (1, 16, 66, 130, 512):
            sizes = {fm.wide_layout(b, n, sms).c for n in (1, 767, 1088, 4096, 10000)}
            assert len(sizes) == 1
            c = sizes.pop()
            assert 1 <= c <= fm.WIDE_MAX_CLUSTER
            assert b * c >= sms or c == fm.WIDE_MAX_CLUSTER
            assert c == 1 or b * (c - 1) < sms
    with pytest.raises(ValueError):
        fm.wide_layout(0, 767, 132)


def test_wide_layout_fits_every_n():
    """The shared memory per CTA is the same at every n, within the
    232,448 bytes an H100 block may use, and two CTAs' (1 KB each
    reserved) within an SM's 233,472 where the kernel is built for two;
    the scratch is n + 1 rows of whole float4s, for every n up to 8192."""
    assert fm.route_limits()["panel"][1] is None
    nbytes = fm.wide_bytes()
    assert nbytes <= fm.SMEM_LIMIT and 2 * (nbytes + 1024) <= fm.SM_SMEM
    for n in range(1, 8193):
        for b in (1, 16, 512):
            lay = fm.wide_layout(b, n, 132)
            assert lay.bytes == nbytes and lay.p == fm.WIDE_PANEL, (b, n)
        ld = lay.scratch // (n + 1)
        assert lay.scratch == (n + 1) * ld and ld % 4 == 0 and n + 1 <= ld < n + 5
    # a panel of 128 columns fits one CTA but not two, so it is built for one
    assert fm.wide_bytes(128) <= fm.SMEM_LIMIT < 2 * (fm.wide_bytes(128) + 1024)


@pytest.mark.parametrize("n,c0", [(767, 0), (767, 64), (1088, 0), (1088, 1024), (2048, 128),
                                  (4096, 0), (17, 0), (544, 0), (544, 448), (544, 512),
                                  (320, 256), (687, 640)])
def test_wide_rows_each_owned_once(n, c0):
    """The panel starting at column c0: every row below it (c1 .. n) in
    exactly one rank, in chunks of WIDE_CHUNK rows dealt out round-robin,
    so no rank holds more than one chunk more than another."""
    lay = fm.wide_layout(16, n, 132)
    c1 = min(c0 + fm.WIDE_PANEL, n)
    rows = fm.wide_rows(n, lay.c, c0)
    assert sorted(i for r in rows for i in r) == list(range(c1, n + 1))
    for r, mine in enumerate(rows):
        assert all(((i - c1) // fm.WIDE_CHUNK) % lay.c == r for i in mine)
    sizes = [len(r) for r in rows]
    assert max(sizes) - min(sizes) <= fm.WIDE_CHUNK
