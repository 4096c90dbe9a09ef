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


def test_blocked_order_at_the_cluster_route_start_matches_jax_pallas_and_f64():
    """n = 319, where the stitched-size routes begin: the blocked order at
    the cluster route's panel width (the cluster route's arithmetic order
    is the shared-memory route's) against the JAX Pallas kernel (interpret
    mode) at rtol 2e-4 and the float64 plain elimination at rtol 2e-4."""
    n = 319
    y, cov = _problem(2, n, seed=319)
    j_pallas = np.asarray(pm.mvn_loglike_pallas(jnp.asarray(y), jnp.asarray(cov)))
    yt, ct = torch.tensor(y), torch.tensor(cov)
    want64 = fm.fused_mvn_loglike_plain(yt.double(), ct.double()).numpy()
    got = _blocked_elimination(yt, ct, fm.CLUSTER_PANEL)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), j_pallas, rtol=2e-4)
    np.testing.assert_allclose(got.numpy(), want64, rtol=2e-4)


def _cluster_n(n):
    """An n of the cluster cases: an int, or "max", the route's largest."""
    return fm.route_limits()["cluster"][1] if n == "max" else n


@pytest.mark.parametrize("n", [1, 15, 16, 31, 32, 33, 320, 439, 440, 523, 544, 600, "max"])
def test_cluster_layout_places_every_row_once_and_fits(n):
    """The cluster route's layout: every row 0 .. n of the augmented matrix
    in exactly one rank, row blocks of P dealt out cyclically, the bytes
    per CTA within the 232,448 an H100 block may use, and no smaller
    cluster that would fit."""
    n = _cluster_n(n)
    lay = fm.cluster_layout(n)
    assert lay.p == fm.CLUSTER_PANEL and 2 <= lay.c <= fm.CLUSTER_MAX
    rows = fm.cluster_rows(n, lay.c, lay.p)
    flat = sorted(i for r in rows for i in r)
    assert flat == list(range(n + 1))
    for r, mine in enumerate(rows):
        assert all((i // lay.p) % lay.c == r for i in mine)
    assert lay.bytes == fm.cluster_bytes(n, lay.c) <= 232448
    for c in range(2, lay.c):
        assert fm.cluster_bytes(n, c) > 232448, c


def test_cluster_layout_picks_the_smallest_cluster():
    """n = 544 (the stitched matrix) takes four CTAs; the size grows with n
    one step at a time up to eight, and past the route's largest n no
    cluster holds the matrix."""
    assert fm.cluster_layout(544).c == 4
    hi = fm.route_limits()["cluster"][1]
    sizes = [fm.cluster_layout(n).c for n in range(fm.route_limits()["cluster"][0], hi + 1)]
    assert sizes == sorted(sizes) and sizes[0] == 2 and sizes[-1] == fm.CLUSTER_MAX
    assert set(sizes) == set(range(2, fm.CLUSTER_MAX + 1))
    with pytest.raises(ValueError):
        fm.cluster_layout(hi + 1)


@pytest.mark.parametrize("n", [320, 441, 544, "max"])
def test_cluster_storage_is_balanced_within_one_row_block(n):
    """Block-cyclic rows: the ranks' packed floats differ by no more than
    one P-row block at the matrix's foot (P (n + 1) floats), so no rank
    runs out of work long before the others."""
    n = _cluster_n(n)
    lay = fm.cluster_layout(n)
    floats = [sum(i + 1 for i in r) for r in fm.cluster_rows(n, lay.c, lay.p)]
    assert max(floats) - min(floats) <= lay.p * (n + 1)


def test_routes_tile_every_n_once():
    """The three routes' n ranges tile 1 .. 1759 with no gap and no
    overlap: shared memory, then cluster, then panel."""
    limits = fm.route_limits()
    assert list(limits) == ["smem", "cluster", "panel"]
    ranges = list(limits.values())
    assert ranges[0][0] == 1 and ranges[-1][1] == 1759
    for (lo, hi), (nxt, _) in zip(ranges, ranges[1:]):
        assert lo <= hi and nxt == hi + 1
    assert limits["cluster"][0] <= 544 <= limits["cluster"][1]


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
    three routes of the kernel stand in the registry with their source."""
    registry.reset_launch_counts()
    y, cov = _problem(3, 6, seed=6)
    fm.mvn_loglike_best(torch.tensor(y), torch.tensor(cov))
    fm.fused_mvn_loglike(torch.tensor(y), torch.tensor(cov))
    assert all(v == 0 for v in registry.LAUNCH_COUNTS.values())
    for name in ("fused_mvn_loglike", "fused_mvn_loglike_cluster", "fused_mvn_loglike_panel"):
        source, replaces = registry.KERNELS[name]
        assert source.endswith("csrc/fused_mvn.cu") and replaces.endswith("pallas_mvn.py:61")
    assert set(registry.KERNELS) == set(registry.LAUNCH_COUNTS)


def test_kernel_source_calls_no_library_factorization():
    """The CUDA source is self-contained: no cuSOLVER / cuBLAS / ATen."""
    from gpbayestools_hic_tpu_torch.ops import _build

    src = (_build._PKG_DIR / _build.SOURCES["fused_mvn"]).read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    for word in ("cusolver", "cublas", "torch", "ATen", "potrf"):
        assert word not in code, word
    assert "__global__" in code and "kernel<<<" in code and "mvn_panel_kernel<<<" in code
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in code
    # the cluster route: launched as clusters, DSMEM through map_shared_rank
    assert "cudaLaunchKernelEx" in code and "cudaLaunchAttributeClusterDimension" in code
    assert "map_shared_rank" in code and "mvn_cluster_kernel" in code
    # the panel widths the blocked-order tests and the layout mirror use are the kernel's
    assert f"constexpr int SMEM_PANEL = {PANEL};" in code
    assert f"constexpr int SMEM_PANEL = {fm.SMEM_PANEL};" in code
    assert f"constexpr int CLUSTER_PANEL = {fm.CLUSTER_PANEL};" in code
    assert f"constexpr int CLUSTER_MAX = {fm.CLUSTER_MAX};" in code
    assert f"constexpr int PANEL = {fm.PANEL_PANEL};" in code
    assert f"constexpr int SMEM_LIMIT = {fm.SMEM_LIMIT};" in code


def test_mvn_variant_tool_edits_apply_to_the_source():
    """tools/torch_mvn_variants.py times the shared-memory route at other
    panel widths by editing SMEM_PANEL in csrc/fused_mvn.cu, and the
    cluster route's variants by edits of its own: every edit must still
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
    cluster = tool.variant_sources(src, route="cluster")
    assert cluster["kept"] == src
    assert set(cluster) == {"kept", *tool.CLUSTER_EDITS}
    for name in tool.CLUSTER_EDITS:
        assert cluster[name] != src, name
    assert set(tool.CLUSTER_DIAGNOSTIC) <= set(tool.CLUSTER_EDITS)
    assert "cpanel_32" in cluster and "phase_clock" in cluster and "no_lookahead" in cluster
