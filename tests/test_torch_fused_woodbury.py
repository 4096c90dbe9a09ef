"""PyTorch port: the fused Woodbury epilogue (ops/fused_woodbury.py).

The CPU tests hold the closed form (value, alpha = B^-1 d, diag(B^-1) and
the backward) against autograd through the library's factor in float64,
the route, and the posterior's library route bit for bit.  The card tests
(skipped without a CUDA device; the kernels have no CPU mode) hold the
kernels against the library's factor in float64.  The file imports neither
JAX nor the JAX package; on a machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fused_woodbury.py

Tolerances of the card tests, and why:
- lp within 1e-5 of S = |d^T B^-1 d| + |log det B| + |const2| + |logdet_c0_m|
  + 1 (float32 with IEEE division and square root: a Cholesky of k <= 88
  on B = M^-1 + diag(v) with cond(B) < 10 is good to about k eps cond(B)
  of S, 5e-5 at k = 88; measured far below);
- each gradient within 1e-4 of its largest float64 entry, normwise (the
  same bound through the solve with B^-1's diagonal, the fused predict's
  forward tolerance);
- a walker-block that is not positive definite gives -inf and a zero
  gradient, and its neighbours' values are bit for bit those of a call
  without it (each matrix's result depends on that matrix alone).
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from gpbayestools_hic_tpu_torch.ops import fused_woodbury as fw
from gpbayestools_hic_tpu_torch.ops.registry import LAUNCH_COUNTS
from gpbayestools_hic_tpu_torch.samplers import chain as chain_mod

BES_KS = [4] * 9                                  # auau-bes: 9 emulators x 4 PCs
PCSK_KS = [24, 23, 11, 88, 13, 19, 24, 48, 88]   # auau-bes-pcsk's npc_blocks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _block(k, m, seed, dtype=torch.float64, device="cpu", kdiag=False):
    """One block's state and inputs: M^-1 SPD with eigenvalues in [0.5, 2],
    v in [0, 0.3] (or qf with kdiag, some v clamped to 0), d ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(k, k)))
    m_inv = (q * rng.uniform(0.5, 2.0, k)) @ q.T
    opts = dict(dtype=dtype, device=device)
    bs = {"p0": torch.tensor(rng.normal(size=k), **opts),
          "m_inv": torch.tensor(0.5 * (m_inv + m_inv.T), **opts),
          "const2": torch.tensor(rng.uniform(10, 50), **opts),
          "logdet_c0_m": torch.tensor(rng.uniform(-20, 20), **opts)}
    mean = torch.tensor(rng.normal(size=(m, k)), **opts) + bs["p0"]
    v = rng.uniform(0.0, 0.3, (m, k))
    if not kdiag:
        return bs, mean, torch.tensor(v, **opts), None
    kd = rng.uniform(0.5, 1.0, k)
    qf = kd - v
    qf[::7, 0] = kd[0] + 0.05  # clamped: v = 0 there, no gradient through qf
    return bs, mean, torch.tensor(qf, **opts), torch.tensor(kd, **opts)


def _cast(bs, *ts, **opts):
    return ({k: v.to(**opts) for k, v in bs.items()},
            *(None if t is None else t.to(**opts) for t in ts))


def _library_grad(bs, mean, var, kd, g):
    """lp and its gradient in (gp_mean, var) by autograd through the
    library's factor (the posterior's library route)."""
    mean = mean.detach().requires_grad_(True)
    var = var.detach().requires_grad_(True)
    lp = chain_mod._lowrank_library(bs, mean, var, kd)
    gm, gv = torch.autograd.grad(lp, (mean, var), g)
    return lp.detach(), gm, gv


# ---------------------------------------------------------------------- CPU


@pytest.mark.parametrize("kdiag", [False, True])
@pytest.mark.parametrize("k", [1, 4, 17, 88])
def test_closed_form_matches_autograd_of_the_library_in_float64(k, kdiag):
    """The plain closed form against autograd of spd_qform_logdet, float64:
    values to 1e-10 of S, gradients to 1e-9 of their largest entry; a
    walker whose B is not positive definite gives -inf and zeros in both."""
    m = 33
    bs, mean, var, kd = _block(k, m, seed=k, kdiag=kdiag)
    if not kdiag:
        var[5, 0] = -50.0  # B not positive definite for walker 5
    g = torch.linspace(0.5, 1.5, m, dtype=torch.float64)
    lp, alpha, dinv = fw.woodbury_plain(bs, mean, var, kd)
    gm, gv = fw.woodbury_grad_plain(g, lp, alpha, dinv, var, kd)
    want_lp, want_gm, want_gv = _library_grad(bs, mean, var, kd, g)
    ok = torch.isfinite(want_lp)
    assert torch.equal(torch.isfinite(lp), ok)
    assert int((~ok).sum()) == (0 if kdiag else 1)
    s = want_lp[ok].abs().max() + 1
    assert (lp[ok] - want_lp[ok]).abs().max() <= 1e-10 * s
    for got, want in ((gm, want_gm), (gv, want_gv)):
        assert torch.isfinite(got).all()
        assert (got[ok] - want[ok]).abs().max() <= 1e-9 * want[ok].abs().max()
        assert not got[~ok].any()
    if kdiag:
        assert not gv[::7, 0].any()


@pytest.mark.parametrize("device,dtype,ks,expect", [
    ("cpu", torch.float32, [4, 4], False),
    ("cpu", torch.float64, [88], False),
    ("cuda", torch.float64, [4], False),
    ("cuda", torch.float32, BES_KS, True),
    ("cuda", torch.float32, PCSK_KS + [128], True),
    ("cuda", torch.float32, [4, 129], False),
])
def test_the_route_follows_device_dtype_and_the_largest_k(device, dtype, ks, expect):
    """Float32 on CUDA with every k <= 128 takes the kernels; CPU, float64
    and a block past 128 PCs take the library (a stated route limit)."""
    assert fw.MAX_K == 128
    assert fw.takes_kernel(torch.device(device), dtype, ks) is expect


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kdiag", [False, True])
def test_cpu_takes_the_library_bit_for_bit(dtype, kdiag):
    """woodbury_blocks on the CPU: the library route (not fused), each
    column and each gradient bit for bit the per-block library loop, in
    one hic.woodbury call over ragged blocks."""
    m, ks = 19, [4, 11, 2]
    blocks = [_cast(*_block(k, m, seed=10 + k, kdiag=kdiag), dtype=dtype) for k in ks]
    states = [b[0] for b in blocks]
    leaves = [(b[1].clone().requires_grad_(True), b[2].clone().requires_grad_(True), b[3])
              for b in blocks]
    lp, fused = chain_mod.woodbury_blocks(states, leaves)
    assert not fused and lp.shape == (m, len(ks)) and lp.dtype == dtype
    grads = torch.autograd.grad(lp.sum(1).sum(), [t for lf in leaves for t in lf[:2]])
    for j, (bs, mean, var, kd) in enumerate(blocks):
        want, gm, gv = _library_grad(bs, mean, var, kd, torch.ones(m, dtype=dtype))
        assert torch.equal(lp[:, j].detach(), want)
        assert torch.equal(grads[2 * j], gm) and torch.equal(grads[2 * j + 1], gv)


@pytest.fixture(scope="module")
def mixed_chain(tmp_path_factory):
    """A small CPU chain, float64: three PCA emulators, the middle one
    turned into a diagonal block (exp_and_cov_diagonal)."""
    from gpbayestools_hic_tpu_torch.utils.synthetic import build_synthetic_chain

    ch, _ = build_synthetic_chain(nev=40, ndim=3, nobs_blocks=(6, 8, 5), npc=3, gp_maxiter=0,
                                  seed=4, tmpdir=str(tmp_path_factory.mktemp("mixed")),
                                  device="cpu", dtype=torch.float64)
    ch.emuList[1].exp_and_cov_diagonal_ = True
    ch._device_fns = None
    return ch


def test_blocked_likelihood_with_mixed_blocks_gives_todays_values(mixed_chain):
    """The posterior over low-rank, diagonal, low-rank blocks equals the
    per-block sum in block order (what it was before the fused op) bit for
    bit, value and gradient."""
    ch = mixed_chain
    fn, st = ch.posterior_with_state()
    kinds = [set(b) for b in st["blocks"]]
    assert "p0" in kinds[0] and "exp_var_block" in kinds[1] and "p0" in kinds[2]
    x = torch.tensor(ch.random_pos(17, seed=5), requires_grad=True)
    lp = fn(st, x)
    g, = torch.autograd.grad(lp.sum(), x)

    xw = x.detach().clone().requires_grad_(True)
    xs = torch.clamp(xw, st["lo"], st["hi"])
    ll = torch.zeros(17, dtype=torch.float64)
    for e, bs in zip(ch.emuList, st["blocks"]):
        if "p0" in bs:
            ll = ll + chain_mod._lowrank_library(bs, *e.predict_pc_parts_fastgrad(xs))
        else:
            mean, var = e.predict_diag(xs)
            ll = ll + chain_mod.mvn_loglike_diagcov_batch(mean - bs["exp_block"],
                                                          var + bs["exp_var_block"])
    inside = ((xw > st["lo"]) & (xw < st["hi"])).all(1)
    want = torch.where(inside, ll + chain_mod._EXTRA_STD_CONST, torch.full_like(ll, -torch.inf))
    want_g, = torch.autograd.grad(want.sum(), xw)
    assert torch.isfinite(lp).all()
    assert torch.equal(lp.detach(), want.detach())
    assert torch.allclose(g, want_g, rtol=1e-12, atol=0)


def test_block_table_layout():
    """The ctypes table mirrors the source's BlockArg: seven pointers, four
    64-bit strides, k and a pad."""
    assert ctypes.sizeof(fw.BlockArg) == 96
    assert fw.BlockArg.k.offset == 88


def test_the_kernels_refuse_a_cpu_call():
    bs, mean, var, _ = _block(4, 8, seed=1, dtype=torch.float32)
    with pytest.raises(ValueError, match="float32 CUDA"):
        fw.fused_woodbury([bs], [mean], [var], [None])


# --------------------------------------------------------------------- card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _card_blocks(ks, m, dev, kdiag=False, seed=0):
    """float32 card inputs per block, gp_mean and var laid out as the fused
    predict leaves them ((k, m) storage seen as (m, k)), and their float64
    CPU copies."""
    f32, out = dict(dtype=torch.float32, device=dev), []
    for j, k in enumerate(ks):
        bs, mean, var, kd = _block(k, m, seed=seed + 31 * j + k, kdiag=kdiag)
        bs32, kd32 = _cast(bs, kd, **f32) if kd is not None else (_cast(bs, **f32)[0], None)
        mean32 = mean.t().contiguous().to(**f32).t()
        var32 = var.t().contiguous().to(**f32).t()
        out.append(((bs32, mean32, var32, kd32),
                    _cast(bs32, mean32, var32, kd32, dtype=torch.float64, device="cpu")))
    return out


def _check(blocks, g, lp, grads):
    """lp and the gradient against the float64 library, per block."""
    for j, (_, (bs, mean, var, kd)) in enumerate(blocks):
        want, gm, gv = _library_grad(bs, mean, var, kd, g[:, j].double().cpu())
        ok = torch.isfinite(want)
        got = lp[:, j].double().cpu()
        assert torch.equal(torch.isfinite(got), ok)
        s = (want[ok].abs().max() + bs["const2"].abs() + bs["logdet_c0_m"].abs() + 1)
        assert (got[ok] - want[ok]).abs().max() <= 1e-5 * s, j
        for got_g, want_g in ((grads[2 * j], gm), (grads[2 * j + 1], gv)):
            got_g = got_g.double().cpu()
            assert torch.isfinite(got_g).all()
            assert (got_g - want_g).abs().max() <= 1e-4 * want_g.abs().max(), j


def _run(blocks, g):
    leaves = [(b[0][1].detach().requires_grad_(True), b[0][2].detach().requires_grad_(True))
              for b in blocks]
    lp = fw.fused_woodbury([b[0][0] for b in blocks], [lf[0] for lf in leaves],
                           [lf[1] for lf in leaves], [b[0][3] for b in blocks])
    grads = torch.autograd.grad(lp, [t for lf in leaves for t in lf], g)
    torch.cuda.synchronize()
    return lp.detach(), grads


@pytest.mark.parametrize("b", [1, 255, 4096])
@pytest.mark.parametrize("k", [1, 4, 6, 11, 24, 48, 88, 128])
def test_card_kernels_match_float64(card, k, b):
    """One block at each route's ranks (thread at 4 and 8 rows, warp at 16
    and 32, CTA, past 48 KB of shared memory at 128), walkers from one to
    the cells' 4096; one launch forward, one backward."""
    blocks = _card_blocks([k], b, card)
    g = torch.linspace(0.5, 1.5, b, device=card)[:, None]
    before = dict(LAUNCH_COUNTS)
    lp, grads = _run(blocks, g)
    assert LAUNCH_COUNTS["fused_woodbury_fwd"] == before["fused_woodbury_fwd"] + 1
    assert LAUNCH_COUNTS["fused_woodbury_bwd"] == before["fused_woodbury_bwd"] + 1
    _check(blocks, g, lp, grads)


@pytest.mark.parametrize("ks", [BES_KS, PCSK_KS], ids=["auau-bes", "auau-bes-pcsk"])
@pytest.mark.parametrize("kdiag", [False, True])
def test_card_ragged_block_lists(card, ks, kdiag):
    """The cells' block lists in one call at 4096 walkers, v given or
    through kdiag - qf (clamped entries give no gradient), the cotangent
    broadcast as the posterior's sum gives it: one launch each way."""
    m = 4096
    blocks = _card_blocks(ks, m, card, kdiag=kdiag, seed=1)
    g = torch.linspace(0.5, 1.5, m, device=card)[:, None].expand(m, len(ks))
    before = dict(LAUNCH_COUNTS)
    lp, grads = _run(blocks, g)
    assert LAUNCH_COUNTS["fused_woodbury_fwd"] == before["fused_woodbury_fwd"] + 1
    assert LAUNCH_COUNTS["fused_woodbury_bwd"] == before["fused_woodbury_bwd"] + 1
    _check(blocks, g, lp, grads)
    if kdiag:
        for j in range(len(ks)):
            assert not grads[2 * j + 1][::7, 0].any()


@pytest.mark.parametrize("k", [4, 24, 88])
def test_card_non_pd_block_gives_neg_inf_and_a_zero_gradient(card, k):
    """A walker-block whose B is not positive definite: -inf, a zero (not
    NaN) gradient; every other walker and block bit for bit as without it."""
    m = 300
    blocks = _card_blocks([k, 13], m, card, seed=2)
    g = torch.ones((m, 2), device=card)
    lp0, grads0 = _run(blocks, g)
    blocks[0][0][2][17, 0] = -50.0
    lp, grads = _run(blocks, g)
    assert torch.isneginf(lp[17, 0])
    keep = torch.ones(m, dtype=torch.bool, device=card)
    keep[17] = False
    assert torch.equal(lp[keep, 0], lp0[keep, 0]) and torch.equal(lp[:, 1], lp0[:, 1])
    for got, was in zip(grads, grads0):
        assert torch.isfinite(got).all()
    assert not grads[0][17].any() and not grads[1][17].any()
    assert torch.equal(grads[0][keep], grads0[0][keep])
    assert torch.equal(grads[2], grads0[2]) and torch.equal(grads[3], grads0[3])


def test_card_more_blocks_than_a_launch_holds(card):
    """40 blocks: two launches each way, every block right."""
    ks = [4, 11, 40] * 13 + [4]
    blocks = _card_blocks(ks, 64, card, seed=3)
    g = torch.ones((64, len(ks)), device=card)
    before = dict(LAUNCH_COUNTS)
    lp, grads = _run(blocks, g)
    assert LAUNCH_COUNTS["fused_woodbury_fwd"] == before["fused_woodbury_fwd"] + 2
    assert LAUNCH_COUNTS["fused_woodbury_bwd"] == before["fused_woodbury_bwd"] + 2
    _check(blocks, g, lp, grads)


def test_card_value_only_call_matches_the_gradient_call(card):
    """Without a gradient the forward skips alpha and diag(B^-1); its lp is
    the same."""
    blocks = _card_blocks(PCSK_KS, 256, card, seed=4)
    with torch.no_grad():
        lp = fw.fused_woodbury(*[[b[0][i] for b in blocks] for i in range(4)])
    lp_g, _ = _run(blocks, torch.ones((256, len(PCSK_KS)), device=card))
    assert torch.equal(lp, lp_g)


def test_card_limits_match_the_built_library(card):
    assert fw.built_limits() == {"max_k": fw.MAX_K, "max_blocks": fw.MAX_BLOCKS,
                                 "arg_bytes": ctypes.sizeof(fw.BlockArg)}
