"""PyTorch port: the named spans at the port's layer boundaries
(``utils/profiling.py::span``).  Off by default and then free of any
``record_function``; on, a CPU ``torch.profiler`` trace of a tiny HMC or
ensemble run holds each span as often as its layer ran, nested as the
layers are; and a chain drawn with spans on equals one drawn with them
off, bit for bit.  CPU, tiny synthetic chains."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpbayestools_hic_tpu_torch.samplers.ensemble import run_ensemble
from gpbayestools_hic_tpu_torch.samplers.hmc import run_hmc
from gpbayestools_hic_tpu_torch.utils import profiling
from gpbayestools_hic_tpu_torch.utils.profiling import enable_spans, span, spans_enabled
from gpbayestools_hic_tpu_torch.utils.synthetic import build_synthetic_chain

NPC = 2
BLOCKS = (5, 3)
HMC_STEPS, WARMUP = 3, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _spans_off_after():
    yield
    enable_spans(False)


@pytest.fixture(scope="module", params=[torch.float64, torch.float32], ids=["f64", "f32"])
def chain(request):
    c, _ = build_synthetic_chain(nev=60, ndim=4, nobs_blocks=BLOCKS, npc=NPC, gp_maxiter=10,
                                 device="cpu", dtype=request.param)
    return c


class Counted:
    """A posterior function that counts its calls."""

    def __init__(self, fn):
        self.fn = fn
        self.n = 0

    def __call__(self, state, x):
        self.n += 1
        return self.fn(state, x)


def _spans(prof) -> list[tuple]:
    """``(name, start_ns, end_ns, thread)`` of the trace's ``hic.*`` spans."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("hic."):
            s = e.start_ns()
            out.append((e.name(), s, s + e.duration_ns(), e.start_thread_id()))
    return out


def _count(spans, name) -> int:
    return sum(1 for s in spans if s[0] == name)


def _hmc(chain, calls, seed=7):
    log_post, state = chain.posterior_with_state()
    x0 = np.random.default_rng(0).uniform(chain.min, chain.max, (8, chain.ndim))
    return run_hmc(calls if calls is not None else log_post, x0, HMC_STEPS, seed, state=state,
                   lo=chain.min, hi=chain.max, n_leapfrog=3, warmup=WARMUP, scheme="windowed",
                   persist=0.5, device="cpu", dtype=chain._dtype)


def _ensemble(chain, calls, nsteps=2):
    log_post, state = chain.posterior_with_state()
    x0 = np.random.default_rng(1).uniform(chain.min, chain.max, (8, chain.ndim))
    return run_ensemble(calls if calls is not None else log_post,
                        torch.as_tensor(x0, dtype=chain._dtype), nsteps, 11, state=state,
                        move="stretch")


def test_spans_are_off_by_default_and_off_builds_no_record_function(chain, monkeypatch):
    assert not spans_enabled()

    def refuse(*a, **k):
        raise AssertionError("record_function built with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert span("hic.step") is span("hic.posterior")
    chain.likelihood_mode = "auto"
    _hmc(chain, None)
    chain.likelihood_mode = "stitched"
    _ensemble(chain, None, nsteps=1)
    chain.likelihood_mode = "auto"


def test_enable_spans_switches_record_function():
    enable_spans(True)
    assert spans_enabled()
    assert isinstance(span("hic.step"), torch.profiler.record_function)
    enable_spans(False)
    assert not spans_enabled()
    assert span("hic.step") is profiling._NO_SPAN


def test_hmc_trace_holds_each_layer_span(chain):
    chain.likelihood_mode = "auto"
    log_post, _ = chain.posterior_with_state()
    calls = Counted(log_post)
    enable_spans(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _hmc(chain, calls)
    enable_spans(False)
    spans = _spans(prof)
    n_emu = len(BLOCKS)
    fused = chain.emuList[0]._fused is not None
    steps = 2 * WARMUP + HMC_STEPS
    assert _count(spans, "hic.step") == steps
    assert _count(spans, "hic.posterior") == calls.n
    assert _count(spans, "hic.predict") == n_emu * calls.n
    # one fused epilogue over every emulator's block per call
    assert _count(spans, "hic.woodbury") == calls.n
    # every HMC posterior call takes a gradient; the fused backward is one
    # node per emulator, the plain one (_NormMeanVar) one per GP
    assert _count(spans, "hic.grad") == calls.n
    assert _count(spans, "hic.predict_bwd") == n_emu * calls.n * (1 if fused else NPC)
    # float(acc) in every step, the chain and the log-probabilities at the end
    assert _count(spans, "hic.readback") == steps + 2
    assert _count(spans, "hic.mvn") == 0 and _count(spans, "hic.assembly") == 0
    posts = [s for s in spans if s[0] == "hic.posterior"]
    for name, s, e, tid in spans:
        if name == "hic.predict":
            assert any(p[3] == tid and p[1] <= s and e <= p[2] for p in posts)
    steps_at = [(s, e) for name, s, e, _ in spans if name == "hic.step"]

    def outside_steps(name):
        return sum(1 for n, s, e, _ in spans
                   if n == name and not any(a <= s and e <= b for a, b in steps_at))

    # each of the three phases (two warmup, production) evaluates its start
    # before its first step; the two end-of-run copies follow the last one
    assert outside_steps("hic.posterior") == outside_steps("hic.grad") == 3
    assert outside_steps("hic.readback") == 2


@pytest.mark.parametrize("mode", ["generic", "stitched"])
def test_ensemble_trace_holds_assembly_and_mvn_per_call(chain, mode):
    chain.likelihood_mode = mode
    log_post, _ = chain.posterior_with_state()
    calls = Counted(log_post)
    nsteps = 2
    enable_spans(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _ensemble(chain, calls, nsteps)
    enable_spans(False)
    chain.likelihood_mode = "auto"
    spans = _spans(prof)
    n_emu = len(BLOCKS)
    assert calls.n == 1 + 2 * nsteps
    assert _count(spans, "hic.step") == nsteps
    assert _count(spans, "hic.posterior") == calls.n
    assert _count(spans, "hic.predict") == n_emu * calls.n
    if mode == "generic":
        assert _count(spans, "hic.assembly") == n_emu * calls.n
        assert _count(spans, "hic.mvn") == n_emu * calls.n
    else:
        # the stitching around the emulators' own assembly
        assert _count(spans, "hic.assembly") == (1 + n_emu) * calls.n
        assert _count(spans, "hic.mvn") == calls.n
    for name in ("hic.woodbury", "hic.grad", "hic.predict_bwd", "hic.readback"):
        assert _count(spans, name) == 0, name


def test_chains_with_spans_on_equal_chains_with_spans_off(chain):
    chain.likelihood_mode = "auto"
    off = _hmc(chain, None)
    enable_spans(True)
    on = _hmc(chain, None)
    enable_spans(False)
    assert np.array_equal(off.chain, on.chain)
    assert np.array_equal(off.log_prob, on.log_prob)
    chain.likelihood_mode = "generic"
    ens_off = _ensemble(chain, None)
    enable_spans(True)
    ens_on = _ensemble(chain, None)
    enable_spans(False)
    chain.likelihood_mode = "auto"
    assert torch.equal(ens_off.chain, ens_on.chain)
    assert torch.equal(ens_off.log_prob, ens_on.log_prob)
