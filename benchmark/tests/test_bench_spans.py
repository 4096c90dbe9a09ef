"""The reduction of the port's spans (``benchmark/harness/spans.py``) on a
synthetic trace whose answers are known; a whole tiny CPU run of
``benchmark/tools/span_table.py``; and, on the card, one fused-predict
value-and-gradient call traced with the spans on, whose kernels must each
link to a launch, the fused ones inside the predict's spans."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark.harness import spans
from benchmark.harness.spec import load_module
from benchmark.harness.trace import WINDOW_SPAN
from benchmark.work.counts import bwd_work, fwd_work, least_seconds

from .conftest import CELLS, tiny_spec

MS = 1_000_000  # ns
T1, T2, T3 = 1, 2, 3   # the main thread, autograd's thread, a thread with no span


def _op(name, a, b, tid, corr):
    return (name, "op", int(a * MS), int(b * MS), tid, corr)


def _launch(a, corr, tid, name="cudaLaunchKernel"):
    return (name, "launch", int(a * MS), int(a * MS) + 20_000, tid, corr)


def _kernel(name, a, b, corr):
    return (name, "device", int(a * MS), int(b * MS), -1, corr)


def _events():
    """A 20 ms window.  Main thread: hic.step 1-19 holding hic.posterior 2-10
    (hic.predict 3-5.5, hic.woodbury 6-8), hic.grad 11-17 (an odd hic.mvn
    13-13.5 inside it) and hic.readback 17.5-18.55; autograd's thread:
    hic.predict_bwd 12-14.  Each device activity starts 0.05 ms after its
    launch; one kernel has no launch, one launch comes before any span, on
    a thread of its own."""
    return [
        _op(WINDOW_SPAN, 0, 20, T1, 1),
        _op("hic.step", 1, 19, T1, 2),
        _op("hic.posterior", 2, 10, T1, 3),
        _op("hic.predict", 3, 5.5, T1, 4),
        _op("aten::mm", 3.2, 3.4, T1, 5),
        _op("hic.woodbury", 6, 8, T1, 6),
        _op("aten::add", 6.5, 6.6, T1, 7),
        _op("aten::where", 8.1, 8.3, T1, 14),
        _op("hic.grad", 11, 17, T1, 8),
        _op("hic.predict_bwd", 12, 14, T2, 9),
        _op("aten::bmm", 12.5, 12.6, T2, 10),
        _op("hic.mvn", 13, 13.5, T1, 15),
        _op("aten::bmm", 13.1, 13.3, T2, 13),
        _op("aten::mul", 15, 15.1, T2, 11),
        _op("hic.readback", 17.5, 18.55, T1, 12),
        _launch(3.45, 101, T1),
        _launch(6.65, 102, T1),
        _launch(8.45, 108, T1),
        _launch(12.65, 103, T2),
        _launch(13.35, 106, T2, "cudaLaunchKernelExC"),
        _launch(15.15, 104, T2, "cuLaunchKernelEx"),
        _launch(0.55, 105, T3),
        _launch(17.95, 107, T1, "cudaMemcpyAsync"),
        _kernel("void kstar_kernel<4>(float*)", 3.5, 4.0, 101),
        _kernel("elementwise_kernel", 6.7, 7.0, 102),
        _kernel("where_kernel", 8.5, 9.0, 108),
        _kernel("void bwd_wgmma_kernel<2>(float*)", 12.7, 13.7, 103),
        _kernel("void fwd_wgmma_kernel<2>(float*)", 13.4, 13.6, 106),
        _kernel("mul_kernel", 15.2, 15.4, 104),
        _kernel("init_kernel", 0.6, 0.8, 105),
        _kernel("orphan_kernel", 18.6, 18.8, 999),
        _kernel("Memcpy DtoH (Device -> Pinned)", 18.0, 18.4, 107),
        _kernel("outside_kernel", 21, 22, 110),
    ]


def test_kernels_go_to_the_span_open_at_their_launch():
    red = spans.reduce(_events())
    rows = red["spans"]
    ms = pytest.approx
    assert red["n_kernels"] == 8 and red["linked"] == 7 and red["launch_after"] == 0
    assert red["lag_us"][0] == pytest.approx(50.0)
    assert rows["hic.predict"]["kernels"] == 1
    assert rows["hic.predict"]["kernel_s"] == ms(0.0005)
    assert rows["hic.woodbury"]["kernels"] == 1
    assert rows["hic.posterior"]["kernels"] == 1
    # the launch's own thread first: hic.predict_bwd, though hic.mvn on the
    # main thread started later
    assert rows["hic.predict_bwd"]["kernels"] == 2
    assert rows["hic.predict_bwd"]["kernel_s"] == ms(0.0012)
    assert rows["hic.mvn"]["kernels"] == 0
    # no span on autograd's thread: the latest-starting one open anywhere
    assert rows["hic.grad"]["kernels"] == 1
    # a launch before any span, and a kernel without a launch
    assert rows[spans.NO_SPAN]["kernels"] == 2
    assert spans.kernels_under(red, r"\b(kstar|fwd_wgmma|bwd_wgmma)_kernel") == {
        "hic.predict": 1, "hic.predict_bwd": 2}


def test_idle_gaps_go_to_the_innermost_span_at_their_middle():
    red = spans.reduce(_events())
    idle = {k: v["idle_s"] for k, v in red["spans"].items()}
    ms = pytest.approx
    assert red["window_s"] == ms(0.020) and red["busy_s"] == ms(0.0033)
    assert red["anchored"] == ms((16.7 - 0.2 - 1.2) / 16.7)   # all but the last two gaps
    assert idle[spans.NO_SPAN] == ms(0.0018)      # 0-0.6, 18.8-20
    assert idle["hic.posterior"] == ms(0.0027)    # 0.8-3.5
    assert idle["hic.predict"] == ms(0.0027)      # 4.0-6.7
    assert idle["hic.woodbury"] == ms(0.0015)     # 7.0-8.5
    assert idle["hic.step"] == ms(0.0037)         # 9.0-12.7
    assert idle["hic.grad"] == ms(0.0041)         # 13.7-15.2, 15.4-18.0
    assert idle["hic.readback"] == ms(0.0002)     # 18.4-18.6
    want = {"sampler": 28.5, "posterior": 13.5, "predict": 13.5, "likelihood": 7.5,
            "grad": 20.5}
    got = {layer: spans.idle_percent(red, layer) for layer in spans.LAYERS}
    assert got == {k: ms(v) for k, v in want.items()}
    # each activity starts just after its launch: both clocks agree
    assert {layer: spans.idle_percent(red, layer, "idle_card_clock_s")
            for layer in spans.LAYERS} == {k: ms(v) for k, v in want.items()}
    assert sum(got.values()) == ms(spans.device_idle_percent(red), abs=1e-9)
    assert spans.device_idle_percent(red) == ms(83.5)


def test_counts_and_self_times():
    red = spans.reduce(_events())
    rows = red["spans"]
    ms = pytest.approx
    assert all(rows[n]["count"] == 1 for n in rows if n != spans.NO_SPAN)
    assert rows["hic.step"]["self_s"] == ms(0.00295)      # 18 less 8, 6 and 1.05
    assert rows["hic.posterior"]["self_s"] == ms(0.0035)  # 8 less 2.5 and 2
    assert rows["hic.predict"]["self_s"] == ms(0.0025)
    # hic.predict_bwd, on autograd's thread, is hic.grad's child
    assert rows["hic.grad"]["self_s"] == ms(0.004)
    assert rows["hic.predict_bwd"]["self_s"] == ms(0.002)
    assert spans.per_step(red, "hic.readback") == 1.0


def test_the_predict_roofline_reads_the_predict_spans_kernels():
    red = spans.reduce(_events())
    summary = {"config": {"n_design": 40, "ndim": 3, "npc": 2, "blocks": [5, 3]},
               "calls": {(16, True): 3}}
    work = (fwd_work(2, 40, 16, 3) + bwd_work(2, 40, 16, 3)).scaled(2 * 3)
    want = 100.0 * least_seconds(work) / 0.0017
    assert spans.predict_roofline_percent(red, summary, "auto") == pytest.approx(want)


def test_a_trace_without_the_ports_spans_reads_nothing():
    events = [e for e in _events() if not e[0].startswith(spans.PREFIX)]
    red = spans.reduce(events)
    assert not spans.has_spans(red)
    assert all(spans.idle_percent(red, layer) is None for layer in spans.LAYERS)
    assert spans.per_step(red, "hic.readback") is None
    summary = {"config": {"n_design": 40, "ndim": 3, "npc": 2, "blocks": [5, 3]},
               "calls": {(16, True): 3}}
    assert spans.predict_roofline_percent(red, summary, "auto") is None
    assert red["spans"][spans.NO_SPAN]["idle_s"] == pytest.approx(red["idle_s"])


def test_a_late_kernel_is_counted():
    events = _events() + [_launch(9.5, 120, T1), _kernel("early_kernel", 9.4, 9.45, 120)]
    red = spans.reduce(events)
    assert red["launch_after"] == 1 and red["lag_us"][0] == pytest.approx(-100.0)


def test_a_gap_goes_by_the_launch_that_ends_it_when_the_clocks_drift():
    """The card's timeline 3 ms early against the host's: the gap before
    the kernel launched inside span B goes to B, where the card's own
    clock puts its middle inside span A."""
    events = [
        _op(WINDOW_SPAN, 0, 10, T1, 1),
        _op("hic.predict", 1, 4, T1, 2),
        _op("hic.woodbury", 5, 9, T1, 3),
        _launch(3.9, 11, T1),
        _launch(8.9, 12, T1),
        _kernel("k1", 1.0, 1.5, 11),
        _kernel("k2", 6.0, 6.5, 12),
    ]
    red = spans.reduce(events)
    idle = {k: v["idle_s"] for k, v in red["spans"].items()}
    assert red["launch_after"] == 2
    assert idle["hic.predict"] == pytest.approx(0.001)     # 0-1.0, placed at 2.9-3.9
    assert idle["hic.woodbury"] == pytest.approx(0.008)    # 1.5-6.0 at 4.4-8.9; 6.5-10
    assert idle[spans.NO_SPAN] == 0.0
    # on the card's clock the middle gap (mid 3.75) falls inside hic.predict
    card = {k: v["idle_card_clock_s"] for k, v in red["spans"].items()}
    assert card["hic.predict"] == pytest.approx(0.0045)
    assert card[spans.NO_SPAN] == pytest.approx(0.001)


@pytest.mark.parametrize("cell", CELLS)
def test_a_whole_tiny_cpu_run_reports_every_layer(cell):
    tool = load_module("tools", "span_table")
    out = tool.measure(tiny_spec(cell), 2**31 + 29, torch.device("cpu"), rounds=1, untraced=1)
    (rnd,) = out["rounds"]
    new = rnd["new"]
    layers = [new[f"idle_{layer}"] for layer in spans.LAYERS]
    assert all(v is not None for v in layers), new
    assert sum(layers) == pytest.approx(new["device_idle"], abs=0.1)
    steps = rnd["steps"]
    if cell == "bes-hmc":
        # float(acc) in each step, the chain and the log-probabilities at the end
        assert new["readbacks_per_step"] == pytest.approx((steps + 2) / steps)
    else:
        assert new["readbacks_per_step"] == 0.0
    assert rnd["spans"]["hic.step"]["count"] == steps
    assert rnd["spans"]["hic.posterior"]["count"] == sum(rnd["calls"].values())
    assert set(rnd["existing_on"]) == set(rnd["existing_off"])
    assert len(out["untraced"]) == 1 and set(out["untraced"][0]) == {"on", "off"}


def test_card_fused_kernels_launch_inside_the_predict_spans(card):
    from torch.profiler import ProfilerActivity, profile, record_function

    from gpbayestools_hic_tpu_torch.samplers.hmc import make_value_and_grad
    from gpbayestools_hic_tpu_torch.utils.profiling import enable_spans
    from gpbayestools_hic_tpu_torch.utils.synthetic import build_synthetic_chain

    chain, _ = build_synthetic_chain(nev=200, ndim=6, nobs_blocks=(28, 12), npc=4,
                                     gp_maxiter=0, device=card, dtype=torch.float32)
    assert all(e._fused is not None for e in chain.emuList)
    log_post, state = chain.posterior_with_state()
    d = chain.ndim
    lo = torch.as_tensor(chain.min, dtype=torch.float32, device=card)
    tf = {"mu": torch.zeros(d, device=card), "chol": torch.eye(d, device=card), "lo": lo,
          "width": torch.as_tensor(chain.max, dtype=torch.float32, device=card) - lo}
    vg = make_value_and_grad(log_post, state, tf, True)
    u = torch.as_tensor(np.random.default_rng(0).standard_normal((256, d)),
                        dtype=torch.float32, device=card)
    vg(u)
    torch.cuda.synchronize()
    enable_spans(True)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW_SPAN):
                vg(u)
                torch.cuda.synchronize()
                time.sleep(0.01)
    finally:
        enable_spans(False)
    red = spans.reduce(spans.span_events(prof))
    assert red["n_kernels"] > 0
    assert red["linked"] == red["n_kernels"], red
    # a kernel's start against its launch's reads the profiler's two clocks,
    # which drift apart on the card's machines: reported, not held here
    print("kernel start less launch start, us (least, 1st percentile, median):",
          red["lag_us"])
    for kernel in (r"\bkstar_kernel", r"\bfwd_wgmma_kernel", r"\bbwd_wgmma_kernel"):
        under = spans.kernels_under(red, kernel)
        assert sum(under.values()) == len(chain.emuList), (kernel, under)
        assert set(under) <= {"hic.predict", "hic.predict_bwd"}, (kernel, under)
