"""The Woodbury epilogue's reader (``woodbury_share.hmc``,
``woodbury_share.pcsk``) on synthetic summaries whose answers are known."""

from __future__ import annotations

import pytest

from benchmark.harness.spec import load_benchmark, load_reader

FWD = "void (anonymous namespace)::woodbury_fwd_kernel<true>((anonymous namespace)::FwdParams)"
BWD = "void (anonymous namespace)::woodbury_bwd_kernel((anonymous namespace)::BwdParams)"


def _summary(calls, kernels):
    return {"calls": calls, "kernels": kernels, "window_s": 0.010, "busy_s": 0.004,
            "n_kernels": 0, "steps": 4}


@pytest.mark.parametrize("name", ["woodbury_share.hmc", "woodbury_share.pcsk"])
def test_one_forward_per_posterior_call_reads_100(name):
    calls = {(4096, True): 14, (4096, False): 2}
    s = _summary(calls, {FWD: [16, 0.003], BWD: [14, 0.001]})
    assert load_reader(name).read(s) == pytest.approx(100.0)
    s["kernels"][FWD] = [8, 0.003]
    assert load_reader(name).read(s) == pytest.approx(50.0)


@pytest.mark.parametrize("kernels", [
    {},
    {"void batch_trsm_left_kernel<float>(float*)": [300, 0.2]},
    {BWD: [4, 0.001]},
], ids=["nothing", "the library's factor", "a backward alone"])
def test_zero_without_the_fused_forward_and_silent_without_calls(kernels):
    """The library's factor (the parent's program) launches no such kernel:
    the share reads 0; a window without posterior calls reads nothing."""
    read = load_reader("woodbury_share.hmc").read
    assert read(_summary({(4096, True): 3}, kernels)) == 0.0
    assert read(_summary({}, {FWD: [2, 0.001]})) is None


def test_the_entries_name_the_hmc_cells():
    entries = {m["name"]: m for m in load_benchmark()["per_layer"]}
    for name, cell in (("woodbury_share.hmc", "bes-hmc"), ("woodbury_share.pcsk", "pcsk-hmc")):
        m = entries[name]
        assert m["workloads"] == [cell] and m["moves"] == "hmc_samples_per_s"
        assert m["layer"] == "Woodbury epilogue" and m["unit"] == "%"
