"""The traced window: a ``torch.profiler`` trace reduced to a summary.

Copied in its idea from ``tools/torch_profile_posterior.py::profile_calls``
(device time per kernel name from the profiler's device events), with two
changes: the device's busy time is the union of the device activities'
intervals (not the sum of their durations, which counts overlapping work
twice), and the window is the span the harness itself records around the
traced work (``bench.window``), so busy and idle time come from one clock.

:func:`summarize` turns the raw events into the plain dict that the
per-layer metric readers (``benchmark/metrics``) read:

- ``window_s``: the traced window; ``busy_s``: the union of every device
  activity (kernels, copies, fills) inside it;
- ``kernels``: ``{name: [launches, device seconds]}`` of the device
  kernels inside it (copies and fills left out), ``n_kernels`` their sum;
- ``device_ops``: the ten device activities (copies and fills included)
  that took most time;
- ``idle_gaps``: the device's idle time inside the window, summed by what
  the host was doing meanwhile (the innermost host operation or span open
  at the gap's middle, on any host thread), the ten largest.
"""

from __future__ import annotations

from contextlib import contextmanager

WINDOW_SPAN = "bench.window"
POSTERIOR_SPAN = "bench.posterior"
_NOT_KERNELS = ("Memcpy", "Memset")


@contextmanager
def traced(enabled: bool):
    """Profile the enclosed work (CPU and CUDA activities) when ``enabled``;
    yields the profiler, or None."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def raw_events(prof) -> list[tuple]:
    """``(name, on_device, start_ns, end_ns, thread)`` of every event but
    the device-side copies of the harness's spans (the profiler shows a
    host span on the device's timeline too: it is no device work).  Read
    from the profiler's raw results, which is far quicker than building
    its event tree."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = str(e.device_type()).endswith("CUDA")
        if dev and (e.is_user_annotation() or e.name() in (WINDOW_SPAN, POSTERIOR_SPAN)):
            continue
        s = e.start_ns()
        out.append((e.name(), dev, s, s + e.duration_ns(), -1 if dev else e.start_thread_id()))
    return out


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _innermost(host: list[tuple], points: list[int]) -> list[str | None]:
    """For each time in ``points`` (sorted), the name of the innermost host
    event open at that time (the latest-starting one still open, over all
    threads), or None."""
    by_thread: dict[int, list[tuple]] = {}
    for name, s, e, tid in host:
        by_thread.setdefault(tid, []).append((s, e, name))
    best: list[tuple[int, str] | None] = [None] * len(points)
    for evs in by_thread.values():
        evs.sort(key=lambda t: (t[0], -t[1]))
        stack: list[tuple] = []
        i = 0
        for k, p in enumerate(points):
            while i < len(evs) and evs[i][0] <= p:
                while stack and stack[-1][1] < evs[i][0]:
                    stack.pop()
                stack.append(evs[i])
                i += 1
            while stack and stack[-1][1] < p:
                stack.pop()
            if stack and (best[k] is None or stack[-1][0] > best[k][0]):
                best[k] = (stack[-1][0], stack[-1][2])
    return [b[1] if b else None for b in best]


def summarize(events: list[tuple]) -> dict:
    """Reduce raw events (see :func:`raw_events`) to the traced window's
    summary; the window is the last ``bench.window`` span."""
    spans = [(s, e) for name, dev, s, e, _ in events if not dev and name == WINDOW_SPAN]
    if not spans:
        raise ValueError(f"the trace holds no {WINDOW_SPAN!r} span")
    w0, w1 = spans[-1]
    device, host = [], []
    for name, dev, s, e, tid in events:
        if e <= w0 or s >= w1:
            continue
        s, e = max(s, w0), min(e, w1)
        if dev:
            device.append((name, s, e))
        elif name != WINDOW_SPAN:
            host.append((name, s, e, tid))
    busy = _union([(s, e) for _, s, e in device])
    kernels: dict[str, list] = {}
    ops: dict[str, float] = {}
    for name, s, e in device:
        ops[name] = ops.get(name, 0.0) + (e - s) * 1e-9
        if not name.startswith(_NOT_KERNELS):
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += (e - s) * 1e-9
    gaps, prev = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    labels = _innermost(host, [(a + b) // 2 for a, b in gaps])
    idle: dict[str, float] = {}
    for (a, b), label in zip(gaps, labels):
        key = label or "host outside any traced operation"
        idle[key] = idle.get(key, 0.0) + (b - a) * 1e-9
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": sum(e - s for s, e in busy) * 1e-9,
        "kernels": kernels,
        "n_kernels": sum(v[0] for v in kernels.values()),
        "device_ops": [[k, v] for k, v in top],
        "idle_gaps": [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
    }


def kernel_seconds(summary: dict, patterns) -> tuple[int, float]:
    """(launches, device seconds) of the kernels whose name matches any of
    the regular expressions ``patterns``."""
    import re

    regs = [re.compile(p) for p in patterns]
    n, t = 0, 0.0
    for name, (count, secs) in summary["kernels"].items():
        if any(r.search(name) for r in regs):
            n += count
            t += secs
    return n, t
