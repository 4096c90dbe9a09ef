"""The port's own spans in a traced window: which layer launched each
kernel, and in which layer the card sat idle.

The port records ``hic.*`` spans (``gpbayestools_hic_tpu_torch/utils/
profiling.py::span``) once ``enable_spans(True)`` is set.  This module
reads the profiler's raw events again, with their correlation ids, and
reduces them over the window that ``trace.py`` uses (the last
``bench.window`` span):

- each device kernel is linked to its launching runtime event
  (``cudaLaunchKernel``, ``cuLaunchKernel(Ex)``, ``cudaLaunchKernelExC``)
  by the CUPTI correlation id they share, and put down to the innermost
  ``hic.*`` span open at that launch: first on the launch's own thread,
  else on any thread (the latest-starting one open);
- each idle gap of the window (the gaps ``trace.py::summarize`` finds:
  the window less the union of the device activities) is put down to the
  innermost ``hic.*`` span open at its middle, on any thread; a gap under
  no ``hic.*`` span is the sampler's own (:data:`NO_SPAN`).  The gap is
  first placed on the host's clock by the launch of the device activity
  that ends it: its end is taken as that launch's start.  The card's
  timeline and the host's can drift apart by milliseconds within one
  trace (on the H100 machines seen, up to 0.26 s in a 4 s window), while
  a launch and the spans around it share the host's clock; a gap that no
  linked activity ends (the window's last) keeps the card's clock;
- per span name: the count, the self time (duration less what its child
  spans cover; a span's parent is the innermost span containing it on its
  thread, else on any thread), the kernels launched inside it with their
  device seconds, and the idle seconds.

Since every gap goes to exactly one name, the layers' idle shares
(:func:`idle_percent`) sum to the window's device idle share.
"""

from __future__ import annotations

import re

from benchmark.harness.readers import window_work
from benchmark.harness.trace import POSTERIOR_SPAN, WINDOW_SPAN, _union
from benchmark.work.counts import least_seconds

PREFIX = "hic."
NO_SPAN = "(no hic span)"
_LAUNCH = re.compile(r"^cu(da)?(LaunchKernel|Memcpy|Memset)")
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")
_NOT_KERNELS = ("Memcpy", "Memset")

#: the spans each layer's idle share is read under (PERF.md section 3)
LAYERS = {
    "sampler": (NO_SPAN, "hic.step", "hic.readback"),
    "posterior": ("hic.posterior",),
    "predict": ("hic.predict", "hic.predict_bwd"),
    "likelihood": ("hic.woodbury", "hic.assembly", "hic.mvn"),
    "grad": ("hic.grad",),
}
PREDICT_SPANS = LAYERS["predict"]


def span_events(prof) -> list[tuple]:
    """``(name, kind, start_ns, end_ns, thread, correlation)`` of the
    profiler's events that the reduction reads.  ``kind``: ``"device"`` (a
    kernel, copy or fill; the device-side copies of host spans left out),
    ``"launch"`` (a runtime event that launches a kernel, a copy or a fill) or ``"op"`` (a
    PyTorch operation or a span on a host thread; the other runtime and
    driver calls are left out).  ``correlation``: the CUPTI id that a
    device activity shares with its launch (PyTorch gives a launch the
    thread id of the operations on its thread)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            if e.is_user_annotation() or name.startswith(PREFIX) \
                    or name in (WINDOW_SPAN, POSTERIOR_SPAN):
                continue
            k = "device"
        elif _LAUNCH.match(name):
            k = "launch"
        elif _RUNTIME.match(name):
            continue
        else:
            k = "op"
        s = e.start_ns()
        out.append((name, k, s, s + e.duration_ns(), e.start_thread_id(), e.correlation_id()))
    return out


def _open(spans: list[tuple], points: list[int]) -> list[dict]:
    """For each time in ``points`` (sorted), ``{thread: index}`` of the
    innermost of ``spans`` (``(name, start, end, thread)``) open there on
    each thread (spans nest on a thread)."""
    by_thread: dict[int, list[int]] = {}
    for i, sp in enumerate(spans):
        by_thread.setdefault(sp[3], []).append(i)
    out: list[dict] = [{} for _ in points]
    for tid, idx in by_thread.items():
        idx.sort(key=lambda i: (spans[i][1], -spans[i][2]))
        stack: list[int] = []
        j = 0
        for k, p in enumerate(points):
            while j < len(idx) and spans[idx[j]][1] <= p:
                while stack and spans[stack[-1]][2] < spans[idx[j]][1]:
                    stack.pop()
                stack.append(idx[j])
                j += 1
            while stack and spans[stack[-1]][2] < p:
                stack.pop()
            if stack:
                out[k][tid] = stack[-1]
    return out


def _pick(spans, open_at: dict, tid=None):
    """The span open on thread ``tid`` if any, else the latest-starting
    one open on any thread; None where none is open."""
    if tid is not None and tid in open_at:
        return open_at[tid]
    if not open_at:
        return None
    return max(open_at.values(), key=lambda i: spans[i][1])


def _attribute(spans, points: list[int], threads=None) -> list:
    order = sorted(range(len(points)), key=points.__getitem__)
    found = _open(spans, [points[i] for i in order])
    out = [None] * len(points)
    for k, i in enumerate(order):
        out[i] = _pick(spans, found[k], None if threads is None else threads[i])
    return out


def _parents(spans) -> list:
    """Each span's parent (index or None): the innermost span containing
    it on its own thread, else the latest-starting one open at its start
    on another thread."""
    parent: list = [None] * len(spans)
    by_thread: dict[int, list[int]] = {}
    for i, sp in enumerate(spans):
        by_thread.setdefault(sp[3], []).append(i)
    orphans = []
    for idx in by_thread.values():
        idx.sort(key=lambda i: (spans[i][1], -spans[i][2]))
        stack: list[int] = []
        for i in idx:
            while stack and spans[stack[-1]][2] < spans[i][2]:
                stack.pop()
            if stack:
                parent[i] = stack[-1]
            else:
                orphans.append(i)
            stack.append(i)
    orphans.sort(key=lambda i: spans[i][1])
    found = _open(spans, [spans[i][1] for i in orphans])
    for i, open_at in zip(orphans, found):
        others = {t: j for t, j in open_at.items()
                  if t != spans[i][3] and spans[j][2] >= spans[i][2]}
        parent[i] = _pick(spans, others)
    return parent


def reduce(events: list[tuple]) -> dict:
    """Reduce :func:`span_events`' output over the last ``bench.window``
    span: ``{"window_s", "busy_s", "idle_s", "n_kernels", "linked",
    "launch_after", "lag_us", "spans": {name: {"count", "self_s",
    "kernels", "kernel_s", "idle_s", "idle_card_clock_s"}}, "kernels": {kernel: {name:
    [launches, device seconds]}}, "anchored"}``; ``linked``: kernels with a launch,
    ``launch_after``: kernels that started before their launch (none on a
    sound clock), ``lag_us``: the least, the 1st percentile and the median
    of a kernel's start less its launch's (None without a linked kernel),
    ``anchored``: the share of the idle time placed by a launch;
    ``idle_card_clock_s``: the idle time put down by each gap's middle on
    the card's own clock instead, for comparison.
    Names are the ``hic.*`` spans and :data:`NO_SPAN`."""
    windows = [(s, e) for n, k, s, e, *_ in events if k == "op" and n == WINDOW_SPAN]
    if not windows:
        raise ValueError(f"the trace holds no {WINDOW_SPAN!r} span")
    w0, w1 = windows[-1]
    spans = [(n, s, e, t) for n, k, s, e, t, _ in events if k == "op" and n.startswith(PREFIX)]
    launches = {c: (s, t) for n, k, s, e, t, c in events if k == "launch"}
    device = [(n, s, e, c) for n, k, s, e, t, c in events
              if k == "device" and e > w0 and s < w1]
    table: dict[str, dict] = {}

    def row(name):
        return table.setdefault(name, {"count": 0, "self_s": 0.0, "kernels": 0, "kernel_s": 0.0,
                                       "idle_s": 0.0, "idle_card_clock_s": 0.0})

    # kernels -> launches -> spans
    kernels = [d for d in device if not d[0].startswith(_NOT_KERNELS)]
    linked = [launches.get(c) for _, _, _, c in kernels]
    have = [i for i, ln in enumerate(linked) if ln is not None]
    at = _attribute(spans, [linked[i][0] for i in have], [linked[i][1] for i in have])
    label = [NO_SPAN] * len(kernels)
    for i, j in zip(have, at):
        if j is not None:
            label[i] = spans[j][0]
    lags = sorted(kernels[i][1] - linked[i][0] for i in have)
    by_kernel: dict[str, dict] = {}
    for (name, s, e, _), lab in zip(kernels, label):
        secs = (min(e, w1) - max(s, w0)) * 1e-9
        r = row(lab)
        r["kernels"] += 1
        r["kernel_s"] += secs
        k = by_kernel.setdefault(name, {}).setdefault(lab, [0, 0.0])
        k[0] += 1
        k[1] += secs

    # idle gaps -> spans, each gap placed by the launch that ends it
    clipped = sorted((max(s, w0), min(e, w1), c) for _, s, e, c in device)
    first_at: dict[int, int] = {}
    for s, _, c in clipped:
        first_at.setdefault(s, c)
    busy = _union([(s, e) for s, e, _ in clipped])
    gaps, prev = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    mids, anchored = [], 0
    for a, b in gaps:
        ln = launches.get(first_at.get(b, -1)) if b < w1 else None
        mids.append((a + b) // 2 if ln is None else ln[0] - (b - a) // 2)
        anchored += 0 if ln is None else b - a
    at = _attribute(spans, mids)
    # beside it, each gap at its middle on the card's own clock
    at_card = _attribute(spans, [(a + b) // 2 for a, b in gaps])
    for (a, b), j, jc in zip(gaps, at, at_card):
        row(NO_SPAN if j is None else spans[j][0])["idle_s"] += (b - a) * 1e-9
        row(NO_SPAN if jc is None else spans[jc][0])["idle_card_clock_s"] += (b - a) * 1e-9

    # counts and self times of the spans inside the window
    parent = _parents(spans)
    children: dict[int, list] = {}
    for i, p in enumerate(parent):
        if p is not None:
            children.setdefault(p, []).append((spans[i][1], spans[i][2]))
    for i, (name, s, e, _) in enumerate(spans):
        if s < w0 or s >= w1:
            continue
        covered = sum(min(b, e) - max(a, s) for a, b in _union(children.get(i, []))
                      if min(b, e) > max(a, s))
        r = row(name)
        r["count"] += 1
        r["self_s"] += (min(e, w1) - s - covered) * 1e-9
    window_s = (w1 - w0) * 1e-9
    busy_s = sum(e - s for s, e in busy) * 1e-9
    return {"window_s": window_s, "busy_s": busy_s, "idle_s": window_s - busy_s,
            "n_kernels": len(kernels), "linked": len(have),
            "launch_after": sum(1 for v in lags if v < 0),
            "lag_us": [lags[0] * 1e-3, lags[len(lags) // 100] * 1e-3, lags[len(lags) // 2] * 1e-3]
            if lags else None,
            "spans": dict(sorted(table.items())), "kernels": by_kernel,
            "anchored": anchored / (w1 - w0 - sum(e - s for s, e in busy)) if gaps else None}


def has_spans(red: dict) -> bool:
    return any(name.startswith(PREFIX) and r["count"] for name, r in red["spans"].items())


def idle_percent(red: dict, layer: str, key: str = "idle_s") -> float | None:
    """The share of the window in which the card idled under ``layer``'s
    spans (:data:`LAYERS`), in percent; None where the window holds no
    ``hic.*`` span (a program without them).  ``key="idle_card_clock_s"``
    reads the gaps placed on the card's clock."""
    if not has_spans(red) or red["window_s"] <= 0:
        return None
    idle = sum(red["spans"].get(n, {}).get(key, 0.0) for n in LAYERS[layer])
    return 100.0 * idle / red["window_s"]


def device_idle_percent(red: dict) -> float | None:
    return 100.0 * red["idle_s"] / red["window_s"] if red["window_s"] > 0 else None


def per_step(red: dict, name: str) -> float | None:
    """``name`` spans in the window over its ``hic.step`` spans."""
    steps = red["spans"].get("hic.step", {}).get("count", 0)
    return red["spans"].get(name, {}).get("count", 0) / steps if steps else None


def predict_roofline_percent(red: dict, summary: dict, mode: str) -> float | None:
    """The least time of the window's predict work (``readers.window_work``,
    over the posterior calls the harness counted) over the device seconds
    of the kernels launched inside the predict's spans, in percent."""
    secs = sum(red["spans"].get(n, {}).get("kernel_s", 0.0) for n in PREDICT_SPANS)
    if secs <= 0:
        return None
    work = window_work(summary, mode, ("predict",))
    if work.flops <= 0 and work.nbytes <= 0:
        return None
    return 100.0 * least_seconds(work) / secs


def kernels_under(red: dict, pattern: str) -> dict[str, int]:
    """``{span name: launches}`` of the window's kernels named like the
    regular expression ``pattern``."""
    reg = re.compile(pattern)
    out: dict[str, int] = {}
    for kernel, labels in red["kernels"].items():
        if reg.search(kernel):
            for name, (n, _) in labels.items():
                out[name] = out.get(name, 0) + n
    return out
