"""The traced segment: spans around the program's kernel entries, a
``torch.profiler`` trace of the card, and its reduction to the numbers
the per-layer readers take.

:class:`Spans` replaces each op of ``repro_torch.kernels.ops`` named in
:data:`perfbench.work.KERNELS` by a wrapper that runs the op inside a
``record_function`` span ``perfbench.op.<name>`` and reckons the call's
work from its arguments. A device operation belongs to a span when the
host call that launched it (its CUDA runtime or driver call, matched by
correlation id) lies inside the span on the same thread; so a new route
or kernel behind the same op is measured on the same work.

:func:`reduce` takes the profiler's Chrome trace: the window is the
``perfbench.window`` span; the breakdown lists the device operations that
took most time and the longest idle gaps by what the host was doing at
their middle: the innermost traced host operation covering it, on
whichever thread has the shortest. Tracing the host's operations slows
the host, so the busy and idle shares come from a second segment of the
same work traced on the device alone (:func:`device_busy`): the union of
its kernels, copies and fills over the segment's host-clock length.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Tuple

from perfbench import work

WINDOW = "perfbench.window"
SPAN = "perfbench.op."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
TOP = 10
NAME_CHARS = 96


class Spans:
    """Within ``with``: each named op of ``ops`` runs in a span and its
    calls' work is kept in ``calls[name]``."""

    def __init__(self, ops):
        self.ops = ops
        self.calls: Dict[str, List[work.Work]] = collections.defaultdict(list)
        self._saved: Dict[str, Callable] = {}

    def _wrap(self, name: str, fn: Callable, reckon: Callable) -> Callable:
        from torch.profiler import record_function

        def wrapped(*args, **kwargs):
            with record_function(SPAN + name):
                out = fn(*args, **kwargs)
            self.calls[name].append(reckon(*args, **kwargs))
            return out
        return wrapped

    def __enter__(self):
        for name, reckon in work.KERNELS.items():
            fn = getattr(self.ops, name)
            self._saved[name] = fn
            setattr(self.ops, name, self._wrap(name, fn, reckon))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.ops, name, fn)
        self._saved.clear()
        return False


def traced(fn: Callable[[], None], warm: Callable[[], None], ops,
           sync: Callable[[], None]) -> Dict:
    """Run ``warm`` and then ``fn`` under the profiler with the op spans
    on, and reduce the trace of ``fn`` alone (:func:`reduce`). ``warm``
    runs in the profiler's warm-up phase, which starts CUPTI, and is
    dropped; each part ends in ``sync``."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        sync()
        with Spans(ops) as spans, profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1, active=1),
                on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            warm()
            sync()
            spans.calls.clear()
            prof.step()
            with record_function(WINDOW):
                fn()
                sync()
            prof.step()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out = reduce(events)
    out["calls"] = {k: len(v) for k, v in spans.calls.items()}
    out["bound_s"] = {k: sum(work.bound_s(w) for w in v)
                      for k, v in spans.calls.items()}
    out["host_traced"] = {"busy_s": out["busy_s"], "window_s": out["window_s"]}
    out["busy_s"], out["window_s"] = device_busy(fn, warm, sync)
    return out


def device_busy(fn: Callable[[], None], warm: Callable[[], None],
                sync: Callable[[], None]) -> Tuple[float, float]:
    """(seconds in which a kernel, copy or fill ran, the segment's
    seconds) of ``fn`` traced on the device alone, after ``warm`` in the
    profiler's warm-up phase."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        sync()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)
                     ) as prof:
            warm()
            sync()
            prof.step()
            t0 = time.perf_counter()
            fn()
            sync()
            window = time.perf_counter() - t0
            prof.step()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    busy, merged = union_s(dev)
    span = (merged[-1][1] - merged[0][0]) * 1e-6 if merged else 0.0
    return busy * 1e-6, max(window, span)


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def union_s(intervals: List[Tuple[float, float]]) -> Tuple[float, list]:
    """(covered microseconds, the merged intervals) of ``intervals``."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def _host_at(events: List[dict], points: List[float]) -> List[tuple]:
    """For each time in ``points`` (ascending), (duration, name) of the
    innermost host event of ``events`` (one thread, sorted by start)
    covering it, or None."""
    found, stack, i = [], [], 0
    for t in points:
        while i < len(events) and events[i]["ts"] <= t:
            e = events[i]
            while stack and stack[-1][1] < e["ts"]:
                stack.pop()
            stack.append((e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        found.append((stack[-1][1] - stack[-1][0], stack[-1][2])
                     if stack else None)
    return found


def reduce(events: List[dict]) -> Dict:
    """{busy_s, window_s, op_device_s: {op: seconds under its spans},
    breakdown: {device_ops, idle_gaps}} of a Chrome trace's events."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = next(e for e in xs if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation")
    w0, w1 = win["ts"], win["ts"] + win["dur"]

    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and e["ts"] < w1 and e["ts"] + e.get("dur", 0) > w0]
    busy, merged = union_s([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                            for e in dev])

    launches = {e["args"]["correlation"]: (e["pid"], e["tid"], e["ts"])
                for e in xs if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    spans: Dict[tuple, List[tuple]] = collections.defaultdict(list)
    for e in xs:
        if e.get("cat") == "user_annotation" and e["name"].startswith(SPAN):
            spans[(e["pid"], e["tid"])].append(
                (e["ts"], e["ts"] + e["dur"], e["name"][len(SPAN):]))
    for v in spans.values():
        v.sort()
    starts = {k: [s[0] for s in v] for k, v in spans.items()}
    op_us: Dict[str, float] = collections.defaultdict(float)
    by_name: Dict[str, float] = collections.defaultdict(float)
    for e in dev:
        by_name[e["name"]] += e["dur"]
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None or (launch[0], launch[1]) not in spans:
            continue
        key = (launch[0], launch[1])
        i = bisect.bisect_right(starts[key], launch[2]) - 1
        if i >= 0 and spans[key][i][1] >= launch[2]:
            op_us[spans[key][i][2]] += e["dur"]

    gaps, prev = [], w0
    for a, b in merged + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    threads: Dict[tuple, List[dict]] = collections.defaultdict(list)
    for e in xs:
        if e.get("cat") in HOST_CATS and e["pid"] == win["pid"] \
                and e is not win and not e["name"].startswith("ProfilerStep"):
            threads[(e["pid"], e["tid"])].append(e)
    mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
    points = [m for m, _ in mids]
    per_thread = [_host_at(sorted(v, key=lambda e: (e["ts"], -e.get("dur", 0))),
                           points) for v in threads.values()]
    idle: Dict[str, float] = collections.defaultdict(float)
    for k, (_, length) in enumerate(mids):
        covering = [f[k] for f in per_thread if f[k] is not None]
        idle[min(covering)[1] if covering else "host outside any traced op"] \
            += length

    top = lambda d: [[_short(k), v * 1e-6] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"busy_s": busy * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "op_device_s": {k: v * 1e-6 for k, v in op_us.items()},
            "breakdown": {"device_ops": top(by_name), "idle_gaps": top(idle)}}
