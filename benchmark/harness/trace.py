"""A traced slice: ``torch.profiler`` over a short steady part of the
window, reduced to the device's busy time, kernel time by name and the
idle gaps by what the host was doing.

The trace is written as a Chrome trace into the run's ``TMPDIR``, read
back and deleted. Device intervals are the kernels, copies and memsets;
host events are the ``cpu_op`` events and the benchmark's own spans
(``record_function`` ranges named ``bench.*``), on the clock that the
profiler aligns the device's to.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from pathlib import Path
from typing import Callable

import torch

#: Chrome-trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: entries of each breakdown list
TOP = 10
#: host events looked at before a gap's midpoint when finding the
#: innermost one that covers it
LOOK_BACK = 256


def warm_profiler() -> None:
    """Start and stop the profiler once around a trivial kernel, in
    set-up: its first start initialises the device tracing and takes
    seconds, which the window's slice must not hold."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def profile_slice(run_slice: Callable[[], None]) -> dict:
    """Run *run_slice* under the profiler (the device drained before and
    after it) and reduce its trace (:func:`reduce_trace`). The slice is
    the ``bench.slice`` span's own length: starting and stopping the
    profiler fall outside it."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("bench.slice"):
            run_slice()
            torch.cuda.synchronize()
    fd, name = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
    os.close(fd)
    path = Path(name)
    try:
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    finally:
        path.unlink(missing_ok=True)
    return reduce_trace(events)


def short_name(name: str) -> str:
    """A kernel's name without ``void``, its argument list and the
    anonymous namespace."""
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.replace("(anonymous namespace)::", "")


def _union(intervals: list) -> list:
    merged: list = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


class _Cover:
    """The innermost host event of a list that covers an instant."""

    def __init__(self, events: list) -> None:
        self.events = sorted(events)
        self.starts = [e[0] for e in self.events]

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t)
        for j in range(i - 1, max(-1, i - 1 - LOOK_BACK), -1):
            start, end, name = self.events[j]
            if end >= t:
                return name
        return ""


def reduce_trace(events: list) -> dict:
    """``busy_s`` (the union of device intervals inside the slice),
    ``window_s`` (the slice's length), ``kernels`` ({short name:
    seconds}) and ``breakdown`` (the top device operations and the idle
    gaps summed by the host's innermost ``bench.*`` span and ``cpu_op``
    at the gap's middle)."""
    slice_ev = [e for e in events if e.get("name") == "bench.slice"
                and e.get("cat") == "user_annotation"]
    if not slice_ev:
        raise RuntimeError("the trace holds no bench.slice span")
    lo = float(slice_ev[0]["ts"])
    hi = lo + float(slice_ev[0]["dur"])
    tid = slice_ev[0].get("tid")
    device, kernels = [], {}
    spans, ops = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start = float(e["ts"])
        end = start + float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            start, end = max(start, lo), min(end, hi)
            if end <= start:
                continue
            device.append((start, end))
            key = short_name(e.get("name", "?"))
            kernels[key] = kernels.get(key, 0.0) + (end - start) / 1e6
        elif e.get("tid") == tid and cat == "user_annotation" \
                and e.get("name", "").startswith("bench.") \
                and e.get("name") != "bench.slice":
            spans.append((start, end, e["name"]))
        elif e.get("tid") == tid and cat == "cpu_op":
            ops.append((start, end, e.get("name", "?")))
    merged = _union(device)
    busy = sum(end - start for start, end in merged) / 1e6
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    span_at, op_at = _Cover(spans), _Cover(ops)
    idle: dict = {}
    for start, end in zip(edges[::2], edges[1::2]):
        if end <= start:
            continue
        mid = (start + end) / 2
        label = " / ".join(x for x in (span_at.at(mid), op_at.at(mid))
                           if x) or "outside every span"
        idle[label] = idle.get(label, 0.0) + (end - start) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy, "window_s": (hi - lo) / 1e6,
            "kernels": kernels,
            "breakdown": {"device_ops": [[k, v] for k, v in top],
                          "idle_gaps": [[k, v] for k, v in gaps]}}
