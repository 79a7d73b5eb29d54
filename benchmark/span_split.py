"""Where a serving cell's idle card time goes, by the program's own spans.

    python3 benchmark/span_split.py --workload <cell> --seed <n> \
        --seconds 51 --out <file>

One traced run of the cell, as ``run.py --trace 1`` makes it, whose
profiled slice is reduced twice: as the benchmark reduces it
(``harness/trace.py``: each idle gap put, by its middle, under the
innermost ``bench.*`` span), and split by the program's ranges
(``serve.*``, ``kv_pool.*``, ``executor.*``, ``model.*``): each gap's
whole length divided among the innermost program ranges that cover it.
It writes, as JSON: that split under each benchmark label; the share of
the idle time under ``bench.scheduler.step`` alone that lies inside a
program range below ``serve.step``; the cell's per-layer metrics and the
share of ``pool_write_ms.serve`` that ``pool_gauge_ms.serve`` is; the MoE
expert fill the window's decode passes and chunks give from the shapes,
beside the reader's; and the mean iteration of the ledger with the
profiler off (the window before the slice) and on (the slice). The
benchmark's own runs do not run any of this.
"""

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
# the kernel builds where run.py keeps them
os.environ["TORCH_EXTENSIONS_DIR"] = str(BENCH.parent / "build"
                                         / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BENCH.parent / "build" / "triton")
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import torch  # noqa: E402
from torch.profiler import (ProfilerActivity, profile,  # noqa: E402
                            record_function)

from harness import cli, manifest, serve_cell, trace  # noqa: E402
from harness.program import clock  # noqa: E402

#: name prefixes of the program's ranges
PROGRAM = ("serve.", "kv_pool.", "executor.", "model.")
#: the benchmark's span that holds the scheduler's own work
SCHEDULER_STEP = "bench.scheduler.step"


def _innermost(stack: list) -> str:
    return stack[-1][1] if stack else ""


def split_idle(events: list) -> dict:
    """``{bench label: {program label: idle seconds}}`` over the slice of
    a Chrome trace: each idle gap of the card under the benchmark's label
    at its middle (the innermost ``bench.*`` span and ``cpu_op``, as
    ``harness/trace.py`` labels it), its length split among the innermost
    program ranges that cover it ("" where none does)."""
    reduced = trace.reduce_trace(events)
    slice_ev = next(e for e in events if e.get("name") == "bench.slice"
                    and e.get("cat") == "user_annotation")
    lo = float(slice_ev["ts"])
    hi = lo + float(slice_ev["dur"])
    tid = slice_ev.get("tid")
    device, bench, ops, ranges = [], [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start = float(e["ts"])
        end = start + float(e["dur"])
        name = e.get("name", "")
        if e.get("cat") in trace.DEVICE_CATS:
            if min(end, hi) > max(start, lo):
                device.append((max(start, lo), min(end, hi)))
        elif e.get("tid") != tid:
            continue
        elif e.get("cat") == "cpu_op":
            ops.append((start, end, name))
        elif e.get("cat") == "user_annotation":
            if name.startswith("bench.") and name != "bench.slice":
                bench.append((start, end, name))
            elif name.startswith(PROGRAM):
                ranges.append((start, end, name))
    merged = trace._union(device)
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    bench_at, op_at = trace._Cover(bench), trace._Cover(ops)
    # the program's ranges nest on the thread: a sweep over their edges
    # gives the innermost at every instant
    points = sorted([(s, 1, -(e - s), i) for i, (s, e, _) in
                     enumerate(ranges)]
                    + [(e, 0, 0.0, i) for i, (s, e, _) in
                       enumerate(ranges)])
    out: dict = {}
    gi = 0
    stack: list = []
    t_prev = lo
    cuts = [p[0] for p in points] + [hi]
    pi = 0
    for t in cuts:
        # the stretch [t_prev, t) under the current innermost range
        while gi < len(gaps) and gaps[gi][1] <= t_prev:
            gi += 1
        gj = gi
        while gj < len(gaps) and gaps[gj][0] < t:
            a, b = max(gaps[gj][0], t_prev), min(gaps[gj][1], t)
            if b > a:
                mid = (gaps[gj][0] + gaps[gj][1]) / 2
                label = " / ".join(x for x in (bench_at.at(mid),
                                               op_at.at(mid)) if x) \
                    or "outside every span"
                inner = _innermost(stack)
                row = out.setdefault(label, {})
                row[inner] = row.get(inner, 0.0) + (b - a) / 1e6
            gj += 1
        t_prev = max(t_prev, t)
        while pi < len(points) and points[pi][0] <= t:
            _, opening, _, i = points[pi]
            if opening:
                stack.append((i, ranges[i][2]))
            else:
                stack = [x for x in stack if x[0] != i]
            pi += 1
    return {"reduced": reduced, "split": out}


def scheduler_share(split: dict) -> dict:
    """The idle seconds whose benchmark label is ``bench.scheduler.step``
    alone (with or without a ``cpu_op``), by innermost program range, and
    the share of them inside a range below ``serve.step``."""
    by_range: dict = {}
    for label, row in split.items():
        if label.split(" / ")[0] != SCHEDULER_STEP:
            continue
        for name, seconds in row.items():
            by_range[name] = by_range.get(name, 0.0) + seconds
    total = sum(by_range.values())
    below = sum(s for n, s in by_range.items()
                if n and n != "serve.step")
    return {"idle_s": total, "below_serve_step_s": below,
            "share": below / total if total else None,
            "by_range": dict(sorted(by_range.items(),
                                    key=lambda kv: -kv[1]))}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--out", required=True)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("span_split: no CUDA card", file=sys.stderr)
        return 2
    from dpu_operator_tpu_torch.workloads import serve
    device = torch.device("cuda", 0)
    device_name = torch.cuda.get_device_name(device)
    mf = manifest.load_manifest()
    cell = manifest.find_cell(mf, args.workload)
    config = manifest.load_config(mf, cell["config"])
    traffic = manifest.load_traffic(cell["traffic"])
    limits = manifest.load_limits(args.workload)

    held: dict = {}
    init = serve.Scheduler.__init__

    def capture(self, *a, **k):
        init(self, *a, **k)
        held["trace"], held["ledger"] = self.trace, self.ledger

    serve.Scheduler.__init__ = capture
    reduce_slice = serve_cell.profile_slice

    def keep_events(run_slice):
        torch.cuda.synchronize()
        held["slice_start"] = clock()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("bench.slice"):
                run_slice()
                torch.cuda.synchronize()
        held["slice_end"] = clock()
        fd, name = tempfile.mkstemp(prefix="span_split_", suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(name)
            events = json.loads(Path(name).read_text())["traceEvents"]
        finally:
            Path(name).unlink(missing_ok=True)
        held["split"] = split_idle(events)
        return held["split"]["reduced"]

    serve_cell.profile_slice = keep_events
    try:
        out = serve_cell.run(config, traffic, args.seed, args.seconds, True,
                             device, time.monotonic(), limits)
    finally:
        serve_cell.profile_slice = reduce_slice
        serve.Scheduler.__init__ = init
    layer = cli.layer_metrics(mf, args.workload, out["layer_run"],
                              device_name)
    host = out["layer_run"]["host"]
    window = {e["iteration"] for _, e in host["iterations"]}
    counts = dict.fromkeys(("decode", "decode_tokens", "chunk",
                            "chunk_tokens"), 0)
    for t in held["trace"]:
        if t[0] in ("decode", "chunk") and t[1] in window:
            counts[t[0]] += 1
            # ("decode", it, rows) and ("chunk", it, rid, offset, n)
            counts[t[0] + "_tokens"] += t[-1]
    entries = held["ledger"].entries()
    on = [e["total_s"] for e in entries
          if held["slice_start"] <= e["now_s"] <= held["slice_end"]]
    off = [e["total_s"] for e in entries
           if e["now_s"] < held["slice_start"]]
    value = {k: v["value"] for k, v in layer.items()}
    gauge, write = value.get("pool_gauge_ms.serve"), \
        value.get("pool_write_ms.serve")
    result = {
        "card": cli.power_line(), "workload": args.workload,
        "seed": args.seed, "correct": out["correct"],
        "e2e": out["e2e"], "setup_s": out["setup_s"],
        "per_layer": value,
        "pool_gauge_share_of_pool_write": (gauge / write if gauge and write
                                           else None),
        "window_counts": counts,
        "moe_expert_fill_from_shapes": manifest.block_of(config)
        .expected_moe_fill(config["model"], traffic, counts),
        "iteration_ms": {
            "profiler_off": (1e3 * sum(off) / len(off)) if off else None,
            "profiler_on": (1e3 * sum(on) / len(on)) if on else None,
            "off_n": len(off), "on_n": len(on)},
        "slice": {"busy_s": out["trace"]["busy_s"],
                  "window_s": out["trace"]["window_s"]},
        "breakdown": out["trace"]["breakdown"],
        "scheduler_step": scheduler_share(held["split"]["split"]),
        "split": held["split"]["split"],
        "forbidden_modules": cli.forbidden_loaded(),
    }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    brief = {k: result[k] for k in (
        "workload", "seed", "correct", "e2e", "per_layer",
        "pool_gauge_share_of_pool_write", "window_counts",
        "moe_expert_fill_from_shapes", "iteration_ms", "slice")}
    brief["scheduler_step"] = dict(result["scheduler_step"],
                                   by_range=dict(list(result[
                                       "scheduler_step"]["by_range"]
                                       .items())[:8]))
    print(json.dumps(brief), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
