"""A serving cell: the port's ``Scheduler`` on the real clock over its
``TorchSlotExecutor``.

The scheduler runs with ``clock=time.monotonic``, every slot of the
executor's bf16 cache in use, chunked prefill under the mix's budget with
the executor's chunk width the same, no speculation and no prefix
sharing. Requests come from the general generator: a backlog kept topped
up, or Poisson arrivals scheduled ahead of time, each due at its own
instant. Each request's tokens are stamped on the host clock as the
scheduler delivers them. Set-up warms the two shapes the traffic uses (a
chunk of the chunk width, a decode of every slot), then serves the mix so
that the window opens on the steady state: a backlog until the first
decode pass that serves at least ``open_fill_share`` of the slots, after
``setup_traffic_s`` and before ``setup_traffic_max_s`` at the most (a run
that reaches the ceiling opens its window all the same and says so);
Poisson arrivals for ``setup_traffic_s``. It then freezes what it made out
of Python's collector (``gc.freeze``, as a server does once it has
started), so that no full collection walks the weights' and the
scheduler's long-lived objects inside the window.

A traced run wraps the executor's ``step`` and ``prefill_chunk`` and the
scheduler's ``step`` in the benchmark's spans, reads the scheduler's
``StepLedger`` entry and decode rows each iteration, and profiles the last
``trace_slice_s`` seconds of the window. The decode work it counts is that
of the rows the scheduler hands the step (live requests, each at its
position), not of the idle slots the executor may decode beside them.
"""

from __future__ import annotations

import collections
import gc
import math
import time

import numpy as np
import torch

from . import arith, compare, reference
from .manifest import block_of
from .program import clock, free, peak_bytes, program_config, span, sync
from .trace import profile_slice, warm_profiler
from .traffic import RequestStream, arrival_offsets
from .weights import make_weights

#: the host's pause when the scheduler has nothing due
IDLE_S = 0.0005
#: arrivals are scheduled this far past the window's planned end
ARRIVAL_MARGIN_S = 5.0
#: the sample's stream of the seed
SAMPLE_STREAM = 0xC4EC


def _cpu_ticks() -> "list | None":
    """The machine's CPU ticks by kind (``/proc/stat``'s first line: user,
    nice, system, idle, iowait, irq, softirq, steal, ...), where it can be
    read."""
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        return None


def host_load(start: tuple, end: tuple) -> dict:
    """What the host did over a window from two ``(wall, process CPU,
    ticks)`` readings: the process's CPU seconds, and the machine's busy
    and stolen shares of its CPU time (a hypervisor's other guests)."""
    out = {"window_s": end[0] - start[0], "process_cpu_s": end[1] - start[1]}
    if start[2] and end[2]:
        d = [b - a for a, b in zip(start[2], end[2])]
        total = sum(d[:8]) or 1
        out["machine_busy_share"] = 1.0 - (d[3] + d[4]) / total
        out["machine_steal_share"] = d[7] / total if len(d) > 7 else None
    return out


class TokenTimes:
    """A request's stream: the host clock at each delivered token."""

    def __init__(self) -> None:
        self.times: list = []

    def __call__(self, event: str, value: object) -> None:
        if event == "token":
            self.times.append(clock())


def nearest_rank(values: list, q: float) -> float:
    """The q-quantile by nearest rank: the smallest value with at least a
    share q of the values at or below it."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered) - 1e-9) - 1)]


def sample_finished(finished: list, count: int, seed: int) -> list:
    """*count* finished requests drawn from the seed, the longest (prompt
    and served tokens) among them."""
    if not finished:
        return []
    ordered = sorted(finished, key=lambda r: int(r.rid[1:]))
    longest = max(ordered, key=lambda r: r.prompt_len + len(r.tokens))
    rest = [r for r in ordered if r is not longest]
    rng = np.random.default_rng([seed % (1 << 64), SAMPLE_STREAM])
    pick = rng.permutation(len(rest))[:max(0, count - 1)]
    return [longest] + [rest[i] for i in sorted(pick)]


class _Recorder:
    """The traced run's spans around the executor's calls, and what the
    per-layer readers take from them."""

    def __init__(self, ex) -> None:
        self.calls: list = []
        self.in_slice = False
        step, chunk = ex.step, ex.prefill_chunk

        def traced_step(active: list) -> dict:
            rows = [int(ex.pos[s]) for s, _ in active]
            t = clock()
            with span("bench.executor.step"):
                out = step(active)
            self.calls.append(("step", t, clock(), rows, self.in_slice))
            return out

        def traced_chunk(req, slot: int, offset: int, n: int):
            t = clock()
            with span("bench.executor.prefill_chunk"):
                out = chunk(req, slot, offset, n)
            self.calls.append(("chunk", t, clock(),
                               (offset, n, out is not None), self.in_slice))
            return out

        ex.step, ex.prefill_chunk = traced_step, traced_chunk


def _work(calls: list, lo: float, hi: float) -> dict:
    """The useful work of the executor calls inside [lo, hi]."""
    w = dict.fromkeys(("prefill_tokens", "prefill_pairs", "first_tokens",
                       "decode_tokens", "decode_pairs"), 0)
    for kind, start, end, info, _ in calls:
        if start < lo or end > hi:
            continue
        if kind == "step":
            w["decode_tokens"] += len(info)
            w["decode_pairs"] += sum(p + 1 for p in info)
        else:
            offset, n, first = info
            w["prefill_tokens"] += n
            w["prefill_pairs"] += arith.causal_pairs(n, offset)
            w["first_tokens"] += int(first)
    return w


def run(config: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device: torch.device, t_start: float,
        limits: dict) -> dict:
    from dpu_operator_tpu_torch.workloads.serve import (
        Request, Scheduler, ServeConfig, TorchSlotExecutor)
    blk, m = block_of(config), config["model"]
    slots, chunk = traffic["slots"], traffic["chunk_tokens"]
    block = traffic["kv_block_size"]
    ex = TorchSlotExecutor(make_weights(config, seed, device),
                           program_config(config), slots,
                           chunk_tokens=chunk, device=device)
    sched = Scheduler(
        ServeConfig(slots=slots,
                    kv_blocks=slots * blk.positions(m) // block,
                    kv_block_size=block, queue_limit=1 << 30,
                    prefill_chunk_tokens=traffic["prefill_budget"]),
        executor=ex, clock=clock)
    warm = Request(rid="warm-up", prompt_len=chunk, output_len=1,
                   prompt=(0,) * chunk)
    ex.prefill_chunk(warm, 0, 0, chunk)
    ex.step([])
    sync(device)
    if trace:
        warm_profiler()
    recorder = _Recorder(ex) if trace else None
    iterations: list = []

    stream = RequestStream(traffic, blk.vocab(m), seed)
    made: list = []

    def make(arrival: float):
        rid, ids, out_len = stream.next()
        tokens = TokenTimes()
        req = Request(rid=rid, prompt_len=len(ids), output_len=out_len,
                      slo_class=traffic["slo_class"], arrival_s=arrival,
                      prompt=ids, stream=tokens)
        made.append((req, tokens))
        return req

    arrivals = traffic["arrivals"]
    backlog: collections.deque = collections.deque()
    if arrivals["kind"] == "poisson":
        offsets = arrival_offsets(traffic, seed, traffic["setup_traffic_s"]
                                  + seconds + ARRIVAL_MARGIN_S)
        pending = [make(0.0) for _ in offsets]
        t_traffic = clock()
        for req, off in zip(pending, offsets):
            req.arrival_s = t_traffic + off
            sched.submit(req)
    else:
        t_traffic = clock()

    def iterate() -> None:
        if arrivals["kind"] == "backlog":
            while backlog and backlog[0].admitted_s is not None:
                backlog.popleft()
            while len(backlog) < arrivals["depth"]:
                req = make(clock())
                sched.submit(req)
                backlog.append(req)
        seen = len(sched.trace)
        t = clock()
        with span("bench.scheduler.step", trace):
            did = sched.step()
        if not did:
            time.sleep(IDLE_S)
            return
        if recorder is not None:
            rows = sum(e[2] for e in sched.trace[seen:] if e[0] == "decode")
            iterations.append((t, clock(), rows,
                               sched.ledger.entries(last=1)[0]))

    def fill() -> dict:
        """The rows the last decode pass served, and the share of the
        cache's blocks in use."""
        rows = next((e[2] for e in reversed(sched.trace) if e[0] == "decode"),
                    0)
        return {"decode_rows": rows, "cache_blocks": sched.pool.occupancy()}

    # set-up's traffic: a backlog until the first decode pass that serves
    # the share of the slots, not before the floor and not past the
    # ceiling; Poisson arrivals for the floor
    floor_s = traffic["setup_traffic_s"]
    if arrivals["kind"] == "backlog":
        need = math.ceil(traffic["open_fill_share"] * slots)
        ceiling_s = traffic["setup_traffic_max_s"]
    else:
        need, ceiling_s = 0, floor_s
    while True:
        seen = len(sched.trace)
        iterate()
        served_s = clock() - t_traffic
        full = sum(e[2] for e in sched.trace[seen:]
                   if e[0] == "decode") >= need
        if served_s >= ceiling_s or served_s >= floor_s and full:
            break
    # what set-up made lives to the end: a full collection never walks it
    gc.collect()
    gc.freeze()
    fill_open = fill()
    load_open = (clock(), time.process_time(), _cpu_ticks())
    t0 = clock()
    setup_s = t0 - t_start
    host_end = t0 + seconds - (traffic["trace_slice_s"] if trace else 0.0)
    while clock() < host_end:
        iterate()
    t_host = clock()
    traced = None
    if trace:
        def run_slice() -> None:
            recorder.in_slice = True
            end = clock() + traffic["trace_slice_s"]
            while clock() < end:
                iterate()
            recorder.in_slice = False
        traced = profile_slice(run_slice)
    sync(device)
    t1 = clock()
    memory_peak = peak_bytes(device)
    fills = {"at_open": fill_open, "at_close": fill(),
             "setup_traffic_s": served_s, "at_ceiling": not full}
    load = host_load(load_open, (clock(), time.process_time(), _cpu_ticks()))

    in_window = [(r, tt) for r, tt in made if t0 <= r.arrival_s <= t1]
    lost = {r.rid for r in sched.rejected} | {r.rid for r in sched.failed}
    failed = sum(1 for r, _ in in_window if r.rid in lost)
    delivered = sum(sum(1 for t in tt.times if t0 <= t <= t1)
                    for _, tt in made)
    ttft = [((tt.times[0] if tt.times and tt.times[0] <= t1 else t1)
             - r.arrival_s) for r, tt in in_window]
    itl = [b - a for _, tt in made for a, b in zip(tt.times, tt.times[1:])
           if t0 <= b <= t1]
    e2e = {"serve_tokens_per_s": delivered / (t1 - t0)}
    for q in (0.5, 0.95):
        if ttft:
            e2e[f"ttft_p{round(q * 100)}_ms"] = nearest_rank(ttft, q) * 1e3
        if itl:
            e2e[f"itl_p{round(q * 100)}_ms"] = nearest_rank(itl, q) * 1e3
    finished = [r for r in sched.completed
                if r.finish_s is not None and t0 <= r.finish_s <= t1]
    chunks: dict = {}
    for e in sched.trace:
        if e[0] == "chunk":
            chunks.setdefault(e[2], []).append((e[3], e[4]))
    sample = [(list(r.prompt), list(r.tokens), chunks[r.rid])
              for r in sample_finished(finished, traffic["check_requests"],
                                       seed)]

    def waiting_at(t: float) -> int:
        """Requests due by *t* without a first token by then."""
        return sum(1 for r, tt in made if r.arrival_s <= t and not (
            tt.times and tt.times[0] <= t))
    queue = {"at_open": waiting_at(t0), "at_close": waiting_at(t1)}

    layer_run = {"model": m, "traffic": traffic, "block": blk}
    if trace:
        host_reqs = [(r, tt) for r, tt in made
                     if t0 <= r.arrival_s <= t_host]
        layer_run["host"] = {
            "seconds": t_host - t0, "slots": slots,
            "ttft_s": [(tt.times[0] if tt.times and tt.times[0] <= t_host
                        else t_host) - r.arrival_s for r, tt in host_reqs],
            "itl_s": [b - a for _, tt in made
                      for a, b in zip(tt.times, tt.times[1:])
                      if t0 <= b <= t_host],
            "iterations": [(rows, entry) for a, b, rows, entry in iterations
                           if a >= t0 and b <= t_host],
            "queue_waits_s": [
                (r.admitted_s if r.admitted_s is not None
                 and r.admitted_s <= t_host else t_host) - r.arrival_s
                for r, _ in host_reqs],
            "work": _work(recorder.calls, t0, t_host)}
        layer_run["slice"] = {
            "kernels": traced["kernels"], "busy_s": traced["busy_s"],
            "window_s": traced["window_s"],
            "decode_positions": [c[3] for c in recorder.calls
                                 if c[0] == "step" and c[4]]}

    del ex, sched, recorder, made, in_window, finished, backlog
    gc.collect()
    free(device)
    t_ref = time.monotonic()
    params32 = reference.fp32_tree(make_weights(config, seed, device))
    gaps: list = []
    for prompt, served, chunked in sample:
        ids = prompt + served[:-1]
        logits = reference.sequence_logits(
            params32, ids, config, device, groups=reference.served_groups(
                len(prompt), len(ids), chunked, chunk))
        gaps += compare.served_gaps(logits, len(prompt), served)
    numbers = compare.serve_numbers(gaps)
    return {
        "setup_s": setup_s, "e2e": e2e,
        "attempted": len(ttft), "failed": failed,
        "numbers": numbers, "correct": compare.judge(numbers, limits),
        "memory_peak_bytes": memory_peak, "trace": traced,
        "reference_s": time.monotonic() - t_ref,
        "sample": {"requests": len(sample),
                   "served_tokens": len(gaps)},
        "sequences": sample, "queue": queue, "fill": fills,
        "host_load": load,
        "layer_run": layer_run,
    }
