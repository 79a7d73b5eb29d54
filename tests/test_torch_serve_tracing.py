"""The serving loop's instrumentation in the PyTorch/CUDA port, on the CPU.

The scheduler, the KV pool, the slot executor and the model open
``torch.profiler`` ranges (``serve.*``, ``kv_pool.gauges``,
``executor.wait``, ``model.*``) only while the profiler records, and the
``StepLedger`` entry's ``detail`` carries the counters its readers use:
the pool's gauge upkeep, the decode pass's transfers and the MoE layers'
real tokens beside their expert rows.

Injected clocks, seeded weights and tiny shapes only.
"""

import contextlib
import json
import time
import types

import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from dpu_operator_tpu_torch.utils import tracing
from dpu_operator_tpu_torch.workloads import kv_pool
from dpu_operator_tpu_torch.workloads import serve as tserve
from dpu_operator_tpu_torch.workloads.model import (TransformerConfig,
                                                    init_params)
from dpu_operator_tpu_torch.workloads.moe import moe_capacity

#: a tiny MoE model: layers 1 and 3 route over 4 experts
MOE = TransformerConfig(vocab=64, d_model=16, n_heads=2, n_layers=4, d_ff=32,
                        max_seq=64, dtype=torch.float32, moe_experts=4)
DENSE = TransformerConfig(vocab=64, d_model=16, n_heads=2, n_layers=2,
                          d_ff=32, max_seq=64, dtype=torch.float32)
SLOTS = 3
CHUNK = 8
DETAIL = {"pool_gauge_s", "decode_wait_s", "moe_routed_tokens",
          "moe_expert_rows"}
SERVE_SPANS = ("serve.admit", "serve.prefill", "serve.select",
               "serve.decode", "serve.commit", "serve.finish",
               "serve.gauges")
MODEL_SPANS = ("model.embed", "model.cache_write", "model.attention",
               "model.mlp", "model.moe", "model.logits")


class _TickingClock:
    """A clock injected: every read moves it by 1/64 s (exact in binary
    and at the ledger's 6 places)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1 / 64
        return self.t


def _config(**kw):
    base = dict(slots=SLOTS, kv_blocks=24, kv_block_size=8,
                queue_limit=256)
    base.update(kw)
    return tserve.ServeConfig(**base)


def _requests(n, prompt_len=11, output_len=4):
    return [tserve.Request(rid=f"tr{i}", prompt_len=prompt_len,
                           output_len=output_len, arrival_s=0.0,
                           prompt=tuple((7 * i + j) % MOE.vocab
                                        for j in range(prompt_len)))
            for i in range(n)]


@pytest.fixture(scope="module")
def moe_params():
    return init_params(3, MOE, device="cpu")


def _executor(params, cfg=MOE, **kw):
    return tserve.TorchSlotExecutor(params, cfg, slots=SLOTS,
                                    chunk_tokens=CHUNK, device="cpu", **kw)


def test_detail_lies_inside_its_phase_on_a_real_clock(moe_params):
    """Under the real clock, with an executor whose card stalls on every
    transfer of a decode pass, ``decode_wait_s`` holds the stalls and lies
    inside the decode phase, and the pool's upkeep inside the iteration;
    the simulated executor keeps no executor counters."""
    stall = 0.02

    class StallingExecutor(tserve.TorchSlotExecutor):
        @contextlib.contextmanager
        def _waiting(self, decode=False):
            with super()._waiting(decode):
                if decode:
                    time.sleep(stall)
                yield

    sched = tserve.Scheduler(_config(prefill_chunk_tokens=CHUNK),
                             _executor_of(StallingExecutor, moe_params),
                             clock=time.perf_counter)
    for req in _requests(3, prompt_len=11, output_len=3):
        sched.submit(req)
    while sched.step():
        pass
    assert len(sched.completed) == 3
    entries = sched.ledger.entries()
    decoded = [e for e in entries if e["phases"]["decode"] > 0]
    assert decoded
    for e in entries:
        d = e["detail"]
        assert set(d) == DETAIL
        assert 0.0 <= d["pool_gauge_s"] <= e["total_s"] + 1e-6
        assert d["decode_wait_s"] <= e["phases"]["decode"] + 1e-6
    for e in decoded:
        # a stall inside each of the pass's two transfers
        assert e["detail"]["decode_wait_s"] >= 2 * stall - 1e-6
    assert sched.ledger.reconcile()["ok"]

    sim = tserve.Scheduler(_config(prefill_chunk_tokens=16),
                           clock=_TickingClock())
    for req in _requests(2):
        sim.submit(req)
    while sim.step():
        pass
    assert {k for e in sim.ledger.entries() for k in e["detail"]} \
        == {"pool_gauge_s"}


def _executor_of(cls, params):
    return cls(params, MOE, slots=SLOTS, chunk_tokens=CHUNK, device="cpu")


def test_pool_gauge_s_times_every_gauge_update(monkeypatch):
    """Each of the pool's gauge updates adds its own seconds to
    ``pool_gauge_s``, in whichever segment of the iteration it fell: on a
    pool clock that moves 1 s a read, an iteration's ``pool_gauge_s`` is
    its count of updates."""
    ticks = [0.0]

    def perf_counter():
        ticks[0] += 1.0
        return ticks[0]

    monkeypatch.setattr(kv_pool, "time",
                        types.SimpleNamespace(perf_counter=perf_counter))
    sched = tserve.Scheduler(_config(prefill_chunk_tokens=16))
    pool = sched.pool
    original = pool._update_gauges_locked
    calls = []

    def counted():
        calls.append(1)
        original()

    pool._update_gauges_locked = counted
    start = pool.gauge_s
    for req in _requests(5):
        sched.submit(req)
    per_step = []
    while True:
        before = len(calls)
        if not sched.step():
            break
        per_step.append(len(calls) - before)
    details = [e["detail"] for e in sched.ledger.entries()]
    assert [d["pool_gauge_s"] for d in details] == per_step
    assert sum(per_step) > len(details)
    assert pool.gauge_s - start == len(calls)


def test_moe_counts_are_real_tokens_over_the_shapes(moe_params):
    """One chunk, one decode and one verify call of the tiny MoE model:
    the routed tokens are the real ones (the chunk's valid tokens, the
    active slots, each active row's committed token and drafts) and the
    expert rows E * b * capacity, per MoE layer (two of the four); a dense
    model counts none."""
    ex = _executor(moe_params, spec_k=2)
    req = _requests(1, prompt_len=6)[0]
    layers = sum(MOE.is_moe_layer(i) for i in range(MOE.n_layers))
    assert layers == 2
    e = MOE.moe_experts

    def counted(call, executor=ex):
        before = executor.counters()
        call()
        after = executor.counters()
        return (after["moe_routed_tokens"] - before["moe_routed_tokens"],
                after["moe_expert_rows"] - before["moe_expert_rows"])

    # a chunk of 6 valid tokens routes its padded width: b 1, s CHUNK
    cap = moe_capacity(CHUNK, e, MOE.moe_capacity_factor)
    assert counted(lambda: ex.prefill_chunk(req, 0, 0, 6)) \
        == (layers * 6, layers * e * cap)
    # decode routes every slot alone, one of them active: capacity 8
    assert moe_capacity(1, e, MOE.moe_capacity_factor) == 8
    assert counted(lambda: ex.step([(0, req)])) \
        == (layers * 1, layers * e * SLOTS * 8)
    # verify at width 3: the active row holds its token and two drafts
    cap = moe_capacity(3, e, MOE.moe_capacity_factor)
    assert counted(lambda: ex.spec_step([(0, req)], {0: [1, 2]})) \
        == (layers * 3, layers * e * SLOTS * cap)
    dense = _executor(init_params(5, DENSE, device="cpu"), cfg=DENSE)
    assert counted(lambda: dense.prefill_chunk(req, 0, 0, 6), dense) \
        == (0, 0)


def test_decode_waits_time_the_decode_transfers(moe_params, tmp_path):
    """Every transfer is an ``executor.wait`` range: a chunk's input copy,
    and its read when it completes the prompt; a decode pass's copies and
    its read. Only the decode pass's add to ``decode_wait_s``."""
    ex = _executor(moe_params)
    req = _requests(1, prompt_len=CHUNK + 3)[0]

    def waits(call):
        before = ex.counters()["decode_wait_s"]
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            call()
        ranges = [e for e in _trace_events(prof, tmp_path)
                  if e["name"] == "executor.wait"]
        return len(ranges), ex.counters()["decode_wait_s"] - before

    assert waits(lambda: ex.prefill_chunk(req, 0, 0, CHUNK)) == (1, 0.0)
    assert waits(lambda: ex.prefill_chunk(req, 0, CHUNK, 3)) == (2, 0.0)
    n, seconds = waits(lambda: ex.step([(0, req)]))
    assert n == 2 and seconds > 0.0
    assert waits(lambda: ex.begin(_requests(2, prompt_len=5)[1], 1)) \
        == (2, 0.0)


def test_scheduler_ledger_counts_the_executor(moe_params):
    """Over the scheduler, each iteration's ``detail`` holds the change of
    the executor's counters: the decode transfers' seconds in the
    iterations that decoded, and the MoE counts of every forward."""
    ex = _executor(moe_params)
    sched = tserve.Scheduler(_config(prefill_chunk_tokens=CHUNK), ex)
    reqs = _requests(4, prompt_len=11, output_len=3)
    for req in reqs:
        sched.submit(req)
    sched.run()
    assert len(sched.completed) == len(reqs)
    details = [e["detail"] for e in sched.ledger.entries()]
    assert all(set(d) == DETAIL for d in details)
    decodes = [t for t in sched.trace if t[0] == "decode"]
    chunks = [t for t in sched.trace if t[0] == "chunk"]
    assert sum(d["decode_wait_s"] for d in details) > 0.0
    assert sum(d["decode_wait_s"] for d in details) == pytest.approx(
        ex.counters()["decode_wait_s"], abs=1e-6 * len(details))
    e = MOE.moe_experts
    cap_chunk = moe_capacity(CHUNK, e, MOE.moe_capacity_factor)
    assert sum(d["moe_routed_tokens"] for d in details) \
        == 2 * (sum(t[-1] for t in chunks) + sum(t[2] for t in decodes))
    assert sum(d["moe_expert_rows"] for d in details) \
        == 2 * e * (len(chunks) * cap_chunk + len(decodes) * SLOTS * 8)


def _trace_events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _inside(inner, outer):
    return (inner["tid"] == outer["tid"] and inner["ts"] >= outer["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_profiler_trace_holds_the_spans_nested_under_serve_step(
        moe_params, tmp_path):
    """Under a CPU ``torch.profiler`` run the exported trace holds every
    named span, each stretch of an iteration inside a ``serve.step``
    range, the pool's and the executor's inside one too, and the model's
    inside a prefill or decode stretch; ``tracing.span`` opens a range of
    its own name, and a speculating scheduler a ``serve.verify``."""
    sched = tserve.Scheduler(_config(prefill_chunk_tokens=CHUNK),
                             _executor(moe_params))
    spec = tserve.Scheduler(_config(spec_k=2),
                            tserve.PeriodicSimExecutor(2))
    for req in _requests(3, prompt_len=11, output_len=3):
        sched.submit(req)
    for req in _requests(3, prompt_len=9, output_len=6):
        spec.submit(req)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("ingress.generate"):
            pass
        sched.run()
        spec.run()
    events = _trace_events(prof, tmp_path)
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)
    for name in ("serve.step", "serve.verify", "kv_pool.gauges",
                 "executor.wait", "ingress.generate", *SERVE_SPANS,
                 *MODEL_SPANS):
        assert by_name.get(name), name
    steps = by_name["serve.step"]
    for name in (*SERVE_SPANS, "serve.verify", "kv_pool.gauges",
                 "executor.wait", *MODEL_SPANS):
        for e in by_name[name]:
            assert any(_inside(e, s) for s in steps), (name, e)
    forward = by_name["serve.prefill"] + by_name["serve.decode"]
    for name in MODEL_SPANS:
        for e in by_name[name]:
            assert any(_inside(e, s) for s in forward), (name, e)
    for e in by_name["executor.wait"]:
        assert any(_inside(e, s) for s in forward)
    for e in by_name["model.cache_write"]:
        assert any(_inside(e, s) for s in by_name["model.attention"])


def test_no_range_is_recorded_with_the_profiler_off(moe_params,
                                                    monkeypatch):
    """With no profiler running the program opens no ``record_function``
    range: the helper hands out its shared no-op context. Under the
    profiler the same run opens them (the probe works)."""
    opened = []
    real = autograd_profiler.record_function

    def probe(name, *args, **kwargs):
        opened.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(autograd_profiler, "record_function", probe)

    def serve_some():
        sched = tserve.Scheduler(_config(prefill_chunk_tokens=CHUNK),
                                 _executor(moe_params))
        for req in _requests(2, prompt_len=10, output_len=3):
            sched.submit(req)
        with tracing.span("ingress.generate"):
            sched.run()
        assert len(sched.completed) == 2

    assert not autograd_profiler._is_profiler_enabled
    serve_some()
    assert opened == []
    assert tracing.profiled("serve.step") is tracing.profiled("other")
    with profile(activities=[ProfilerActivity.CPU]):
        serve_some()
    assert {"serve.step", "kv_pool.gauges", "executor.wait",
            "model.attention", "ingress.generate"} <= set(opened)
