"""The serving shell of the PyTorch/CUDA port on the CPU: ``DecodeService``,
its streaming HTTP ingress and the ``/debug/serve*`` endpoints, against
the JAX package.

The twins of tests/test_serve.py's service tests, of the six of
tests/test_serve_trace.py and of the hostile bodies of
tests/test_fuzz_ingress.py (each one a case, sent to the port's and the
JAX ingress alike). Where a reference test reads an endpoint through
``tpuctl``, the twin fetches the endpoint's JSON payload from the port's
``MetricsServer`` and hands that payload to the same ``tpuctl`` renderer.
Last, the tiny fp32 model served through ``TorchSlotExecutor(device=
"cpu")`` behind ``start_http``: every streamed token equals ``generate``.

No test sleeps: a thread's progress is awaited on an event, a semaphore
or a join, each with its own timeout.
"""

import http.client
import itertools
import json
import random
import re
import socket
import threading
import time

import numpy as np
import pytest
import torch

from dpu_operator_tpu import tpuctl
from dpu_operator_tpu.utils import flight as jflight
from dpu_operator_tpu.utils import profiler as jprofiler
from dpu_operator_tpu.workloads import serve as jserve
from dpu_operator_tpu_torch.utils import flight as tflight
from dpu_operator_tpu_torch.utils import metrics as tmetrics
from dpu_operator_tpu_torch.utils import profiler as tprofiler
from dpu_operator_tpu_torch.utils import tracing as ttracing
from dpu_operator_tpu_torch.utils import watchdog as twatchdog
from dpu_operator_tpu_torch.utils.metrics import MetricsServer
from dpu_operator_tpu_torch.workloads import decode as tdecode
from dpu_operator_tpu_torch.workloads import model as tmodel
from dpu_operator_tpu_torch.workloads import serve as tserve
from test_fuzz_ingress import (NAN_BODY, SEED as FUZZ_SEED, _assert_virgin,
                               _post_raw, _wrong_typed_corpus)

#: (serve module, flight module) of each side
SIDES = {"jax": (jserve, jflight), "port": (tserve, tflight)}
#: how long any one wait of this file may take
WAIT_S = 15.0


@pytest.fixture(autouse=True)
def _no_sampler_left():
    """``DecodeService.start`` starts its package's process-global
    sampling profiler, which ``stop`` leaves running: stop and empty both
    packages' after each test, so no sampler outlives the test."""
    yield
    for prof in (tprofiler, jprofiler):
        prof.PROFILER.stop()
        prof.PROFILER.reset()


def _harness(serve, **kw):
    base = dict(slots=4, kv_blocks=64, kv_block_size=16, queue_limit=256)
    base.update(kw)
    return serve.ServeConfig(**base)


def _done_event(req):
    """Give *req* a stream that sets the returned event on its terminal
    record."""
    done = threading.Event()
    req.stream = lambda ev, val: done.set() if ev != "token" else None
    return done


def _read_ndjson_stream(port, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    try:
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(headers or {})
        conn.request("POST", "/v1/generate", json.dumps(body), hdrs)
        resp = conn.getresponse()
        assert resp.status == 200, resp.read()
        assert resp.getheader("Transfer-Encoding") == "chunked"
        raw = resp.read()
    finally:
        conn.close()
    return [json.loads(line) for line in raw.split(b"\n") if line.strip()]


def _raw_chunks(port, body: dict, headers=None) -> list:
    """POST over a bare socket and return the chunked body's chunks, each
    decoded as JSON: the chunk framing itself, which ``http.client``
    hides."""
    data = json.dumps(body).encode()
    head = ["POST /v1/generate HTTP/1.1", "Host: 127.0.0.1",
            "Content-Type: application/json",
            f"Content-Length: {len(data)}"]
    head += [f"{k}: {v}" for k, v in (headers or {}).items()]
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=WAIT_S) as sock:
        sock.sendall("\r\n".join(head).encode() + b"\r\n\r\n" + data)
        f = sock.makefile("rb")
        status = f.readline()
        assert b" 200 " in status, status
        while f.readline() not in (b"\r\n", b""):
            pass
        chunks = []
        while True:
            size = int(f.readline().strip(), 16)
            payload = f.read(size + 2)
            if size == 0:
                return chunks
            assert payload.endswith(b"\r\n")
            lines = payload[:-2].split(b"\n")
            assert len(lines) == 2 and lines[1] == b"", payload
            chunks.append(json.loads(lines[0]))


# -- /debug/serve and the service shell (tests/test_serve.py) -----------------


def test_debug_serve_endpoint_payload():
    """test_serve.py:611: ``/debug/serve`` over the port's MetricsServer
    answers the scheduler's snapshot, equal to the JAX scheduler's on the
    same run, and ``tpuctl``'s renderer reads it."""
    snaps = {}
    for name, (serve, _) in SIDES.items():
        sched = serve.Scheduler(_harness(serve))
        sched.submit(serve.Request(rid="web0", prompt_len=8, output_len=4,
                                   slo_class=serve.INTERACTIVE,
                                   arrival_s=0.0))
        sched.run()
        snaps[name] = json.loads(json.dumps(sched.snapshot()))
        if name == "port":
            service = tserve.DecodeService(sched)
            server = MetricsServer(host="127.0.0.1", port=0,
                                   debug_handlers=service.debug_handlers())
            server.start()
            try:
                snap = tflight.fetch(f"127.0.0.1:{server.port}",
                                     path="/debug/serve")
            finally:
                server.stop()
    assert snap == snaps["port"] == snaps["jax"]
    assert snap["completed"] == 1
    assert snap["kv"]["usedBlocks"] == 0
    assert snap["capacity"]["slots"] == 4
    view = tpuctl.render_serve(snap, [], now=0.0)
    assert view["reachable"] is True
    assert view["scheduler"]["completed"] == 1


def test_decode_service_drives_scheduler_and_registers_heartbeat():
    """test_serve.py:664."""
    sched = tserve.Scheduler(_harness(tserve))
    service = tserve.DecodeService(sched, idle_interval_s=0.01)
    service.start()
    try:
        assert any(h["name"] == "serve.scheduler"
                   for h in twatchdog.WATCHDOG.snapshot())
        req = tserve.Request(rid="svc0", prompt_len=4, output_len=4,
                             arrival_s=0.0)
        done = _done_event(req)
        sched.submit(req)
        assert done.wait(WAIT_S)
        assert sched.completed and sched.completed[0].rid == "svc0"
        assert sched.history_limit == 4096
    finally:
        service.stop()
    assert service._thread is None
    assert not any(h["name"] == "serve.scheduler"
                   for h in twatchdog.WATCHDOG.snapshot())


def test_streaming_ingress_one_token_per_chunk_and_trace_adoption():
    """test_serve.py:1181: a client POSTs with a W3C traceparent and reads
    a chunked response of one token object a chunk plus a terminal done
    record; the serve.request span lands in the client's trace and the
    wire TTFT is observed with that trace as its exemplar."""
    sched = tserve.Scheduler(_harness(tserve, slots=2, kv_blocks=32))
    service = tserve.DecodeService(sched, idle_interval_s=0.01)
    service.start()
    port = service.start_http()
    tflight.RECORDER.clear()
    trace_id = ttracing.new_trace_id()
    parent = f"00-{trace_id}-{ttracing.new_span_id()}-01"
    wire_before = tmetrics.SERVE_WIRE_TTFT_SECONDS.count
    try:
        chunks = _raw_chunks(port, {"rid": "wire0", "prompt_len": 8,
                                    "output_len": 5,
                                    "slo_class": "interactive"},
                             headers={"traceparent": parent})
    finally:
        service.stop()
    tokens = [c["token"] for c in chunks if "token" in c]
    assert len(tokens) == 5 and len(chunks) == 6
    assert chunks[-1] == {"done": True, "tokens": 5}
    assert sched.completed[0].rid == "wire0"
    assert sched.completed[0].tokens == tokens
    assert tmetrics.SERVE_WIRE_TTFT_SECONDS.count == wire_before + 1
    spans = [e for e in tflight.RECORDER.events(kind="span")
             if e["name"] == "serve.request"]
    assert spans and spans[0]["trace_id"] == trace_id
    phases = [e for e in tflight.RECORDER.events(kind="serve")
              if (e.get("attributes") or {}).get("rid") == "wire0"]
    assert phases and {e["trace_id"] for e in phases} == {trace_id}
    om = tmetrics.REGISTRY.render(openmetrics=True)
    assert f'trace_id="{trace_id}"' in "".join(
        line for line in om.splitlines()
        if line.startswith("tpu_serve_wire_ttft_seconds_bucket"))


def test_ingress_coerces_prompt_ids_or_400s():
    """test_serve.py:1299: a non-numeric prompt element 400s at the wire;
    numeric strings coerce."""
    sched = tserve.Scheduler(_harness(tserve))
    service = tserve.DecodeService(sched, idle_interval_s=0.01)
    service.start()
    port = service.start_http()
    try:
        assert _post_raw(port, json.dumps(
            {"output_len": 2, "prompt": ["a", "b"]}).encode()) == 400
        lines = _read_ndjson_stream(
            port, {"rid": "coerce", "output_len": 2, "prompt": ["3", "4"]})
    finally:
        service.stop()
    assert lines[-1] == {"done": True, "tokens": 2}
    assert sched.completed[0].prompt == (3, 4)


def test_client_disconnect_mid_stream_cancels_the_request():
    """test_serve.py:1448: a client that hangs up mid-stream gets its
    request cancelled: the next write fails and the ingress cancels, so
    the slot and blocks come back. The output is long enough (60 000
    tokens) that the request cannot finish first."""
    sched = tserve.Scheduler(_harness(tserve, kv_blocks=4000),
                             clock=time.monotonic)
    cancelled = threading.Event()
    cancel = sched.cancel

    def watched(rid):
        hit = cancel(rid)
        cancelled.set()
        return hit

    sched.cancel = watched
    service = tserve.DecodeService(sched, idle_interval_s=0.005)
    service.start()
    port = service.start_http()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=WAIT_S)
        conn.request("POST", "/v1/generate",
                     json.dumps({"rid": "dropper", "prompt_len": 8,
                                 "output_len": 60000}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.read(32)               # take a token or two...
        conn.close()                       # ...then hang up
        assert cancelled.wait(WAIT_S), "disconnect never cancelled"
    finally:
        service.stop()
    assert [(r.rid, r.reject_reason) for r in sched.rejected] \
        == [("dropper", "cancelled")]
    assert not sched.completed
    assert sched.pool.outstanding() == 0
    assert sched.capacity()["freeSlots"] == 4


def test_stream_timeout_cancels_the_request():
    """A stream that waits past ``stream_timeout_s`` for its next token
    writes a timeout record and cancels its request (here the service
    thread never runs, so no token ever comes)."""
    sched = tserve.Scheduler(_harness(tserve))
    service = tserve.DecodeService(sched, stream_timeout_s=0.2)
    port = service.start_http()
    try:
        lines = _read_ndjson_stream(
            port, {"rid": "slowpoke", "prompt_len": 4, "output_len": 2})
    finally:
        service.stop()
    assert lines == [{"error": "stream timeout"}]
    assert [(r.rid, r.reject_reason) for r in sched.rejected] \
        == [("slowpoke", "cancelled")]


def test_decode_service_thread_survives_a_step_exception():
    """test_serve.py:1541: a step that raises costs that step: the loop
    logs, counts the swallow and keeps serving."""
    class BrokenScheduler(tserve.Scheduler):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.blowups = 0

        def step(self):
            if self.blowups < 3:
                self.blowups += 1
                raise RuntimeError("batch-wide blowup")
            return super().step()

    before = tmetrics.SWALLOWED_ERRORS.value(site="serve.step")
    sched = BrokenScheduler(_harness(tserve))
    service = tserve.DecodeService(sched, idle_interval_s=0.001)
    service.start()
    try:
        req = tserve.Request(rid="ok", prompt_len=4, output_len=2,
                             arrival_s=0.0)
        done = _done_event(req)
        sched.submit(req)
        assert done.wait(WAIT_S)
        assert sched.completed and sched.completed[0].rid == "ok"
        assert tmetrics.SWALLOWED_ERRORS.value(site="serve.step") \
            == before + 3
        assert service._thread is not None and service._thread.is_alive()
    finally:
        service.stop()


def test_streaming_ingress_rejects_bad_and_rejected_requests():
    """test_serve.py:1575: malformed specs 400; a request the scheduler
    rejects streams one error record."""
    sched = tserve.Scheduler(_harness(tserve, slots=1, kv_blocks=2,
                                      kv_block_size=16))
    service = tserve.DecodeService(sched, idle_interval_s=0.01)
    service.start()
    port = service.start_http()
    try:
        for body in ({"prompt_len": 8}, [1, 2],
                     {"prompt_len": 3, "output_len": 2,
                      "prompt": [1, 2, 3, 4]}):
            assert _post_raw(port, json.dumps(body).encode()) == 400
        lines = _read_ndjson_stream(
            port, {"rid": "huge", "prompt_len": 500, "output_len": 5})
    finally:
        service.stop()
    assert lines == [{"error": "rejected: kv_too_large"}]


def _anomalous_trend(trend_mod, history_mod):
    """A fresh trend engine over a fresh history on a virtual clock, driven
    until a 20%/s chunk-backlog ramp fires its anomaly (the scenario of
    tests/test_history.py): the same engine state on either side."""
    now = [0.0]
    hist = history_mod.MetricsHistory(clock=lambda: now[0])
    value = [1000.0]
    series = "tpu_serve_prefill_chunk_backlog_tokens"
    hist.register_gauge(series, lambda: value[0])
    engine = trend_mod.TrendEngine(hist)
    engine.watch(series, -1)
    for _ in range(30):
        now[0] += 1.0
        value[0] *= 1.2
        hist.sample_once()
        if engine.evaluate_once():
            break
    assert engine.anomalies() == [series]
    return engine


def test_decode_service_headroom_folds_slo_and_fault_dimensions(monkeypatch):
    """test_serve.py:1847: only serve-* alerts join the digest; the fault
    gate's capacity is folded in (null and gauged 0 without one); the
    trend engine's anomalies are ``trendAnomalies`` (gauged as
    ``dimension="trend_anomalies"``); the whole digest, ``trendAnomalies``
    included, equals the JAX service's with each side's global trend
    engine driven through the same anomaly."""
    from dpu_operator_tpu.utils import history as jhistory
    from dpu_operator_tpu.utils import trend as jtrend
    from dpu_operator_tpu_torch.utils import history as thistory
    from dpu_operator_tpu_torch.utils import trend as ttrend

    class FakeEvaluator:
        def active_alerts(self):
            return [("cni-latency", "page"), ("serve-ttft", "page"),
                    ("serve-tokens", "ticket")]

    monkeypatch.setattr(jtrend, "TREND", _anomalous_trend(jtrend, jhistory))
    monkeypatch.setattr(ttrend, "TREND", _anomalous_trend(ttrend, thistory))
    digests = {}
    for name, (serve, _) in SIDES.items():
        sched = serve.Scheduler(_harness(serve),
                                headroom_clock=lambda: 99.0)
        service = serve.DecodeService(sched, evaluator=FakeEvaluator(),
                                      fault_capacity_fn=lambda: 7)
        digest = service.headroom()
        digests[name] = digest
        if name == "port":
            assert digest["trendAnomalies"] == [
                "tpu_serve_prefill_chunk_backlog_tokens"]
            assert tmetrics.SERVE_HEADROOM.value(
                dimension="trend_anomalies") == 1.0
            assert digest["sloAlerts"] == [
                {"slo": "serve-ttft", "severity": "page"},
                {"slo": "serve-tokens", "severity": "ticket"}]
            assert digest["faultGateCapacity"] == 7
            assert tmetrics.SERVE_HEADROOM.value(
                dimension="slo_alerts_firing") == 2.0
            assert tmetrics.SERVE_HEADROOM.value(
                dimension="fault_gate_capacity") == 7.0
            bare = tserve.DecodeService(sched, evaluator=FakeEvaluator())
            assert bare.headroom()["faultGateCapacity"] is None
            assert tmetrics.SERVE_HEADROOM.value(
                dimension="fault_gate_capacity") == 0.0
            # the ladder's second signal reads the same alerts
            assert sched.slo_alert_fn() is True
    assert digests["port"] == digests["jax"]


def test_ledger_headroom_and_index_served_over_debug_endpoints():
    """test_serve.py:1873: the ledger, the digest and the ``/debug``
    index over the port's MetricsServer; the ledger payload equals the
    JAX scheduler's ledger snapshot on the same run."""
    ledgers = {}
    for name, (serve, _) in SIDES.items():
        sched = serve.Scheduler(_harness(serve, prefill_chunk_tokens=16),
                                headroom_clock=lambda: 5.0)
        sched.submit(serve.Request(rid="dbg0", prompt_len=8, output_len=2,
                                   arrival_s=0.0))
        sched.run()
        ledgers[name] = json.loads(json.dumps(sched.ledger.snapshot()))
    service = tserve.DecodeService(sched)
    server = MetricsServer(host="127.0.0.1", port=0,
                           debug_handlers=service.debug_handlers())
    server.start()
    addr = f"127.0.0.1:{server.port}"
    try:
        ledger = tflight.fetch(addr, path="/debug/serve/ledger")
        headroom = tflight.fetch(addr, path="/debug/serve/headroom")
        index = tflight.fetch(addr, path="/debug")
        flight_dump = tflight.fetch(addr)
    finally:
        server.stop()
    assert ledger == ledgers["port"]
    assert dict(ledger, entries=[
        {k: v for k, v in e.items() if k != "detail"}
        for e in ledger["entries"]]) == ledgers["jax"]
    assert ledger["entries"] and ledger["reconciliation"]["ok"]
    assert headroom["freeSlots"] == 4 and "sloAlerts" in headroom
    assert set(index["debugHandlers"]) == {
        "/debug/flight", "/debug/serve", "/debug/serve/ledger",
        "/debug/serve/headroom", "/debug/profile", "/debug/history"}
    assert flight_dump["capacity"] == tflight.RECORDER.capacity


# -- request-lifecycle tracing over the ingress (tests/test_serve_trace.py) ---

BG_TRACE = "ab" * 16
BG_PARENT = f"00-{BG_TRACE}-{'12' * 8}-01"
FG_TRACE = "cd" * 16
FG_PARENT = f"00-{FG_TRACE}-{'34' * 8}-01"


def _run_scenario(side):
    """The forced preemption of test_serve_trace.py: a streamed batch
    request decodes on the only slot when a streamed interactive request
    arrives; the victim is evicted mid-decode, waits, re-prefills and
    completes. Both ride HTTP with caller traceparents; the scheduler is
    stepped on this thread alone, and each POST's arrival is awaited on a
    semaphore its ``submit_now`` releases."""
    serve, flight = SIDES[side]
    flight.RECORDER.clear()
    sched = serve.Scheduler(serve.ServeConfig(
        slots=1, kv_blocks=16, kv_block_size=4, prefill_chunk_tokens=4,
        queue_limit=8))
    arrived = threading.Semaphore(0)
    submit_now = sched.submit_now

    def watched(req):
        submit_now(req)
        arrived.release()

    sched.submit_now = watched
    service = serve.DecodeService(sched)
    port = service.start_http()
    streams = {}

    def post(name, body, parent):
        streams[name] = _read_ndjson_stream(port, body,
                                            {"traceparent": parent})

    bg = threading.Thread(target=post, args=(
        "bg", {"rid": "bg", "prompt_len": 10, "output_len": 6,
               "slo_class": "batch"}, BG_PARENT))
    fg = threading.Thread(target=post, args=(
        "fg", {"rid": "fg", "prompt_len": 6, "output_len": 2,
               "slo_class": "interactive"}, FG_PARENT))
    try:
        bg.start()
        assert arrived.acquire(timeout=WAIT_S)
        for _ in range(50):
            if any(r.tokens for r in sched._active.values()):
                break
            assert sched.step()
        fg.start()
        assert arrived.acquire(timeout=WAIT_S)
        for _ in range(200):
            if sched.completed_total == 2:
                break
            assert sched.step()
        bg.join(timeout=WAIT_S)
        fg.join(timeout=WAIT_S)
        assert not bg.is_alive() and not fg.is_alive()
    finally:
        service.stop()
    assert sched.preemptions == 1
    return flight.RECORDER.snapshot()["events"], streams, sched


def _serve_events(events, rid):
    return [e for e in events if e.get("kind") == "serve"
            and (e.get("attributes") or {}).get("rid") == rid]


def _span_tree(events):
    return [(e["name"], e.get("trace_id"), e.get("span_id"),
             e.get("duration_s"),
             tuple(sorted((e.get("attributes") or {}).items())))
            for e in events if e.get("kind") == "serve"]


def test_one_trace_id_from_ingress_to_every_phase_span():
    """test_serve_trace.py: the caller's trace id on the ingress span,
    every phase span and the FirstToken entry of each request."""
    events, streams, _ = _run_scenario("port")
    assert streams["bg"][-1] == {"done": True, "tokens": 6}
    assert streams["fg"][-1] == {"done": True, "tokens": 2}
    for rid, trace_id in (("bg", BG_TRACE), ("fg", FG_TRACE)):
        mine = _serve_events(events, rid)
        assert mine and {e.get("trace_id") for e in mine} == {trace_id}
        names = [e["name"] for e in mine]
        for phase in ("serve.queued", "serve.prefill_chunk",
                      "serve.decode", "FirstToken"):
            assert phase in names
        ingress = [e for e in events if e.get("kind") == "span"
                   and e.get("name") == "serve.request"
                   and (e.get("attributes") or {}).get("rid") == rid]
        assert ingress and ingress[0]["trace_id"] == trace_id
    decodes = [e for e in _serve_events(events, "bg")
               if e["name"] == "serve.decode"]
    assert [e["attributes"]["outcome"] for e in decodes] \
        == ["preempted", "complete"]


def test_timeline_reads_the_whole_lifecycle():
    """test_serve_trace.py's tpuctl timeline, from the port's flight
    payload: queued, prefill chunks, decode, preempted, re-prefill,
    decode, complete."""
    events, _, _ = _run_scenario("port")
    view = tpuctl.render_serve_trace(events, "bg")
    assert view["found"] and view["terminal"] == "Completed"
    assert view["traceId"] == BG_TRACE
    assert view["ttftSeconds"] is not None
    order = [k for k, _ in itertools.groupby(
        p["phase"] for p in view["phases"])]
    assert order == ["serve.queued", "serve.prefill_chunk",
                     "serve.decode", "serve.preempted",
                     "serve.prefill_chunk", "serve.decode"]
    starts = [p["startSeconds"] for p in view["phases"]]
    assert starts == sorted(starts)
    assert all(p["durationSeconds"] >= 0.0 for p in view["phases"])
    preempted = next(p for p in view["phases"]
                     if p["phase"] == "serve.preempted")
    assert preempted["durationSeconds"] > 0.0


def test_span_tree_bit_identical_across_two_runs_and_equal_to_jax():
    """test_serve_trace.py: two runs record the same serve span tree, and
    it equals the JAX service's on the same scenario."""
    events1, _, _ = _run_scenario("port")
    events2, _, _ = _run_scenario("port")
    events_jax, _, _ = _run_scenario("jax")
    assert _span_tree(events1) == _span_tree(events2)
    assert _span_tree(events1) == _span_tree(events_jax)


def test_serve_trace_and_top_over_http():
    """test_serve_trace.py's CLI path: the timeline from the
    ``/debug/flight`` payload and the top view from ``/debug/serve`` and
    ``/debug/serve/ledger``, all fetched from a live MetricsServer."""
    _run_scenario("port")  # leaves the scenario in the ring
    sched = tserve.Scheduler(tserve.ServeConfig(
        slots=1, kv_blocks=16, kv_block_size=4, prefill_chunk_tokens=4))
    sched.submit(tserve.Request(rid="t0", prompt_len=6, output_len=2,
                                arrival_s=0.0))
    sched.run()
    service = tserve.DecodeService(sched)
    server = MetricsServer(host="127.0.0.1", port=0,
                           debug_handlers=service.debug_handlers())
    server.start()
    addr = f"127.0.0.1:{server.port}"
    try:
        trace = tpuctl.render_serve_trace(
            tflight.fetch(addr)["events"], "bg")
        top = tpuctl.render_serve_top(
            tflight.fetch(addr, path="/debug/serve"),
            tflight.fetch(addr, path="/debug/serve/ledger"), last=5)
    finally:
        server.stop()
    assert trace["found"] and trace["traceId"] == BG_TRACE
    assert trace["phases"]
    assert top["iterations"] > 0
    assert set(top["phaseSeconds"]) <= set(tserve.LEDGER_PHASES)
    assert top["reconciliation"]["ok"]


_EXEMPLAR_RE = re.compile(
    r' # \{trace_id="([0-9a-f]{32})"\} [0-9][0-9.e+-]*$')


def test_openmetrics_exemplars_join_flight_first_tokens_mid_storm():
    """test_serve_trace.py: an OpenMetrics scrape of the port's
    ``/metrics`` renders grammar-valid exemplars on the TTFT histogram
    that join flight-recorded FirstToken trace ids, and ends in
    ``# EOF``; a classic scrape carries no exemplar."""
    tflight.RECORDER.clear()
    sched = tserve.Scheduler(tserve.ServeConfig(
        slots=2, kv_blocks=64, kv_block_size=8, prefill_chunk_tokens=16,
        queue_limit=512))
    sched.submit_all([tserve.Request(
        rid=r.rid, prompt_len=r.prompt_len, output_len=r.output_len,
        slo_class=r.slo_class, arrival_s=r.arrival_s)
        for r in jserve.open_loop_arrivals(
            seed=20260804, rate_rps=8.0, horizon_s=4.0, id_prefix="om")])
    sched.run()
    first_ids = {e.get("trace_id")
                 for e in tflight.RECORDER.events(kind="serve")
                 if e["name"] == "FirstToken"}
    assert first_ids
    server = MetricsServer(host="127.0.0.1", port=0)
    server.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=WAIT_S)
        conn.request("GET", "/metrics", headers={
            "Accept": "application/openmetrics-text"})
        resp = conn.getresponse()
        om = resp.read().decode()
        assert resp.getheader("Content-Type").startswith(
            "application/openmetrics-text")
        conn.close()
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=WAIT_S)
        conn.request("GET", "/metrics")
        plain = conn.getresponse().read().decode()
        conn.close()
    finally:
        server.stop()
    assert om.rstrip().endswith("# EOF")
    assert "# TYPE tpu_serve_requests counter" in om
    assert "# TYPE tpu_serve_requests_total counter" in plain
    assert " # {" not in plain
    exemplar_ids = set()
    for line in om.splitlines():
        if line.startswith("tpu_serve_ttft_seconds_bucket") \
                and " # " in line:
            m = _EXEMPLAR_RE.search(line)
            assert m, f"exemplar violates the OpenMetrics grammar: {line}"
            exemplar_ids.add(m.group(1))
    assert exemplar_ids and exemplar_ids & first_ids


def test_classic_scrape_stays_byte_unchanged_by_exemplars():
    """test_serve_trace.py: a histogram's classic render is the same with
    and without exemplars; only the OpenMetrics render carries them."""
    bare = tmetrics.Histogram("tpu_serve_ttft_seconds", "ttft",
                              buckets=(0.1, 1.0))
    exemplared = tmetrics.Histogram("tpu_serve_ttft_seconds", "ttft",
                                    buckets=(0.1, 1.0))
    for value in (0.05, 0.4, 2.0):
        bare.observe(value)
        exemplared.observe(value, exemplar={
            "trace_id": ttracing.det_trace_id(f"x{value}")})
    assert bare._render() == exemplared._render()
    assert not any(" # {" in line for line in exemplared._render())
    assert any(" # {" in line
               for line in exemplared._render(openmetrics=True))


# -- hostile bodies (tests/test_fuzz_ingress.py) ------------------------------

RAW_BODIES = (b"{nope", b"\x00\xff\xfe garbage", b"[1,2", NAN_BODY.encode(),
              b'{"prompt_len": 1, "output_len": Infinity}',
              b'{"prompt_len": 1, "output_len": -Infinity}')
SPECS = _wrong_typed_corpus(random.Random(FUZZ_SEED))
#: the 10 MB Content-Length with no body sent, and a 2 MB body sent whole
HOSTILE = ([("raw", i) for i in range(len(RAW_BODIES))]
           + [("spec", i) for i in range(len(SPECS))]
           + [("10mb_header", 0), ("2mb_body", 0)])


@pytest.fixture(scope="module")
def ingresses():
    """Both packages' ingresses over idle schedulers (the step loop never
    runs: a refused body must not even reach the pending queue)."""
    out = {}
    for name, (serve, _) in SIDES.items():
        sched = serve.Scheduler(serve.ServeConfig(
            slots=2, kv_blocks=8, kv_block_size=16, queue_limit=8))
        service = serve.DecodeService(sched, idle_interval_s=0.01)
        out[name] = (service.start_http(), sched, service)
    yield out
    for _, _, service in out.values():
        service.stop()


def _declared_10mb(port) -> int:
    """A 10 MB Content-Length and no body: the 400 must come from the
    header clamp alone (a server that read the body would time out)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    try:
        conn.putrequest("POST", "/v1/generate")
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", str(10 * 1024 * 1024))
        conn.endheaders()
        resp = conn.getresponse()
        resp.read()
        return resp.status
    finally:
        conn.close()


@pytest.mark.parametrize("kind,index", HOSTILE,
                         ids=[f"{k}-{i}" for k, i in HOSTILE])
def test_hostile_body_400s_without_touching_the_scheduler(ingresses, kind,
                                                          index):
    """Each hostile body of tests/test_fuzz_ingress.py: the port's
    ingress answers 400 as the JAX one does (or, for a 2 MB body sent
    whole, may sever the connection first), and no scheduler state
    changes: nothing pending, queued or admitted."""
    statuses = {}
    for name, (port, sched, _) in ingresses.items():
        if kind == "raw":
            statuses[name] = _post_raw(port, RAW_BODIES[index])
        elif kind == "spec":
            statuses[name] = _post_raw(port,
                                       json.dumps(SPECS[index]).encode())
        elif kind == "10mb_header":
            statuses[name] = _declared_10mb(port)
        else:
            statuses[name] = _post_raw(port, json.dumps(
                {"prompt_len": 4, "output_len": 4,
                 "rid": "x" * (2 * 1024 * 1024)}).encode())
        _assert_virgin(sched)
        with sched._lock:
            assert not sched._pending
    if kind == "2mb_body":
        assert set(statuses.values()) <= {400, None}
    else:
        assert statuses == {"jax": 400, "port": 400}, \
            f"{kind} {index}: {statuses}"


# -- the tiny model served over the wire ---------------------------------------


def test_tiny_model_served_over_http_streams_equal_generate():
    """The tiny fp32 model through ``TorchSlotExecutor(device="cpu")``
    with chunked prefill, behind ``start_http`` and the service thread:
    four concurrent clients, one token a chunk, every stream equal to
    ``generate``; the pool drains and the ledger reconciles."""
    cfg = tmodel.TransformerConfig(vocab=256, d_model=64, n_heads=4,
                                   n_layers=2, d_ff=128, max_seq=64,
                                   dtype=torch.float32)
    params = tmodel.init_params(0, cfg, device="cpu")
    ex = tserve.TorchSlotExecutor(params, cfg, slots=2, chunk_tokens=8,
                                  device="cpu")
    sched = tserve.Scheduler(tserve.ServeConfig(
        slots=2, kv_blocks=16, kv_block_size=8, prefill_chunk_tokens=8),
        ex, clock=time.monotonic)
    service = tserve.DecodeService(sched, idle_interval_s=0.005)
    service.start()
    port = service.start_http()
    rng = np.random.default_rng(7)
    bodies = []
    for i in range(4):
        p = int(rng.integers(5, 20))
        bodies.append({"rid": f"tiny{i}", "output_len": int(
            rng.integers(3, 10)),
            "prompt": [int(t) for t in rng.integers(0, 256, p)]})
    got: dict = {}

    def client(body):
        got[body["rid"]] = _raw_chunks(port, body)

    threads = [threading.Thread(target=client, args=(b,)) for b in bodies]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        service.stop()
    for body in bodies:
        chunks = got[body["rid"]]
        n = body["output_len"]
        assert chunks[-1] == {"done": True, "tokens": n}
        want = tdecode.generate(params, cfg, torch.tensor([body["prompt"]]),
                                n, device="cpu")[0].tolist()
        assert [c["token"] for c in chunks[:-1]] == want, body["rid"]
    assert sched.completed_total == 4
    assert sched.pool.outstanding() == 0
    assert sched.ledger.reconcile()["ok"]


# -- the port's utils copies against the reference's ---------------------------

TRACEPARENTS = [
    "00-" + "ab" * 16 + "-" + "12" * 8 + "-01",
    "00-" + "AB" * 16 + "-" + "12" * 8 + "-01",      # uppercase hex
    "ff-" + "ab" * 16 + "-" + "12" * 8 + "-01",      # forbidden version
    "00-" + "0" * 32 + "-" + "12" * 8 + "-01",       # all-zero trace id
    "00-" + "ab" * 16 + "-" + "0" * 16 + "-01",      # all-zero span id
    "00-" + "ab" * 16 + "-" + "12" * 8 + "-01\n",    # header splitting
    " 00-" + "ab" * 16 + "-" + "12" * 8 + "-01",
    "00-" + "ab" * 15 + "-" + "12" * 8 + "-01",      # short trace id
    "00-" + "ab" * 16 + "-" + "12" * 8,              # no flags
    "x" * 65, "", None, 17, b"00-ab",
]


@pytest.mark.parametrize("value", TRACEPARENTS,
                         ids=[f"tp{i}" for i in range(len(TRACEPARENTS))])
def test_extract_traceparent_equals_the_reference(value):
    from dpu_operator_tpu.utils import tracing as jtracing
    ours = ttracing.extract_traceparent(value)
    theirs = jtracing.extract_traceparent(value)
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert (ours.trace_id, ours.span_id, ours.traceparent()) \
            == (theirs.trace_id, theirs.span_id, theirs.traceparent())


def test_deterministic_ids_equal_the_reference():
    from dpu_operator_tpu.utils import tracing as jtracing
    for seed in ("r0", "req-05", "dt13", "", "ü"):
        trace = ttracing.det_trace_id(seed)
        assert trace == jtracing.det_trace_id(seed)
        for seq in (0, 1, 7):
            assert ttracing.det_span_id(trace, seed, seq) \
                == jtracing.det_span_id(trace, seed, seq)


VALIDATE_CASES = [
    ("clamped_int", (5, 1, 10)), ("clamped_int", ("7", 1, 10)),
    ("clamped_int", (True, 0, 9)), ("clamped_int", (float("nan"), 0, 9)),
    ("clamped_int", (1.5e308, 0, 9)), ("clamped_int", ("abc", 0, 9)),
    ("clamped_int", ([], 0, 9)), ("clamped_int", (11, 1, 10)),
    ("clamped_int", (None, 0, 9)),
    ("bounded_str", ("ok-id", 128)), ("bounded_str", ("x" * 129, 128)),
    ("bounded_str", ("a\nb", 128)), ("bounded_str", ("a\x7fb", 128)),
    ("parse_choice", ("batch", ("interactive", "batch"))),
    ("parse_choice", (5, ("interactive", "batch"))),
    ("parse_choice", ("platinum", ("interactive", "batch"))),
    ("safe_path_segment", ("chip-1",)), ("safe_path_segment", ("..",)),
    ("safe_path_segment", ("a/b",)),
]


@pytest.mark.parametrize("fn,args", VALIDATE_CASES,
                         ids=[f"{f}-{i}" for i, (f, _) in
                              enumerate(VALIDATE_CASES)])
def test_validate_helpers_equal_the_reference(fn, args):
    """The same value or the same ValueError text."""
    from dpu_operator_tpu.utils import validate as jvalidate
    from dpu_operator_tpu_torch.utils import validate as tvalidate

    def outcome(mod):
        try:
            return ("ok", getattr(mod, fn)(*args))
        except ValueError as e:
            return ("refused", str(e))

    assert outcome(tvalidate) == outcome(jvalidate)


@pytest.mark.parametrize("raw", ["", "1024", "16", "65536", "15", "65537",
                                 "abc", "-5", "1e3"])
def test_flight_capacity_clamp_equals_the_reference(raw):
    assert tflight.capacity_from_env({"TPU_FLIGHT_CAPACITY": raw}) \
        == jflight.capacity_from_env({"TPU_FLIGHT_CAPACITY": raw})


def test_flight_ring_is_bounded_and_counts_its_drops():
    ring = tflight.FlightRecorder(capacity=16)
    before = tmetrics.FLIGHT_DROPPED.value(kind="serve")
    for i in range(20):
        ring.record("serve", f"e{i}", trace_id="t" * 32)
    snap = ring.snapshot()
    assert len(snap["events"]) == 16 and snap["recorded"] == 20
    assert snap["dropped"] == {"serve": 4}
    assert snap["events"][0]["name"] == "e4"
    assert tmetrics.FLIGHT_DROPPED.value(kind="serve") == before + 4


def test_metric_families_equal_the_reference():
    """Every family of the port's registry exists in the reference's
    under the same name, with the same type, help text, buckets and
    label: the contract the operator's SLOs and telemetry read."""
    from dpu_operator_tpu.utils import metrics as jmetrics
    theirs = {m.name: m for m in jmetrics.REGISTRY._metrics}
    assert len(tmetrics.REGISTRY._metrics) >= 30
    for ours in tmetrics.REGISTRY._metrics:
        ref = theirs[ours.name]
        assert type(ours).__name__ == type(ref).__name__, ours.name
        assert ours.help == ref.help, ours.name
        assert getattr(ours, "buckets", None) \
            == getattr(ref, "buckets", None), ours.name
        assert getattr(ours, "label", None) \
            == getattr(ref, "label", None), ours.name


def test_watchdog_detects_a_stalled_step_on_an_injected_clock():
    """A task-scoped heartbeat: idle is healthy however long; a step that
    outlives its deadline is a stall (stack dump in the flight ring,
    ``WatchdogStall`` Event), and its end a recovery."""
    from dpu_operator_tpu_torch.utils import events as tevents
    clock = [0.0]
    dog = twatchdog.Watchdog(clock=lambda: clock[0])
    hb = dog.register("serve.scheduler", deadline=30.0)
    got = []
    tevents.configure(lambda reason, message, type_, series:
                      got.append((reason, series)))
    try:
        clock[0] += 3600.0
        assert dog.check() == ([], [])
        with twatchdog.task(hb):
            clock[0] += 31.0
            stalled, _ = dog.check()
            assert stalled == [hb]
        _, recovered = dog.check()
        assert recovered == [hb]
    finally:
        tevents.reset()
        hb.close()
    assert got == [("WatchdogStall", "serve.scheduler"),
                   ("WatchdogRecovered", "serve.scheduler")]
    assert tflight.RECORDER.events(kind="stall")


def test_serve_slo_fires_on_slow_first_tokens_and_feeds_the_ladder():
    """The standing serve-ttft objective over the port's TTFT histogram
    (the twin of test_serve.py's serve-ttft burn test): a storm of slow
    first tokens fires its page alert, which ``DecodeService`` hands the
    degradation ladder as its second signal."""
    from dpu_operator_tpu_torch.utils import slo as tslo
    clock = [0.0]
    ev = tslo.SloEvaluator(clock=lambda: clock[0])
    for s in tslo.serve_slos(rules=tslo.default_rules(scale=0.001)):
        ev.add(s)
    assert [s.name for s in tslo.EVALUATOR._slos] \
        == ["serve-ttft", "serve-tokens"]
    ev.evaluate()
    for _ in range(6):
        clock[0] += 1.0
        for _ in range(50):
            tmetrics.SERVE_TTFT_SECONDS.observe(5.0)
        ev.evaluate()
    assert ("serve-ttft", "page") in ev.active_alerts()
    sched = tserve.Scheduler(_harness(tserve))
    service = tserve.DecodeService(sched, evaluator=ev)
    assert sched.slo_alert_fn() is True
    assert service.headroom()["sloAlerts"][0]["slo"] == "serve-ttft"
