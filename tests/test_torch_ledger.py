"""The scheduler's accounting in the PyTorch/CUDA port, on the CPU, against
the JAX package.

The JAX ``Scheduler`` and the port's run the same seeded arrivals on the
virtual clock over their own package's ``SimExecutor`` (or
``PeriodicSimExecutor``, or ``ChaosExecutor`` under one fault script), and
must agree on everything the accounting records: the ``StepLedger``
entries, ``snapshot()``, ``headroom()`` (the stamp's clock injected equal
in both), ``serving_summary()``, the pool's ``snapshot()``, the flight
ring's phase spans (kind ``serve``: names, trace and span ids, durations,
attributes), the deltas of every serve metric over the run, and the Events
emitted (reason, message, type, series). The JAX registry and flight ring
are process-global and other tests touch them, so metrics are compared as
deltas over the run and each ring is cleared before it. Then the twins of
tests/test_serve.py's ledger, span, headroom and concurrency tests.

Injected clocks and seeded arrivals only.
"""

import threading

import pytest

from dpu_operator_tpu.testing import chaos as jchaos
from dpu_operator_tpu.utils import flight as jflight
from dpu_operator_tpu.utils import metrics as jmetrics
from dpu_operator_tpu.workloads import serve as jserve
from dpu_operator_tpu_torch.testing import chaos as tchaos
from dpu_operator_tpu_torch.utils import events as tevents
from dpu_operator_tpu_torch.utils import flight as tflight
from dpu_operator_tpu_torch.utils import metrics as tmetrics
from dpu_operator_tpu_torch.workloads import serve as tserve

SEED = 20260804
#: tests/test_serve.py's prefill-heavy calibrated cost model
CALIBRATED = dict(decode_base_s=0.0007512, decode_per_seq_s=0.0000835,
                  prefill_per_token_s=0.00026168)
#: (serve module, flight module, metrics module, chaos module) of a side
SIDES = {"jax": (jserve, jflight, jmetrics, jchaos),
         "port": (tserve, tflight, tmetrics, tchaos)}

COUNTERS = ("SERVE_REQUESTS", "SERVE_TOKENS", "SERVE_PREEMPTIONS",
            "SERVE_ADMISSION_REJECTED", "SERVE_PREFILL_CHUNKS",
            "SERVE_PREFILL_CHUNK_TOKENS", "KV_COW_COPIES",
            "KV_PREFIX_BLOCK_HITS", "SERVE_SPEC_TOKENS",
            "SERVE_EXECUTOR_FAULTS", "SERVE_RETRIES", "SERVE_POISONED",
            "SWALLOWED_ERRORS")
HISTOGRAMS = ("SERVE_TTFT_SECONDS", "SERVE_ITL_SECONDS",
              "SERVE_SPEC_VERIFY_SECONDS")
#: the gauge samples every step (or every pool change) rewrites, so their
#: values after a run are the run's own
GAUGES = (("SERVE_QUEUE_DEPTH", {"slo_class": "interactive"}),
          ("SERVE_QUEUE_DEPTH", {"slo_class": "batch"}),
          ("SERVE_ACTIVE", {"slo_class": "interactive"}),
          ("SERVE_ACTIVE", {"slo_class": "batch"}),
          ("SERVE_SLOTS", {"state": "free"}),
          ("SERVE_SLOTS", {"state": "active"}),
          ("SERVE_PREFILL_BACKLOG", {}),
          ("SERVE_KV_BLOCKS", {"state": "free"}),
          ("SERVE_KV_BLOCKS", {"state": "used"}),
          ("KV_SHARED_BLOCKS", {}),
          ("SERVE_KV_FRAGMENTATION", {}),
          ("SERVE_DEGRADED_RUNG", {}),
          *(("SERVE_HEADROOM", {"dimension": d}) for d in (
              "free_slots", "advertisable_slots", "free_kv_blocks",
              "chunk_backlog_tokens", "prefix_index_keys",
              "degraded_rung")))


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def port_entries(entries: list) -> list:
    """The port's ``StepLedger`` entries on the JAX entry's keys: each
    holds one key of its own, ``detail``, which is checked and dropped;
    every other key is kept for the comparison."""
    out = []
    for e in entries:
        assert isinstance(e["detail"], dict)
        out.append({k: v for k, v in e.items() if k != "detail"})
    return out


def port_snapshot(snap: dict) -> dict:
    """The port's ledger snapshot with :func:`port_entries`."""
    return dict(snap, entries=port_entries(snap["entries"]))


def _metric_state(metrics) -> dict:
    """Every serve counter's samples, histogram's bucket counts and sum
    (the step breakdown's per phase), and gauge value of one registry."""
    out = {}
    for name in COUNTERS:
        out[name] = {tuple(sorted(lb.items())): v
                     for lb, v in getattr(metrics, name).samples()}
    for name in HISTOGRAMS:
        h = getattr(metrics, name)
        out[name] = (list(h._counts), h._sum)
    vec = metrics.SERVE_STEP_BREAKDOWN
    out["SERVE_STEP_BREAKDOWN"] = {
        phase: (list(h._counts), h._sum)
        for phase, h in sorted(vec._children.items())}
    return out


def _delta(before: dict, after: dict) -> dict:
    """Counters and histogram buckets as exact deltas; histogram sums as
    deltas rounded to 9 places (each registry adds to its own total)."""
    out = {}
    for name in COUNTERS:
        b, a = before[name], after[name]
        out[name] = {k: v - b.get(k, 0.0) for k, v in a.items()
                     if v != b.get(k, 0.0)}

    def hist(b, a):
        return ([x - y for x, y in zip(a[0], b[0])], round(a[1] - b[1], 9))

    for name in HISTOGRAMS:
        out[name] = hist(before[name], after[name])
    zero = ([0] * 17, 0.0)
    out["SERVE_STEP_BREAKDOWN"] = {
        phase: hist(before["SERVE_STEP_BREAKDOWN"].get(phase, zero), h)
        for phase, h in after["SERVE_STEP_BREAKDOWN"].items()}
    return out


def _gauges(metrics) -> list:
    return [getattr(metrics, name).value(**labels)
            for name, labels in GAUGES]


def _span_tree(flight) -> list:
    """The serve-kind events less the ring's wall-clock fields."""
    return [(e["name"], e.get("trace_id"), e.get("span_id"),
             e.get("duration_s"),
             tuple(sorted((e.get("attributes") or {}).items())))
            for e in flight.RECORDER.events(kind="serve")]


def _request(serve, r, **kw):
    return serve.Request(rid=r.rid, prompt_len=r.prompt_len,
                         output_len=r.output_len, slo_class=r.slo_class,
                         arrival_s=r.arrival_s, prompt=r.prompt, **kw)


@pytest.fixture
def captured_events(monkeypatch):
    """The Events each side emits: the JAX seam's ``events.emit``
    patched, the port's seam configured with a sink."""
    from dpu_operator_tpu.k8s import events as jevents
    got = {"jax": [], "port": []}
    monkeypatch.setattr(
        jevents, "emit",
        lambda reason, message, type_="Normal", series="":
        got["jax"].append((reason, message, type_, series)))
    tevents.configure(lambda reason, message, type_, series:
                      got["port"].append((reason, message, type_, series)))
    yield got
    tevents.reset()


def _run_side(name, scenario):
    serve, flight, metrics, chaos = SIDES[name]
    flight.RECORDER.clear()
    before = _metric_state(metrics)
    ex = scenario["executor"](serve, chaos)
    sched = serve.Scheduler(
        serve.ServeConfig(**scenario["config"]), executor=ex,
        cost_model=serve.CostModel(**scenario.get("cost", {})),
        headroom_clock=lambda: 1234.5)
    for r in scenario["arrivals"]():
        sched.submit(_request(serve, r, **scenario.get("extra", {}).get(
            r.rid, {})))
    views = []
    cancel = scenario.get("cancel")
    while sched.step():
        if cancel and sched.iterations == cancel[1]:
            assert sched.cancel(cancel[0])
        views.append((sched.snapshot(), sched.pool.owners(),
                      sched.pool.internal_fragmentation(),
                      sched.pool.prefix_index_keys()))
    return {"sched": sched, "views": views,
            "delta": _delta(before, _metric_state(metrics)),
            "gauges": _gauges(metrics), "tree": _span_tree(flight),
            "ring": flight.RECORDER.snapshot()["dropped"]}


def _sim(serve, chaos):
    return serve.SimExecutor()


def _chaotic(serve, chaos):
    plan = chaos.FaultPlan(seed=SEED)
    plan.script("prefill_chunk", chaos.Ok(times=5), chaos.Oom())
    plan.script("step", chaos.Ok(times=8), chaos.Fail(times=4))
    return chaos.ChaosExecutor(serve.SimExecutor(), plan=plan).poison("sc7")


def _arrivals(**kw):
    return lambda: jserve.open_loop_arrivals(**kw)


SCENARIOS = {
    # chunked prefill on 2 slots under pressure: a preemption, and a
    # preempted wait in the span tree
    "chunked_preempt": dict(
        config=dict(slots=2, kv_blocks=16, kv_block_size=8,
                    prefill_chunk_tokens=16, queue_limit=256),
        cost=CALIBRATED, executor=_sim,
        arrivals=_arrivals(seed=SEED, rate_rps=10.0, horizon_s=6.0,
                           prompt_lens=(24, 64), id_prefix="dt")),
    # whole-prompt prefill at admission, a small queue that rejects
    "atomic_queue_full": dict(
        config=dict(slots=4, kv_blocks=64, kv_block_size=16,
                    queue_limit=3),
        executor=_sim,
        arrivals=_arrivals(seed=SEED, rate_rps=30.0, horizon_s=2.0,
                           id_prefix="aq")),
    # speculation over shared prefixes: CoW spans, prefix hits, spec
    # metrics
    "sharing_spec": dict(
        config=dict(slots=4, kv_blocks=48, kv_block_size=16,
                    queue_limit=256, spec_k=3, prefix_sharing=True,
                    prefill_chunk_tokens=32),
        executor=lambda serve, chaos: serve.PeriodicSimExecutor(4),
        arrivals=lambda: jserve.prefix_heavy_arrivals(
            SEED, 30.0, 3.0, n_prefixes=3, prefix_len=33)),
    # faults: an Oom mid-prefill, four failing decode passes (the ladder
    # climbs and recovers), a poisoned rid, deadlines and a cancel
    "faults": dict(
        config=dict(slots=4, kv_blocks=64, kv_block_size=16,
                    queue_limit=256, prefill_chunk_tokens=32),
        executor=_chaotic,
        arrivals=_arrivals(seed=SEED, rate_rps=8.0, horizon_s=4.0,
                           id_prefix="sc"),
        extra={"sc3": dict(deadline_budget_s=0.01),
               "sc11": dict(deadline_budget_s=0.3)},
        cancel=("sc14", 40)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_accounting_equals_the_jax_scheduler(name, captured_events):
    """Every view of the accounting, after every step and at the end,
    equals the JAX scheduler's on the same run."""
    scenario = SCENARIOS[name]
    jax_run = _run_side("jax", scenario)
    port_run = _run_side("port", scenario)
    j, t = jax_run["sched"], port_run["sched"]
    assert t.trace == j.trace
    assert t.iterations > 10
    assert port_run["views"] == jax_run["views"]
    assert port_entries(t.ledger.entries()) == j.ledger.entries()
    assert port_snapshot(t.ledger.snapshot()) == j.ledger.snapshot()
    assert t.snapshot() == j.snapshot()
    assert t.pool.snapshot() == j.pool.snapshot()
    assert t.serving_summary() == j.serving_summary()
    assert t.headroom() == j.headroom()
    assert t.headroom()["sequence"] == 2
    assert port_run["tree"] == jax_run["tree"]
    assert port_run["tree"]
    assert port_run["ring"] == jax_run["ring"]
    assert port_run["delta"] == jax_run["delta"]
    assert port_run["gauges"] == jax_run["gauges"]
    assert captured_events["port"] == captured_events["jax"]
    # each scenario exercises what it names
    kinds = {e[0] for e in t.trace}
    outcomes = port_run["delta"]["SERVE_REQUESTS"]
    if name == "chunked_preempt":
        assert t.preemptions > 0
        assert any(e[0] == "ServePreempted"
                   for e in captured_events["port"])
    if name == "atomic_queue_full":
        assert (("outcome", "rejected"), ("slo_class", "batch")) in outcomes \
            or (("outcome", "rejected"),
                ("slo_class", "interactive")) in outcomes
        assert "ServeAdmissionRejected" \
            in {e[0] for e in captured_events["port"]}
    if name == "sharing_spec":
        assert t.pool.cow_copies > 0 and t.pool.prefix_block_hits > 0
        assert any(s[0] == "serve.cow" for s in port_run["tree"])
        assert port_run["delta"]["SERVE_SPEC_TOKENS"]
    if name == "faults":
        assert {"retry", "poison", "deadline", "cancel", "rung"} <= kinds
        assert {"ServeRequestPoisoned", "ServeDegraded",
                "ServeRecovered"} <= {e[0] for e in captured_events["port"]}
    assert t.pool.outstanding() == 0


# -- twins of tests/test_serve.py ---------------------------------------------


def _harness(serve, **kw):
    base = dict(slots=4, kv_blocks=64, kv_block_size=16, queue_limit=256)
    base.update(kw)
    return serve.ServeConfig(**base)


def test_ledger_reconciles_exactly_in_virtual_time():
    """test_serve.py:1662: every entry's phase sum equals the iteration's
    virtual advance, prefill and decode both carry spend, sched none, and
    the breakdown histogram sees every step; the entries equal JAX's."""
    runs = {}
    for name, (serve, _, metrics, _) in SIDES.items():
        breakdown_before = metrics.SERVE_STEP_BREAKDOWN.count()
        sched = serve.Scheduler(_harness(serve, prefill_chunk_tokens=16),
                                cost_model=serve.CostModel())
        sched.submit_all([_request(serve, r) for r in
                          jserve.open_loop_arrivals(SEED, 6.0, 10.0,
                                                    id_prefix="lg")])
        sched.run()
        runs[name] = sched
        entries = sched.ledger.entries()
        assert entries and len(entries) <= sched.ledger.capacity
        rec = sched.ledger.reconcile(tolerance_s=1e-5, rel=0.0)
        assert rec["checked"] == len(entries) and rec["ok"], rec
        assert set(entries[-1]["phases"]) == set(serve.LEDGER_PHASES)
        assert sum(e["phases"]["prefill"] for e in entries) > 0
        assert sum(e["phases"]["decode"] for e in entries) > 0
        assert sum(e["phases"]["sched"] for e in entries) == 0
        assert sum(e["phases"]["compile"] for e in entries) == 0
        assert metrics.SERVE_STEP_BREAKDOWN.count() \
            >= breakdown_before + len(serve.LEDGER_PHASES)
    assert tserve.LEDGER_PHASES == jserve.LEDGER_PHASES
    assert port_entries(runs["port"].ledger.entries()) \
        == runs["jax"].ledger.entries()


def test_ledger_attributes_stall_to_the_stalled_phase():
    """test_serve.py:1688: under an injected real clock a stalling
    executor's seconds land in the phase that stalled (decode for a step
    stall, prefill for a chunk stall), and the ledger reconciles."""
    entries = {}
    for name, (serve, *_) in SIDES.items():
        clock = _Clock()

        class StallingExecutor(serve.SimExecutor):
            def prefill_chunk(self, req, slot, offset, n):
                clock.advance(2.0)
                return super().prefill_chunk(req, slot, offset, n)

            def step(self, active):
                clock.advance(3.0)
                return super().step(active)

        sched = serve.Scheduler(
            _harness(serve, slots=2, prefill_chunk_tokens=64),
            clock=clock, executor=StallingExecutor())
        sched.submit(serve.Request(rid="stall", prompt_len=8,
                                   output_len=3, arrival_s=0.0))
        while sched.step():
            pass
        assert len(sched.completed) == 1
        got = sched.ledger.entries()
        assert any(e["phases"]["decode"] >= 3.0 for e in got)
        assert any(e["phases"]["prefill"] >= 2.0 for e in got)
        for e in got:
            assert e["phases"]["sched"] < 1.0
            assert e["phases"]["cow"] < 1.0
        assert sched.ledger.reconcile()["ok"]
        entries[name] = got
    assert port_entries(entries["port"]) == entries["jax"]


def test_ledger_ring_is_bounded():
    """test_serve.py:1722."""
    snaps = {}
    for name, (serve, *_) in SIDES.items():
        sched = serve.Scheduler(_harness(serve, slots=2))
        sched.ledger = serve.StepLedger(capacity=8)
        for i in range(40):
            sched.submit(serve.Request(rid=f"lb{i}", prompt_len=4,
                                       output_len=2, arrival_s=0.01 * i))
        sched.run()
        assert sched.iterations > 8
        assert len(sched.ledger.entries()) == 8
        snap = sched.ledger.snapshot()
        assert snap["capacity"] == 8
        assert snap["reconciliation"]["checked"] == 8
        snaps[name] = snap
    assert port_snapshot(snaps["port"]) == snaps["jax"]


def test_snapshot_is_safe_against_a_concurrent_step_loop():
    """test_serve.py:685: snapshot(), capacity() and headroom() read from
    another thread while run() mutates the queues and slots must never
    fail; the run still completes every request."""
    sched = tserve.Scheduler(_harness(tserve, slots=4, kv_blocks=64))
    for i in range(300):
        sched.submit(tserve.Request(
            rid=f"cc{i}", prompt_len=8, output_len=4,
            slo_class=tserve.INTERACTIVE if i % 3 else tserve.BATCH,
            arrival_s=0.005 * i))
    errors: list = []
    reads = [0]
    done = threading.Event()

    def hammer():
        while not done.is_set():
            try:
                sched.snapshot()
                sched.capacity()
                sched.headroom()
                reads[0] += 1
            except Exception as e:  # noqa: BLE001 — the assertion
                errors.append(e)
                return

    t = threading.Thread(target=hammer)
    t.start()
    try:
        sched.run()
    finally:
        done.set()
        t.join(timeout=10)
    assert not t.is_alive()
    assert errors == []
    assert reads[0] > 0
    assert sched.completed_total == 300


def test_concurrent_submit_now_loses_no_request():
    """Eight threads ``submit_now`` 50 requests each while this thread
    steps the scheduler, with the interpreter switching threads every
    10 µs: every request is admitted and completed exactly once (a lost
    update of the arrival heap or its sequence would drop or duplicate
    one) and the pool drains."""
    import sys
    sched = tserve.Scheduler(_harness(tserve, slots=4, kv_blocks=64,
                                      queue_limit=1000))
    start = threading.Barrier(9)

    def submitter(k):
        start.wait(timeout=10)
        for i in range(50):
            sched.submit_now(tserve.Request(rid=f"c{k}-{i}", prompt_len=4,
                                            output_len=2))

    threads = [threading.Thread(target=submitter, args=(k,))
               for k in range(8)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        start.wait(timeout=10)
        for _ in range(100_000):
            sched.step()
            if not any(t.is_alive() for t in threads):
                break
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        sched.run()
    finally:
        sys.setswitchinterval(switch)
    done = [r.rid for r in sched.completed]
    assert len(done) == len(set(done)) == 400
    assert sched.rejected_total == 0
    assert sched.pool.outstanding() == 0


def test_phase_span_tree_bit_identical_across_seeded_runs():
    """test_serve.py:1739: two seeded runs of a preemption-heavy chunked
    workload record the same serve span tree, and so does the JAX
    scheduler."""
    arrivals = jserve.open_loop_arrivals(SEED, 10.0, 6.0,
                                         prompt_lens=(24, 64),
                                         id_prefix="dt")

    def run_once(serve, flight):
        flight.RECORDER.clear()
        sched = serve.Scheduler(
            _harness(serve, slots=2, kv_blocks=16, kv_block_size=8,
                     prefill_chunk_tokens=16),
            cost_model=serve.CostModel(**CALIBRATED))
        sched.submit_all([_request(serve, r) for r in arrivals])
        sched.run()
        return _span_tree(flight), sched.preemptions

    tree1, preempt1 = run_once(tserve, tflight)
    tree2, preempt2 = run_once(tserve, tflight)
    assert preempt1 > 0
    assert any(name == "serve.preempted" for name, *_ in tree1)
    assert tree1 == tree2 and preempt1 == preempt2
    assert tree1 == run_once(jserve, jflight)[0]


def test_cow_copy_emits_a_phase_span():
    """test_serve.py:1772: a divergent write of identical prompts under
    sharing leaves a serve.cow span on the writer's trace."""
    trees = {}
    for name, (serve, flight, *_) in SIDES.items():
        flight.RECORDER.clear()
        prompt = tuple(range(24))
        sched = serve.Scheduler(
            serve.ServeConfig(slots=2, kv_blocks=16, kv_block_size=16,
                              prefix_sharing=True,
                              prefill_chunk_tokens=64),
            cost_model=serve.CostModel(**CALIBRATED))
        sched.submit(serve.Request(rid="cw0", prompt_len=len(prompt),
                                   output_len=24, slo_class=serve.BATCH,
                                   arrival_s=0.0, prompt=prompt))
        sched.submit(serve.Request(rid="cw1", prompt_len=len(prompt),
                                   output_len=8, slo_class=serve.BATCH,
                                   arrival_s=0.007, prompt=prompt))
        sched.run()
        assert sched.pool.cow_copies > 0
        cows = [e for e in flight.RECORDER.events(kind="serve")
                if e["name"] == "serve.cow"]
        assert cows and all(e.get("trace_id") for e in cows)
        trees[name] = _span_tree(flight)
    assert trees["port"] == trees["jax"]


def test_headroom_digest_matches_capacity_and_gauges():
    """test_serve.py:1804, at the default typical request (128 tokens:
    the port's ServeConfig has no ``typical_tokens`` field)."""
    digests = {}
    for name, (serve, _, metrics, _) in SIDES.items():
        sched = serve.Scheduler(
            serve.ServeConfig(slots=4, kv_blocks=64, kv_block_size=16,
                              prefill_chunk_tokens=16),
            cost_model=serve.CostModel(**CALIBRATED),
            headroom_clock=lambda: 7.25)
        sched.submit(serve.Request(rid="h0", prompt_len=80, output_len=4,
                                   arrival_s=0.0))
        sched.step()  # admitted, mid-prefill: the backlog is live
        digest = sched.headroom()
        cap = sched.capacity()
        assert digest["freeSlots"] == cap["freeSlots"] == 3
        assert digest["advertisableSlots"] == cap["advertisableSlots"]
        assert digest["freeKvBlocks"] == cap["freeKvBlocks"]
        assert digest["chunkBacklogTokens"] > 0
        assert digest["queueDepth"] == {"interactive": 0, "batch": 0}
        assert digest["prefixIndexKeys"] == 0
        assert metrics.SERVE_HEADROOM.value(dimension="free_slots") == 3.0
        assert metrics.SERVE_HEADROOM.value(
            dimension="chunk_backlog_tokens") \
            == float(digest["chunkBacklogTokens"])
        sched.run()
        last = sched.headroom()
        assert last["chunkBacklogTokens"] == 0
        digests[name] = (digest, last)
    assert digests["port"] == digests["jax"]


def test_headroom_counts_prefix_index_keys():
    """test_serve.py:1827."""
    digests = {}
    for name, (serve, _, metrics, _) in SIDES.items():
        prompt = tuple(range(32))
        sched = serve.Scheduler(
            serve.ServeConfig(slots=2, kv_blocks=32, kv_block_size=8,
                              prefix_sharing=True,
                              prefill_chunk_tokens=32),
            cost_model=serve.CostModel(**CALIBRATED),
            headroom_clock=lambda: 3.0)
        sched.submit(serve.Request(rid="pk0", prompt_len=32, output_len=2,
                                   arrival_s=0.0, prompt=prompt))
        sched.submit(serve.Request(rid="pk1", prompt_len=32, output_len=8,
                                   arrival_s=0.0, prompt=prompt))
        for _ in range(6):
            sched.step()
        digest = sched.headroom()
        assert digest["prefixIndexKeys"] > 0
        assert metrics.SERVE_HEADROOM.value(
            dimension="prefix_index_keys") > 0
        sched.run()
        digests[name] = digest
    assert digests["port"] == digests["jax"]


def test_cancel_closes_the_open_phase_span():
    """test_serve.py:1925: a cancel mid-decode closes the residency span
    (outcome cancelled), a cancel while queued closes the wait span."""
    trees = {}
    for name, (serve, flight, *_) in SIDES.items():
        flight.RECORDER.clear()
        sched = serve.Scheduler(_harness(serve, slots=1,
                                         prefill_chunk_tokens=16))
        sched.submit(serve.Request(rid="live", prompt_len=8,
                                   output_len=50, arrival_s=0.0))
        sched.submit(serve.Request(rid="waiting", prompt_len=8,
                                   output_len=4, arrival_s=0.0))
        for _ in range(4):
            sched.step()
        assert sched.cancel("live") and sched.cancel("waiting")
        events = flight.RECORDER.events(kind="serve")

        def spans(rid, span_name):
            return [e for e in events if e["name"] == span_name
                    and (e.get("attributes") or {}).get("rid") == rid]

        (decode,) = spans("live", "serve.decode")
        assert decode["attributes"]["outcome"] == "cancelled"
        assert decode["duration_s"] > 0
        (queued,) = spans("waiting", "serve.queued")
        assert queued["attributes"]["outcome"] == "cancelled"
        assert sched.pool.outstanding() == 0
        trees[name] = _span_tree(flight)
    assert trees["port"] == trees["jax"]


def test_submit_now_stamps_the_real_clock_and_trims_history():
    """``submit_now`` stamps the injected clock itself (not the cached
    ``now``); ``history_limit`` trims trace / completed / rejected while
    the totals stay monotone."""
    clock = _Clock()
    sched = tserve.Scheduler(_harness(tserve, slots=2), clock=clock)
    sched.history_limit = 5
    clock.advance(4.0)
    req = tserve.Request(rid="now0", prompt_len=4, output_len=2)
    sched.submit_now(req)
    assert req.arrival_s == 4.0 and sched.now == 0.0
    sched.submit_all([tserve.Request(rid=f"h{i}", prompt_len=4,
                                     output_len=2, arrival_s=4.0)
                      for i in range(12)])
    while sched.step():
        pass
    assert sched.completed_total == 13
    assert len(sched.completed) == 5 and len(sched.trace) == 5
