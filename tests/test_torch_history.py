"""The metrics history and trend planes of the PyTorch/CUDA port
(``utils/history.py``, ``utils/trend.py``, ``utils/metric_direction.py``)
against the reference's, on injected clocks.

The twins of tests/test_history.py:71, :99, :118, :141, :162, :190, :274,
:327, :344, :377 and :394; the anomaly Events go through the port's Event
seam (``utils/events``, a list as the sink) where the reference's go to a
FakeKube. Then the port held to the reference on the same injected
samples: the ``/debug/history`` snapshot byte for byte, the trend state,
the transitions and the Events, the serving families of
``register_serving_families`` and the watches of
``register_serving_watches``; and ``/debug/history`` served by the port's
``MetricsServer`` through ``DecodeService.debug_handlers``. No wall-clock
sleeps.
"""

from __future__ import annotations

import json

import pytest

from dpu_operator_tpu import tpuctl
from dpu_operator_tpu.k8s import events as jevents
from dpu_operator_tpu.utils import history as jhistory
from dpu_operator_tpu.utils import metrics as jmetrics
from dpu_operator_tpu.utils import trend as jtrend
from dpu_operator_tpu.utils.metric_direction import direction as jdirection
from dpu_operator_tpu_torch.utils import events, flight, history, metrics
from dpu_operator_tpu_torch.utils import trend
from dpu_operator_tpu_torch.utils.metric_direction import direction
from dpu_operator_tpu_torch.utils.metrics import MetricsServer
from dpu_operator_tpu_torch.workloads import serve as tserve


class Clock:
    def __init__(self, now: float = 0.0) -> None:
        self.now = now

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt


@pytest.fixture
def sink():
    """The port's Event seam with a list as its sink."""
    got: list = []
    events.configure(lambda reason, message, type_, series:
                     got.append((reason, message, type_, series)))
    yield got
    events.reset()


def _sampled_history(clock: Clock, module=history, **kw):
    return module.MetricsHistory(clock=clock, **kw)


# -- bounded rings ------------------------------------------------------------

def test_rings_bounded_under_10k_sample_storm():
    """test_history.py:71."""
    clock = Clock()
    h = _sampled_history(clock)
    value = [0.0]
    h.register_gauge("g", lambda: value[0])
    for i in range(10_000):
        clock.advance(1.0)
        value[0] = float(i)
        h.sample_once()
    series = h.snapshot()["series"]["g"]
    assert len(series["raw"]) == history.RAW_CAPACITY
    assert len(series["10s"]) == history.MID_CAPACITY
    assert len(series["2m"]) <= history.COARSE_CAPACITY
    assert h.total_points() <= (history.RAW_CAPACITY + history.MID_CAPACITY
                                + history.COARSE_CAPACITY)
    assert h.evicted_ring >= 10_000 - history.RAW_CAPACITY
    assert h.samples == 10_000
    assert series["raw"][-1][1] == 9999.0
    assert series["raw"][0][1] == float(10_000 - history.RAW_CAPACITY)
    assert metrics.HISTORY_POINTS.value() == h.total_points()


def test_series_cap_refuses_new_label_sets():
    """test_history.py:99."""
    clock = Clock()
    h = _sampled_history(clock, max_series=8)
    before = metrics.HISTORY_EVICTED.value(reason="series_cap")
    h.register_gauge("fam", lambda: {f"k{i:03d}": float(i)
                                     for i in range(50)})
    clock.advance(1.0)
    h.sample_once()
    assert len(h.series_names()) == 8
    assert h.refused_series == 42
    clock.advance(1.0)
    h.sample_once()
    assert len(h.series_names()) == 8
    assert h.refused_series == 84
    assert metrics.HISTORY_EVICTED.value(reason="series_cap") == before + 84


# -- downsampling, rates, quantiles -------------------------------------------

def test_downsampling_exact_on_seeded_series():
    """test_history.py:118: bucket ends, last / min / max / n; the t=7
    spike survives both downsamples in max."""
    clock = Clock()
    h = _sampled_history(clock)
    value = [0.0]
    h.register_gauge("g", lambda: value[0])
    for t in range(1, 131):
        clock.advance(1.0)
        value[0] = 999.0 if t == 7 else float(t * 2)
        h.sample_once()
    mid = h.points("g", "10s")
    assert mid[0] == (10.0, 18.0, 2.0, 999.0, 9)
    assert mid[1] == (20.0, 38.0, 20.0, 38.0, 10)
    assert h.points("g", "2m")[0] == (120.0, 238.0, 2.0, 999.0, 119)


def test_counter_stored_as_exact_windowed_rate():
    """test_history.py:141."""
    clock = Clock()
    h = _sampled_history(clock)
    total = [0.0]
    h.register_counter("c_total", lambda: total[0])
    for inc in (10.0, 10.0, 30.0, 0.0):
        clock.advance(2.0)
        total[0] += inc
        h.sample_once()
    assert h.values("c_total") == [5.0, 15.0, 0.0]
    clock.advance(2.0)
    total[0] = 1.0
    h.sample_once()
    assert h.values("c_total")[-1] == 0.0


def test_histogram_stored_as_exact_quantile_snapshots():
    """test_history.py:162, over a port ``Histogram``."""
    clock = Clock()
    hist = metrics.Histogram("test_history_quantiles_seconds", "d",
                             buckets=(0.1, 0.5, 1.0, 5.0))
    h = _sampled_history(clock)
    h.register_histogram("lat", hist)
    clock.advance(1.0)
    h.sample_once()
    for v in [0.05] * 10 + [0.3] * 80 + [0.7] * 10:
        hist.observe(v)
    clock.advance(2.0)
    h.sample_once()
    assert h.values("lat.p50") == [pytest.approx(0.3)]
    assert h.values("lat.p95") == [pytest.approx(0.75)]
    assert h.values("lat.rate") == [pytest.approx(50.0)]
    clock.advance(2.0)
    h.sample_once()
    assert h.values("lat.p50")[-1] == pytest.approx(0.3)
    assert h.values("lat.rate")[-1] == 0.0


def _seeded_snapshot(module) -> str:
    clock = Clock()
    h = _sampled_history(clock, module=module)
    value = [1.0]
    total = [0.0]
    h.register_gauge("g", lambda: {"a": value[0], "b": value[0] * 3.1})
    h.register_counter("c_total", lambda: total[0])
    for i in range(400):
        clock.advance(1.0)
        value[0] += 0.377
        total[0] += float(i % 7)
        h.sample_once()
    return json.dumps(h.snapshot(), sort_keys=True)


def test_two_seeded_runs_serialize_byte_identical_snapshots():
    """test_history.py:190, and the same bytes as the reference's."""
    assert _seeded_snapshot(history) == _seeded_snapshot(history)
    assert _seeded_snapshot(history) == _seeded_snapshot(jhistory)


# -- direction: the shared vocabulary -----------------------------------------

NAMES = [
    "serve.tokens_per_s", "serve.ttft_p99_s", "serve.itl_p50_s",
    "spec.acceptance_rate", "decode.improvement", "mfu",
    "kv.leaked_blocks", "prefill.chunk_backlog_tokens",
    "scheduler.preemptions", "cow.copies", "retraces", "steps.completed",
    "cache.hits", "per_s", "unknown.thing", "tpu_serve_ttft_seconds.p95",
    "tpu_serve_spec_acceptance_rate", "tpu_slo_burn_rate",
    "tpu_serve_kv_blocks.used", "tpu_serve_degraded_rung",
]


@pytest.mark.parametrize("name", NAMES)
def test_direction_equals_the_reference(name):
    """The copied vocabulary judges as the reference's, and the engine's
    default direction is that judgment."""
    assert direction(name) == jdirection(name)
    eng = trend.TrendEngine(_sampled_history(Clock()))
    eng.watch(name)
    assert eng._watched[name] == direction(name)


# -- trend hysteresis: the chunk-backlog scenario -----------------------------

_POLICY = dict(escalate_after=3, recover_after=4, hold_down_base_s=30.0,
               hold_down_max_s=240.0, flap_window_s=120.0)
SERIES = "tpu_serve_prefill_chunk_backlog_tokens"


def _backlog_rig(module=trend, hmodule=history, series=SERIES):
    clock = Clock()
    h = _sampled_history(clock, module=hmodule)
    value = [1000.0]
    h.register_gauge(series, lambda: value[0])
    eng = module.TrendEngine(h, policy=module.TrendPolicy(**_POLICY))
    eng.watch(series, -1)
    return clock, h, value, eng


def _step(clock, h, eng, value, factor: float) -> list:
    clock.advance(1.0)
    value[0] *= factor
    h.sample_once()
    return eng.evaluate_once()


def test_backlog_growth_fires_exactly_one_anomaly_then_clears(sink):
    """test_history.py:274: one TrendAnomaly (Warning Event through the
    port's seam, a kind=trend flight entry, the gauge at 1) for a
    20%/s ramp, held through the hold-down, cleared after recover_after
    goods (one TrendCleared, Normal)."""
    clock, h, value, eng = _backlog_rig()
    label = metrics.bounded_label(SERIES)
    flight_before = len(flight.RECORDER.events("trend"))
    transitions = []
    fired_at = None
    for _ in range(30):
        out = _step(clock, h, eng, value, 1.2)
        transitions += out
        if out:
            fired_at = clock.now
            break
    assert fired_at is not None, "anomaly never fired on a 20%/s ramp"
    for _ in range(5):
        transitions += _step(clock, h, eng, value, 1.2)
    assert [t["transition"] for t in transitions] == ["anomaly"]
    assert eng.anomalies() == [SERIES]
    assert metrics.TREND_ANOMALY.value(series=label) == 1.0
    fired = [e for e in sink if e[0] == "TrendAnomaly"]
    assert len(fired) == 1 and fired[0][2] == "Warning"
    assert SERIES in fired[0][1] and fired[0][3] == SERIES
    trend_flight = flight.RECORDER.events("trend")[flight_before:]
    assert [e["name"] for e in trend_flight] == ["TrendAnomaly"]
    assert trend_flight[0]["attributes"]["series"] == SERIES
    while clock.now < fired_at + _POLICY["hold_down_base_s"]:
        transitions += _step(clock, h, eng, value, 1.0)
        assert eng.anomalies() == [SERIES]
    for _ in range(_POLICY["recover_after"]):
        transitions += _step(clock, h, eng, value, 1.0)
    assert eng.anomalies() == []
    assert metrics.TREND_ANOMALY.value(series=label) == 0.0
    assert [t["transition"] for t in transitions] == ["anomaly", "cleared"]
    cleared = [e for e in sink if e[0] == "TrendCleared"]
    assert len(cleared) == 1 and cleared[0][2] == "Normal"


def test_steady_twin_fires_no_anomaly(sink):
    """test_history.py:327."""
    clock, h, value, eng = _backlog_rig()
    flight_before = len(flight.RECORDER.events("trend"))
    transitions = []
    for _ in range(80):
        transitions += _step(clock, h, eng, value, 1.0)
    assert transitions == [] and eng.anomalies() == []
    assert [e for e in sink
            if e[0] in ("TrendAnomaly", "TrendCleared")] == []
    assert flight.RECORDER.events("trend")[flight_before:] == []
    assert eng.state()["series"][SERIES]["verdict"] == "steady"


def test_flap_doubles_the_hold_down():
    """test_history.py:344."""
    clock, h, value, eng = _backlog_rig(series="kv.used")

    def until_anomaly(limit: int = 100) -> None:
        for _ in range(limit):
            if any(t["transition"] == "anomaly"
                   for t in _step(clock, h, eng, value, 1.2)):
                return
        raise AssertionError("anomaly never fired")

    def until_cleared(limit: int = 1000) -> float:
        start = clock.now
        for _ in range(limit):
            if any(t["transition"] == "cleared"
                   for t in _step(clock, h, eng, value, 1.0)):
                return clock.now - start
        raise AssertionError("never cleared")

    until_anomaly()
    first = until_cleared()
    until_anomaly()
    second = until_cleared()
    assert second > first + _POLICY["hold_down_base_s"] / 2


def test_unknown_direction_drifts_but_never_alarms():
    """test_history.py:377."""
    clock = Clock()
    h = _sampled_history(clock)
    value = [100.0]
    h.register_gauge("mystery.dial", lambda: value[0])
    eng = trend.TrendEngine(h, policy=trend.TrendPolicy(**_POLICY))
    eng.watch("mystery.dial")
    transitions = []
    for _ in range(60):
        transitions += _step(clock, h, eng, value, 1.3)
    assert transitions == []
    assert eng.state()["series"]["mystery.dial"]["verdict"] == "drifting"


# -- the port against the reference on the same samples -----------------------

def _scenario(module, hmodule):
    """Ramp, plateau, ramp again and a flat second series: every
    transition, the judged state after each pass and the final snapshot
    with the trend state, as the debug handler serves them."""
    clock, h, value, eng = _backlog_rig(module, hmodule)
    other = [5.0]
    h.register_gauge("tpu_serve_kv_blocks", lambda: {"used": other[0],
                                                     "free": 10.0})
    eng.watch("tpu_serve_kv_blocks.used", -1)
    transitions, states = [], []
    for factor in [1.2] * 12 + [1.0] * 60 + [1.25] * 10 + [1.0] * 100:
        other[0] += 0.01
        transitions += _step(clock, h, eng, value, factor)
        states.append(json.dumps(eng.state(), sort_keys=True))
    snap = h.snapshot()
    snap["trend"] = eng.state()
    return transitions, states, json.dumps(snap, sort_keys=True), \
        eng.digest()


def test_trend_state_transitions_and_events_equal_the_reference(sink,
                                                                monkeypatch):
    """The same samples through both packages: equal transitions, equal
    state after every pass, equal ``/debug/history`` bytes, equal digest,
    and the Events the port's seam got are the reference's (its seam
    patched to a list)."""
    ref_events: list = []
    monkeypatch.setattr(jevents, "emit",
                        lambda reason, message, type_="Normal", series="":
                        ref_events.append((reason, message, type_, series)))
    ours = _scenario(trend, history)
    theirs = _scenario(jtrend, jhistory)
    assert [t["transition"] for t in ours[0]] \
        == ["anomaly", "cleared", "anomaly", "cleared"]
    assert ours == theirs
    assert sink == ref_events
    assert [e[0] for e in sink] == ["TrendAnomaly", "TrendCleared",
                                    "TrendAnomaly", "TrendCleared"]


def _serving_run(module, hmodule, mmodule):
    """register_serving_families on a fresh history over each package's
    global metrics, the same values set and observed on both sides:
    the snapshot's serving series (TTFT / ITL quantiles among them)."""
    clock = Clock()
    h = _sampled_history(clock, module=hmodule)
    hmodule.register_serving_families(h)
    eng = module.register_serving_watches(module.TrendEngine(h))
    for i in range(40):
        mmodule.SERVE_PREFILL_BACKLOG.set(100.0 + 7 * i)
        mmodule.SERVE_KV_BLOCKS.set(float(10 + i % 5), state="used")
        mmodule.SERVE_KV_BLOCKS.set(float(50 - i % 5), state="free")
        mmodule.SERVE_SPEC_ACCEPTANCE.set(0.5 + 0.01 * (i % 3))
        mmodule.SERVE_DEGRADED_RUNG.set(0.0)
        for k in range(6):
            mmodule.SERVE_TTFT_SECONDS.observe(0.01 * (1 + (i + k) % 9))
            mmodule.SERVE_ITL_SECONDS.observe(0.002 * (1 + (i * k) % 5))
        clock.advance(1.0)
        h.sample_once()
        eng.evaluate_once()
    keep = ("tpu_serve_",)
    snap = h.snapshot()
    series = {k: v for k, v in snap["series"].items() if k.startswith(keep)}
    state = {k: v for k, v in eng.state()["series"].items()
             if k.startswith(keep)}
    return series, state


def test_serving_families_and_watches_equal_the_reference():
    ours = _serving_run(trend, history, metrics)
    theirs = _serving_run(jtrend, jhistory, jmetrics)
    assert json.dumps(ours, sort_keys=True) \
        == json.dumps(theirs, sort_keys=True)
    series, state = ours
    for name in ("tpu_serve_ttft_seconds.p50", "tpu_serve_ttft_seconds.p99",
                 "tpu_serve_itl_seconds.p50", "tpu_serve_itl_seconds.p99",
                 "tpu_serve_prefill_chunk_backlog_tokens",
                 "tpu_serve_kv_blocks.used"):
        assert len(series[name]["raw"]) >= 39, name
    assert set(state) == {s for s, _ in trend.SERVING_WATCHES}
    assert trend.SERVING_WATCHES == jtrend.SERVING_WATCHES
    assert trend.SERVING_WATCH_PREFIXES == jtrend.SERVING_WATCH_PREFIXES


# -- /debug/history over the port's MetricsServer -----------------------------

def test_debug_history_serves_snapshot_and_trend_state(monkeypatch):
    """test_history.py:394: the port's ``/debug/history`` through
    ``DecodeService.debug_handlers`` over its MetricsServer, rendered by
    tpuctl's ``render_history`` as the reference test renders its own."""
    clock = Clock()
    h = _sampled_history(clock)
    value = [10.0]
    h.register_gauge(SERIES, lambda: value[0])
    eng = trend.TrendEngine(h, policy=trend.TrendPolicy(**_POLICY))
    eng.watch(SERIES, -1)
    for _ in range(20):
        clock.advance(1.0)
        value[0] *= 1.1
        h.sample_once()
        eng.evaluate_once()
    monkeypatch.setattr(history, "HISTORY", h)
    monkeypatch.setattr(trend, "TREND", eng)
    sched = tserve.Scheduler(tserve.ServeConfig(slots=2, kv_blocks=16,
                                                kv_block_size=8))
    server = MetricsServer(
        host="127.0.0.1", port=0,
        debug_handlers=tserve.DecodeService(sched).debug_handlers())
    server.start()
    try:
        snap = flight.fetch(f"127.0.0.1:{server.port}",
                            path="/debug/history")
    finally:
        server.stop()
    assert snap["trend"] == json.loads(json.dumps(eng.state()))
    listing = tpuctl.render_history(snap)
    row = listing["series"][SERIES]
    assert row["kind"] == "gauge"
    assert row["points"]["raw"] == 20
    assert row["verdict"] in ("drifting", "anomaly")
    view = tpuctl.render_history(snap, family=SERIES)
    srow = view["series"][SERIES]
    assert len(srow["sparkline"]) == 20
    assert set(srow["sparkline"]) <= set(tpuctl._BLOCKS)
    assert srow["sparkline"][-1] == tpuctl._BLOCKS[-1]
    assert srow["trend"] == "▲"
    assert srow["last"] > srow["min"]
    assert metrics.HISTORY_SERIES.value() == 1.0


def test_decode_service_start_arms_and_stop_stops_the_planes(monkeypatch):
    """``start`` starts the profiler and the history sampler (the serving
    families registered, the watches attached); ``stop`` stops the
    sampler and leaves the profiler running, as the reference's does.
    The sampler's loop runs on an injected trigger, so nothing sleeps."""
    from dpu_operator_tpu_torch.utils import profiler

    clock = Clock()
    h = history.MetricsHistory(clock=clock, trigger=lambda: False)
    eng = trend.TrendEngine(h)
    p = profiler.SamplingProfiler(trigger=lambda: False)
    monkeypatch.setattr(history, "HISTORY", h)
    monkeypatch.setattr(history, "_wired", False)
    monkeypatch.setattr(trend, "TREND", eng)
    monkeypatch.setattr(profiler, "PROFILER", p)
    started = []
    monkeypatch.setattr(h, "start", lambda: started.append("history"))
    monkeypatch.setattr(p, "start", lambda: started.append("profiler"))
    stopped = []
    monkeypatch.setattr(h, "stop", lambda: stopped.append("history"))
    sched = tserve.Scheduler(tserve.ServeConfig(slots=2, kv_blocks=16,
                                                kv_block_size=8))
    service = tserve.DecodeService(sched)
    service.start()
    try:
        assert started == ["profiler", "history"]
        assert {"tpu_serve_ttft_seconds", "tpu_serve_itl_seconds",
                "tpu_serve_kv_blocks"} <= set(h._families)
        assert set(eng._watched) == {s for s, _ in trend.SERVING_WATCHES}
    finally:
        service.stop()
    assert stopped == ["history"]
