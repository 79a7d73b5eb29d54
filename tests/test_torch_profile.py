"""The sampling profiler of the PyTorch/CUDA port (``utils/profiler.py``)
against the reference's, on injected frames, clocks and triggers.

The twins of tests/test_profile.py:97, :118, :133, :147, :158 and :199
(the last without the reference's ``"jax"`` block: the port has no jit
compile watch), then the port's folded output and snapshot held byte for
byte to the reference's on the same injected samples, the background loop
driven by an injected trigger, and ``/debug/profile`` served by the port's
``MetricsServer`` through ``DecodeService.debug_handlers``. No test sleeps;
the 2% overhead bound of test_profile.py:169 is a wall-clock budget and is
not twinned here (``chip_smoke.py`` prints the ratio on the card).
"""

import json
import threading

import pytest

from dpu_operator_tpu import tpuctl
from dpu_operator_tpu.utils import profiler as jprofiler
from dpu_operator_tpu_torch.utils import flight as tflight
from dpu_operator_tpu_torch.utils import metrics as tmetrics
from dpu_operator_tpu_torch.utils import profiler
from dpu_operator_tpu_torch.utils.metrics import MetricsServer
from dpu_operator_tpu_torch.workloads import serve as tserve


class Clock:
    """Injected clock: advance() moves time explicitly."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class FakeCode:
    def __init__(self, filename, name):
        self.co_filename = filename
        self.co_name = name


class FakeFrame:
    def __init__(self, filename, funcname, back=None):
        self.f_code = FakeCode(filename, funcname)
        self.f_back = back


def chain(*sites):
    """A frame chain from root-first (file, fn) pairs; returns the leaf
    frame, as sys._current_frames yields it."""
    frame = None
    for filename, funcname in sites:
        frame = FakeFrame(filename, funcname, frame)
    return frame


def _profiler(frames, names, module=profiler, **kw):
    clock = Clock()
    p = module.SamplingProfiler(clock=clock, frames_fn=lambda: frames,
                                threads_fn=lambda: names, **kw)
    return p, clock


FRAMES = {
    1: chain(("/a/sched.py", "run"), ("/a/sched.py", "step"),
             ("/a/pool.py", "alloc")),
    2: chain(("/b/informer.py", "loop"), ("/b/informer.py", "poll")),
}
NAMES = {1: "decode-service", 2: "informer"}


def test_folded_output_is_byte_deterministic():
    """test_profile.py:97."""
    def run():
        p, _ = _profiler(FRAMES, NAMES)
        for _ in range(5):
            assert p.sample_once() == 2
        return p.folded()

    a, b = run(), run()
    assert a == b
    assert a == ("decode-service;sched.py:run;sched.py:step;"
                 "pool.py:alloc 5\n"
                 "informer;informer.py:loop;informer.py:poll 5")


def test_self_total_semantics_and_recursion_counted_once():
    """test_profile.py:118: a recursive site's total counts once a
    sample; only the leaf earns self."""
    frames = {7: chain(("/a/s.py", "step"), ("/a/s.py", "retry"),
                       ("/a/s.py", "step"), ("/a/p.py", "alloc"))}
    p, _ = _profiler(frames, {7: "worker"})
    for _ in range(4):
        p.sample_once()
    rows = {r["site"]: r for r in p.snapshot()["threads"]["worker"]}
    assert rows["p.py:alloc"]["self"] == 4
    assert rows["p.py:alloc"]["total"] == 4
    assert rows["s.py:step"]["self"] == 0
    assert rows["s.py:step"]["total"] == 4


def test_bounded_tables_drop_instead_of_growing():
    """test_profile.py:133: the bounded tables count their drops
    (``tpu_profile_dropped_total``) instead of growing."""
    p, _ = _profiler({}, {}, max_stacks=2, max_sites=2)
    dropped_before = tmetrics.PROFILE_DROPPED.total()
    for i in range(4):
        p.frames_fn = lambda i=i: {
            1: chain(("/x.py", f"fn{i}"), ("/x.py", f"leaf{i}"))}
        p.sample_once()
    snap = p.snapshot()
    assert len(snap["folded"].splitlines()) == 2
    assert len(snap["threads"]["thread-1"]) == 2
    assert snap["dropped"] > 0
    assert tmetrics.PROFILE_DROPPED.total() > dropped_before


def test_sampler_excludes_its_own_thread_and_never_raises():
    """test_profile.py:147: the sampling thread is not charged, and a
    failing frame source is swallowed and counted."""
    own = threading.get_ident()
    frames = {own: chain(("/me.py", "sampling")),
              5: chain(("/w.py", "work"))}
    p, _ = _profiler(frames, {own: "main", 5: "w"})
    assert p.sample_once() == 1
    assert "me.py:sampling" not in p.folded()
    before = tmetrics.SWALLOWED_ERRORS.value(site="profiler.sample")
    p.frames_fn = lambda: (_ for _ in ()).throw(RuntimeError("boom"))
    assert p.sample_once() == 0
    assert tmetrics.SWALLOWED_ERRORS.value(site="profiler.sample") \
        == before + 1


def test_top_sites_quantized_for_the_damped_digest():
    """test_profile.py:158."""
    frames = {1: chain(("/a.py", "hot")), 2: chain(("/b.py", "cold"))}
    p, _ = _profiler(frames, {1: "t1", 2: "t2"})
    for _ in range(10):
        p.sample_once()
    top = p.top_sites(2)
    assert [r["site"] for r in top] == ["a.py:hot", "b.py:cold"]
    assert all(r["selfFraction"] == 0.5 for r in top)


def test_debug_profile_handler_has_no_jax_block():
    """test_profile.py:199 without its ``"jax"`` block: the payload is the
    global profiler's snapshot, its keys the reference payload's but
    ``jax``."""
    payload = profiler.debug_handler()
    assert {"running", "samples", "folded", "overheadRatio"} <= set(payload)
    assert "jax" not in payload
    assert set(payload) == set(jprofiler.debug_handler()) - {"jax"}


# -- byte for byte against the reference --------------------------------------

def _mixed_run(module):
    """Samples over a changing frame set with costs on the injected clock:
    recursion, two threads, an unnamed ident, table overflow."""
    p, clock = _profiler({}, {1: "serve-scheduler", 2: "serve-ingress"},
                         module=module, max_stacks=6, max_sites=5)
    sets = [
        {1: chain(("/s/serve.py", "_run"), ("/s/serve.py", "step"),
                  ("/s/decode.py", "_hidden")),
         2: chain(("/s/http.py", "serve_forever"), ("/s/http.py", "poll"))},
        {1: chain(("/s/serve.py", "_run"), ("/s/serve.py", "step"),
                  ("/s/serve.py", "step"), ("/s/model.py", "layer")),
         3: chain(("/t/x.py", "main"))},
        {1: chain(("/s/serve.py", "_run"), ("/s/serve.py", "wait")),
         2: chain(("/s/http.py", "serve_forever"), ("/s/http.py", "poll"))},
        {1: chain(*[("/d/deep.py", f"f{i}") for i in range(40)])},
    ]
    for i in range(24):
        frames = sets[(i * 7) % len(sets)]
        p.frames_fn = lambda frames=frames: frames
        clock.advance(0.025)
        p.sample_once()
        clock.advance(0.0005 * (i % 3))
    return p


def test_folded_and_snapshot_equal_the_reference_byte_for_byte():
    ours, theirs = _mixed_run(profiler), _mixed_run(jprofiler)
    assert ours.folded() == theirs.folded()
    assert ours.folded().encode() == theirs.folded().encode()
    assert json.dumps(ours.snapshot(), sort_keys=True) \
        == json.dumps(theirs.snapshot(), sort_keys=True)
    assert ours.top_sites(4) == theirs.top_sites(4)
    # the depth cap keeps the 32 frames nearest the leaf
    deep = [ln for ln in ours.folded().splitlines() if "deep.py" in ln]
    assert deep and deep[0].count(";") == profiler.MAX_DEPTH


def test_reference_renderer_reads_the_port_snapshot():
    """tpuctl's profile renderer takes the port's payload as it takes the
    reference's."""
    p = _mixed_run(profiler)
    snap = p.snapshot()
    assert tpuctl.render_profile(snap) \
        == tpuctl.render_profile(_mixed_run(jprofiler).snapshot())


# -- the background loop on an injected trigger -------------------------------

def test_background_loop_runs_on_the_injected_trigger_and_stops():
    """The loop samples once per trigger and exits when the trigger says
    so; a raising trigger ends the loop (counted), never the process."""
    ticks = threading.Semaphore(0)
    done = threading.Event()
    budget = [3]

    def trigger():
        if budget[0] == 0:
            done.set()
            return False
        budget[0] -= 1
        ticks.release()
        return True

    p, _ = _profiler({1: chain(("/a.py", "hot"))}, {1: "t1"},
                     trigger=trigger)
    p.start()
    assert done.wait(10)
    p.stop()
    assert not p.running
    assert p.snapshot()["samples"] == 3
    before = tmetrics.SWALLOWED_ERRORS.value(site="profiler.trigger")
    broken, _ = _profiler({}, {}, trigger=lambda: 1 / 0)
    broken.start()
    broken._thread.join(10)
    assert not broken.running
    assert tmetrics.SWALLOWED_ERRORS.value(site="profiler.trigger") \
        == before + 1


# -- /debug/profile over the port's MetricsServer -----------------------------

def test_debug_profile_served_through_the_decode_service(monkeypatch):
    """``DecodeService.debug_handlers`` serves ``/debug/profile``: the
    global profiler's payload over the port's MetricsServer, read by
    tpuctl's renderer; ``tpu_profile_*`` gauges refreshed."""
    p = _mixed_run(profiler)
    monkeypatch.setattr(profiler, "PROFILER", p)
    sched = tserve.Scheduler(tserve.ServeConfig(slots=2, kv_blocks=16,
                                                kv_block_size=8))
    service = tserve.DecodeService(sched)
    server = MetricsServer(host="127.0.0.1", port=0,
                           debug_handlers=service.debug_handlers())
    server.start()
    try:
        payload = tflight.fetch(f"127.0.0.1:{server.port}",
                                path="/debug/profile")
    finally:
        server.stop()
    assert payload == json.loads(json.dumps(p.snapshot()))
    assert "serve-scheduler" in payload["threads"]
    assert payload["folded"] == p.folded()
    assert tmetrics.PROFILE_TRACKED_SITES.value() == payload["trackedSites"]
    assert tpuctl.render_profile(payload)["samples"] == payload["samples"]


@pytest.mark.parametrize("name", ["PROFILE_SAMPLES", "PROFILE_DROPPED",
                                  "PROFILE_OVERHEAD",
                                  "PROFILE_TRACKED_SITES"])
def test_profile_families_equal_the_reference(name):
    from dpu_operator_tpu.utils import metrics as jmetrics
    ours, ref = getattr(tmetrics, name), getattr(jmetrics, name)
    assert (ours.name, ours.help, type(ours).__name__) \
        == (ref.name, ref.help, type(ref).__name__)
    assert (profiler.MAX_STACKS, profiler.MAX_SITES, profiler.MAX_DEPTH,
            profiler.DEFAULT_INTERVAL_S) \
        == (jprofiler.MAX_STACKS, jprofiler.MAX_SITES, jprofiler.MAX_DEPTH,
            jprofiler.DEFAULT_INTERVAL_S)
