"""Serving under faults in the PyTorch/CUDA port, on the CPU, against the
JAX package: the twin of tests/test_serve_chaos.py.

Each contract of the JAX file runs the JAX and the port scheduler side by
side, each over its own package's ``SimExecutor`` wrapped in its own
``ChaosExecutor``, under fault plans built from the same seed and script.
Their traces, counters, outcomes and fault logs must be equal, and the
JAX test's own assertions (less its metrics and Events, which
tests/test_torch_ledger.py holds against the JAX scheduler's) must hold on
the port. Then the regressions of the port's
old fault handling, and the real model through ``TorchSlotExecutor``:
scripted faults retry their victims and every stream still equals the
port's ``generate`` bit for bit.

Injected clocks and seeded RNGs only (the serve_chaos marker carries the
chaos-determinism lint rule). Nothing here writes a file.
"""

import math
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpu_operator_tpu.testing import chaos as jchaos
from dpu_operator_tpu.utils import resilience as jres
from dpu_operator_tpu.utils import slo
from dpu_operator_tpu.workloads import degrade as jdegrade
from dpu_operator_tpu.workloads import model as jmodel
from dpu_operator_tpu.workloads import serve as jserve
from dpu_operator_tpu_torch.testing import chaos as tchaos
from dpu_operator_tpu_torch.utils import resilience as tres
from dpu_operator_tpu_torch.workloads import decode as tdecode
from dpu_operator_tpu_torch.workloads import degrade as tdegrade
from dpu_operator_tpu_torch.workloads import model as tmodel
from dpu_operator_tpu_torch.workloads import serve as tserve

pytestmark = pytest.mark.serve_chaos

SEED = 20260806
#: (serve module, chaos module) of each side
SIDES = {"jax": (jserve, jchaos), "port": (tserve, tchaos)}
#: counters both schedulers keep, compared after every twin run
COUNTERS = ("completed_total", "rejected_total", "failed_total",
            "poisoned_total", "deadline_exceeded_total", "retries_total",
            "iterations", "preemptions", "prefill_chunks_total",
            "prefill_tokens_discarded", "spec_rows_total")


def _config(serve, **kw):
    base = dict(slots=4, kv_blocks=64, kv_block_size=16, queue_limit=256)
    base.update(kw)
    return serve.ServeConfig(**base)


def _expected_tokens(serve, req) -> list:
    """The SimExecutor stream is a pure function of (rid, position): the
    oracle every rebuilt request must still match exactly."""
    return [serve.SimExecutor._token(req, i) for i in range(req.output_len)]


def _p99(xs: list) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, math.ceil(0.99 * len(xs)) - 1))]


class Clock:
    """Injected clock: Stall faults call ``advance``, so an executor hang
    costs no wall time and replays exactly."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _side(name, config, requests, script=None, poison=(), cost=None,
          clock=None, drive=None):
    """One side's run: its SimExecutor in its ChaosExecutor under
    ``script(plan, chaos, clock)``, the requests ``requests(serve)``, then
    ``run()`` or ``drive(sched, ex)``."""
    serve, chaos = SIDES[name]
    plan = chaos.FaultPlan(seed=SEED)
    if script is not None:
        script(plan, chaos, clock)
    ex = chaos.ChaosExecutor(serve.SimExecutor(), plan=plan).poison(*poison)
    sched = serve.Scheduler(_config(serve, **config), executor=ex,
                            cost_model=serve.CostModel(**cost)
                            if cost else None, clock=clock)
    for r in requests(serve):
        sched.submit(r)
    if drive is None:
        assert sched.run(max_steps=500_000) < 500_000
    else:
        drive(sched, ex)
    return sched


def _outcomes(sched) -> dict:
    return {
        "trace": sched.trace,
        "counters": [getattr(sched, c) for c in COUNTERS],
        "completed": [(r.rid, r.tokens, r.retries, r.first_token_s,
                       r.finish_s) for r in sched.completed],
        "failed": [(r.rid, r.reject_reason, len(r.tokens), r.prefilled)
                   for r in sched.failed],
        "rejected": [(r.rid, r.reject_reason) for r in sched.rejected],
        "recoveries": sched.retry_recoveries,
        "injected": sched.executor.plan.injected,
        "ladder": sched.ladder.snapshot(sched.now),
        "now": sched.now,
        "outstanding": sched.pool.outstanding(),
        "capacity": sched.capacity(),
    }


def _twin(config, requests, **kw):
    """The same run through the JAX and the port scheduler: every outcome
    must be equal. Returns the port's scheduler."""
    clocks = kw.pop("clocks", None)
    runs = {}
    for name in SIDES:
        clock = clocks() if clocks else None
        runs[name] = _side(name, config, requests, clock=clock, **kw)
    ours, theirs = _outcomes(runs["port"]), _outcomes(runs["jax"])
    for key in ours:
        assert ours[key] == theirs[key], key
    return runs["port"]


def _reqs(*specs):
    """``requests(serve)`` for the given Request keyword dicts, the class
    given by name ("interactive" / "batch")."""
    def make(serve):
        return [serve.Request(**spec) for spec in specs]
    return make


# -- retry-with-rebuild -------------------------------------------------------


def test_transient_step_fault_retries_and_stream_survives_bitwise():
    """One decode-step failure costs its victim one retry / rebuild round
    trip; every completed stream, the victim's included, equals the
    unfaulted oracle."""
    def script(plan, chaos, _clock):
        plan.script("step", chaos.Ok(times=3), chaos.Fail())

    sched = _twin({}, _reqs(
        dict(rid="a", prompt_len=8, output_len=12, slo_class="interactive"),
        dict(rid="b", prompt_len=8, output_len=12, slo_class="batch")),
        script=script)
    assert sched.completed_total == 2 and not sched.failed
    assert sched.retries_total == 1
    faults = [t for t in sched.trace if t[0] == "step_fault"]
    assert faults == [("step_fault", faults[0][1], "decode", faults[0][3],
                       "ConnectionResetError")]
    victim_rid = faults[0][3]
    assert [t for t in sched.trace if t[0] == "retry"] \
        == [("retry", faults[0][1], victim_rid, 1)]
    for req in sched.completed:
        assert req.tokens == _expected_tokens(tserve, req)
    victim = next(r for r in sched.completed if r.rid == victim_rid)
    assert victim.retries == 1
    assert [rid for rid, _ in sched.retry_recoveries] == [victim_rid]
    assert sched.retry_recoveries[0][1] > 0.0
    assert sched.pool.outstanding() == 0


def test_allocation_oom_is_transient_and_takes_the_retry_path():
    def script(plan, chaos, _clock):
        plan.script("step", chaos.Ok(times=2), chaos.Oom())

    sched = _twin({}, _reqs(dict(rid="oomed", prompt_len=8, output_len=10)),
                  script=script)
    assert sched.completed_total == 1 and not sched.failed
    assert sched.retries_total == 1
    (fault,) = [t for t in sched.trace if t[0] == "step_fault"]
    assert fault[4] == "ExecutorOom"
    assert sched.completed[0].tokens \
        == _expected_tokens(tserve, sched.completed[0])
    assert sched.pool.outstanding() == 0


def test_stall_past_the_deadline_on_an_injected_clock_is_excised():
    """A Stall moves each side's injected clock past the deadline while
    the step hangs; the victim is excised with its partial tokens."""
    def script(plan, chaos, clock):
        plan.script("step", chaos.Ok(times=2),
                    chaos.Stall(2.0, clock.advance))

    sched = _twin({}, _reqs(dict(rid="hung", prompt_len=8, output_len=40,
                                 deadline_budget_s=1.5)),
                  script=script, clocks=Clock)
    (hung,) = sched.failed
    assert hung.rid == "hung" and hung.reject_reason == "deadline_exceeded"
    assert 0 < len(hung.tokens) < hung.output_len
    assert sched.deadline_exceeded_total == 1
    assert sched.pool.outstanding() == 0
    assert sched.now == pytest.approx(2.0)


def test_poisoned_rid_is_excised_within_budget():
    """A rid failing every executor call burns exactly its retry budget,
    then is excised as ``poisoned``; its stream sees one terminal record;
    the innocent request completes untouched."""
    seen = {}

    def requests(serve):
        log = seen.setdefault(serve.__name__, [])
        return [serve.Request(rid="good", prompt_len=8, output_len=8),
                serve.Request(rid="bad", prompt_len=8, output_len=8,
                              slo_class="interactive",
                              stream=lambda ev, val: log.append((ev, val)))]

    sched = _twin({}, requests, poison=("bad",))
    (good,) = sched.completed
    assert good.rid == "good" \
        and good.tokens == _expected_tokens(tserve, good)
    (bad,) = sched.failed
    assert bad.rid == "bad" and bad.state == tserve.FAILED
    assert bad.reject_reason == "poisoned" and bad not in sched.rejected
    retries = [t for t in sched.trace if t[0] == "retry"]
    assert retries == [("retry", t[1], "bad", i + 1)
                       for i, t in enumerate(retries)]
    assert len(retries) == tserve.RETRY_BUDGET
    (poison,) = [t for t in sched.trace if t[0] == "poison"]
    assert poison[2] == "bad" and poison[3] == tserve.RETRY_BUDGET
    assert sched.poisoned_total == 1 and sched.failed_total == 1
    assert sched.pool.outstanding() == 0
    port_seen = seen[tserve.__name__]
    assert port_seen == seen[jserve.__name__]
    assert port_seen[-1] == ("failed", "poisoned")
    assert [e for e in port_seen if e[0] != "token"] == [("failed",
                                                          "poisoned")]


def test_batched_step_fault_attributes_the_actual_victim():
    """A PoisonedRid out of a batched step names its rid: the scheduler
    bills the actual victim, not the latest-admitted guess."""
    def drive(sched, ex):
        for _ in range(4):
            sched.step()
        ex.poison("v")
        assert sched.run(max_steps=10_000) < 10_000

    sched = _twin({}, _reqs(
        dict(rid="v", prompt_len=8, output_len=20, slo_class="interactive"),
        dict(rid="w", prompt_len=8, output_len=20)), drive=drive)
    faults = [t for t in sched.trace if t[0] == "step_fault"]
    assert faults and all(t[3] == "v" and t[4] == "PoisonedRid"
                          for t in faults)
    (bad,) = sched.failed
    assert bad.rid == "v" and bad.reject_reason == "poisoned"
    (w,) = sched.completed
    assert w.rid == "w" and w.tokens == _expected_tokens(tserve, w)
    assert sched.pool.outstanding() == 0


# -- the seeded storm: ladder, SLO, determinism -------------------------------


def _storm_arrivals(serve):
    return [serve.Request(rid=r.rid, prompt_len=r.prompt_len,
                          output_len=r.output_len, slo_class=r.slo_class,
                          arrival_s=r.arrival_s)
            for r in jserve.open_loop_arrivals(
                SEED, rate_rps=6.0, horizon_s=8.0, prompt_lens=(8, 32),
                output_lens=(8, 32), interactive_frac=0.5)]


def _storm_script(plan, chaos, _clock):
    plan.script("step", chaos.Ok(times=40), chaos.Fail(times=2),
                chaos.Ok(times=30), chaos.Fail(times=2))


def _storm_run(name="port"):
    return _side(name, dict(slots=4, kv_blocks=96, queue_limit=512),
                 _storm_arrivals, script=_storm_script)


def test_storm_sheds_batch_holds_interactive_slo_and_recovers():
    """Two Fail bursts walk the ladder down twice (the second doubles the
    hold-down), batch arrivals are shed with ``degraded_shed``, the
    interactive TTFT SLO holds, and the ladder recovers to healthy; the
    rung tuples stand in for the reference's Events."""
    sched = _twin(dict(slots=4, kv_blocks=96, queue_limit=512),
                  _storm_arrivals, script=_storm_script)
    assert len(sched.executor.plan.injected) == 4
    assert sched.ladder.escalations >= 2
    assert sched.ladder.holddown_doublings >= 1
    assert sched.ladder.rung == tdegrade.RUNG_HEALTHY
    rungs = [t for t in sched.trace if t[0] == "rung"]
    assert any(t[3] > t[2] for t in rungs)
    assert any(t[3] < t[2] for t in rungs)
    assert rungs[-1][3] == tdegrade.RUNG_HEALTHY
    shed = [r for r in sched.rejected if r.reject_reason == "degraded_shed"]
    assert shed and all(r.slo_class == tserve.BATCH for r in shed)
    ttfts = [r.ttft_s for r in sched.completed
             if r.slo_class == tserve.INTERACTIVE]
    assert ttfts and _p99(ttfts) <= slo.SERVE_TTFT_SLOW_SECONDS
    for req in sched.completed:
        assert req.tokens == _expected_tokens(tserve, req)
    assert sched.retries_total >= 1
    assert sched.pool.outstanding() == 0


def test_storm_traces_are_bit_identical_across_runs():
    a, b = _storm_run(), _storm_run()
    assert a.trace == b.trace
    assert [r.rid for r in a.completed] == [r.rid for r in b.completed]
    assert [(r.rid, r.reject_reason) for r in a.failed] \
        == [(r.rid, r.reject_reason) for r in b.failed]
    assert [(r.rid, r.reject_reason) for r in a.rejected] \
        == [(r.rid, r.reject_reason) for r in b.rejected]
    assert a.retry_recoveries == b.retry_recoveries
    assert a.ladder.snapshot(a.now) == b.ladder.snapshot(b.now)


# -- 500 fault / retry / rebuild lifecycles: the leak gate --------------------


def _lifecycles(serve):
    rng = random.Random(SEED)
    out, t = [], 0.0
    for i in range(520):
        t += rng.expovariate(8.0)
        out.append(serve.Request(
            rid=f"life{i}", prompt_len=rng.randint(4, 64),
            output_len=rng.randint(1, 48),
            slo_class=serve.INTERACTIVE if rng.random() < 0.4
            else serve.BATCH, arrival_s=t))
    return out


def test_kv_never_leaks_across_500_fault_lifecycles():
    """520 lifecycles through a seeded 3% step-fault and 1% begin-fault
    storm with two poisoned rids: every request ends terminally, every
    rebuilt stream matches the oracle, the pool drains to zero, and both
    schedulers agree on all of it (the MTTR samples included)."""
    def script(plan, chaos, _clock):
        plan.flaky("step", 0.03, n=8000)
        plan.flaky("begin", 0.01, n=1000)

    cfg = dict(slots=6, kv_blocks=96, queue_limit=1000)
    sched = _twin(cfg, _lifecycles, script=script,
                  poison=("life100", "life300"))
    assert (sched.completed_total + sched.failed_total
            + sched.rejected_total) == 520
    assert sched.completed_total >= 300
    assert all(r.reject_reason == "degraded_shed" for r in sched.rejected)
    assert sched.ladder.escalations >= 1
    assert sched.retries_total >= 20
    assert len(sched.executor.plan.injected) >= 20
    assert sched.retry_recoveries
    failed = {r.rid: r.reject_reason for r in sched.failed}
    assert failed.get("life100") == "poisoned"
    assert failed.get("life300") == "poisoned"
    assert set(failed.values()) == {"poisoned"}
    assert any(r.retries for r in sched.completed)
    for req in sched.completed:
        assert req.tokens == _expected_tokens(tserve, req)
    assert sched.pool.outstanding() == 0
    assert len(sched._free_slots) == cfg["slots"]
    assert not sched._prefilling


# -- the degradation ladder (pure state machine) ------------------------------


def test_ladder_escalates_only_on_consecutive_bads():
    lad = tdegrade.DegradationLadder()
    assert lad.observe(0.0, True) is None
    assert lad.observe(0.1, False) is None
    assert lad.observe(0.2, True) is None
    change = lad.observe(0.3, True)
    assert change == tdegrade.RungChange(0, 1, "degraded")
    assert lad.rung == tdegrade.RUNG_SHED_BATCH
    assert lad.escalations == 1


def test_ladder_ignores_goods_during_hold_down_then_recovers():
    lad = tdegrade.DegradationLadder()
    lad.observe(0.0, True)
    lad.observe(0.1, True)
    assert lad.rung == 1 and lad.hold_remaining_s(0.1) == 2.0
    for i in range(6):
        assert lad.observe(0.2 + i * 0.1, False) is None
    assert lad.rung == 1
    now = 2.5
    for i in range(3):
        assert lad.observe(now + i * 0.1, False) is None
    change = lad.observe(now + 0.4, False)
    assert change == tdegrade.RungChange(1, 0, "recovered")
    assert lad.rung == tdegrade.RUNG_HEALTHY


def test_ladder_reescalation_in_flap_window_doubles_hold_down():
    lad = tdegrade.DegradationLadder()
    lad.observe(0.0, True)
    lad.observe(0.1, True)
    lad.observe(1.0, True)
    lad.observe(1.1, True)
    assert lad.rung == 2
    assert lad.holddown_doublings == 1
    assert lad.hold_remaining_s(1.1) == pytest.approx(4.0)
    lad.observe(100.0, True)
    lad.observe(100.1, True)
    assert lad.hold_remaining_s(100.1) == 2.0


def test_ladder_hold_down_is_capped_and_top_rung_is_terminal():
    pol = tdegrade.LadderPolicy(hold_down_base_s=2.0, hold_down_max_s=8.0)
    lad = tdegrade.DegradationLadder(pol)
    t = 0.0
    for _ in range(10):
        lad.observe(t, True)
        lad.observe(t + 0.1, True)
        t += 1.0
        if lad.rung == tdegrade.RUNG_INTERACTIVE_ONLY:
            break
    assert lad.rung == tdegrade.RUNG_INTERACTIVE_ONLY
    for _ in range(5):
        assert lad.observe(t, True) is None
        t += 0.1
    assert lad.rung == tdegrade.RUNG_INTERACTIVE_ONLY
    assert lad._hold_s <= pol.hold_down_max_s
    snap = lad.snapshot(t)
    assert snap["name"] == "interactive_only"
    assert set(snap) == {"rung", "name", "escalations",
                         "holddownDoublings", "holdRemainingS"}


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_ladder_matches_jax_on_a_random_signal_stream(seed):
    """The same seeded (time, signal) stream into both ladders: the same
    change at every step and the same snapshot at the end."""
    rng = np.random.default_rng(seed)
    ours, theirs = tdegrade.DegradationLadder(), jdegrade.DegradationLadder()
    t = 0.0
    for _ in range(2000):
        t += float(rng.exponential(0.2))
        bad = bool(rng.random() < 0.35)
        got, want = ours.observe(t, bad), theirs.observe(t, bad)
        assert (got and (got.old, got.new, got.reason)) \
            == (want and (want.old, want.new, want.reason))
    assert ours.snapshot(t) == theirs.snapshot(t)
    assert ours.escalations > 3
    assert tdegrade.RUNGS == jdegrade.RUNGS


# -- hostile deadline-header parsing ------------------------------------------

HOSTILE_DEADLINES = [
    (None, None), (123, None), (b"100", None), ("", None), ("-5", None),
    ("+5", None), ("NaN", None), ("1e3", None), ("1.5", None),
    (" 100", None), ("100 ", None), ("0", None), ("86400001", None),
    ("999999999", None), ("100\r\nX-Evil: 1", None), ("0x64", None),
    ("1", 1), ("1500", 1500), ("86400000", 86_400_000),
]


@pytest.mark.parametrize("value,expected", HOSTILE_DEADLINES)
def test_parse_deadline_ms_hostile_table(value, expected):
    assert tserve.parse_deadline_ms(value) == expected
    assert jserve.parse_deadline_ms(value) == expected
    assert tserve.DEADLINE_HEADER == jserve.DEADLINE_HEADER
    assert tserve.MAX_DEADLINE_MS == jserve.MAX_DEADLINE_MS


# -- deadline enforcement: admission, chunk re-entry, mid-stream --------------


def test_deadline_rejected_at_admission_when_eta_cannot_fit():
    seen = {}

    def requests(serve):
        log = seen.setdefault(serve.__name__, [])
        return [serve.Request(rid="late", prompt_len=8, output_len=400,
                              deadline_budget_s=0.05,
                              stream=lambda ev, val: log.append((ev, val)))]

    sched = _twin({}, requests)
    (late,) = sched.failed
    assert late.reject_reason == "deadline_exceeded"
    assert late.tokens == [] and late.first_token_s is None
    assert sched.deadline_exceeded_total == 1
    assert [t for t in sched.trace if t[0] == "deadline"] \
        == [("deadline", 1, "late", 0)]
    assert seen[tserve.__name__] == seen[jserve.__name__] \
        == [("deadline_exceeded", 0)]
    assert sched.pool.outstanding() == 0


def test_deadline_enforced_at_chunk_queue_reentry():
    sched = _twin(
        dict(kv_blocks=96, queue_limit=64, prefill_chunk_tokens=16),
        _reqs(dict(rid="i0", prompt_len=8, output_len=40,
                   slo_class="interactive"),
              dict(rid="i1", prompt_len=8, output_len=40,
                   slo_class="interactive"),
              dict(rid="crawl", prompt_len=256, output_len=4,
                   deadline_budget_s=0.2)))
    (crawl,) = sched.failed
    assert crawl.rid == "crawl"
    assert crawl.reject_reason == "deadline_exceeded"
    assert crawl.prefilled > 0 and crawl.tokens == []
    assert len(sched.completed) == 2
    assert sched.pool.outstanding() == 0


CONTENDED = dict(decode_base_s=0.02, decode_per_seq_s=0.01)


def test_deadline_enforced_mid_stream_with_partial_tokens():
    seen = {}

    def requests(serve):
        log = seen.setdefault(serve.__name__, [])
        return [serve.Request(rid=f"bg{i}", prompt_len=8, output_len=30)
                for i in range(3)] + [serve.Request(
                    rid="victim", prompt_len=8, output_len=30,
                    slo_class="interactive", deadline_budget_s=1.2,
                    stream=lambda ev, val: log.append((ev, val)))]

    sched = _twin({}, requests, cost=CONTENDED)
    (victim,) = sched.failed
    assert victim.rid == "victim"
    assert victim.reject_reason == "deadline_exceeded"
    assert 0 < len(victim.tokens) < victim.output_len
    assert seen[tserve.__name__] == seen[jserve.__name__]
    assert seen[tserve.__name__][-1] == ("deadline_exceeded",
                                         len(victim.tokens))
    assert len(sched.completed) == 3
    assert sched.pool.outstanding() == 0


def test_completion_wins_the_deadline_race_and_excision_is_idempotent():
    base = _side("port", {}, _reqs(*(dict(rid=f"r{i}", prompt_len=8,
                                           output_len=16)
                                      for i in range(4))), cost=CONTENDED)
    finish = next(r for r in base.completed if r.rid == "r1").finish_s
    specs = [dict(rid=f"r{i}", prompt_len=8, output_len=16)
             for i in range(4)]
    specs[1]["deadline_budget_s"] = finish - 0.005
    race = _twin({}, _reqs(*specs), cost=CONTENDED)
    b = next(r for r in race.completed if r.rid == "r1")
    assert b.finish_s > b.deadline_s
    assert race.deadline_exceeded_total == 0 and not race.failed

    def drive(sched, _ex):
        assert sched.run(max_steps=10_000) < 10_000
        assert sched.failed[0].reject_reason == "deadline_exceeded"
        assert sched.pool.outstanding() == 0
        assert sched.cancel("gone") is False

    late = _twin({}, _reqs(dict(rid="gone", prompt_len=8, output_len=400,
                                deadline_budget_s=0.05)), drive=drive)
    assert late.pool.outstanding() == 0
    assert late.failed_total == 1 and late.rejected_total == 0


# -- cancel, the slo alert probe, capacity ------------------------------------


def test_fresh_copy_keeps_the_spec_and_drops_the_run():
    """A rerun's copy carries id, lengths, class, arrival, prompt and
    deadline budget, and none of the first run's state or stream."""
    copies = {}
    for name, (serve, _chaos) in SIDES.items():
        req = serve.Request(rid="r", prompt_len=3, output_len=5,
                            slo_class=serve.INTERACTIVE, arrival_s=0.25,
                            prompt=(1, 2, 3), deadline_budget_s=0.5,
                            stream=print)
        sched = serve.Scheduler(_config(serve), executor=serve.SimExecutor())
        sched.submit(req)
        sched.run()
        copy = req.fresh_copy()
        assert req.state == serve.DONE and copy.state == serve.QUEUED
        copies[name] = (copy.rid, copy.prompt_len, copy.output_len,
                        copy.slo_class, copy.arrival_s, copy.prompt,
                        copy.deadline_budget_s, copy.deadline_s,
                        copy.tokens, copy.retries, copy.stream)
    assert copies["port"] == copies["jax"]
    assert copies["port"][-4:] == (None, [], 0, None)


def test_cancel_from_pending_queue_prefill_and_decode():
    """cancel() removes a request wherever it is: a future arrival, the
    queue, the chunk queue, a decoding slot; an unknown rid is a no-op."""
    answers = {}

    def drive(sched, _ex):
        got = [sched.cancel("future")]
        for _ in range(3):
            sched.step()
        got += [sched.cancel(rid) for rid in ("queued", "chunking",
                                              "decoding", "nobody")]
        assert sched.run(max_steps=10_000) < 10_000
        answers[type(sched).__module__] = got

    sched = _twin(
        dict(slots=2, prefill_chunk_tokens=16),
        _reqs(dict(rid="decoding", prompt_len=8, output_len=30),
              dict(rid="chunking", prompt_len=200, output_len=4),
              dict(rid="queued", prompt_len=8, output_len=4),
              dict(rid="future", prompt_len=8, output_len=4,
                   arrival_s=50.0)),
        drive=drive)
    assert answers[tserve.__name__] == answers[jserve.__name__] \
        == [True, True, True, True, False]
    cancels = [t for t in sched.trace if t[0] == "cancel"]
    assert [t[2] for t in cancels] == ["future", "queued", "chunking",
                                       "decoding"]
    assert all(r.reject_reason == "cancelled" for r in sched.rejected)
    assert sched.rejected_total == 4 and sched.completed_total == 0
    assert sched.pool.outstanding() == 0


def test_slo_alert_probe_walks_the_ladder_and_a_broken_probe_is_ignored():
    """The ladder's second signal: a firing serve-SLO alert escalates it
    as faults do, and a probe that raises counts as not firing."""
    def drive(sched, _ex):
        calls = {"n": 0}

        def probe():
            calls["n"] += 1
            if calls["n"] > 30:
                raise RuntimeError("probe broke")
            return 5 <= calls["n"] <= 12

        sched.slo_alert_fn = probe
        assert sched.run(max_steps=10_000) < 10_000

    sched = _twin({}, _reqs(*(dict(rid=f"s{i}", prompt_len=8,
                                   output_len=60, arrival_s=0.1 * i)
                              for i in range(6))), drive=drive)
    rungs = [t for t in sched.trace if t[0] == "rung"]
    assert rungs and rungs[0][2:] == (0, 1)
    assert max(t[3] for t in rungs) >= 2
    assert sched.completed_total + sched.rejected_total == 6


@pytest.mark.parametrize("const,field", [
    ("RETRY_BUDGET", "retry_budget"),
    ("RETRY_BACKOFF_BASE_S", "retry_backoff_base_s"),
    ("RETRY_BACKOFF_CAP_S", "retry_backoff_cap_s"),
    ("TYPICAL_TOKENS", "typical_tokens")])
def test_fault_constants_are_the_jax_config_defaults(const, field):
    """The port fixes as constants what the reference's ServeConfig leaves
    settable: they must hold its defaults, which every twin here runs."""
    assert getattr(tserve, const) == getattr(jserve.ServeConfig(), field)


@pytest.mark.parametrize("rung", range(5))
def test_capacity_is_derated_by_the_ladder_as_jax_does(rung):
    caps = {}
    for name, (serve, _chaos) in SIDES.items():
        sched = serve.Scheduler(_config(serve, slots=8, kv_blocks=40),
                                executor=serve.SimExecutor())
        sched.submit(serve.Request(rid="x", prompt_len=100, output_len=60))
        sched.step()
        sched.ladder.rung = rung
        caps[name] = sched.capacity()
    assert caps["port"] == caps["jax"]
    # 7 free slots, 30 free blocks: 3 typical requests' worth
    want = {0: 3, 1: 3, 2: 3, 3: 2, 4: 0}[rung]
    assert caps["port"]["advertisableSlots"] == want


# -- the port's copies: retry backoff, fault plans, the chaos wrapper ---------


@pytest.mark.parametrize("base,cap", [(0.05, 1.0), (0.01, 0.3), (1.0, 2.0)])
def test_retry_backoff_replays_the_jax_jitter(base, cap):
    ours = tres.RetryPolicy(max_attempts=3, base=base, cap=cap,
                            rng=random.Random(0x5E17E))
    theirs = jres.RetryPolicy(max_attempts=3, base=base, cap=cap,
                              rng=random.Random(0x5E17E))
    for attempt in [0, 1, 2, 0, 5, 3, 1] * 4:
        got = ours.backoff(attempt)
        assert got == theirs.backoff(attempt)
        assert 0.0 <= got <= min(cap, base * 2 ** attempt)
    with pytest.raises(ValueError):
        tres.RetryPolicy(max_attempts=0)


@pytest.mark.parametrize("seed", [0, 7, SEED])
def test_fault_plan_injects_what_the_jax_plan_injects(seed):
    """Same seed, same script: the same faults in the same order, the
    same injected log, the same exhaustion."""
    plans = {}
    for name, (_serve, chaos) in SIDES.items():
        plan = chaos.FaultPlan(seed=seed)
        plan.flaky("step", 0.3, n=40)
        plan.script("begin", chaos.Ok(times=2), chaos.Oom(),
                    chaos.Fail(times=0), chaos.Fail(times=2))
        plan.script("*", chaos.Oom())
        outcomes = []
        for key in ["step", "begin", "prefill_chunk"] * 20:
            try:
                outcomes.append(plan.run(key, lambda: "ok"))
            except Exception as e:  # noqa: BLE001 — recorded and compared
                outcomes.append(type(e).__name__)
        plans[name] = (outcomes, plan.injected, plan.exhausted())
    assert plans["port"] == plans["jax"]
    assert "ExecutorOom" in plans["port"][0]


def test_chaos_executor_passes_capabilities_and_poisons_by_rid():
    inner = tserve.SimExecutor()
    inner.chunk_capacity, inner.spec_width = 256, 5
    ex = tchaos.ChaosExecutor(inner).poison("bad")
    assert (ex.prefix_aware, ex.chunk_capacity, ex.spec_width) \
        == (True, 256, 5)
    req = tserve.Request(rid="bad", prompt_len=4, output_len=2)
    for call in (lambda: ex.begin(req, 0),
                 lambda: ex.prefill_chunk(req, 0, 0, 4),
                 lambda: ex.step([(0, req)]),
                 lambda: ex.spec_step([(0, req)], {})):
        with pytest.raises(tchaos.PoisonedRid) as info:
            call()
        assert info.value.rid == "bad"
    assert not ex.plan.injected
    stalled = Clock()
    plan = tchaos.FaultPlan().script(
        "step", tchaos.Stall(2.5, stalled.advance), tchaos.FailAfter())
    ex = tchaos.ChaosExecutor(tserve.SimExecutor(), plan=plan)
    good = tserve.Request(rid="good", prompt_len=4, output_len=2)
    assert ex.step([(0, good)]) == tserve.SimExecutor().step([(0, good)])
    assert stalled.t == 2.5
    with pytest.raises(ConnectionResetError):
        ex.step([(0, good)])
    assert plan.injected == [("step", "Stall"), ("step", "FailAfter")]


# -- regressions of the port's old fault handling -----------------------------


class _Raising(tserve.PeriodicSimExecutor):
    """A period-4 synthetic executor whose *method* raises *exc* on its
    call number *at*."""

    def __init__(self, method, exc, at=1):
        super().__init__(4)
        self.method, self.exc, self.at, self.calls = method, exc, at, 0

    def _maybe(self):
        self.calls += 1
        if self.calls == self.at:
            raise self.exc

    def begin(self, req, slot):
        if self.method == "begin":
            self._maybe()
        return super().begin(req, slot)

    def prefill_chunk(self, req, slot, offset, n):
        if self.method == "prefill_chunk":
            self._maybe()
        return super().prefill_chunk(req, slot, offset, n)

    def step(self, active):
        if self.method == "step":
            self._maybe()
        return super().step(active)

    def spec_step(self, active, drafts):
        if self.method == "spec_step":
            self._maybe()
        return super().spec_step(active, drafts)


def _two(ex, **kw):
    sched = tserve.Scheduler(tserve.ServeConfig(slots=4, kv_blocks=64,
                                                **kw), ex)
    for rid in ("a", "b"):
        sched.submit(tserve.Request(rid=rid, prompt_len=8, output_len=12))
    sched.run()
    for r in sched.completed:
        assert r.tokens == [ex._token(r, n) for n in range(r.output_len)]
    return sched


@pytest.mark.parametrize("method,spec_k,phase", [("step", 0, "decode"),
                                                 ("spec_step", 3, "verify")])
def test_a_raising_batched_pass_retries_one_victim(method, spec_k, phase):
    """F1: an exception out of the decode or verify pass stayed out of
    ``Scheduler.step`` until now. Now it blames one victim, which retries;
    the batch loses one iteration and no token."""
    sched = _two(_Raising(method, ConnectionResetError("reset"), at=2),
                 spec_k=spec_k)
    (fault,) = [t for t in sched.trace if t[0] == "step_fault"]
    assert fault[2:] == (phase, "b", "ConnectionResetError")
    i = sched.trace.index(fault)
    assert sched.trace[i + 1] == ("retry", fault[1], "b", 1)
    assert not any(t[0] == "decode" and t[1] == fault[1]
                   for t in sched.trace)
    assert sched.completed_total == 2 and sched.retries_total == 1
    assert sched.pool.outstanding() == 0


@pytest.mark.parametrize("method,chunk", [("prefill_chunk", 16),
                                          ("begin", 0)])
def test_a_transient_prefill_fault_retries_instead_of_failing(method,
                                                              chunk):
    """F2: a RuntimeError at prefill failed its request with the
    exception's text; the reference retries it (budget 2)."""
    sched = _two(_Raising(method, RuntimeError("cuda hiccup")),
                 prefill_chunk_tokens=chunk)
    assert ("retry", 1, "a", 1) in sched.trace
    assert not sched.failed and sched.completed_total == 2


@pytest.mark.parametrize("method,chunk", [("prefill_chunk", 16),
                                          ("begin", 0)])
@pytest.mark.parametrize("exc", [TypeError, ValueError])
def test_a_contract_breach_fails_alone_with_the_reference_reason(
        method, chunk, exc):
    """F2: a TypeError escaped ``step()``, and a ValueError's outcome read
    the exception's text; both now fail their request alone as
    ``executor_error``."""
    seen = []
    ex = _Raising(method, exc("bad spec"))
    sched = tserve.Scheduler(tserve.ServeConfig(
        slots=4, kv_blocks=64, prefill_chunk_tokens=chunk), ex)
    sched.submit(tserve.Request(rid="a", prompt_len=8, output_len=4,
                                stream=lambda ev, v: seen.append((ev, v))))
    sched.submit(tserve.Request(rid="b", prompt_len=8, output_len=4))
    sched.run()
    (a,) = sched.failed
    assert a.rid == "a" and a.reject_reason == "executor_error"
    assert ("fail", 1, "a") in sched.trace and sched.failed_total == 1
    assert seen == [("failed", "executor_error")]
    assert [r.rid for r in sched.completed] == ["b"]


def test_no_speculation_at_the_no_spec_rung():
    """F3: ``_propose`` ignored the ladder; at ``no_spec`` and above it
    must return None (plain decode)."""
    sched = tserve.Scheduler(tserve.ServeConfig(slots=4, spec_k=4),
                             tserve.PeriodicSimExecutor(4))
    reqs = [tserve.Request(rid=f"p{i}", prompt_len=8, output_len=40)
            for i in range(3)]
    for r in reqs:
        sched.submit(r)
    for _ in range(6):
        sched.step()
    active = sorted(sched._active.items())
    assert sched._propose(active)
    sched.ladder.rung = tdegrade.RUNG_NO_SPEC
    assert sched._propose(active) is None
    spec_before = sum(t[0] == "spec" for t in sched.trace)
    for _ in range(5):
        # held at the rung (good iterations would walk the ladder back up)
        sched.ladder.rung = tdegrade.RUNG_NO_SPEC
        sched.step()
    assert sum(t[0] == "spec" for t in sched.trace) == spec_before


# -- the real model through TorchSlotExecutor ---------------------------------

SHAPE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=64)


@pytest.fixture(scope="module")
def f32():
    """The tiny fp32 model's JAX ``init_params`` tree, bridged through
    numpy into the port."""
    jcfg = jmodel.TransformerConfig(dtype=jnp.float32, **SHAPE)
    tcfg = tmodel.TransformerConfig(dtype=torch.float32, **SHAPE)
    tree = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.key(0), jcfg))
    return tcfg, tmodel.params_from_numpy(tree, tcfg, device="cpu")


def _prompts(n, seed=5):
    rng = np.random.default_rng(seed)
    return [tuple(int(t) for t in rng.integers(0, SHAPE["vocab"],
                                               int(rng.integers(5, 24))))
            for _ in range(n)]


def _generate(params, cfg, r):
    return tdecode.generate(params, cfg, torch.tensor([r.prompt]),
                            r.output_len, device="cpu")[0].tolist()


@pytest.mark.parametrize("chunk", [0, 8])
def test_slot_executor_faults_retry_and_streams_equal_generate(f32, chunk):
    """A scripted decode fault, a prefill Oom (chunked or whole) and a
    poisoned rid on the real model: the victims retry and are prefilled
    again from prompt + kept tokens, the poisoned one is excised, and
    every completed stream equals ``generate`` bit for bit."""
    cfg, params = f32
    plan = tchaos.FaultPlan(seed=SEED)
    plan.script("prefill_chunk" if chunk else "begin", tchaos.Ok(times=2),
                tchaos.Oom())
    plan.script("step", tchaos.Ok(times=6), tchaos.Fail())
    inner = tserve.TorchSlotExecutor(params, cfg, slots=3,
                                     chunk_tokens=chunk, device="cpu")
    ex = tchaos.ChaosExecutor(inner, plan=plan).poison("r4")
    sched = tserve.Scheduler(tserve.ServeConfig(
        slots=3, kv_blocks=16, kv_block_size=16,
        prefill_chunk_tokens=chunk), ex)
    for i, p in enumerate(_prompts(6)):
        sched.submit(tserve.Request(rid=f"r{i}", prompt_len=len(p),
                                    output_len=12, prompt=p))
    sched.run()
    assert plan.injected == [("prefill_chunk" if chunk else "begin",
                              "Oom"), ("step", "Fail")]
    assert [t[2:] for t in sched.trace if t[0] == "poison"] == [("r4", 2)]
    assert sched.retries_total == 2 + tserve.RETRY_BUDGET
    assert sched.completed_total == 5
    assert any(r.retries and r.tokens for r in sched.completed)
    for r in sched.completed:
        assert r.tokens == _generate(params, cfg, r), r.rid
    assert sched.pool.outstanding() == 0


def test_a_forward_that_raises_commits_no_slot_state(f32, monkeypatch):
    """A decode forward that writes the cache and then raises moves
    neither ``pos`` nor ``last``; the next step gives the tokens an
    unfaulted executor gives. The same for a chunk."""
    cfg, params = f32
    prompts = _prompts(2, seed=9)
    twins = [tserve.TorchSlotExecutor(params, cfg, slots=3, chunk_tokens=8,
                                      device="cpu") for _ in range(2)]
    reqs = [tserve.Request(rid=f"q{i}", prompt_len=len(p), output_len=8,
                           prompt=p) for i, p in enumerate(prompts)]
    for ex in twins:
        for slot, r in enumerate(reqs):
            for off in range(0, r.prompt_len, 8):
                ex.prefill_chunk(r, slot, off, min(8, r.prompt_len - off))
    active = list(enumerate(reqs))
    real_step, real_chunk = tserve.decode_step, tserve.prefill_chunk

    def step_then_raise(*a, **kw):
        real_step(*a, **kw)
        raise RuntimeError("device fault after the forward")

    def chunk_then_raise(*a, **kw):
        real_chunk(*a, **kw)
        raise RuntimeError("device fault after the chunk")

    faulty, clean = twins
    before = (faulty.pos.copy(), faulty.last.copy())
    monkeypatch.setattr(tserve, "decode_step", step_then_raise)
    with pytest.raises(RuntimeError):
        faulty.step(active)
    monkeypatch.setattr(tserve, "prefill_chunk", chunk_then_raise)
    late = tserve.Request(rid="late", prompt_len=5, output_len=2,
                          prompt=(1, 2, 3, 4, 5))
    with pytest.raises(RuntimeError):
        faulty.prefill_chunk(late, 2, 0, 5)
    assert np.array_equal(faulty.pos, before[0])
    assert np.array_equal(faulty.last, before[1])
    monkeypatch.setattr(tserve, "decode_step", real_step)
    monkeypatch.setattr(tserve, "prefill_chunk", real_chunk)
    for _ in range(3):
        assert faulty.step(active) == clean.step(active)
