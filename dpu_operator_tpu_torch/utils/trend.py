"""Trend and drift judgment over the metrics history rings.

The port's copy of ``dpu_operator_tpu/utils/trend.py``. ``utils/history.py``
remembers; this module decides which way a series is going and whether
that direction is bad. For each watched series it fits a least-squares
slope over the last window of raw points, normalizes it by the series' own
magnitude (an EWMA-smoothed scale, so a backlog of 40k tokens and an
acceptance rate of 0.6 are judged on the same relative footing), and runs
the verdict through the degradation ladder's hysteresis: consecutive-bad
escalation, consecutive-good recovery gated by a hold-down, and flap
damping that doubles the hold-down when an anomaly fires again inside the
flap window. A series fires one ``TrendAnomaly`` an episode.

Direction defaults come from ``utils/metric_direction.py``, overridable a
watch (``tpu_slo_burn_rate`` holds the higher-better token ``rate``, but
burning faster is worse).

Each transition sets the ``tpu_trend_*`` gauges and counter, emits a
``TrendAnomaly`` / ``TrendCleared`` Event through the port's Event seam
(``utils/watchdog.emit_health_event`` -> ``utils/events``) and records a
``kind=trend`` flight entry. The state machine itself is pure (no locks,
no emission); the engine wraps it.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from . import flight, history, metrics, watchdog
from .metric_direction import direction as _infer_direction

#: verdicts, in escalation order
INSUFFICIENT = "insufficient"
STEADY = "steady"
DRIFTING = "drifting"
ANOMALY = "anomaly"


@dataclass(frozen=True)
class TrendPolicy:
    """Hysteresis + judgment knobs (FaultPolicy/LadderPolicy shape:
    frozen, injectable, defaults tuned for 1s sampling)."""

    #: consecutive bad evaluations before a series turns anomalous
    escalate_after: int = 3
    #: consecutive good evaluations (after hold-down) before it clears
    recover_after: int = 4
    #: minimum seconds an anomaly persists before goods count at all
    hold_down_base_s: float = 60.0
    #: cap for flap-doubled hold-downs
    hold_down_max_s: float = 600.0
    #: re-anomaly within this window of the last clear doubles the
    #: hold-down (flap damping)
    flap_window_s: float = 300.0
    #: relative drift (slope * window span / scale) beyond which an
    #: evaluation is bad in the series' bad direction
    slope_threshold: float = 0.05
    #: EWMA smoothing for the normalization scale
    ewma_alpha: float = 0.3
    #: evaluations below this many raw points return ``insufficient``
    min_points: int = 5
    #: raw points the slope is fit over
    window_points: int = 12


@dataclass
class _SeriesState:
    """Pure per-series hysteresis state — DegradationLadder's machine
    with two rungs (ok / anomalous)."""

    direction: int
    anomalous: bool = False
    bad: int = 0
    good: int = 0
    hold_down_until: float = 0.0
    last_clear_at: float = -1.0e18
    episodes: int = 0
    verdict: str = INSUFFICIENT
    rel_slope: float = 0.0
    ewma: Optional[float] = None

    def observe(self, now: float, bad: bool,
                policy: TrendPolicy) -> Optional[str]:
        """Feed one evaluation; returns ``"anomaly"``/``"cleared"`` on
        a transition, else None."""
        if bad:
            self.good = 0
            self.bad += 1
            if not self.anomalous and self.bad >= policy.escalate_after:
                self.anomalous = True
                self.bad = 0
                hold = policy.hold_down_base_s
                if now - self.last_clear_at <= policy.flap_window_s:
                    hold = min(policy.hold_down_max_s,
                               hold * (2 ** min(self.episodes, 8)))
                self.hold_down_until = now + hold
                self.episodes += 1
                return "anomaly"
            return None
        self.bad = 0
        if not self.anomalous:
            return None
        if now < self.hold_down_until:
            # goods during hold-down are ignored outright (ladder
            # semantics): the counter starts after the hold expires
            self.good = 0
            return None
        self.good += 1
        if self.good >= policy.recover_after:
            self.anomalous = False
            self.good = 0
            self.last_clear_at = now
            return "cleared"
        return None


def _slope(points: List[Tuple[float, float]]) -> float:
    """Least-squares slope (value units per second) over (t, v)."""
    n = len(points)
    if n < 2:
        return 0.0
    mt = sum(t for t, _ in points) / n
    mv = sum(v for _, v in points) / n
    num = sum((t - mt) * (v - mv) for t, v in points)
    den = sum((t - mt) ** 2 for t, _ in points)
    return num / den if den else 0.0


class TrendEngine:
    """Judges watched series after every history sample pass (attach
    via ``history.add_listener(engine.evaluate_once)``)."""

    def __init__(self, hist: history.MetricsHistory, *,
                 policy: Optional[TrendPolicy] = None,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.history = hist
        self.policy = policy or TrendPolicy()
        #: None → the history's clock, so injected-clock tests drive
        #: hysteresis timing and ring timestamps from one source
        self._clock = clock
        self._lock = threading.Lock()
        #: exact-name watches: series -> direction sign
        self._watched: Dict[str, int] = {}
        #: prefix watches (dynamic sub-series, e.g. burn-rate windows)
        self._prefixes: List[Tuple[str, int]] = []
        self._states: Dict[str, _SeriesState] = {}

    # -- registration ---------------------------------------------------------
    def watch(self, series: str,
              direction: Optional[int] = None) -> None:
        """Watch one series; *direction* +1 higher-is-better / -1
        lower-is-better / 0 report-only, default inferred from the
        name via the shared bench vocabulary."""
        sign = (_infer_direction(series) if direction is None
                else direction)
        with self._lock:
            self._watched[series] = sign

    def watch_prefix(self, prefix: str, direction: int) -> None:
        """Watch every series whose name starts with *prefix* (burn
        rates expand one sub-series per slo/window label set, unknown
        until traffic arrives)."""
        with self._lock:
            self._prefixes.append((prefix, direction))

    def _targets(self) -> Dict[str, int]:
        with self._lock:
            targets = dict(self._watched)
            prefixes = list(self._prefixes)
        if prefixes:
            for name in self.history.series_names():
                if name in targets:
                    continue
                for prefix, sign in prefixes:
                    if name.startswith(prefix):
                        targets[name] = sign
                        break
        return targets

    # -- evaluation -----------------------------------------------------------
    def evaluate_once(self, now: Optional[float] = None) -> List[dict]:
        """One judgment pass over every watched series; returns the
        transitions emitted (empty most passes)."""
        clock = self._clock or self.history.clock
        t = clock() if now is None else now
        policy = self.policy
        transitions: List[dict] = []
        for name, sign in sorted(self._targets().items()):
            points = self.history.points(name, history.RAW)
            with self._lock:
                state = self._states.get(name)
                if state is None:
                    state = _SeriesState(direction=sign)
                    self._states[name] = state
            metrics.TREND_EVALUATIONS.inc()
            if len(points) < policy.min_points:
                state.verdict = INSUFFICIENT
                continue
            window = points[-policy.window_points:]
            slope = _slope(window)
            last = window[-1][1]
            mean = sum(v for _, v in window) / len(window)
            alpha = policy.ewma_alpha
            state.ewma = (last if state.ewma is None
                          else alpha * last + (1 - alpha) * state.ewma)
            scale = max(abs(state.ewma), abs(mean), 1.0)
            span = window[-1][0] - window[0][0]
            rel = slope * span / scale if span > 0 else 0.0
            state.rel_slope = rel
            drifting = abs(rel) >= policy.slope_threshold
            # bad = drifting the wrong way; direction 0 never alarms
            bad = drifting and sign != 0 and rel * sign < 0
            transition = state.observe(t, bad, policy)
            if state.anomalous:
                state.verdict = ANOMALY
            elif drifting:
                state.verdict = DRIFTING
            else:
                state.verdict = STEADY
            label = metrics.bounded_label(name)
            metrics.TREND_SLOPE.set(rel, series=label)
            metrics.TREND_ANOMALY.set(
                1.0 if state.anomalous else 0.0, series=label)
            if transition is not None:
                transitions.append(self._emit(name, label, state,
                                              transition, rel))
        return transitions

    def _emit(self, name: str, label: str, state: _SeriesState,
              transition: str, rel: float) -> dict:
        anomaly = transition == "anomaly"
        reason = "TrendAnomaly" if anomaly else "TrendCleared"
        to = "anomaly" if anomaly else "cleared"
        metrics.TREND_TRANSITIONS.inc(series=label, to=to)
        way = "degrading" if anomaly else "recovered"
        message = (f"series {name} {way}: relative slope {rel:+.4f} "
                   f"over the judgment window (direction "
                   f"{state.direction:+d}, episode {state.episodes})")
        watchdog.emit_health_event(
            reason, message, "Warning" if anomaly else "Normal",
            series=name)
        flight.record("trend", reason, attributes={
            "series": name, "relSlope": round(rel, 4),
            "direction": state.direction, "episode": state.episodes,
        })
        return {"series": name, "transition": to,
                "relSlope": round(rel, 4)}

    # -- reads ----------------------------------------------------------------
    def anomalies(self) -> List[str]:
        with self._lock:
            return sorted(n for n, s in self._states.items()
                          if s.anomalous)

    def state(self) -> dict:
        """Deterministic per-series judgment table (served inside
        ``/debug/history``)."""
        with self._lock:
            return {
                "series": {
                    name: {
                        "verdict": s.verdict,
                        "direction": s.direction,
                        "relSlope": round(s.rel_slope, 4),
                        "anomalous": s.anomalous,
                        "episodes": s.episodes,
                    }
                    for name, s in sorted(self._states.items())
                },
                "anomalies": sorted(n for n, s in self._states.items()
                                    if s.anomalous),
            }

    def digest(self) -> Optional[dict]:
        """The node telemetry digest's ``trends`` block: None until
        something has been judged (section omitted → old-snapshot
        consumers stay graceful), else the anomaly list plus per-series
        verdict/slope — small enough to damp, rich enough for the
        fleet rollup."""
        with self._lock:
            if not self._states:
                return None
            return {
                "anomalies": sorted(n for n, s in self._states.items()
                                    if s.anomalous),
                "series": {
                    name: {"verdict": s.verdict,
                           "slope": round(s.rel_slope, 4)}
                    for name, s in sorted(self._states.items())
                },
            }


#: serving-critical watch list: (series, direction override or None to
#: trust the shared vocabulary). Overrides document exactly where the
#: name-based inference would lie.
SERVING_WATCHES: Tuple[Tuple[str, Optional[int]], ...] = (
    ("tpu_serve_ttft_seconds.p50", None),       # latency → lower
    ("tpu_serve_ttft_seconds.p95", None),
    ("tpu_serve_ttft_seconds.p99", None),
    ("tpu_serve_itl_seconds.p50", None),
    ("tpu_serve_itl_seconds.p95", None),
    ("tpu_serve_itl_seconds.p99", None),
    # "tokens" is a higher-better token, but a growing prefill backlog
    # is pressure — override
    ("tpu_serve_prefill_chunk_backlog_tokens", -1),
    # KV occupancy: used growing is pressure, free growing is slack
    ("tpu_serve_kv_blocks.used", -1),
    ("tpu_serve_spec_acceptance_rate", None),   # acceptance → higher
    # rung 0 is healthy; climbing the ladder is degradation
    ("tpu_serve_degraded_rung", -1),
)

#: burn-rate sub-series appear per (slo, window) label set — watched by
#: prefix, always lower-is-better despite the "rate" token
SERVING_WATCH_PREFIXES: Tuple[Tuple[str, int], ...] = (
    ("tpu_slo_burn_rate.", -1),
)


def register_serving_watches(engine: Optional["TrendEngine"]
                             = None) -> "TrendEngine":
    """Attach the serving-critical watch list (idempotent — watch()
    overwrites by name)."""
    target = engine if engine is not None else TREND
    for series, sign in SERVING_WATCHES:
        target.watch(series, sign)
    for prefix, sign in SERVING_WATCH_PREFIXES:
        target.watch_prefix(prefix, sign)
    return target


#: process-global engine over the process-global history, evaluated
#: synchronously after every sample pass
TREND = TrendEngine(history.HISTORY)
history.HISTORY.add_listener(TREND.evaluate_once)
