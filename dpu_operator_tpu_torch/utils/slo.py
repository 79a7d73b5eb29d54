"""Multi-window, multi-burn-rate SLO evaluation over the port's registry.

The port's copy of ``dpu_operator_tpu/utils/slo.py``, trimmed to the
serving shell: :class:`Slo` (an objective over two monotone counter
reads), :class:`SloEvaluator` (burn rates per window, alert transitions
exported as ``tpu_slo_burn_rate`` / ``tpu_slo_alert_active``, recorded in
the flight ring, kind ``slo``, and emitted as ``SloAlertFiring`` /
``SloAlertCleared`` Events; :meth:`SloEvaluator.active_alerts`) and the
standing ``serve-ttft`` / ``serve-tokens`` objectives over the serve
histograms. Their firing alerts are the degradation ladder's second signal
(``Scheduler.slo_alert_fn``) and join the headroom digest. The reference's
other standing SLOs (CNI, apiserver, breakers) and its health snapshot
belong to the operator, not to this package.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
from typing import Callable, Optional

from . import flight, metrics
from .watchdog import emit_health_event

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class BurnWindow:
    """One look-back window with its burn-rate threshold."""

    label: str
    seconds: float
    threshold: float


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """Fires when every window's burn rate exceeds its threshold."""

    severity: str               # "page" | "ticket"
    windows: tuple[BurnWindow, ...]


def default_rules(scale: float = 1.0) -> tuple[AlertRule, ...]:
    """The SRE Workbook's pairs for a 30-day budget: page on 14.4x over
    (5m AND 1h), ticket on 6x over (30m AND 6h); *scale* shrinks the
    windows uniformly."""
    return (
        AlertRule("page", (BurnWindow("5m", 300 * scale, 14.4),
                           BurnWindow("1h", 3600 * scale, 14.4))),
        AlertRule("ticket", (BurnWindow("30m", 1800 * scale, 6.0),
                             BurnWindow("6h", 21600 * scale, 6.0))),
    )


class Slo:
    """One objective over two monotone counter reads."""

    def __init__(self, name: str, component: str, objective: float,
                 total_fn: Callable[[], float],
                 bad_fn: Callable[[], float],
                 rules: Optional[tuple[AlertRule, ...]] = None) -> None:
        if not 0.0 < objective < 1.0:
            raise ValueError("objective must be in (0, 1)")
        self.name = name
        self.component = component
        self.objective = objective
        self.error_budget = 1.0 - objective
        self.total_fn = total_fn
        self.bad_fn = bad_fn
        self.rules = rules if rules is not None else default_rules()
        seen: dict[str, float] = {}
        for rule in self.rules:
            for w in rule.windows:
                if seen.setdefault(w.label, w.seconds) != w.seconds:
                    raise ValueError(
                        f"window label {w.label!r} reused with a "
                        f"different duration ({seen[w.label]}s vs "
                        f"{w.seconds}s) across rules of SLO {name!r}")

    def windows(self) -> list[BurnWindow]:
        seen_labels: dict[str, BurnWindow] = {}
        for rule in self.rules:
            for w in rule.windows:
                seen_labels.setdefault(w.label, w)
        return list(seen_labels.values())


class SloEvaluator:
    """Samples every registered SLO per :meth:`evaluate` (injectable
    clock) and drives the alert states."""

    def __init__(self, clock: Callable[[], float] = time.monotonic) -> None:
        self.clock = clock
        self._lock = threading.Lock()
        self._slos: list[Slo] = []
        #: per-SLO monotone samples (t, bad, total), pruned to one sample
        #: at or beyond the longest window
        self._samples: dict[str, "collections.deque[tuple]"] = {}
        self._active: dict[tuple[str, str], bool] = {}

    def add(self, slo: Slo) -> Slo:
        with self._lock:
            self._slos.append(slo)
            self._samples[slo.name] = collections.deque()
        return slo

    def evaluate(self) -> dict:
        """Sample, compute burn rates, transition alerts; returns the
        per-SLO state."""
        now = self.clock()
        with self._lock:
            slos = list(self._slos)
        out: dict[str, dict] = {}
        for slo in slos:
            try:
                bad, total = float(slo.bad_fn()), float(slo.total_fn())
            except Exception:  # noqa: BLE001 — a broken source must not
                # take the whole evaluation down
                metrics.SWALLOWED_ERRORS.inc(site="slo.sample")
                log.exception("SLO %s sample failed; skipping this tick",
                              slo.name)
                continue
            horizon = max(w.seconds for w in slo.windows())
            with self._lock:
                samples = self._samples[slo.name]
                samples.append((now, bad, total))
                while (len(samples) >= 2
                       and samples[1][0] <= now - horizon):
                    samples.popleft()
                window_samples = list(samples)
            burns = {w.label: self._burn(window_samples, now, w.seconds,
                                         slo.error_budget)
                     for w in slo.windows()}
            for label, burn in burns.items():
                metrics.SLO_BURN_RATE.set(burn, slo=slo.name,
                                          window=label)
            alerts = {rule.severity: self._transition(slo, rule, burns)
                      for rule in slo.rules}
            out[slo.name] = {"component": slo.component,
                             "objective": slo.objective,
                             "burn_rates": burns, "alerts": alerts,
                             "bad": bad, "total": total}
        return out

    @staticmethod
    def _burn(samples: list, now: float, window: float,
              error_budget: float) -> float:
        """Burn rate over [now - window, now]: the bad fraction of the
        window's events over the error budget; the reference sample is the
        newest at or before the window's start (the oldest while the
        series is younger than the window)."""
        if not samples:
            return 0.0
        ref = samples[0]
        for s in samples:
            if s[0] <= now - window:
                ref = s
            else:
                break
        latest = samples[-1]
        d_bad = latest[1] - ref[1]
        d_total = latest[2] - ref[2]
        if d_total <= 0 or error_budget <= 0:
            return 0.0
        return (d_bad / d_total) / error_budget

    def _transition(self, slo: Slo, rule: AlertRule,
                    burns: dict) -> bool:
        firing = all(burns[w.label] > w.threshold for w in rule.windows)
        key = (slo.name, rule.severity)
        with self._lock:
            was = self._active.get(key, False)
            self._active[key] = firing
        metrics.SLO_ALERT_ACTIVE.set(1.0 if firing else 0.0,
                                     slo=slo.name, severity=rule.severity)
        if firing == was:
            return firing
        worst = max(burns[w.label] for w in rule.windows)
        detail = ", ".join(f"{w.label}={burns[w.label]:.1f}x"
                           f" (>{w.threshold:g})" for w in rule.windows)
        flight.record("slo", slo.name, attributes={
            "severity": rule.severity,
            "state": "firing" if firing else "cleared",
            "burn_rates": detail})
        series = f"{slo.name}/{rule.severity}"
        if firing:
            log.error("SLO alert firing: %s [%s] burn %s", slo.name,
                      rule.severity, detail)
            emit_health_event("SloAlertFiring",
                              f"SLO {slo.name} ({slo.component}) "
                              f"burning {worst:.1f}x its error budget "
                              f"[{rule.severity}]: {detail}", "Warning",
                              series=series)
        else:
            log.warning("SLO alert cleared: %s [%s]", slo.name,
                        rule.severity)
            emit_health_event("SloAlertCleared",
                              f"SLO {slo.name} ({slo.component}) back "
                              f"within budget [{rule.severity}]",
                              "Normal", series=series)
        return firing

    def active_alerts(self) -> list[tuple[str, str]]:
        """(slo name, severity) pairs firing now."""
        with self._lock:
            return sorted(k for k, v in self._active.items() if v)


#: a first token slower than this burns the serve-ttft budget
SERVE_TTFT_SLOW_SECONDS = 2.0
#: a decode iteration slower than this burns the serve-tokens budget
SERVE_ITL_SLOW_SECONDS = 0.2


def serve_slos(rules: Optional[tuple[AlertRule, ...]] = None) -> list[Slo]:
    """The standing objectives over the serve latency series: 99% of
    requests get a first token under :data:`SERVE_TTFT_SLOW_SECONDS` (an
    admission rejection is an infinitely late first token), and 99% of
    decode iterations run under :data:`SERVE_ITL_SLOW_SECONDS`."""

    def ttft_bad() -> float:
        return (metrics.SERVE_TTFT_SECONDS.count_above(
            SERVE_TTFT_SLOW_SECONDS)
            + metrics.SERVE_ADMISSION_REJECTED.total())

    def ttft_total() -> float:
        return (float(metrics.SERVE_TTFT_SECONDS.count)
                + metrics.SERVE_ADMISSION_REJECTED.total())

    return [
        Slo("serve-ttft", component="serve", objective=0.99,
            total_fn=ttft_total, bad_fn=ttft_bad, rules=rules),
        Slo("serve-tokens", component="serve", objective=0.99,
            total_fn=lambda: float(metrics.SERVE_ITL_SECONDS.count),
            bad_fn=lambda: metrics.SERVE_ITL_SECONDS.count_above(
                SERVE_ITL_SLOW_SECONDS),
            rules=rules),
    ]


#: the process-global evaluator over the standing serve SLOs
EVALUATOR = SloEvaluator()
for _slo in serve_slos():
    EVALUATOR.add(_slo)
del _slo
