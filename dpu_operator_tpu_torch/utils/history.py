"""Bounded multi-resolution in-process metrics history: the rings the
trend engine reads and ``/debug/history`` serves.

The port's copy of ``dpu_operator_tpu/utils/history.py``. A sampler over
the registered metric families keeps raw -> 10 s -> 2 m downsampling rings
a series, hard-capped in entries, so a serving pod can answer "is the
chunk backlog growing" and "is TTFT drifting" without an external TSDB.

Storage a family kind:

- **counters** are stored as windowed rates (the delta over the sample
  interval, clamped at zero across resets);
- **gauges** are stored raw; downsampled points carry last / min / max,
  so a spike inside a 2 m bucket survives the downsample;
- **histograms** are stored as quantile snapshots (p50 / p95 / p99 by
  linear interpolation over the windowed per-bucket deltas) plus an
  observation rate: the TTFT / ITL percentile series the trend engine
  judges.

Everything the sampler consumes is injectable (the clock, the cadence
trigger), as in ``utils/profiler.py``: tests drive
:meth:`MetricsHistory.sample_once` on a virtual clock with no wall sleeps
and compare the snapshot byte for byte (:meth:`MetricsHistory.snapshot`
sorts every key and rounds every float).

Bounded by construction: at most *max_series* series, each ring at a
fixed capacity; overflow evicts the oldest point (counted in
``tpu_history_evicted_total{reason="ring"}``) and a label-set explosion
refuses new series (``reason="series_cap"``) instead of growing.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Mapping, Optional, \
    Tuple, Union

from . import metrics

#: default sampling cadence (raw-ring spacing)
DEFAULT_INTERVAL_S = 1.0

#: downsample resolutions: raw points aggregate into 10s buckets, 10s
#: points into 2m buckets — ~5min of raw detail, 1h at 10s, 12h at 2m
#: with the default capacities
MID_INTERVAL_S = 10.0
COARSE_INTERVAL_S = 120.0

RAW_CAPACITY = 300
MID_CAPACITY = 360
COARSE_CAPACITY = 360

#: hard cap on distinct series (families expand per label set /
#: quantile); beyond it new series are refused, never grown
MAX_SERIES = 64

#: resolution names as served in the snapshot
RAW, MID, COARSE = "raw", "10s", "2m"

#: the quantiles histogram families expand into
DEFAULT_QUANTILES = (0.5, 0.95, 0.99)

_ReadResult = Union[None, float, Mapping[str, float]]


def _r6(v: float) -> float:
    return round(float(v), 6)


class _Agg:
    """One open downsample bucket: last/min/max/count accumulator."""

    __slots__ = ("bucket", "last", "min", "max", "n")

    def __init__(self, bucket: int, value: float) -> None:
        self.bucket = bucket
        self.last = self.min = self.max = value
        self.n = 1

    def add(self, value: float) -> None:
        self.last = value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        self.n += 1


class _Series:
    """One series' rings + downsample accumulators. All mutation runs
    under the owning MetricsHistory's lock."""

    __slots__ = ("name", "kind", "raw", "mid", "coarse", "_mid_agg",
                 "_coarse_agg", "evicted")

    def __init__(self, name: str, kind: str) -> None:
        self.name = name
        self.kind = kind
        #: raw ring: (t, value)
        self.raw: deque = deque(maxlen=RAW_CAPACITY)
        #: downsampled rings: (t_bucket_end, last, min, max, n)
        self.mid: deque = deque(maxlen=MID_CAPACITY)
        self.coarse: deque = deque(maxlen=COARSE_CAPACITY)
        self._mid_agg: Optional[_Agg] = None
        self._coarse_agg: Optional[_Agg] = None
        self.evicted = 0

    def append(self, t: float, value: float) -> int:
        """Append one raw point, cascading closed downsample buckets;
        returns points evicted by full rings."""
        dropped = 0
        if len(self.raw) == self.raw.maxlen:
            dropped += 1
        self.raw.append((t, value))
        dropped += self._downsample(t, value)
        self.evicted += dropped
        return dropped

    def _downsample(self, t: float, value: float) -> int:
        dropped = 0
        bucket = int(t // MID_INTERVAL_S)
        agg = self._mid_agg
        if agg is None:
            self._mid_agg = _Agg(bucket, value)
        elif bucket == agg.bucket:
            agg.add(value)
        else:
            dropped += self._flush_mid(agg)
            self._mid_agg = _Agg(bucket, value)
        return dropped

    def _flush_mid(self, agg: _Agg) -> int:
        dropped = 0
        if len(self.mid) == self.mid.maxlen:
            dropped += 1
        end = (agg.bucket + 1) * MID_INTERVAL_S
        self.mid.append((end, agg.last, agg.min, agg.max, agg.n))
        # cascade: a closed 10s point feeds the 2m accumulator
        cbucket = int(agg.bucket * MID_INTERVAL_S // COARSE_INTERVAL_S)
        cagg = self._coarse_agg
        if cagg is None:
            cagg = _Agg(cbucket, agg.last)
            cagg.min, cagg.max, cagg.n = agg.min, agg.max, agg.n
            self._coarse_agg = cagg
        elif cbucket == cagg.bucket:
            cagg.last = agg.last
            cagg.min = min(cagg.min, agg.min)
            cagg.max = max(cagg.max, agg.max)
            cagg.n += agg.n
        else:
            if len(self.coarse) == self.coarse.maxlen:
                dropped += 1
            cend = (cagg.bucket + 1) * COARSE_INTERVAL_S
            self.coarse.append((cend, cagg.last, cagg.min, cagg.max,
                                cagg.n))
            fresh = _Agg(cbucket, agg.last)
            fresh.min, fresh.max, fresh.n = agg.min, agg.max, agg.n
            self._coarse_agg = fresh
        return dropped

    def points(self, resolution: str) -> List[tuple]:
        if resolution == RAW:
            return list(self.raw)
        if resolution == MID:
            return list(self.mid)
        if resolution == COARSE:
            return list(self.coarse)
        raise KeyError(resolution)

    def total_points(self) -> int:
        return len(self.raw) + len(self.mid) + len(self.coarse)

    def render(self) -> dict:
        return {
            "kind": self.kind,
            RAW: [[_r6(t), _r6(v)] for t, v in self.raw],
            MID: [[_r6(t), _r6(last), _r6(lo), _r6(hi), n]
                  for t, last, lo, hi, n in self.mid],
            COARSE: [[_r6(t), _r6(last), _r6(lo), _r6(hi), n]
                     for t, last, lo, hi, n in self.coarse],
        }


class _Family:
    """One registered family: the reader plus per-sub-series cumulative
    state (counters and histograms differentiate against it)."""

    __slots__ = ("name", "kind", "read", "hist", "quantiles", "prev")

    def __init__(self, name: str, kind: str,
                 read: Optional[Callable[[], _ReadResult]] = None,
                 hist: Optional[Any] = None,
                 quantiles: Tuple[float, ...] = DEFAULT_QUANTILES
                 ) -> None:
        self.name = name
        self.kind = kind
        self.read = read
        self.hist = hist
        self.quantiles = quantiles
        #: sub-series key -> previous cumulative observation
        #: (counters: (t, total); histograms: (t, total, cum_buckets))
        self.prev: Dict[str, tuple] = {}


def _hist_quantile(bounds: Tuple[float, ...], deltas: List[float],
                   q: float) -> float:
    """histogram_quantile over windowed per-bucket deltas: linear
    interpolation inside the target bucket, clamped to the highest
    finite bound for the +Inf bucket."""
    total = sum(deltas)
    if total <= 0:
        return 0.0
    target = q * total
    cum = 0.0
    lo = 0.0
    for le, d in zip(bounds, deltas[:-1]):
        if cum + d >= target and d > 0:
            return lo + (le - lo) * (target - cum) / d
        cum += d
        lo = le
    return float(bounds[-1]) if bounds else 0.0


class MetricsHistory:
    """The bounded sampler. *clock* spaces the rings (virtual in
    tests); *trigger*, when given, replaces the stop-event cadence wait
    in the background loop (return False to exit) — the profiler's
    seam, reused verbatim so the loop itself is testable without
    sleeping. Listeners (the trend engine) run synchronously after
    every sample pass, so test determinism covers the whole chain."""

    def __init__(self, *, interval_s: float = DEFAULT_INTERVAL_S,
                 max_series: int = MAX_SERIES,
                 clock: Callable[[], float] = time.monotonic,
                 trigger: Optional[Callable[[], bool]] = None) -> None:
        self.interval_s = interval_s
        self.max_series = max_series
        self.clock = clock
        self._trigger = trigger
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._families: Dict[str, _Family] = {}
        self._series: Dict[str, _Series] = {}
        self._listeners: List[Callable[[float], None]] = []
        self.samples = 0
        self.evicted_ring = 0
        self.refused_series = 0

    # -- registration ---------------------------------------------------------
    def register_gauge(self, name: str,
                       read: Callable[[], _ReadResult]) -> None:
        """*read* returns the instantaneous value — a float, or a
        ``{sub-series: value}`` mapping for labeled families (each key
        becomes ``name.key``), or None to skip this pass."""
        self._register(_Family(name, "gauge", read=read))

    def register_counter(self, name: str,
                         read: Callable[[], _ReadResult]) -> None:
        """*read* returns the CUMULATIVE total(s); the history stores
        the windowed rate per second (negative deltas — a restart
        reset — clamp to zero)."""
        self._register(_Family(name, "counter", read=read))

    def register_histogram(self, name: str, hist: Any,
                           quantiles: Tuple[float, ...]
                           = DEFAULT_QUANTILES) -> None:
        """*hist* is a :class:`utils.metrics.Histogram`; each sample
        stores quantile sub-series (``name.p50`` …) interpolated over
        the windowed per-bucket deltas, plus ``name.rate``
        (observations/s in the window)."""
        self._register(_Family(name, "histogram", hist=hist,
                               quantiles=quantiles))

    def _register(self, family: _Family) -> None:
        with self._lock:
            self._families[family.name] = family

    def add_listener(self, fn: Callable[[float], None]) -> None:
        """Run *fn(now)* synchronously after every sample pass (the
        trend engine's evaluation hook)."""
        with self._lock:
            self._listeners.append(fn)

    # -- sampling -------------------------------------------------------------
    def sample_once(self) -> int:
        """One pass over every registered family; returns the number
        of series points appended. Never raises — history must not be
        able to take down what it remembers."""
        now = self.clock()
        appended = 0
        with self._lock:
            families = list(self._families.values())
        for family in families:
            try:
                readings = self._read_family(family, now)
            except Exception:  # noqa: BLE001 — observe-only by
                # contract; one broken reader drops its family's pass
                metrics.SWALLOWED_ERRORS.inc(site="history.sample")
                continue
            with self._lock:
                for sub, value in readings:
                    series = self._series_locked(family, sub)
                    if series is None:
                        continue
                    self.evicted_ring += series.append(now,
                                                       float(value))
                    appended += 1
        with self._lock:
            self.samples += 1
            listeners = list(self._listeners)
        metrics.HISTORY_SAMPLES.inc()
        for fn in listeners:
            try:
                fn(now)
            except Exception:  # noqa: BLE001 — a broken listener must
                # not stop the sampler
                metrics.SWALLOWED_ERRORS.inc(site="history.listener")
        return appended

    def _read_family(self, family: _Family,
                     now: float) -> List[Tuple[str, float]]:
        """(sub-series, value) rows for one family at *now* —
        differentiated for counters, quantile-interpolated for
        histograms. Sub-series keys are sorted so ring append order is
        deterministic."""
        if family.kind == "histogram":
            return self._read_histogram(family, now)
        raw = family.read() if family.read is not None else None
        if raw is None:
            return []
        if isinstance(raw, Mapping):
            pairs = [(metrics.bounded_label(k), float(v))
                     for k, v in sorted(raw.items())]
        else:
            pairs = [("", float(raw))]
        if family.kind == "gauge":
            return pairs
        out: List[Tuple[str, float]] = []
        for sub, total in pairs:
            prev = family.prev.get(sub)
            family.prev[sub] = (now, total)
            if prev is None:
                continue  # first sight: no window to rate over yet
            dt = now - prev[0]
            if dt <= 0:
                continue
            out.append((sub, max(0.0, total - prev[1]) / dt))
        return out

    def _read_histogram(self, family: _Family,
                        now: float) -> List[Tuple[str, float]]:
        hist = family.hist
        bounds = tuple(hist.buckets)
        total = float(hist.count)
        # cumulative count at each finite bound, plus the +Inf total
        cum = tuple(total - hist.count_above(b) for b in bounds) \
            + (total,)
        prev = family.prev.get("")
        family.prev[""] = (now, total, cum)
        if prev is None:
            return []
        dt = now - prev[0]
        d_total = total - prev[1]
        if dt <= 0 or d_total < 0 or len(prev[2]) != len(cum):
            # reset (restart) or bucket-shape change: re-reference
            return []
        deltas = [max(0.0, c - p) for c, p in zip(cum, prev[2])]
        # per-bucket (non-cumulative) deltas for interpolation
        flat = [deltas[0]] + [deltas[i] - deltas[i - 1]
                              for i in range(1, len(deltas))]
        out: List[Tuple[str, float]] = []
        for q in family.quantiles:
            sub = f"p{int(q * 100)}"
            if d_total > 0:
                value = _hist_quantile(bounds, flat, q)
            else:
                # idle window: carry the last quantile forward so the
                # series stays continuous (a gap would read as a drop)
                value = self._last_value(f"{family.name}.{sub}")
            out.append((sub, value))
        out.append(("rate", max(0.0, d_total) / dt))
        return out

    def _last_value(self, series_name: str) -> float:
        with self._lock:
            series = self._series.get(series_name)
            if series is not None and series.raw:
                return float(series.raw[-1][1])
        return 0.0

    def _series_locked(self, family: _Family,
                       sub: str) -> Optional[_Series]:
        name = f"{family.name}.{sub}" if sub else family.name
        series = self._series.get(name)
        if series is None:
            if len(self._series) >= self.max_series:
                self.refused_series += 1
                metrics.HISTORY_EVICTED.inc(reason="series_cap")
                return None
            series = _Series(name, family.kind)
            self._series[name] = series
        return series

    # -- reads ----------------------------------------------------------------
    def series_names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def points(self, name: str,
               resolution: str = RAW) -> List[tuple]:
        """The (t, ...) tuples of one series at one resolution; empty
        for an unknown series (a consumer polling before the first
        sample must not crash)."""
        with self._lock:
            series = self._series.get(name)
            return series.points(resolution) if series else []

    def values(self, name: str,
               resolution: str = RAW) -> List[float]:
        """Just the value column (last, for downsampled points) — the
        sparkline/trend input."""
        return [float(p[1]) for p in self.points(name, resolution)]

    def total_points(self) -> int:
        with self._lock:
            return sum(s.total_points() for s in self._series.values())

    def snapshot(self) -> dict:
        """The ``/debug/history`` payload: every series' rings, the
        resolution table and the sampler's own accounting. Keys are
        sorted and floats rounded, so two seeded runs serialize
        byte-identically. Also refreshes the ``tpu_history_*``
        gauges."""
        with self._lock:
            series = {name: self._series[name].render()
                      for name in sorted(self._series)}
            n_series = len(self._series)
            points = sum(s.total_points()
                         for s in self._series.values())
            out = {
                "intervalS": _r6(self.interval_s),
                "resolutions": {
                    RAW: {"intervalS": _r6(self.interval_s),
                          "capacity": RAW_CAPACITY},
                    MID: {"intervalS": _r6(MID_INTERVAL_S),
                          "capacity": MID_CAPACITY},
                    COARSE: {"intervalS": _r6(COARSE_INTERVAL_S),
                             "capacity": COARSE_CAPACITY},
                },
                "samples": self.samples,
                "series": series,
                "evicted": {"ring": self.evicted_ring,
                            "seriesCap": self.refused_series},
            }
        metrics.HISTORY_SERIES.set(float(n_series))
        metrics.HISTORY_POINTS.set(float(points))
        return out

    # -- background loop ------------------------------------------------------
    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> None:
        """Spawn the sampling thread (idempotent), named ``history``
        like every component loop the watchdog can name."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="history", daemon=True)
            self._thread.start()

    def stop(self, timeout_s: float = 2.0) -> None:
        self._stop.set()
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None:
            t.join(timeout_s)

    def _default_trigger(self) -> bool:
        return not self._stop.wait(self.interval_s)

    def _run(self) -> None:
        trigger = (self._trigger if self._trigger is not None
                   else self._default_trigger)
        while True:
            try:
                if not trigger():
                    return
            except Exception:  # noqa: BLE001 — a broken injected
                # trigger ends the loop, never unwinds into threading
                metrics.SWALLOWED_ERRORS.inc(site="history.trigger")
                return
            self.sample_once()


#: process-global history (started by the serving shell / daemon
#: entrypoints; tests build their own with injected clocks)
HISTORY = MetricsHistory()

_wired = False


def register_serving_families(history: Optional[MetricsHistory]
                              = None) -> MetricsHistory:
    """Wire the serving-critical families onto *history* (default: the
    process global; idempotent there): TTFT/ITL quantiles, chunk
    backlog, KV occupancy, speculative acceptance, SLO burn rates and
    degraded-rung residency — exactly the series utils/trend.py
    judges."""
    global _wired
    target = history if history is not None else HISTORY
    if history is None:
        if _wired:
            return target
        _wired = True
    target.register_gauge(
        "tpu_serve_prefill_chunk_backlog_tokens",
        metrics.SERVE_PREFILL_BACKLOG.value)
    target.register_gauge(
        "tpu_serve_kv_blocks",
        lambda: {"used": metrics.SERVE_KV_BLOCKS.value(state="used"),
                 "free": metrics.SERVE_KV_BLOCKS.value(state="free")})
    target.register_gauge(
        "tpu_serve_spec_acceptance_rate",
        metrics.SERVE_SPEC_ACCEPTANCE.value)
    target.register_gauge(
        "tpu_serve_degraded_rung",
        metrics.SERVE_DEGRADED_RUNG.value)
    target.register_gauge(
        "tpu_slo_burn_rate",
        lambda: {f"{ls.get('slo', '')}_{ls.get('window', '')}": v
                 for ls, v in metrics.SLO_BURN_RATE.samples()})
    target.register_histogram("tpu_serve_ttft_seconds",
                              metrics.SERVE_TTFT_SECONDS)
    target.register_histogram("tpu_serve_itl_seconds",
                              metrics.SERVE_ITL_SECONDS)
    return target


def debug_handler() -> dict:
    """``/debug/history`` payload: the global history snapshot plus
    the trend engine's judged state (one endpoint answers both "what
    happened" and "which way is it going")."""
    from . import trend
    snap = HISTORY.snapshot()
    snap["trend"] = trend.TREND.state()
    return snap
