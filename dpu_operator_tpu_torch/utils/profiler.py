"""Always-on sampling profiler: the serving shell's performance plane.

The port's copy of ``dpu_operator_tpu/utils/profiler.py``. A daemon thread
walks ``sys._current_frames()`` at a set cadence and aggregates what it
sees into bounded per-(thread, code site) self / total sample counts,
keyed by the threads' names (``serve-scheduler``, ``serve-ingress``,
``history`` ...), so a hot site attributes to a component, not a bare
ident. This is statistical attribution, not tracing: at the default 25 ms
cadence a site that shows up in 4% of a thread's samples spends about 4%
of that thread's time there, and the profiler meters its own cost
(``tpu_profile_overhead_ratio``).

Everything the loop consumes is injectable (the clock, the frame source,
the thread-name source and the loop trigger), so tests drive
:meth:`SamplingProfiler.sample_once` with no wall sleeps and compare the
folded output byte for byte.

Two render forms from one snapshot: JSON (``/debug/profile``: per-thread
top sites with self / total counts, the profiler's own overhead and drops)
and collapsed-stack "folded" lines (``thread;root;...;leaf N``, sorted:
flamegraph.pl / speedscope input, byte-deterministic for a sample set).

Bounded by construction: at most *max_stacks* distinct folded stacks and
*max_sites* site rows a thread are kept; overflow is counted
(``tpu_profile_dropped_total``), never grown.

Where the port differs from the reference: ``/debug/profile`` carries no
``"jax"`` block (the reference merges its jit compile-watch counters
there; eager PyTorch compiles nothing, and the port has no compile
watch).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

from . import metrics

DEFAULT_INTERVAL_S = 0.025
MAX_STACKS = 512
MAX_SITES = 256
MAX_DEPTH = 32


def thread_names() -> Dict[int, str]:
    """Live thread ident -> name map (the watchdog stack-dump idiom):
    component threads register stable names at spawn, so profile rows
    key by role, not by ephemeral ident."""
    return {t.ident: t.name for t in threading.enumerate()
            if t.ident is not None}


def _site(filename: str, funcname: str) -> str:
    return f"{os.path.basename(filename)}:{funcname}"


class SamplingProfiler:
    """Bounded sampling profiler over an injectable frame source.

    *clock* meters elapsed time and per-sample cost; *frames_fn*
    yields ``{ident: frame}`` (``sys._current_frames`` in production,
    fabricated frame chains in tests); *threads_fn* names the idents;
    *trigger*, when given, replaces the stop-event cadence wait in the
    background loop (return False to exit) — the seam that makes the
    loop itself testable without sleeping.
    """

    def __init__(self, *, interval_s: float = DEFAULT_INTERVAL_S,
                 max_stacks: int = MAX_STACKS,
                 max_sites: int = MAX_SITES,
                 max_depth: int = MAX_DEPTH,
                 clock: Callable[[], float] = time.perf_counter,
                 frames_fn: Callable[[], Mapping[int, Any]]
                 = sys._current_frames,
                 threads_fn: Callable[[], Mapping[int, str]]
                 = thread_names,
                 trigger: Optional[Callable[[], bool]] = None) -> None:
        self.interval_s = interval_s
        self.max_stacks = max_stacks
        self.max_sites = max_sites
        self.max_depth = max_depth
        self.clock = clock
        self.frames_fn = frames_fn
        self.threads_fn = threads_fn
        self._trigger = trigger
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: folded stack -> sample count (bounded at max_stacks)
        self._stacks: Dict[str, int] = {}
        #: thread name -> {site: [self, total]} (bounded at max_sites)
        self._sites: Dict[str, Dict[str, List[int]]] = {}
        self._samples = 0
        self._dropped = 0
        self._sample_cost_s = 0.0
        self._started_at = self.clock()

    # -- aggregation ----------------------------------------------------------
    def reset(self) -> None:
        """Drop all aggregates and restart the overhead-metering epoch
        (test seam; also useful after a deploy marker)."""
        with self._lock:
            self._stacks.clear()
            self._sites.clear()
            self._samples = 0
            self._dropped = 0
            self._sample_cost_s = 0.0
            self._started_at = self.clock()

    def sample_once(self) -> int:
        """Walk every live thread's current frame once and aggregate.
        Returns the number of thread stacks folded in. Never raises —
        a profiler must not be able to take down what it profiles."""
        t0 = self.clock()
        own = threading.get_ident()
        entries: List[tuple] = []
        try:
            names = self.threads_fn()
            for ident, frame in sorted(self.frames_fn().items()):
                if ident == own:
                    continue  # never charge threads for sampling them
                stack = self._walk(frame)
                if stack:
                    entries.append(
                        (names.get(ident, f"thread-{ident}"), stack))
        except Exception:  # noqa: BLE001 — observe-only by contract
            metrics.SWALLOWED_ERRORS.inc(site="profiler.sample")
            return 0
        with self._lock:
            for name, stack in entries:
                self._aggregate_locked(name, stack)
            self._samples += 1
            self._sample_cost_s += max(0.0, self.clock() - t0)
        metrics.PROFILE_SAMPLES.inc()
        return len(entries)

    def _walk(self, frame: Any) -> List[str]:
        """Leaf-to-root walk capped at max_depth, returned root-first
        (the folded-stack convention)."""
        sites: List[str] = []
        f: Any = frame
        while f is not None and len(sites) < self.max_depth:
            code = getattr(f, "f_code", None)
            if code is None:
                break
            sites.append(_site(code.co_filename, code.co_name))
            f = getattr(f, "f_back", None)
        sites.reverse()
        return sites

    def _aggregate_locked(self, name: str, stack: List[str]) -> None:
        folded = name + ";" + ";".join(stack)
        if folded in self._stacks:
            self._stacks[folded] += 1
        elif len(self._stacks) < self.max_stacks:
            self._stacks[folded] = 1
        else:
            self._dropped += 1
            metrics.PROFILE_DROPPED.inc()
        table = self._sites.setdefault(name, {})
        for site in dict.fromkeys(stack):  # once per sample, recursion-safe
            counts = table.get(site)
            if counts is None:
                if len(table) >= self.max_sites:
                    self._dropped += 1
                    metrics.PROFILE_DROPPED.inc()
                    continue
                counts = [0, 0]
                table[site] = counts
            counts[1] += 1
        leaf = table.get(stack[-1])
        if leaf is not None:
            leaf[0] += 1

    # -- render ---------------------------------------------------------------
    def folded(self) -> str:
        """Collapsed-stack flamegraph lines (``thread;root;…;leaf N``),
        sorted — byte-identical for identical sample sets."""
        with self._lock:
            items = sorted(self._stacks.items())
        return "\n".join(f"{key} {count}" for key, count in items)

    def top_sites(self, n: int = 3) -> List[dict]:
        """Top self-time sites across all threads as damped-digest
        rows: self fractions are quantized to 0.05 so a one-sample
        wobble cannot flap the telemetry publisher."""
        with self._lock:
            agg: Dict[str, int] = {}
            for table in self._sites.values():
                for site, counts in table.items():
                    agg[site] = agg.get(site, 0) + counts[0]
        total = sum(agg.values())
        if not total:
            return []
        rows = sorted(agg.items(), key=lambda kv: (-kv[1], kv[0]))[:n]
        return [{"site": site,
                 "selfFraction": round(round(c / total * 20) / 20, 2)}
                for site, c in rows]

    def snapshot(self) -> dict:
        """JSON view for ``/debug/profile``: per-thread top rows, the
        folded form, and the profiler's own accounting (samples,
        drops, self-metered overhead). Also refreshes the
        ``tpu_profile_*`` gauges."""
        with self._lock:
            elapsed = max(self.clock() - self._started_at, 1e-9)
            ratio = min(1.0, self._sample_cost_s / elapsed)
            tracked = sum(len(t) for t in self._sites.values())
            threads: Dict[str, List[dict]] = {}
            for name in sorted(self._sites):
                rows = [{"site": site, "self": c[0], "total": c[1]}
                        for site, c in self._sites[name].items()]
                rows.sort(key=lambda r: (-int(r["self"]),
                                         -int(r["total"]),
                                         str(r["site"])))
                threads[name] = rows[:32]
            stacks = sorted(self._stacks.items())
            samples = self._samples
            dropped = self._dropped
            cost = self._sample_cost_s
        metrics.PROFILE_OVERHEAD.set(ratio)
        metrics.PROFILE_TRACKED_SITES.set(float(tracked))
        return {
            "running": self.running,
            "intervalS": self.interval_s,
            "samples": samples,
            "dropped": dropped,
            "trackedSites": tracked,
            "sampleCostS": round(cost, 6),
            "elapsedS": round(elapsed, 6),
            "overheadRatio": round(ratio, 6),
            "threads": threads,
            "folded": "\n".join(f"{k} {v}" for k, v in stacks),
        }

    # -- background loop ------------------------------------------------------
    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> None:
        """Spawn the sampling thread (idempotent). The thread is a
        daemon named ``profiler`` — it shows up in its own frame walks
        only as excluded."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="profiler", daemon=True)
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
                metrics.SWALLOWED_ERRORS.inc(site="profiler.trigger")
                return
            self.sample_once()


#: process-global profiler (started by the serving shell / daemon
#: entrypoints; tests build their own with injected sources)
PROFILER = SamplingProfiler()


def debug_handler() -> dict:
    """``/debug/profile`` payload: the global profiler's snapshot (the
    reference's payload without its ``"jax"`` compile-watch block)."""
    return PROFILER.snapshot()
