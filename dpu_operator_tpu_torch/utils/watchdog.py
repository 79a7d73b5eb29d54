"""Watchdog: named heartbeats with deadlines, and stall detection.

The port's copy of ``dpu_operator_tpu/utils/watchdog.py``, trimmed to what
the serving shell uses: the task-scoped :class:`Heartbeat` (idle is
healthy; each unit of work runs inside :meth:`Heartbeat.task` and stalls
only when it outlives the deadline), :class:`Watchdog` with
:meth:`Watchdog.check` (a heartbeat past its deadline dumps every thread's
stack into the flight ring, kind ``stall``, bumps
``tpu_watchdog_stalls_total`` and emits a ``WatchdogStall`` Event;
recovery emits ``WatchdogRecovered``), the process-global
:data:`WATCHDOG` with :func:`register` and :func:`task`, and
:func:`emit_health_event`, which hands an Event to the port's own seam
(:mod:`.events`). The clock is injectable. The reference's periodic
heartbeats, its background checker thread and its ``/debug/health`` rows
are left out: nothing in the port uses them.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import sys
import threading
import time
import traceback
from typing import Callable, ContextManager, Iterator, Optional

from . import events, flight, metrics

log = logging.getLogger(__name__)

#: a stack dump landing in the flight ring is truncated to this many
#: characters, so one stall cannot evict the history it explains
MAX_DUMP_CHARS = 8000


def dump_all_stacks(limit: int = MAX_DUMP_CHARS) -> str:
    """Formatted stacks of every live thread, truncated to *limit*
    characters with an explicit marker."""
    names = {t.ident: t.name for t in threading.enumerate()}
    parts: list[str] = []
    for ident, frame in sys._current_frames().items():
        parts.append(f"-- thread {names.get(ident, '?')} ({ident}) --")
        parts.extend(line.rstrip()
                     for line in traceback.format_stack(frame))
    text = "\n".join(parts)
    if len(text) > limit:
        text = (text[:limit]
                + f"\n... [truncated {len(text) - limit} chars]")
    return text


class Heartbeat:
    """One named, task-scoped liveness contract with the watchdog: a unit
    of work inside :meth:`task` that outlives *deadline* seconds is a
    stall; idle is healthy however long."""

    def __init__(self, name: str, deadline: float,
                 owner: "Watchdog") -> None:
        self.name = name
        self.deadline = deadline
        self._owner = owner
        self._clock = owner.clock
        self._lock = threading.Lock()
        self._tokens = itertools.count(1)
        self._last = self._clock()
        self._tasks: dict[int, float] = {}
        self._closed = False

    @contextlib.contextmanager
    def task(self) -> Iterator[None]:
        """Arm the deadline for one unit of work; disarm on exit, also on
        error (a failed task is not a stalled one)."""
        token = next(self._tokens)
        now = self._clock()
        with self._lock:
            self._tasks[token] = now
            self._last = now
        try:
            yield
        finally:
            with self._lock:
                self._tasks.pop(token, None)
                self._last = self._clock()

    def overdue(self, now: float) -> bool:
        with self._lock:
            if self._closed:
                return False
            return bool(self._tasks) \
                and now - min(self._tasks.values()) > self.deadline

    def state(self, now: float) -> dict:
        with self._lock:
            busy = (round(now - min(self._tasks.values()), 3)
                    if self._tasks else None)
            return {"name": self.name, "deadline_s": self.deadline,
                    "age_s": round(now - self._last, 3),
                    "busy_s": busy}

    def close(self) -> None:
        """Unregister: a stopped loop must not read as a stalled one."""
        with self._lock:
            self._closed = True
        self._owner.unregister(self)


class Watchdog:
    """One checker over every registered heartbeat; :meth:`check` is the
    unit of progress."""

    def __init__(self, clock: Callable[[], float] = time.monotonic) -> None:
        self.clock = clock
        self._lock = threading.Lock()
        self._beats: list[Heartbeat] = []
        self._stalled: "set[Heartbeat]" = set()

    def register(self, name: str, deadline: float) -> Heartbeat:
        hb = Heartbeat(name, deadline, self)
        with self._lock:
            self._beats.append(hb)
        return hb

    def unregister(self, hb: Heartbeat) -> None:
        with self._lock:
            if hb in self._beats:
                self._beats.remove(hb)
            self._stalled.discard(hb)

    def check(self) -> tuple[list[Heartbeat], list[Heartbeat]]:
        """One detection pass: (newly stalled, newly recovered)."""
        now = self.clock()
        with self._lock:
            beats = list(self._beats)
        stalled: list[Heartbeat] = []
        recovered: list[Heartbeat] = []
        for hb in beats:
            overdue = hb.overdue(now)
            with self._lock:
                was = hb in self._stalled
                if overdue and not was:
                    self._stalled.add(hb)
                    stalled.append(hb)
                elif not overdue and was:
                    self._stalled.discard(hb)
                    recovered.append(hb)
        for hb in stalled:
            self._on_stall(hb, now)
        for hb in recovered:
            self._on_recover(hb)
        return stalled, recovered

    def _on_stall(self, hb: Heartbeat, now: float) -> None:
        state = hb.state(now)
        silent_s = (state["busy_s"] if state["busy_s"] is not None
                    else state["age_s"])
        overdue_s = round(max(float(silent_s) - hb.deadline, 0.0), 3)
        metrics.WATCHDOG_STALLS.inc(component=hb.name)
        flight.record("stall", hb.name, attributes={
            "deadline_s": str(hb.deadline),
            "overdue_s": str(overdue_s),
            "stacks": dump_all_stacks()})
        log.error("watchdog: %s stalled (%.1fs past its %.1fs deadline); "
                  "all-thread stacks recorded in the flight ring",
                  hb.name, overdue_s, hb.deadline)
        emit_health_event("WatchdogStall",
                          f"component {hb.name} stalled: no heartbeat "
                          f"within its {hb.deadline:g}s deadline "
                          f"({overdue_s}s overdue); all-thread stack "
                          "dump in the flight recorder (kind=stall)",
                          "Warning", series=hb.name)

    def _on_recover(self, hb: Heartbeat) -> None:
        flight.record("stall", hb.name,
                      attributes={"recovered": "true"})
        log.warning("watchdog: %s recovered (heartbeat resumed)",
                    hb.name)
        emit_health_event("WatchdogRecovered",
                          f"component {hb.name} recovered: heartbeat "
                          "resumed", "Normal", series=hb.name)

    def snapshot(self) -> list[dict]:
        """One state row a heartbeat."""
        now = self.clock()
        with self._lock:
            beats = list(self._beats)
            stalled = set(self._stalled)
        rows = []
        for hb in beats:
            row = hb.state(now)
            row["stalled"] = hb in stalled
            rows.append(row)
        return sorted(rows, key=lambda r: str(r["name"]))


#: the process-global watchdog
WATCHDOG = Watchdog()


def register(name: str, deadline: float) -> Heartbeat:
    """Register a task-scoped heartbeat on the global watchdog."""
    return WATCHDOG.register(name, deadline)


def task(heartbeat: Optional[Heartbeat]) -> ContextManager[None]:
    """``heartbeat.task()``, or a no-op scope without a heartbeat."""
    if heartbeat is None:
        return contextlib.nullcontext()
    return heartbeat.task()


def emit_health_event(reason: str, message: str, type_: str,
                      series: str = "") -> None:
    """The health engine's Event emitter: best effort, so a failing sink
    is logged and swallowed."""
    try:
        events.emit(reason, message, type_=type_, series=series)
    except Exception:  # noqa: BLE001 — event emission is best-effort
        log.debug("health event emission failed", exc_info=True)
