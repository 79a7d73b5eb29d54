"""Flight recorder: a bounded in-memory ring of recent operational events.

The port's copy of ``dpu_operator_tpu/utils/flight.py``: the ring, its
``record`` / ``snapshot`` / ``events`` / ``clear``, the
``TPU_FLIGHT_CAPACITY`` clamp, and :func:`fetch`, the JSON GET of a
``/debug/...`` endpoint. The serving scheduler records its lifecycle phase
spans and outcomes here (kind ``serve``), :mod:`.tracing` every finished
span (kind ``span``); :class:`.metrics.MetricsServer` serves the ring at
``/debug/flight``.

Events carry the active ``trace_id`` / ``span_id`` when one exists, so a
dump joins against the trace tree.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import Any, Mapping, Optional

log = logging.getLogger(__name__)

DEFAULT_CAPACITY = 512

#: TPU_FLIGHT_CAPACITY is clamped to this range: below, the ring cannot
#: hold one request's spans; above, a dump stops being a bounded snapshot
MIN_CAPACITY, MAX_CAPACITY = 16, 65536


def capacity_from_env(env: Optional[Mapping[str, str]] = None) -> int:
    """Ring capacity from ``TPU_FLIGHT_CAPACITY``; a non-integer or
    out-of-range value falls back to the default with a logged warning."""
    raw = (env if env is not None else os.environ).get(
        "TPU_FLIGHT_CAPACITY", "")
    if not raw:
        return DEFAULT_CAPACITY
    try:
        value = int(raw)
    except ValueError:
        log.warning("TPU_FLIGHT_CAPACITY=%r is not an integer; using "
                    "the default %d", raw, DEFAULT_CAPACITY)
        return DEFAULT_CAPACITY
    if not MIN_CAPACITY <= value <= MAX_CAPACITY:
        log.warning("TPU_FLIGHT_CAPACITY=%d outside [%d, %d]; using "
                    "the default %d", value, MIN_CAPACITY, MAX_CAPACITY,
                    DEFAULT_CAPACITY)
        return DEFAULT_CAPACITY
    return value


class FlightRecorder:
    """Thread-safe bounded event ring (oldest evicted first)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self.capacity = capacity
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        #: events evicted by ring overflow, per kind (mirrored to
        #: tpu_flight_dropped_total)
        self._dropped: dict = {}

    def record(self, kind: str, name: str,
               trace_id: Optional[str] = None,
               span_id: Optional[str] = None,
               parent_id: Optional[str] = None,
               duration_s: Optional[float] = None,
               error: str = "",
               attributes: Optional[dict] = None) -> None:
        """Append one event. Without *trace_id*, the current thread's
        trace context (if any) is stamped."""
        if trace_id is None:
            # lazy import: tracing imports this module at load time
            from . import tracing
            ctx = tracing.current()
            if ctx is not None:
                trace_id, span_id = ctx.trace_id, ctx.span_id
        event: dict = {"ts": round(time.time(), 6), "kind": kind,
                       "name": name}
        if trace_id:
            event["trace_id"] = trace_id
        if span_id:
            event["span_id"] = span_id
        if parent_id:
            event["parent_id"] = parent_id
        if duration_s is not None:
            event["duration_s"] = duration_s
        if error:
            event["error"] = error
        if attributes:
            event["attributes"] = attributes
        dropped_kind: Optional[str] = None
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            if len(self._events) == self.capacity:
                dropped_kind = str(self._events[0].get("kind", ""))
                self._dropped[dropped_kind] = \
                    self._dropped.get(dropped_kind, 0) + 1
            self._events.append(event)
        if dropped_kind is not None:
            _count_dropped(dropped_kind)

    def snapshot(self) -> dict:
        """JSON-ready dump: events oldest first, with the eviction
        accounting (``recorded - len(events)`` events were lost)."""
        with self._lock:
            events = list(self._events)
            recorded = self._seq
            dropped = dict(self._dropped)
        return {"capacity": self.capacity, "recorded": recorded,
                "dropped": dropped, "events": events}

    def events(self, kind: Optional[str] = None) -> list:
        """The events of one kind (all without *kind*)."""
        with self._lock:
            events = list(self._events)
        if kind is not None:
            events = [e for e in events if e["kind"] == kind]
        return events

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._seq = 0
            self._dropped.clear()


def _count_dropped(kind: str) -> None:
    """Bump ``tpu_flight_dropped_total{kind}``; lazy and guarded, since
    :mod:`.metrics` imports this module at load time."""
    from . import metrics
    counter = getattr(metrics, "FLIGHT_DROPPED", None)
    if counter is not None:
        counter.inc(kind=kind)


#: the process-global ring, sized from TPU_FLIGHT_CAPACITY when set
RECORDER = FlightRecorder(capacity_from_env())


def record(kind: str, name: str, **kwargs: Any) -> None:
    """Record on the global ring (see :meth:`FlightRecorder.record`)."""
    RECORDER.record(kind, name, **kwargs)


def fetch(addr: str, timeout: float = 5.0,
          path: str = "/debug/flight") -> dict:
    """GET a JSON debug endpoint of a MetricsServer at ``host:port``."""
    import http.client
    import json
    host, sep, port = addr.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(
            f"expected host:port for the metrics endpoint, got {addr!r}")
    conn = http.client.HTTPConnection(host or "127.0.0.1", int(port),
                                      timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            raise RuntimeError(
                f"{path} returned HTTP {resp.status}: "
                f"{body[:200].decode('utf-8', 'replace')}")
        return json.loads(body)
    finally:
        conn.close()
