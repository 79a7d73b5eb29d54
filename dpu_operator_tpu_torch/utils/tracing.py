"""Request-scoped tracing: W3C trace contexts and the serving span ids.

The port's copy of ``dpu_operator_tpu/utils/tracing.py``, trimmed to what
the serving shell uses:

- :class:`SpanContext` (a 128-bit ``trace_id`` shared by every span of one
  request, a 64-bit ``span_id`` an operation) and :func:`span`, which
  records each finished span in the flight ring (kind ``span``);
- :func:`extract_traceparent` (a strict parse: hostile input yields
  ``None``, never an exception), :func:`inject_traceparent` and
  :func:`context_scope`, which adopts a caller's context on this thread;
- :func:`exemplar`, the exemplar label set of a histogram observation;
- :func:`det_trace_id` / :func:`det_span_id`, the deterministic ids of the
  scheduler's phase spans, equal to the reference's for the same inputs;
- :func:`profiled`, a ``torch.profiler.record_function`` range that exists
  only while the profiler records: the serving loop's spans (``serve.*``,
  ``kv_pool.*``, ``executor.*``, ``model.*``) on the clock the profiler
  aligns the device's kernels to. :func:`span` opens one too.

The reference's JSONL sink (``TPU_OPERATOR_TRACE``), its thread-pool
wrapper and its log filter are not ported: the port's spans go to the
flight ring alone.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import re
import threading
import time
import uuid
from typing import ContextManager, Iterator, Optional

from torch.autograd import profiler as _autograd_profiler

from . import flight

_local = threading.local()

TRACEPARENT_HEADER = "traceparent"

#: W3C traceparent: version "-" 32 hex trace-id "-" 16 hex span-id "-"
#: 2 hex flags, all lowercase
_TRACEPARENT_RE = re.compile(
    r"\A([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})\Z")


@dataclasses.dataclass(frozen=True)
class SpanContext:
    """One span's identity within a trace."""

    trace_id: str  # 32 lowercase hex chars (128-bit)
    span_id: str   # 16 lowercase hex chars (64-bit)

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"


_NO_RANGE = contextlib.nullcontext()


def profiled(name: str) -> ContextManager:
    """A ``record_function`` range named *name* while ``torch.profiler``
    records, so the trace lays the host's work under it beside the device's
    kernels; with no profiler running, a shared no-op context (the cost is
    one flag read)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_RANGE
    return _autograd_profiler.record_function(name)


def new_trace_id() -> str:
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def det_trace_id(seed: str) -> str:
    """Deterministic trace id from a stable seed string (sha256): the
    scheduler mints these for requests that arrive without a caller
    context, so a seeded run replays the same span tree."""
    return hashlib.sha256(("trace:" + seed).encode()).hexdigest()[:32]


def det_span_id(trace_id: str, key: str, seq: int) -> str:
    """Deterministic id of the *seq*-th span of *key* within
    *trace_id*."""
    return hashlib.sha256(
        f"span:{trace_id}:{key}:{seq}".encode()).hexdigest()[:16]


def current() -> Optional[SpanContext]:
    """The active span context on this thread, if any."""
    ctx = getattr(_local, "ctx", None)
    return ctx if isinstance(ctx, SpanContext) else None


def exemplar() -> Optional[dict]:
    """Exemplar label set for a histogram observation: the current
    trace."""
    ctx = current()
    return {"trace_id": ctx.trace_id} if ctx else None


def inject_traceparent() -> Optional[str]:
    """The header value carrying the current context to the next hop;
    ``None`` outside any span."""
    ctx = current()
    return ctx.traceparent() if ctx else None


def extract_traceparent(value: object) -> Optional[SpanContext]:
    """Strict parse of an inbound traceparent. ``None`` for anything
    malformed or hostile: non-strings, wrong field widths, uppercase hex,
    the invalid version ``ff``, all-zero ids, embedded whitespace or
    newlines."""
    if not isinstance(value, str) or len(value) > 64:
        return None
    m = _TRACEPARENT_RE.match(value)
    if m is None:
        return None
    version, trace_id, span_id, _flags = m.groups()
    if version == "ff":
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id, span_id)


@contextlib.contextmanager
def context_scope(ctx: Optional[SpanContext]) -> Iterator[None]:
    """Adopt *ctx* as this thread's current context; ``None`` is a no-op,
    so an extract result passes straight through."""
    if ctx is None:
        yield
        return
    prev = getattr(_local, "ctx", None)
    _local.ctx = ctx
    try:
        yield
    finally:
        _local.ctx = prev


@contextlib.contextmanager
def span(name: str, /, **attributes: object) -> Iterator[SpanContext]:
    """Record a span around a block (nesting tracked per thread). Yields
    a live :class:`SpanContext`, a fresh root trace when no context is
    active, and lands the finished span in the flight ring; under a
    running profiler the block is a :func:`profiled` range of the same
    name too."""
    parent = current()
    ctx = SpanContext(parent.trace_id if parent else new_trace_id(),
                      new_span_id())
    prev = getattr(_local, "ctx", None)
    _local.ctx = ctx
    t0 = time.perf_counter()
    error = ""
    try:
        with profiled(name):
            yield ctx
    except BaseException as e:
        error = f"{type(e).__name__}: {e}"
        raise
    finally:
        _local.ctx = prev
        flight.record("span", name, trace_id=ctx.trace_id,
                      span_id=ctx.span_id,
                      parent_id=parent.span_id if parent else None,
                      duration_s=round(time.perf_counter() - t0, 6),
                      error=error,
                      attributes={k: str(v) for k, v in
                                  attributes.items()} or None)
