"""The Event seam of the port's health engine.

The reference's deep layers (watchdog stalls, SLO alerts, the serving
scheduler's rejections, preemptions, poisonings and rung changes) emit
Kubernetes Events through ``dpu_operator_tpu/k8s/events.py``'s
module-global emitter, a no-op until a recorder is configured. The port
keeps the same shape without the Kubernetes client: :func:`configure`
installs a sink, a callable ``sink(reason, message, type_, series)``, and
:func:`emit` is a no-op until one is installed. A pod that serves through
the port passes an emitter of its own; the tests pass a list's append.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

_lock = threading.Lock()
_sink: Optional[Callable[[str, str, str, str], None]] = None


def configure(sink: Callable[[str, str, str, str], None]) -> None:
    """Install the process-global sink (replacing any earlier one)."""
    global _sink
    with _lock:
        _sink = sink


def reset() -> None:
    """Drop the sink: :func:`emit` is a no-op again."""
    global _sink
    with _lock:
        _sink = None


def emit(reason: str, message: str, type_: str = "Normal",
         series: str = "") -> None:
    """Hand one Event to the sink; no-op while none is configured.
    *series* is the stable deduplication key of a repeated Event."""
    with _lock:
        sink = _sink
    if sink is not None:
        sink(reason, message, type_, series)
