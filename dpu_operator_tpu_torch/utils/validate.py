"""Ingress validation helpers: the sanitizers every untrusted field of
the serving ingress passes before it can size a read, a KV reservation or
a decode budget.

The port's copy of ``dpu_operator_tpu/utils/validate.py``, whole. Each
helper REFUSES (raises ``ValueError``) rather than silently clamps: the
ingress turns the refusal into a 400, so hostile input fails loudly at the
boundary and never reaches the scheduler.
"""

from __future__ import annotations

import math
import re
from typing import Iterable, TypeVar

_T = TypeVar("_T")

#: conservative filename charset: no separators, no traversal, no
#: NUL/control bytes — what a sandbox id / ifname / chip id may look
#: like when it becomes a path component
_SEGMENT_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


def clamped_int(value: object, lo: int, hi: int,
                what: str = "value") -> int:
    """*value* coerced to int and verified to lie in [*lo*, *hi*];
    raises ``ValueError`` otherwise (including NaN/inf floats and
    non-numeric types). The allocation-size sanitizer: a size that
    passed here can no longer wedge a reservation."""
    if isinstance(value, bool):
        raise ValueError(f"{what} must be an integer, got a bool")
    if isinstance(value, float) and not math.isfinite(value):
        raise ValueError(f"{what} must be finite, got {value!r}")
    try:
        out = int(value)  # type: ignore[call-overload]
    except (TypeError, ValueError) as e:
        raise ValueError(f"{what} must be an integer: {e}") from None
    if not lo <= out <= hi:
        raise ValueError(
            f"{what} must be in [{lo}, {hi}], got {out}")
    return out


def parse_choice(value: object, allowed: Iterable[str],
                 what: str = "value") -> str:
    """*value* verified to be one of *allowed* (a bounded enumeration);
    raises ``ValueError`` otherwise. The metric-label / subprocess-arg
    sanitizer for enumerated fields."""
    choices = tuple(allowed)
    if value not in choices:
        raise ValueError(
            f"{what} must be one of {sorted(choices)}, got {value!r}")
    return str(value)


def safe_path_segment(value: object, what: str = "path segment",
                      max_len: int = 255, extra: str = "") -> str:
    """*value* verified to be a single safe path component: bounded
    length, conservative charset, no separators and no ``..`` — the
    filesystem-path sanitizer for ids that become file names (sandbox
    ids, ifnames, chip ids). *extra* admits additional benign
    characters (PCI-style device ids carry ``:``). Raises
    ``ValueError`` otherwise."""
    out = str(value)
    if len(out) > max_len:
        raise ValueError(
            f"{what} longer than {max_len} chars")
    if out in (".", ".."):
        raise ValueError(f"{what} may not be a dot segment")
    pattern = _SEGMENT_RE if not extra else re.compile(
        r"^[A-Za-z0-9][A-Za-z0-9._\-%s]*$" % re.escape(extra))
    if not pattern.match(out):
        raise ValueError(
            f"{what} {out!r} has characters outside "
            f"[A-Za-z0-9._-{extra}] (or a leading separator/dot)")
    return out


def bounded_str(value: object, max_len: int = 256,
                what: str = "value") -> str:
    """*value* as a string verified to be printable and bounded —
    the general-purpose sanitizer for free-form ids that land in
    traces, snapshots and error messages. Raises ``ValueError`` on
    oversize or control characters (log-record forgery)."""
    out = str(value)
    if len(out) > max_len:
        raise ValueError(f"{what} longer than {max_len} chars")
    if any(ord(c) < 0x20 or ord(c) == 0x7f for c in out):
        raise ValueError(f"{what} contains control characters")
    return out
