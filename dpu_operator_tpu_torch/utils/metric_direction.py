"""Metric-direction inference shared by the bench trajectory tool and
the live trend engine.

The port's copy of ``dpu_operator_tpu/utils/metric_direction.py``, whole:
the port's trend engine (``utils/trend.py``) judges a series' direction
with the same vocabulary and precedence as the reference's.

A metric's NAME usually says which way is good: ``tokens_per_s`` up,
``ttft_p99_s`` down, ``acceptance_rate`` up. tools/bench_trend.py grew
this judgment first (for the checked-in BENCH_r*.json rounds); the
metrics-history trend engine (utils/trend.py) needs the identical
judgment for live series, so the token tables live here and both
consumers import them — one vocabulary, one precedence order, pinned
by a parity test (tests/test_history.py).

Precedence, highest first:

1. **strong higher** tokens settle the direction outright — a ttft
   *improvement* is higher-better even though ttft itself is a latency;
2. **lower** tokens (latencies, loss/waste counters);
3. **higher** tokens (rates, throughput, completions).

Throughput suffixes (``tok_s``, ``tokens_per_s``, ``per_s``) collapse
to ``rate`` BEFORE tokenization so the trailing ``s`` can never read as
a seconds suffix.
"""

from __future__ import annotations

import re
from typing import List

__all__ = ["HIGHER", "LOWER", "STRONG_HIGHER", "UNKNOWN", "direction",
           "tokens"]

#: the three verdicts, for callers that prefer names over signs
HIGHER, LOWER, UNKNOWN = +1, -1, 0

#: tokens that settle the direction outright (a ttft IMPROVEMENT is
#: higher-better even though ttft itself is a latency)
STRONG_HIGHER = frozenset({
    "improvement", "speedup", "acceptance", "accepted", "mfu",
    "throughput",
})

#: name tokens that mark a metric as lower-is-better (latencies,
#: loss/waste counters, pressure gauges)
_LOWER_TOKENS = frozenset({
    "ms", "s", "p50", "p95", "p99", "ttft", "itl", "latency", "rtt",
    "leaked", "discarded", "rejected", "preemptions", "copies",
    "opened", "stalls", "dropped", "retraces",
})

#: name tokens that mark a metric as higher-is-better
_HIGHER_TOKENS = frozenset({
    "rate", "tokens", "tflops", "peak", "completed", "hits", "shared",
    "reconciles", "cut", "ratio",
})


def tokens(metric: str) -> List[str]:
    """Lowercased name tokens with throughput suffixes collapsed to
    ``rate`` first (``tok_s``/``tokens_per_s``/``per_s`` are rates,
    not durations — the collapse must run BEFORE ``s`` can read as a
    seconds suffix)."""
    name = re.sub(r"tok(ens)?_s|per_s", "rate", metric.lower())
    return [t for t in re.split(r"[^a-z0-9]+", name) if t]


def direction(metric: str) -> int:
    """+1 higher-is-better, -1 lower-is-better, 0 unknown."""
    toks = tokens(metric)
    if any(t in STRONG_HIGHER for t in toks):
        return HIGHER
    if any(t in _LOWER_TOKENS for t in toks):
        return LOWER
    if any(t in _HIGHER_TOKENS for t in toks):
        return HIGHER
    return UNKNOWN
