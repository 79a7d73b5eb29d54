"""Retry backoff for the serving path's retry-with-rebuild.

The port's copy of ``RetryPolicy`` from ``dpu_operator_tpu/utils/
resilience.py``, trimmed to what the scheduler uses: the constructor and
:meth:`RetryPolicy.backoff`. The scheduler gates a retried request on its
own clock (``Request.retry_at``) and never sleeps, so the reference's
``call`` loop, deadline budget, breaker and metrics are left out.
"""

from __future__ import annotations

import random
from typing import Optional


class RetryPolicy:
    """Exponential backoff with full jitter: the wait before retry number
    *attempt* (0-based) is ``uniform(0, min(cap, base * 2**attempt))``,
    drawn from *rng* (seed it and the waits replay exactly)."""

    def __init__(self, max_attempts: int = 3, base: float = 0.05,
                 cap: float = 2.0,
                 rng: Optional[random.Random] = None) -> None:
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = max_attempts
        self.base = base
        self.cap = cap
        self.rng = rng or random.Random()

    def backoff(self, attempt: int) -> float:
        """Full-jitter wait before retry number *attempt* (0-based)."""
        return self.rng.uniform(0.0, min(self.cap,
                                         self.base * (2 ** attempt)))
