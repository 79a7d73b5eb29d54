"""Small statistics helpers of the port (its own copy of
``dpu_operator_tpu/utils/stats.py``, under the isolation rule)."""

from __future__ import annotations

import math
from typing import Sequence


def nearest_rank(samples: Sequence[float], frac: float) -> float:
    """Nearest-rank percentile: the sorted sample at index
    ``ceil(frac * n) - 1`` (never ``int(frac * n)``, which reads the
    maximum whenever ``frac * n`` is integral), 0.0 for an empty set. The
    one rank rule of the port's serving records and its bench."""
    if not samples:
        return 0.0
    ordered = sorted(samples)
    return ordered[max(0, math.ceil(frac * len(ordered)) - 1)]
