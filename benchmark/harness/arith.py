"""The card's peaks and the counts every block shares.

A copy of the port's ``workloads/perf.py`` table ``CARD_PEAKS``, taken
into the benchmark so that a change to the program cannot change the
yardstick. What a model's work is (its parameters, the FLOPs of the
window's serving work, the least time of a decode iteration's attention)
is its block's (``blocks/<block>.py``).
"""

from __future__ import annotations

from typing import Optional

#: data-sheet rates by the exact ``torch.cuda.get_device_name()``: dense
#: bf16 FLOP/s on the tensor cores and HBM bytes/s (NVIDIA's data sheet,
#: SXM part, at its full 700 W power limit)
CARD_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989e12,
                              "hbm_bytes_per_s": 3.35e12},
}

#: bytes an element of the served type
BF16_BYTES = 2


def peaks(device_name: str) -> Optional[dict]:
    """The card's peaks, or None for a card the table does not hold (a
    metric that needs them is then left out)."""
    return CARD_PEAKS.get(device_name)


def causal_pairs(rows: int, offset: int = 0) -> int:
    """(query row, key) pairs a causal mask admits for *rows* queries at
    positions offset .. offset + rows - 1: row p sees keys 0 .. p."""
    return rows * offset + rows * (rows + 1) // 2
