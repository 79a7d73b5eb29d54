"""The comparison that decides ``correct``: the numbers compared and their
judgement against the cell's limits (``limits/<cell>.json``).

Over the served tokens of a sample of finished requests, the gap by which
each served token's reference logit lies below the reference's best logit
at its position: the widest and the mean.
"""

from __future__ import annotations

import math

import torch

def served_gaps(ref_logits: torch.Tensor, prompt_len: int,
                served: list) -> list:
    """Per served token of one request, the gap between the reference's
    best logit and the served token's at its position: row ``prompt_len -
    1 + j`` of the reference's logits over the prompt and the served
    tokens predicts served token j."""
    rows = ref_logits[prompt_len - 1:prompt_len - 1 + len(served)]
    picked = rows.gather(1, torch.tensor(served, device=rows.device)[:, None])
    return (rows.max(-1).values - picked[:, 0]).tolist()


def serve_numbers(gaps: list) -> dict:
    """``logit_gap``, the widest of the served tokens' gaps, and
    ``logit_gap_mean``, their mean."""
    if not gaps:
        return {"logit_gap": math.nan, "logit_gap_mean": math.nan}
    return {"logit_gap": max(gaps), "logit_gap_mean": sum(gaps) / len(gaps)}


def judge(numbers: dict, limits: dict) -> bool:
    """Correct when every number is finite and within its limit."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in limits)
