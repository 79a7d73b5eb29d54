"""The control of a serving cell's comparison: the precision below the
configuration's bfloat16 put in the program's place.

The reference with every product's operands rounded to float8 (e4m3, one
scale a tensor), over each sampled sequence at once, routed in the same
groups as the program served it. At each position the control reads the
float32 reference's gap of the token that it puts first. (The program's
own W8A8 path is no control here: its int8 logits product needs a
vocabulary that is a multiple of 8, and GPT-2's is 50257; nor does it
quantize a MoE layer's router and experts.)
"""

from __future__ import annotations

import torch

from . import compare, reference
from .weights import make_weights


def serve_control_numbers(config: dict, traffic: dict, seed: int,
                          sequences: list, device: torch.device) -> dict:
    """The control's ``serve_numbers`` over a run's sample."""
    params32 = reference.fp32_tree(make_weights(config, seed, device))
    gaps: list = []
    for prompt, served, chunks in sequences:
        ids = prompt + served[:-1]
        groups = reference.served_groups(len(prompt), len(ids), chunks,
                                         traffic["chunk_tokens"])
        ref = reference.sequence_logits(params32, ids, config, device,
                                        groups=groups)
        low = reference.sequence_logits(params32, ids, config, device,
                                        reference.mm_fp8, groups)
        picked = low[len(prompt) - 1:].argmax(-1).tolist()
        gaps += compare.served_gaps(ref, len(prompt), picked)
    return compare.serve_numbers(gaps)
