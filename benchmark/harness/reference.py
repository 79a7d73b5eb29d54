"""The plain reference: the configuration's model in plain PyTorch.

Float32 with TF32 off, no kernel, no cache, no batching tricks. The
layers are the configuration's block's (``blocks/<block>.py``,
``forward``), which follows the configuration's description.

It imports nothing of the program and takes nothing the program made: it
draws the weights again from the seed (:mod:`.weights`). What it reads of
a serving run is what it judges: the served tokens and, since a MoE
layer's capacity is a routing row's, the chunks the program prefilled
each prompt in. It runs once the program's state is freed, one sequence
at a time.

*mm* is the product every matrix multiplication goes through: float32,
or the control's, which rounds both operands to float8 (e4m3, one scale
per tensor) and so computes in the precision below the configuration's
bfloat16.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from .manifest import block_of

Mm = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@contextlib.contextmanager
def full_fp32():
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def mm_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale (its largest magnitude at
    448)."""
    scale = x.abs().amax().clamp(min=1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def mm_fp8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(_fp8(a), _fp8(b))


def fp32_tree(tree):
    """A float32 copy of a weight tree (nested dicts and lists)."""
    if isinstance(tree, dict):
        return {k: fp32_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [fp32_tree(v) for v in tree]
    return tree.detach().float().clone()


def forward(params: dict, tokens: torch.Tensor, config: dict,
            mm: Mm = mm_fp32, groups: Optional[list] = None) -> torch.Tensor:
    """Logits (B, S, V) of the configuration's block; *groups* as
    :func:`served_groups` gives them."""
    return block_of(config).forward(params, tokens, config["model"], mm,
                                    groups)


def served_groups(prompt_len: int, length: int, chunks: list,
                  width: int) -> list:
    """The routing groups of a served sequence of *length* tokens: each
    prefill chunk ``(offset, n)`` of the prompt padded to *width*, then
    the decoded tokens one a row."""
    return [(off, off + n, width) for off, n in chunks] + [
        (prompt_len, length, None)]


def sequence_logits(params32: dict, ids: list, config: dict,
                    device: "str | torch.device", mm: Mm = mm_fp32,
                    groups: Optional[list] = None) -> torch.Tensor:
    """Logits (L, V) float32 of one sequence: row t predicts token t + 1."""
    with full_fp32(), torch.no_grad():
        tokens = torch.tensor([ids], dtype=torch.long, device=device)
        return forward(params32, tokens, config, mm, groups)[0]
