"""Ulysses sequence parallelism for long context: two all-to-alls a layer.

Port of ``dpu_operator_tpu/workloads/ulysses.py``. Activations arrive
sequence-sharded (S/n rows a rank, every head); an all-to-all re-shards
them to head-sharded (every row, H/n heads), the port's differentiable
flash attention (``ops.flash_attention_vjp``: the hand-written forward
with the logsumexp, dQ and dK/dV kernels on the card) runs on the rank's
heads, and a second all-to-all restores sequence sharding. Both
all-to-alls are ``collectives.AllToAll``, differentiable as
``lax.all_to_all`` is. Needs ``n_heads % n == 0``.

Unlike the reference it takes no ``block_q`` / ``block_k``: the port's
kernels choose their blocks for the card.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops import flash_attention_vjp
from .collectives import all_to_all
from .mesh import axis_size


def ulysses_attention(mesh: DeviceMesh, axis: str = "model",
                      causal: bool = True) -> Callable[..., torch.Tensor]:
    """(q, k, v) -> attention with the sequence sharded over *axis*.

    q / k / v are the rank's (B, S/n, H, D) shards, sequence-sharded on
    entry and exit; heads are sharded only inside the all-to-all sandwich.
    A head count that does not split over the axis raises ``ValueError``
    (``collectives.all_to_all``)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return lambda q, k, v: flash_attention_vjp(q, k, v, causal)
    # (B, S/n, H, D) -> (B, S, H/n, D): scatter heads, gather the sequence
    seq_to_heads = all_to_all(mesh, axis, split=2, concat=1)
    heads_to_seq = all_to_all(mesh, axis, split=1, concat=2)

    def _attn(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
        out = flash_attention_vjp(seq_to_heads(q), seq_to_heads(k),
                                  seq_to_heads(v), causal)
        return heads_to_seq(out)

    return _attn
