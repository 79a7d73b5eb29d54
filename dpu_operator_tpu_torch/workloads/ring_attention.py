"""Ring attention: sequence parallelism for long context around a ring.

Port of ``dpu_operator_tpu/workloads/ring_attention.py``. The sequence is
sharded over a mesh axis: each rank keeps its query block and passes its
key and value blocks one hop round the ring a step
(``collectives.RingHop``, differentiable as ``lax.ppermute`` is),
accumulating an online softmax in fp32. A rank holds O(S/n) activations
and one (S/n)^2 score block at a time.

The per-block products are the reference's ``jnp.einsum`` s, outside any
Pallas kernel, so here they are plain PyTorch products, and autograd
differentiates the whole loop as JAX does. Fully masked blocks are
computed and masked, as in the reference.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch.distributed.device_mesh import DeviceMesh

from .collectives import ppermute_hop
from .mesh import axis_size

_NEG_INF = -1e30


def _block_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                qpos: torch.Tensor, kpos: torch.Tensor,
                causal: bool) -> tuple:
    """One Q-block x KV-block pass -> (unnormalized out, row-sum,
    row-max). q: (B, Sq, H, D), k / v: (B, Sk, H, D); the scores and the
    sums in fp32, P cast to v's type for the PV product."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / math.sqrt(q.shape[-1])
    if causal:
        mask = qpos[:, None] >= kpos[None, :]          # (Sq, Sk)
        scores = torch.where(mask, scores, _NEG_INF)
    # keep fully masked rows finite
    blk_max = scores.amax(-1).clamp(min=_NEG_INF)      # (B, H, Sq)
    p = torch.exp(scores - blk_max[..., None])
    blk_sum = p.sum(-1)                                # (B, H, Sq)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return out.float(), blk_sum, blk_max


def _heads_last(t: torch.Tensor) -> torch.Tensor:
    """(B, H, Sq) -> (B, Sq, H, 1), to scale a (B, Sq, H, D) block."""
    return t.movedim(1, -1)[..., None]


def ring_attention(mesh: DeviceMesh, axis: str = "model",
                   causal: bool = True) -> Callable[..., torch.Tensor]:
    """(q, k, v) -> attention with the sequence sharded over *axis*.

    q / k / v are the rank's (B, S/n, H, D) shards of the global (B, S, H,
    D) tensors, rank r holding rows [r S/n, (r+1) S/n); the output is the
    rank's rows of full attention, in q's type."""
    me = mesh.get_local_rank(axis)
    n = axis_size(mesh, axis)
    hop = ppermute_hop(mesh, axis)

    def _attn(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
        b, sq, h, _ = q.shape
        rows = torch.arange(sq, device=q.device)
        qpos = me * sq + rows
        acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        row_max = torch.full((b, h, sq), _NEG_INF, dtype=torch.float32,
                             device=q.device)
        row_sum = torch.zeros_like(row_max)
        # K / V hop one rank on after every block, the last hop returning
        # them to their owners, as the reference's fori_loop does
        for step in range(n):
            kpos = (me - step) % n * sq + rows
            out, blk_sum, blk_max = _block_attn(q, k, v, qpos, kpos, causal)
            new_max = torch.maximum(row_max, blk_max)
            scale_old = torch.exp(row_max - new_max)
            scale_new = torch.exp(blk_max - new_max)
            row_sum = row_sum * scale_old + blk_sum * scale_new
            acc = acc * _heads_last(scale_old) + out * _heads_last(scale_new)
            row_max = new_max
            k, v = hop(k), hop(v)
        return (acc / _heads_last(row_sum).clamp(min=1e-20)).to(q.dtype)

    return _attn


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True) -> torch.Tensor:
    """Plain O(S^2)-memory attention for numerics checks."""
    s = q.shape[1]
    scores = (torch.einsum("bqhd,bkhd->bhqk", q, k).float()
              / math.sqrt(q.shape[-1]))
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
