"""Mixture-of-experts FFN of the port: a switch-style top-1 router with a
static capacity per expert.

Port of ``dpu_operator_tpu/workloads/moe.py`` (``init_moe_params``,
``moe_capacity``, ``moe_ffn``). The function is the JAX one: routing is
grouped per batch row (each row of S tokens routes on its own, with the
capacity taken from S), the router runs in fp32 and breaks ties to the
lowest expert, a token's place in its expert's queue is a cumulative sum
along S, tokens past the capacity are dropped (the residual carries
them), the experts' GELU is the tanh form, expert inputs are cast to the
weights' type and the combine is fp32, and the aux loss is Switch's load
balancing term.

**Gather instead of one-hot einsums.** The JAX function dispatches and
combines through dense (B, S, E, C) one-hot products, each output of which
has one nonzero term. Here the kept tokens are written into the (E, B, C,
D) expert batch by index and read back by the same index, times their
gate: the same values, without the (B, S, E, C) fp32 products (32 GFLOP a
layer each at 8 x 1024 tokens, 8 experts, capacity 160). A dropped token
is written to one spare row past the batch, which no expert output is read
from, so no index depends on the data's count of kept tokens and the card
never waits on the host. The expert products are batched matmuls over
the E experts, as the JAX einsums are; no TPU kernel computes them.

On a mesh whose "model" axis is 1 the sharded forward runs this function
on the rank's batch shard, with *mean* averaging the router statistics
over "data", so the aux loss is the global batch's. The expert-parallel
sharding (``moe_param_specs``) is ROADMAP queue 1, item 7b.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F


def init_moe_params(gen: torch.Generator, d_model: int, d_ff: int,
                    n_experts: int, dtype: torch.dtype,
                    device: torch.device) -> dict:
    """Router ``wg (D, E)`` and expert weights ``w1 (E, D, F)``, ``w2 (E,
    F, D)``, each N(0, 1) / sqrt(fan_in) drawn from *gen* on *device* (the
    JAX shapes and scales; torch's generator is not JAX's)."""

    def dense(shape: tuple, fan_in: int) -> torch.Tensor:
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return w.div_(float(np.sqrt(fan_in))).to(dtype)

    return {"wg": dense((d_model, n_experts), d_model),
            "w1": dense((n_experts, d_model, d_ff), d_model),
            "w2": dense((n_experts, d_ff, d_model), d_ff)}


def moe_capacity(n_tokens: int, n_experts: int,
                 capacity_factor: float) -> int:
    """Static per-expert token capacity: ceil(tokens / experts * factor),
    rounded up to a multiple of 8, at least 8 (the JAX formula)."""
    cap = int(np.ceil(n_tokens / n_experts * capacity_factor))
    return max(8, -(-cap // 8) * 8)


def moe_ffn(params: dict, x: torch.Tensor, capacity_factor: float = 1.25,
            mean: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
            ) -> tuple:
    """Top-1 routed FFN: x (B, S, D) -> (out (B, S, D) in x's type, aux
    loss, an fp32 scalar). Each batch row routes its S tokens on its own
    with capacity :func:`moe_capacity` (S, E, *capacity_factor*); a token
    past its expert's capacity contributes 0. *mean*, where given, maps
    the router's per-expert fractions over these rows to their mean over
    the whole batch (the sharded forward's average over "data")."""
    b, s, d = x.shape
    w1, w2 = params["w1"], params["w2"]
    e = params["wg"].shape[1]
    cap = moe_capacity(s, e, capacity_factor)

    # router in fp32; argmax over the probabilities, the first maximum
    # winning as jnp.argmax's does
    probs = torch.softmax(x.float() @ params["wg"].float(), dim=-1)
    expert = probs.argmax(-1)                                  # (B, S)
    onehot = F.one_hot(expert, e).float()                      # (B, S, E)
    gate = probs.gather(-1, expert[..., None])[..., 0]         # (B, S)
    # 1-based place of each token in its row's queue for its expert
    place = (onehot.cumsum(1) * onehot).sum(-1).long()         # (B, S)
    keep = place <= cap

    # flat row of each kept token in the (E, B, C) expert batch; dropped
    # tokens go to the spare row e * b * cap
    rows = e * b * cap
    b_idx = torch.arange(b, device=x.device)[:, None]
    slot = (expert * b + b_idx) * cap + (place - 1)
    slot = torch.where(keep, slot, torch.full_like(slot, rows))
    buf = x.new_zeros((rows + 1, d), dtype=w1.dtype)
    buf = buf.index_put((slot.flatten(),), x.reshape(-1, d).to(w1.dtype))
    expert_in = buf[:rows].view(e, b * cap, d)
    h = F.gelu(torch.bmm(expert_in, w1), approximate="tanh")
    expert_out = torch.bmm(h, w2).view(rows, d)
    # index_select: its backward adds into the rows (index_add_), which a
    # dropped token's index 0 meets only with a zero gradient
    picked = expert_out.index_select(
        0, torch.where(keep, slot, 0).flatten()).view(b, s, d)
    out = torch.where(keep[..., None], picked.float() * gate[..., None],
                      0.0)

    # Switch's load-balancing term: E * sum_e f_e * P_e
    frac_tokens = onehot.mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    if mean is not None:
        frac_tokens, frac_probs = mean(frac_tokens), mean(frac_probs)
    aux = e * (frac_tokens * frac_probs).sum()
    return out.to(x.dtype), aux
