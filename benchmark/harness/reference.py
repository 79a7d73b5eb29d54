"""The plain reference: the configuration's model in plain PyTorch.

Float32 with TF32 off, no kernel, no cache, no batching tricks. The
layer follows the configuration's description: learned positions added to
the token embedding, pre-norm RMSNorm (eps 1e-6), causal multi-head
attention with the softmax scale 1 / sqrt(head dim), a tanh-GELU MLP or,
on every ``moe_every``-th layer, a top-1 switch FFN (router in float32,
ties to the lowest expert, a per-row capacity of ceil(S / E x factor)
rounded up to a multiple of 8 and at least 8, tokens past it dropped,
the output scaled by the gate), a final RMSNorm and logits against the
tied embedding.

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
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .arith import is_moe_layer

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


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) * scale


def attention(x: torch.Tensor, lp: dict, m: dict, mm: Mm) -> torch.Tensor:
    b, s, d = x.shape
    h = m["n_heads"]
    q, k, v = (t.unflatten(-1, (h, d // h)).transpose(1, 2)
               for t in mm(x, lp["wqkv"]).split(d, dim=-1))
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(d // h)
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), -1)
    o = mm(probs, v).transpose(1, 2).flatten(2)
    return mm(o, lp["wo"])


def capacity(tokens: int, experts: int, factor: float) -> int:
    cap = math.ceil(tokens / experts * factor)
    return max(8, -(-cap // 8) * 8)


def _kept(onehot: torch.Tensor, width: int, m: dict) -> torch.Tensor:
    """Which tokens of a routing row stay within their expert's capacity:
    a token's place in its expert's queue is its count along the row."""
    place = (onehot.cumsum(1) * onehot).sum(-1)
    return place <= capacity(width, m["moe_experts"],
                             m["moe_capacity_factor"])


def moe(x: torch.Tensor, p: dict, m: dict, mm: Mm,
        groups: Optional[list] = None) -> torch.Tensor:
    """The switch FFN's output. Each batch row routes as one row of S
    tokens, or, with *groups* (``(start, end, width)`` over the one row of
    a served sequence), each group routes as a row of *width* tokens whose
    first ``end - start`` are these: a prefill chunk padded to its width,
    or (width None) tokens decoded one a row, which no capacity ever
    drops."""
    b, s, d = x.shape
    e = m["moe_experts"]
    probs = torch.softmax(mm(x, p["wg"]), -1)
    expert = probs.argmax(-1)
    onehot = F.one_hot(expert, e).to(x.dtype)
    gate = probs.gather(-1, expert[..., None])[..., 0]
    if groups is None:
        keep = _kept(onehot, s, m)
    else:
        keep = torch.ones_like(expert, dtype=torch.bool)
        for start, end, width in groups:
            if width is not None:
                keep[:, start:end] = _kept(onehot[:, start:end], width, m)
    flat_x = x.reshape(-1, d)
    flat_e, flat_keep = expert.reshape(-1), keep.reshape(-1)
    flat_gate = gate.reshape(-1)
    out = torch.zeros_like(flat_x)
    for i in range(e):
        idx = torch.nonzero(flat_keep & (flat_e == i))[:, 0]
        if idx.numel() == 0:
            continue
        hid = F.gelu(mm(flat_x[idx], p["w1"][i]), approximate="tanh")
        out = out.index_add(0, idx, mm(hid, p["w2"][i])
                            * flat_gate[idx, None])
    return out.view(b, s, d)


def forward(params: dict, tokens: torch.Tensor, m: dict, mm: Mm = mm_fp32,
            groups: Optional[list] = None) -> torch.Tensor:
    """Logits (B, S, V); *groups* as :func:`moe` takes them."""
    s = tokens.shape[1]
    x = params["embed"][tokens] + params["pos"][:s]
    for i, lp in enumerate(params["layers"]):
        x = x + attention(rmsnorm(x, lp["ln1"]), lp, m, mm)
        hn = rmsnorm(x, lp["ln2"])
        if is_moe_layer(m, i):
            x = x + moe(hn, lp["moe"], m, mm, groups)
        else:
            x = x + mm(F.gelu(mm(hn, lp["w1"]), approximate="tanh"),
                       lp["w2"])
    x = rmsnorm(x, params["out_norm"])
    return mm(x, params["embed"].t())


def fp32_tree(tree: dict) -> dict:
    """A float32 copy of a weight tree."""
    def conv(t):
        return t.detach().float().clone()
    out = {"embed": conv(tree["embed"]), "pos": conv(tree["pos"]),
           "out_norm": conv(tree["out_norm"]), "layers": []}
    for lp in tree["layers"]:
        nl = {k: conv(v) for k, v in lp.items() if k != "moe"}
        if "moe" in lp:
            nl["moe"] = {k: conv(v) for k, v in lp["moe"].items()}
        out["layers"].append(nl)
    return out


def served_groups(prompt_len: int, length: int, chunks: list,
                  width: int) -> list:
    """The routing groups of a served sequence of *length* tokens: each
    prefill chunk ``(offset, n)`` of the prompt padded to *width*, then
    the decoded tokens one a row."""
    return [(off, off + n, width) for off, n in chunks] + [
        (prompt_len, length, None)]


def sequence_logits(params32: dict, ids: list, m: dict,
                    device: "str | torch.device", mm: Mm = mm_fp32,
                    groups: Optional[list] = None) -> torch.Tensor:
    """Logits (L, V) float32 of one sequence: row t predicts token t + 1."""
    with full_fp32(), torch.no_grad():
        tokens = torch.tensor([ids], dtype=torch.long, device=device)
        return forward(params32, tokens, m, mm, groups)[0]
