"""GPT-2's block, as the configurations ``gpt2-medium`` and
``gpt2-medium-moe8`` run it: the port's configuration, the weight tree's
leaves, the plain reference forward and the work counts.

The model dict holds the port's keys (``vocab``, ``d_model``,
``n_heads``, ``n_layers``, ``d_ff``, ``max_seq``, ``moe_experts``,
``moe_every``, ...). The layer: learned positions added to the token
embedding, pre-norm RMSNorm (eps 1e-6), causal multi-head attention with
one fused ``wqkv`` and the softmax scale 1 / sqrt(head dim), a tanh-GELU
MLP or, on every ``moe_every``-th layer, a top-1 switch FFN (router in
float32, ties to the lowest expert, a per-row capacity of ceil(S / E x
factor) rounded up to a multiple of 8 and at least 8, tokens past it
dropped, the output scaled by the gate), a final RMSNorm and logits
against the tied embedding.

The reference imports nothing of the program; only
:func:`program_config` does, when it is called.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from harness.arith import BF16_BYTES


def program_config(m: dict):
    """The port's ``TransformerConfig``."""
    from dpu_operator_tpu_torch.workloads.model import TransformerConfig
    from harness.weights import dtype_of
    return TransformerConfig(
        vocab=m["vocab"], d_model=m["d_model"], n_heads=m["n_heads"],
        n_layers=m["n_layers"], d_ff=m["d_ff"], max_seq=m["max_seq"],
        dtype=dtype_of(m), attention=m["attention"],
        moe_experts=m["moe_experts"], moe_every=m["moe_every"],
        moe_capacity_factor=m["moe_capacity_factor"],
        moe_aux_weight=m["moe_aux_weight"])


def vocab(m: dict) -> int:
    return m["vocab"]


def positions(m: dict) -> int:
    return m["max_seq"]


def is_moe_layer(m: dict, i: int) -> bool:
    every = m["moe_every"]
    return m["moe_experts"] > 0 and i % every == every - 1


# -- the weight tree ----------------------------------------------------------

def leaves(m: dict) -> list:
    """``(path, shape, fan_in)`` of every randomly drawn leaf, in the
    buffer's order: ``embed (V, D)``, ``pos (max_seq, D)``, then each
    layer's ``wqkv (D, 3D)``, ``wo (D, D)`` and ``w1 (D, F)``, ``w2 (F,
    D)``, or for a MoE layer ``moe: {wg (D, E), w1 (E, D, F), w2 (E, F,
    D)}``."""
    d, f, e = m["d_model"], m["d_ff"], m["moe_experts"]
    out = [(("embed",), (m["vocab"], d), m["vocab"]),
           (("pos",), (m["max_seq"], d), m["max_seq"])]
    for i in range(m["n_layers"]):
        out += [(("layers", i, "wqkv"), (d, 3 * d), d),
                (("layers", i, "wo"), (d, d), d)]
        if is_moe_layer(m, i):
            out += [(("layers", i, "moe", "wg"), (d, e), d),
                    (("layers", i, "moe", "w1"), (e, d, f), d),
                    (("layers", i, "moe", "w2"), (e, f, d), f)]
        else:
            out += [(("layers", i, "w1"), (d, f), d),
                    (("layers", i, "w2"), (f, d), f)]
    return out


def norms(m: dict) -> list:
    """``(path, shape)`` of every norm scale: ``out_norm`` and each
    layer's ``ln1`` and ``ln2``."""
    d = (m["d_model"],)
    out = [(("out_norm",), d)]
    for i in range(m["n_layers"]):
        out += [(("layers", i, "ln1"), d), (("layers", i, "ln2"), d)]
    return out


# -- the plain reference ------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) * scale


def attention(x: torch.Tensor, lp: dict, m: dict, mm) -> torch.Tensor:
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


def moe(x: torch.Tensor, p: dict, m: dict, mm,
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


def forward(params: dict, tokens: torch.Tensor, m: dict, mm,
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


# -- work counts (frozen copies of the port's ``workloads/perf.py``) ----------

def param_count(m: dict) -> int:
    """Parameters of the model; a MoE layer counts its router and every
    expert."""
    d, f = m["d_model"], m["d_ff"]
    attn = 2 * d + 3 * d * d + d * d
    total = m["vocab"] * d + m["max_seq"] * d + d
    for i in range(m["n_layers"]):
        total += attn
        if is_moe_layer(m, i):
            total += d * m["moe_experts"] + m["moe_experts"] * 2 * d * f
        else:
            total += 2 * d * f
    return total


def active_param_count(m: dict) -> int:
    """Parameters each token multiplies against: a top-1 MoE layer counts
    its router and one expert."""
    n_moe = sum(is_moe_layer(m, i) for i in range(m["n_layers"]))
    return param_count(m) - n_moe * max(m["moe_experts"] - 1, 0) \
        * 2 * m["d_model"] * m["d_ff"]


def layer_matmul_params(m: dict) -> int:
    """Active parameters that one token multiplies against inside the
    layers (the projections, and a MoE layer's router and one expert):
    the embedding, the positions and the norms are not products."""
    d, f = m["d_model"], m["d_ff"]
    total = 0
    for i in range(m["n_layers"]):
        total += 4 * d * d + 2 * d * f
        if is_moe_layer(m, i):
            total += d * m["moe_experts"]
    return total


def serve_flops(m: dict, work: dict) -> float:
    """Model FLOPs of the useful serving work: 2 per layer parameter for
    every prompt token prefilled and every token decoded for a live
    request, 2 per embedding parameter for each token the logits pick
    (first tokens and decoded tokens), and 4 x d_model per admitted
    causal pair in every layer."""
    d = m["d_model"]
    return (2.0 * layer_matmul_params(m)
            * (work["prefill_tokens"] + work["decode_tokens"])
            + 2.0 * m["vocab"] * d
            * (work["first_tokens"] + work["decode_tokens"])
            + 4.0 * d * m["n_layers"]
            * (work["prefill_pairs"] + work["decode_pairs"]))


def decode_attention_least_s(m: dict, rows: list, peak: dict) -> float:
    """The least time the decode attention of one iteration could take:
    every row (one a live request, at its position p) reads the K and V of
    keys 0 .. p (``d_model`` wide each, a position and a layer) and its q,
    and writes its output, in every layer; bytes at the HBM rate or 4
    FLOPs a pair and head dimension at the bf16 peak, the larger."""
    d = m["d_model"]
    keys = sum(p + 1 for p in rows)
    nbytes = (2 * keys * d + 2 * len(rows) * d) * BF16_BYTES
    flops = 4 * keys * d
    return m["n_layers"] * max(nbytes / peak["hbm_bytes_per_s"],
                               flops / peak["bfloat16"])


def expected_moe_fill(m: dict, traffic: dict,
                      counts: dict) -> "float | None":
    """The MoE expert fill, in %, that *counts* decode passes and chunks
    give from the shapes: a pass routes every slot alone (capacity 8), a
    chunk its padded width; the real tokens among them are the passes'
    active rows and the chunks' valid tokens."""
    if not m["moe_experts"] or not (counts["decode"] or counts["chunk"]):
        return None
    e, cf = m["moe_experts"], m["moe_capacity_factor"]
    slots, width = traffic["slots"], traffic["chunk_tokens"]
    routed = counts["decode_tokens"] + counts["chunk_tokens"]
    rows = e * (counts["decode"] * slots * capacity(1, e, cf)
                + counts["chunk"] * capacity(width, e, cf))
    return 100.0 * routed / rows
