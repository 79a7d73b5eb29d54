"""Frozen work counts and the card's peaks.

Copies of the port's ``workloads/perf.py`` arithmetic (``param_count``,
``active_param_count``, ``CARD_PEAKS``) taken into the benchmark, so that
a change to the program cannot change the yardstick, plus the serving
work counts that the metrics divide by. Every function takes the
configuration's ``model`` dict.
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


def is_moe_layer(m: dict, i: int) -> bool:
    every = m["moe_every"]
    return m["moe_experts"] > 0 and i % every == every - 1


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


def causal_pairs(rows: int, offset: int = 0) -> int:
    """(query row, key) pairs a causal mask admits for *rows* queries at
    positions offset .. offset + rows - 1: row p sees keys 0 .. p."""
    return rows * offset + rows * (rows + 1) // 2


def decode_attention_least_s(m: dict, positions: list,
                             peak: dict) -> float:
    """The least time the decode attention of one iteration could take:
    every row (one a live request, at its position p) reads the K and V of
    keys 0 .. p and its q, and writes its output, in every layer; bytes at
    the HBM rate or 4 FLOPs a pair and head dimension at the bf16 peak, the
    larger."""
    d = m["d_model"]
    keys = sum(p + 1 for p in positions)
    nbytes = (2 * keys * d + 2 * len(positions) * d) * BF16_BYTES
    flops = 4 * keys * d
    return m["n_layers"] * max(nbytes / peak["hbm_bytes_per_s"],
                               flops / peak["bfloat16"])


def serve_flops(m: dict, prefill_tokens: int, prefill_pairs: int,
                first_tokens: int, decode_tokens: int,
                decode_pairs: int) -> float:
    """Model FLOPs of the useful serving work: 2 per layer parameter for
    every prompt token prefilled and every token decoded for a live
    request, 2 per embedding parameter for each token the logits pick
    (first tokens and decoded tokens), and 4 x d_model per admitted
    causal pair in every layer."""
    d = m["d_model"]
    return (2.0 * layer_matmul_params(m) * (prefill_tokens + decode_tokens)
            + 2.0 * m["vocab"] * d * (first_tokens + decode_tokens)
            + 4.0 * d * m["n_layers"] * (prefill_pairs + decode_pairs))
