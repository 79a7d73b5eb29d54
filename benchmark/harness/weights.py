"""Weights made on the device from the seed, by the benchmark.

One ``torch.randn`` call on a generator of the device fills a flat buffer
in the served type with N(0, 1) draws; each dense leaf is a view of it,
scaled by 1 / sqrt(fan_in), and every norm scale is 1. The same seed on
the same device gives the same weights, so the reference makes them again
after the window instead of keeping a copy. The tree has the shape the
program takes: ``embed (V, D)``, ``pos (max_seq, D)``, ``out_norm (D,)``
and ``layers``, each ``ln1, wqkv (D, 3D), wo (D, D), ln2`` and ``w1 (D,
F), w2 (F, D)``, or for a MoE layer ``moe: {wg (D, E), w1 (E, D, F), w2
(E, F, D)}``.
"""

from __future__ import annotations

import math

import torch

from .arith import is_moe_layer

#: the generator's stream of weights is seeded apart from the traffic's
WEIGHT_STREAM = 0x5EED


def dtype_of(m: dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[m["dtype"]]


def dense_shapes(m: dict) -> list:
    """``(path, shape, fan_in)`` of every randomly drawn leaf, in the
    buffer's order."""
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


def _seed(seed: int, stream: int) -> int:
    return (seed * 0x9E3779B1 + stream) % (1 << 63)


def make_weights(m: dict, seed: int, device: "str | torch.device",
                 dtype: "torch.dtype | None" = None) -> dict:
    """The parameter tree from *seed* on *device*, in the configuration's
    type (or *dtype*)."""
    dtype = dtype or dtype_of(m)
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed, WEIGHT_STREAM))
    shapes = dense_shapes(m)
    total = sum(math.prod(s) for _, s, _ in shapes)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    d = m["d_model"]
    tree: dict = {"out_norm": torch.ones(d, dtype=dtype, device=device),
                  "layers": [{"ln1": torch.ones(d, dtype=dtype,
                                                device=device),
                              "ln2": torch.ones(d, dtype=dtype,
                                                device=device)}
                             for _ in range(m["n_layers"])]}
    start = 0
    for path, shape, fan_in in shapes:
        n = math.prod(shape)
        leaf = flat[start:start + n].view(shape).mul_(1.0 / math.sqrt(fan_in))
        start += n
        node = tree
        for key in path[:-1]:
            if key == "moe":
                node = node.setdefault("moe", {})
            else:
                node = node[key]
        node[path[-1]] = leaf
    return tree
