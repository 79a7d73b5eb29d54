"""Weights made on the device from the seed, by the benchmark.

One ``torch.randn`` call on a generator of the device fills a flat buffer
in the served type with N(0, 1) draws; each leaf that the configuration's
block lists (``leaves``: path, shape, fan_in) is a view of it, in the
block's order, scaled by 1 / sqrt(fan_in), and every norm scale it lists
(``norms``) is 1. The same seed on the same device gives the same
weights, so the reference makes them again after the window instead of
keeping a copy. A path is a tuple of keys into nested dicts and lists (an
int indexes a list, a leaf sits in a dict); the tree has the shape the
block's program takes.
"""

from __future__ import annotations

import math

import torch

from .manifest import block_of

#: the generator's stream of weights is seeded apart from the traffic's
WEIGHT_STREAM = 0x5EED


def dtype_of(m: dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[m["dtype"]]


def _seed(seed: int, stream: int) -> int:
    return (seed * 0x9E3779B1 + stream) % (1 << 63)


def _put(tree: dict, path: tuple, leaf: torch.Tensor) -> None:
    """Set *leaf* at *path*, making the dicts and lists on the way."""
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        make = list if isinstance(nxt, int) else dict
        if isinstance(node, list):
            while len(node) <= key:
                node.append(make())
            node = node[key]
        else:
            node = node.setdefault(key, make())
    node[path[-1]] = leaf


def make_weights(config: dict, seed: int, device: "str | torch.device",
                 dtype: "torch.dtype | None" = None) -> dict:
    """The parameter tree from *seed* on *device*, in the configuration's
    type (or *dtype*)."""
    block, m = block_of(config), config["model"]
    dtype = dtype or dtype_of(m)
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed, WEIGHT_STREAM))
    shapes = block.leaves(m)
    total = sum(math.prod(s) for _, s, _ in shapes)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    tree: dict = {}
    for path, shape in block.norms(m):
        _put(tree, path, torch.ones(shape, dtype=dtype, device=device))
    start = 0
    for path, shape, fan_in in shapes:
        n = math.prod(shape)
        _put(tree, path, flat[start:start + n].view(shape)
             .mul_(1.0 / math.sqrt(fan_in)))
        start += n
    return tree
