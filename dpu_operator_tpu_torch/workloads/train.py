"""Training step of the port: loss, gradient, AdamW.

Port of ``dpu_operator_tpu/workloads/model.py::make_train_step``: the
step is ``loss_fn`` -> backward -> AdamW, on one device (the mesh
shardings of the JAX step are the distributed modes, not ported yet).
The optimizer is ``optax.adamw(lr)``'s: betas (0.9, 0.999), eps 1e-8,
weight decay 1e-4 (torch's AdamW defaults to 1e-2), decay applied to every
parameter with the parameter from before the step, first and second
moments kept in the parameters' type as optax keeps them (bf16 for the
bf16 flagship).

**In place.** The JAX step returns new parameters and optimizer state; this
one updates the parameter tensors and the optimizer it is given and returns
the same objects, so a caller that needs the old values keeps a copy.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import resolve_device
from .model import TransformerConfig, init_params, loss_fn


def _map_layer(fn, lp: dict) -> dict:
    out = {n: fn(t) for n, t in lp.items() if n != "moe"}
    if "moe" in lp:
        out["moe"] = {n: fn(t) for n, t in lp["moe"].items()}
    return out


def map_params(fn, params: dict) -> dict:
    """The parameter tree with *fn* applied to every leaf (a MoE layer's
    ``moe`` subtree included)."""
    return {"embed": fn(params["embed"]), "pos": fn(params["pos"]),
            "out_norm": fn(params["out_norm"]),
            "layers": [_map_layer(fn, lp) for lp in params["layers"]]}


def param_leaves(params: dict) -> list:
    """Every parameter tensor in a fixed order: embed, pos, out_norm, then
    each layer's ln1, wqkv, wo, ln2 and w1, w2, or a MoE layer's router
    and experts ``moe.wg``, ``moe.w1``, ``moe.w2``."""
    return [t for _, t in named_leaves(params)]


def named_leaves(params: dict) -> list:
    """``(name, tensor)`` of :func:`param_leaves`, in its order: names such
    as ``layers.3.moe.wg`` (how a guard reports a leaf)."""
    out = [("embed", params["embed"]), ("pos", params["pos"]),
           ("out_norm", params["out_norm"])]
    for i, lp in enumerate(params["layers"]):
        for name in ("ln1", "wqkv", "wo", "ln2"):
            out.append((f"layers.{i}.{name}", lp[name]))
        if "moe" in lp:
            out.extend((f"layers.{i}.moe.{name}", lp["moe"][name])
                       for name in ("wg", "w1", "w2"))
        else:
            out.extend((f"layers.{i}.{name}", lp[name])
                       for name in ("w1", "w2"))
    return out


def make_train_step(cfg: TransformerConfig,
                    device: "str | torch.device" = "cuda") -> tuple:
    """``(step, init_state, place_batch)`` as the JAX function returns.

    * ``init_state(seed=0, params=None) -> (params, opt)``: random
      parameters from *seed* (or the given tree, moved to the device), as
      leaf tensors that require grad, and their AdamW;
    * ``step(params, opt, batch) -> (params, opt, loss)``: one step in
      place; ``loss`` is the step's loss as a 0-d tensor on the device
      (reading it synchronises);
    * ``place_batch(batch) -> batch`` on the device."""
    dev = resolve_device(device)

    def init_state(seed: int = 0, params: Optional[dict] = None) -> tuple:
        if params is None:
            params = init_params(seed, cfg, device=dev)
        else:  # an owned copy on the device, in the config's type
            params = map_params(
                lambda t: t.detach().to(dev, cfg.dtype).clone(), params)
        for t in param_leaves(params):
            t.requires_grad_(True)
        # optax.adamw(lr)'s defaults: betas, eps and weight decay 1e-4
        opt = torch.optim.AdamW(param_leaves(params), lr=cfg.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
        return params, opt

    def step(params: dict, opt: torch.optim.Optimizer,
             batch: dict) -> tuple:
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch, cfg)
        loss.backward()
        opt.step()
        return params, opt, loss.detach()

    def place_batch(batch: dict) -> dict:
        return {k: v.to(dev) for k, v in batch.items()}

    return step, init_state, place_batch
