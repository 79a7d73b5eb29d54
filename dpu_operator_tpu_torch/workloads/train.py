"""Training step of the port: loss, gradient, AdamW.

Port of ``dpu_operator_tpu/workloads/model.py::make_train_step``: the
step is ``loss_fn`` -> backward -> AdamW, on one device or, with a mesh,
dp/tp/sp/ep-sharded, sequence-sharded by ring or Ulysses attention, or
multi-slice (``model.py``'s sharded forward): every rank runs the step on
its parameter shards and its batch shard (in a sequence mode, its S / n
columns of it), the gradients are averaged over the batch ranks ("data",
or "dcn" x "data") and summed over "model" for the leaves that sequence
parallelism, a sequence mode or expert parallelism leaves partial, and
AdamW updates the shards, which is AdamW on the whole tree because every
one of its operations is elementwise. The pipeline's step is
``workloads/pipeline.py``'s. The optimizer is ``optax.adamw(lr)``'s: betas
(0.9, 0.999), eps 1e-8, weight decay 1e-4 (torch's AdamW defaults to
1e-2), decay applied to every parameter with the parameter from before
the step, first and second moments kept in the parameters' type as optax
keeps them (bf16 for the bf16 flagship).

**In place.** The JAX step returns new parameters and optimizer state; this
one updates the parameter tensors and the optimizer it is given and returns
the same objects, so a caller that needs the old values keeps a copy.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import resolve_device
from .mesh import axes_group, mesh_device
from .model import (SEQUENCE_MODES, TransformerConfig, _batch_axes,
                    batch_shard, check_mesh, init_params, loss_fn,
                    param_specs, shard_params)


def _map_layer(fn, lp: dict) -> dict:
    out = {n: fn(t) for n, t in lp.items() if n != "moe"}
    if "moe" in lp:
        out["moe"] = {n: fn(t) for n, t in lp["moe"].items()}
    return out


#: the stage-stacked leaves of a pipeline tree (``workloads/pipeline.py``)
STAGE_LEAVES = ("ln1", "wqkv", "wo", "ln2", "w1", "w2")


def map_params(fn, params: dict) -> dict:
    """The parameter tree with *fn* applied to every leaf (a MoE layer's
    ``moe`` subtree included; a pipeline tree's ``stages``)."""
    out = {"embed": fn(params["embed"]), "pos": fn(params["pos"]),
           "out_norm": fn(params["out_norm"])}
    if "stages" in params:
        out["stages"] = {n: fn(params["stages"][n]) for n in STAGE_LEAVES}
    else:
        out["layers"] = [_map_layer(fn, lp) for lp in params["layers"]]
    return out


def param_leaves(params: dict) -> list:
    """Every parameter tensor in a fixed order: embed, pos, out_norm, then
    each layer's ln1, wqkv, wo, ln2 and w1, w2, or a MoE layer's router
    and experts ``moe.wg``, ``moe.w1``, ``moe.w2``."""
    return [t for _, t in named_leaves(params)]


def named_leaves(params: dict) -> list:
    """``(name, tensor)`` of :func:`param_leaves`, in its order: names such
    as ``layers.3.moe.wg`` (how a guard reports a leaf), or a pipeline
    tree's ``stages.wqkv``."""
    out = [("embed", params["embed"]), ("pos", params["pos"]),
           ("out_norm", params["out_norm"])]
    if "stages" in params:
        return out + [(f"stages.{n}", params["stages"][n])
                      for n in STAGE_LEAVES]
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


def _reduce_grads(params: dict, cfg: TransformerConfig,
                  mesh: DeviceMesh) -> None:
    """The sharded step's gradient collectives, each over one flat buffer:
    the mean over the batch ranks of every leaf, then the sum over
    "model" of the replicated leaves whose gradient each rank took from
    part of the work: under sequence parallelism ``pos`` and the norm
    scales (each rank's S / tp rows) and the MoE routers; without it the
    MoE routers alone (expert parallelism: each rank's own experts). In a
    sequence mode every leaf is replicated and each rank's gradient
    comes from its S / n columns, so every leaf is summed over "model",
    whatever ``sequence_parallel`` says."""
    named = named_leaves(params)
    specs = [s for _, s in named_leaves(param_specs(cfg))]
    group, n, _ = axes_group(mesh, _batch_axes(mesh))
    _all_reduce_into([p.grad for _, p in named], group, n)
    every = cfg.sequence_parallel or cfg.attention in SEQUENCE_MODES
    partial = [p.grad for (name, p), s in zip(named, specs)
               if "model" not in s and (every or name.endswith(".moe.wg"))]
    if partial:
        _all_reduce_into(partial, mesh.get_group("model"), 1)


def _all_reduce_into(grads: list, group: dist.ProcessGroup,
                     div: int) -> None:
    flat = torch.cat([g.flatten() for g in grads])
    dist.all_reduce(flat, group=group)
    if div > 1:
        flat.div_(div)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def make_train_step(cfg: TransformerConfig,
                    mesh: Optional[DeviceMesh] = None,
                    device: "str | torch.device" = "cuda") -> tuple:
    """``(step, init_state, place_batch)`` as the JAX function returns.

    * ``init_state(seed=0, params=None) -> (params, opt)``: random
      parameters from *seed* (or the given tree, moved to the device), as
      leaf tensors that require grad, and their AdamW; with a *mesh*, the
      rank's shards of that global tree (``model.shard_params``);
    * ``step(params, opt, batch) -> (params, opt, loss)``: one step in
      place; ``loss`` is the step's loss as a 0-d tensor on the device
      (reading it synchronises), with a mesh the global batch's;
    * ``place_batch(batch) -> batch`` on the device, with a mesh the
      rank's batch shard.

    With a *mesh* its device type must be *device*'s; the rank's device is
    its current card (or the CPU)."""
    dev = resolve_device(device)
    if mesh is not None:
        check_mesh(cfg, mesh)
        if mesh.device_type != dev.type:
            raise ValueError(f"a {mesh.device_type} mesh for device {dev}")
        dev = mesh_device(mesh)

    def init_state(seed: int = 0, params: Optional[dict] = None) -> tuple:
        if params is None:
            params = init_params(seed, cfg, device=dev)
        else:  # an owned copy on the device, in the config's type
            params = map_params(
                lambda t: t.detach().to(dev, cfg.dtype).clone(), params)
        if mesh is not None:
            params = shard_params(params, cfg, mesh)
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
        loss = loss_fn(params, batch, cfg, mesh)
        loss.backward()
        if mesh is not None:
            _reduce_grads(params, cfg, mesh)
        opt.step()
        return params, opt, loss.detach()

    def place_batch(batch: dict) -> dict:
        if mesh is None:
            return {k: v.to(dev) for k, v in batch.items()}
        return {k: batch_shard(v, mesh).to(dev) for k, v in batch.items()}

    return step, init_state, place_batch
