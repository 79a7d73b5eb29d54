"""Train-state checkpoint and resume, on one device or a mesh.

Port of ``dpu_operator_tpu/workloads/checkpoint.py::TrainCheckpointer``:
``save``, ``latest_step``, ``restore``, ``close``, keeping the newest
*keep* checkpoints. Each step is one file, ``step_<N>.pt``, holding the
parameters and the optimizer's ``state_dict`` (``torch.save``), written to
a temporary name and renamed into place, so a crash mid-write leaves the
previous checkpoints whole. A MoE tree's ``moe`` subtrees save and
restore with the rest (``train.map_params`` / ``param_leaves``).

**Restore is all or nothing**, as the reference's: a checkpoint whose
parameter leaves (count, name, shape, dtype) or optimizer groups do not
match the caller's raises ``ValueError`` before anything is copied. A
mesh restore checks before it cuts the saved state, against the global
shapes of the caller's shards (each split dim times its axis's size), so
a mismatch raises the same ``ValueError`` with and without a mesh.

**Re-sharding** (the reference's restore onto the current mesh). A file
always holds the global train state. With a *mesh*, ``save`` gathers the
parameters and the AdamW moments by the tree's specs (``model.param_specs``
of *cfg*, or ``pipeline.pipeline_param_specs`` for a stage-stacked tree)
and global rank 0 writes them; ``restore`` cuts the global state into the
caller's shards by the caller's specs on the caller's mesh, after the
check. So a state saved on one mesh restores onto another factoring, a
smaller mesh (a multi-slice state onto one slice: parameters replicate
over "dcn"), or one device, and a one-device state onto a mesh.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import axes_group
from .model import (TransformerConfig, gather_tree, global_shapes,
                    param_specs, shard_tree)
from .pipeline import pipeline_param_specs
from .train import map_params, named_leaves, param_leaves

_NAME = re.compile(r"^step_(\d+)\.pt$")


class TrainCheckpointer:
    def __init__(self, directory: str, keep: int = 3) -> None:
        if keep < 1:
            raise ValueError(f"keep must be at least 1, got {keep}")
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def steps(self) -> list:
        """Saved steps, oldest first."""
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, params: dict, opt: torch.optim.Optimizer,
             mesh: Optional[DeviceMesh] = None,
             cfg: Optional[TransformerConfig] = None) -> None:
        """Write *step*'s train state. With a *mesh* (and the *cfg* of a
        model tree) every rank of the mesh calls it: the global state is
        gathered by the tree's specs, global rank 0 writes it, and every
        rank returns after the file is in place."""
        state = {"step": step,
                 "params": map_params(torch.Tensor.detach, params),
                 "opt_state": opt.state_dict()}
        if mesh is not None:  # the global state, gathered (a collective)
            specs = _specs(params, cfg)
            state = _map_state(lambda t: gather_tree(t, specs, mesh), state)
        if mesh is None or dist.get_rank() == 0:
            path = self._path(step)
            tmp = path + ".tmp"
            torch.save(state, tmp)
            os.replace(tmp, path)
            for old in self.steps()[:-self.keep]:
                os.remove(self._path(old))
        if mesh is not None:
            dist.barrier(group=axes_group(mesh, mesh.mesh_dim_names)[0])

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, params: dict, opt: torch.optim.Optimizer,
                step: Optional[int] = None,
                mesh: Optional[DeviceMesh] = None,
                cfg: Optional[TransformerConfig] = None) -> tuple:
        """Load *step* (default: the newest) into *params* (copied into the
        existing tensors, so the optimizer keeps pointing at them) and
        *opt*; returns ``(params, opt, step)``. With a *mesh* (and the
        *cfg* of a model tree) *params* and *opt* are the rank's shards,
        and the saved global state is cut into them first, whatever mesh
        saved it. A checkpoint that does not match them raises
        ``ValueError`` naming the first mismatch (the same with and without
        a mesh), and leaves *params* and *opt* as they were."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        state = torch.load(self._path(step), map_location="cpu",
                           weights_only=True)
        shapes = [t.shape for t in param_leaves(params)]
        if mesh is not None:  # the global shapes of the caller's shards
            specs = _specs(params, cfg)
            shapes = param_leaves(global_shapes(params, specs, mesh))
        _check_restorable(step, params, opt, state, shapes)
        if mesh is not None:  # this rank's shards of the global state
            state = _map_state(lambda t: shard_tree(t, specs, mesh), state)
        with torch.no_grad():
            for dst, src in zip(param_leaves(params),
                                param_leaves(state["params"])):
                dst.copy_(src)
        opt.load_state_dict(state["opt_state"])
        return params, opt, step

    def close(self) -> None:
        """Nothing is written in the background: every save is complete
        when it returns."""



def _specs(params: dict, cfg: Optional[TransformerConfig]) -> dict:
    """The specs of a sharded tree: a pipeline tree's, or *cfg*'s."""
    if "stages" in params:
        return pipeline_param_specs()
    if cfg is None:
        raise ValueError("a sharded model tree's checkpoint needs its cfg")
    return param_specs(cfg)


def _tree_of(like: dict, leaves: list) -> dict:
    """A tree shaped like the parameter tree *like* holding *leaves*, in
    ``train.named_leaves`` order."""
    tree = map_params(lambda t: None, like)
    for (name, _), leaf in zip(named_leaves(like), leaves):
        *path, last = name.split(".")
        node = tree
        for key in path:
            node = node[int(key)] if isinstance(node, list) else node[key]
        node[last] = leaf
    return tree


def _map_state(fn, state: dict) -> dict:
    """*state* (``step``, ``params``, ``opt_state``) with *fn* applied to
    the parameter tree and to each AdamW moment, the moments laid out as
    parameter trees (the optimizer keys them by their parameter's place
    in ``param_leaves``), so the fused ``wqkv`` moments split as their
    parameter does. The step counts are replicated scalars."""
    params = fn(state["params"])
    opt = state["opt_state"]
    moments = {i: dict(s) for i, s in opt["state"].items()}
    if moments:
        n = len(param_leaves(params))
        for kind, v in moments[0].items():
            if v.dim():
                tree = fn(_tree_of(state["params"],
                                   [moments[i][kind] for i in range(n)]))
                for i, t in enumerate(param_leaves(tree)):
                    moments[i][kind] = t
    return {"step": state["step"], "params": params,
            "opt_state": {"state": moments,
                          "param_groups": opt["param_groups"]}}


def _check_restorable(step: int, params: dict, opt: torch.optim.Optimizer,
                      state: dict, shapes: list) -> None:
    """Raise ``ValueError`` naming the first difference between the saved
    *state* and the caller's *params* / *opt*: the leaf count, then each
    leaf's name, shape and dtype in :func:`~.train.named_leaves` order,
    then the optimizer's parameter-group sizes. *shapes* are the caller's
    global leaf shapes (its own, or its shards' on a mesh)."""
    ours, saved = named_leaves(params), named_leaves(state["params"])
    if len(ours) != len(saved):
        raise ValueError(f"checkpoint step {step} holds {len(saved)} "
                         f"parameter leaves, the model {len(ours)}")
    for (name, dst), (saved_name, src), shape in zip(ours, saved, shapes):
        if name != saved_name:
            raise ValueError(f"checkpoint step {step}: leaf {saved_name} "
                             f"where the model has {name}")
        if src.shape != shape or dst.dtype != src.dtype:
            raise ValueError(
                f"checkpoint step {step}: leaf {name} is "
                f"{tuple(src.shape)} {src.dtype}, the model's "
                f"{tuple(shape)} {dst.dtype}")
    groups = [len(g["params"]) for g in opt.param_groups]
    saved_groups = [len(g["params"])
                    for g in state["opt_state"]["param_groups"]]
    if groups != saved_groups:
        raise ValueError(f"checkpoint step {step}: optimizer groups of "
                         f"{saved_groups} parameters, the optimizer's "
                         f"{groups}")
