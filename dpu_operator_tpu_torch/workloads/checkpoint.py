"""Train-state checkpoint and resume on one device.

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
sharded train state (``make_train_step(cfg, mesh)``) saves each rank's
shards as they are; restoring onto another mesh (the reference's
re-sharding restore) is ROADMAP queue 1 item 7c.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

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

    def save(self, step: int, params: dict,
             opt: torch.optim.Optimizer) -> None:
        state = {"step": step,
                 "params": map_params(torch.Tensor.detach, params),
                 "opt_state": opt.state_dict()}
        path = self._path(step)
        tmp = path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, params: dict, opt: torch.optim.Optimizer,
                step: Optional[int] = None) -> tuple:
        """Load *step* (default: the newest) into *params* (copied into the
        existing tensors, so the optimizer keeps pointing at them) and
        *opt*; returns ``(params, opt, step)``. A checkpoint that does not
        match them raises ``ValueError`` naming the first mismatch, and
        leaves *params* and *opt* as they were."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        state = torch.load(self._path(step), map_location="cpu",
                           weights_only=True)
        _check_restorable(step, params, opt, state)
        with torch.no_grad():
            for dst, src in zip(param_leaves(params),
                                param_leaves(state["params"])):
                dst.copy_(src)
        opt.load_state_dict(state["opt_state"])
        return params, opt, step

    def close(self) -> None:
        """Nothing is written in the background: every save is complete
        when it returns."""



def _check_restorable(step: int, params: dict, opt: torch.optim.Optimizer,
                      state: dict) -> None:
    """Raise ``ValueError`` naming the first difference between the saved
    *state* and the caller's *params* / *opt*: the leaf count, then each
    leaf's name, shape and dtype in :func:`~.train.named_leaves` order,
    then the optimizer's parameter-group sizes."""
    ours, saved = named_leaves(params), named_leaves(state["params"])
    if len(ours) != len(saved):
        raise ValueError(f"checkpoint step {step} holds {len(saved)} "
                         f"parameter leaves, the model {len(ours)}")
    for (name, dst), (saved_name, src) in zip(ours, saved):
        if name != saved_name:
            raise ValueError(f"checkpoint step {step}: leaf {saved_name} "
                             f"where the model has {name}")
        if dst.shape != src.shape or dst.dtype != src.dtype:
            raise ValueError(
                f"checkpoint step {step}: leaf {name} is "
                f"{tuple(src.shape)} {src.dtype}, the model's "
                f"{tuple(dst.shape)} {dst.dtype}")
    groups = [len(g["params"]) for g in opt.param_groups]
    saved_groups = [len(g["params"])
                    for g in state["opt_state"]["param_groups"]]
    if groups != saved_groups:
        raise ValueError(f"checkpoint step {step}: optimizer groups of "
                         f"{saved_groups} parameters, the optimizer's "
                         f"{groups}")
