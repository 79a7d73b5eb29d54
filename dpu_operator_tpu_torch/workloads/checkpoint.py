"""Train-state checkpoint and resume on one device.

Port of ``dpu_operator_tpu/workloads/checkpoint.py::TrainCheckpointer``:
``save``, ``latest_step``, ``restore``, ``close``, keeping the newest
*keep* checkpoints. Each step is one file, ``step_<N>.pt``, holding the
parameters and the optimizer's ``state_dict`` (``torch.save``), written to
a temporary name and renamed into place, so a crash mid-write leaves the
previous checkpoints whole. A MoE tree's ``moe`` subtrees save and
restore with the rest (``train.map_params`` / ``param_leaves``). There is
no re-sharding: one card.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from .train import map_params, param_leaves

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
        *opt*; returns ``(params, opt, step)``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        state = torch.load(self._path(step), map_location="cpu",
                           weights_only=True)
        with torch.no_grad():
            for dst, src in zip(param_leaves(params),
                                param_leaves(state["params"])):
                dst.copy_(src)
        opt.load_state_dict(state["opt_state"])
        return params, opt, step

    def close(self) -> None:
        """Nothing is written in the background: every save is complete
        when it returns."""

