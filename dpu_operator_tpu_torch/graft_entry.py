"""Entry points of the port: the one-card forward and a multi-rank dry run.

Port of ``__graft_entry__.py``. :func:`entry` returns the flagship
workload's forward and its inputs: the 2-layer, ``max_seq`` 64 model of
the default ``TransformerConfig``. :func:`dryrun_multichip` runs the full
train step once on tiny shapes in each parallelism mode over n ranks:
dp/tp/sp (standard), ring and Ulysses (long context), ep (MoE experts
over "model"), multi-slice (a leading "dcn" axis) and the pipeline
(stages over a "pipe" axis). It returns each mode's first loss.

The reference runs its dry run on n virtual CPU devices of one process,
and pins JAX's platform and XLA flags to get them. Here a rank is a
process, and nothing reads or sets an environment variable:

- on "cpu", n gloo ranks spawned by :func:`~.testing.spmd.spawn`;
- on "cuda", n NCCL ranks, one card each; one rank runs in this process
  on a one-rank group. A machine with fewer than n cards raises
  ``ValueError``.

The port's ``TransformerConfig`` has no ``flash_block_q`` /
``flash_block_k`` (its block sizes are chosen on the card), so the
Ulysses case runs without them.

Run it as ``python -m dpu_operator_tpu_torch.graft_entry [--device
cpu]``: the entry's forward, then the dry run over every card (or over 8
gloo ranks on the CPU, the reference's 8 virtual devices).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import tempfile
from typing import Callable

import torch
import torch.distributed as dist

from . import resolve_device
from .ops._build import library
from .testing import spmd
from .workloads import pipeline
from .workloads.mesh import axis_size, make_mesh
from .workloads.model import (TransformerConfig, forward, init_params,
                              make_example_batch)
from .workloads.train import make_train_step


def entry(device: "str | torch.device" = "cuda") -> tuple:
    """``(fn, (params, tokens))``: ``fn(params, tokens)`` is the port's
    ``forward`` of ``TransformerConfig(n_layers=2, max_seq=64)`` (vocab
    256, d_model 128, 8 heads of 16, d_ff 512, bf16), *params* its
    ``init_params(0)`` on *device* and *tokens* zeros (4, 64)."""
    cfg = TransformerConfig(n_layers=2, max_seq=64)
    params = init_params(0, cfg, device=device)
    tokens = torch.zeros((4, 64), dtype=torch.int64,
                         device=resolve_device(device))

    def fn(params: dict, tokens: torch.Tensor) -> torch.Tensor:
        return forward(params, tokens, cfg)

    return fn, (params, tokens)


def _first_loss(cfg: TransformerConfig, make: Callable, mesh, seed: int,
                batch: int, device_type: str) -> float:
    """One step of ``make(cfg, mesh, ..., device=)``'s train step from
    *seed* on an example batch of *batch* rows: the step's loss."""
    step, init_state, place = make(cfg, mesh, device=device_type)
    params, opt = init_state(seed)
    data = place(make_example_batch(cfg, batch=batch, seq=cfg.max_seq))
    return float(step(params, opt, data)[2])


def _dryrun_body(device_type: str) -> dict:
    """Every rank of the default group (without one, a one-rank group
    formed here): the reference's ``_dryrun_body``. Returns ``{mode: first
    loss}``; a loss that is not finite and positive raises."""
    mesh = make_mesh(("data", "model"), device_type=device_type)
    n = dist.get_world_size()
    model_axis, data = axis_size(mesh, "model"), axis_size(mesh, "data")
    # tiny shapes; the sequence splits over the model axis
    seq = max(16, 2 * model_axis)
    cfg = TransformerConfig(n_layers=2, d_model=64,
                            n_heads=max(4, model_axis), d_ff=128,
                            max_seq=seq, vocab=64)
    replace = dataclasses.replace
    losses = {"standard": _first_loss(cfg, make_train_step, mesh, 0,
                                      2 * data, device_type)}
    losses["ring"] = _first_loss(replace(cfg, attention="ring"),
                                 make_train_step, mesh, 1, 2 * data,
                                 device_type)
    if cfg.n_heads % model_axis == 0:
        losses["ulysses"] = _first_loss(replace(cfg, attention="ulysses"),
                                        make_train_step, mesh, 5, 2 * data,
                                        device_type)
    # every other layer a top-1 MoE, experts sharded over "model"
    losses["ep"] = _first_loss(replace(cfg, moe_experts=2 * model_axis),
                               make_train_step, mesh, 2, 2 * data,
                               device_type)
    if n >= 4 and n % 4 == 0:  # the batch over ("dcn", "data")
        ms_mesh = make_mesh(("dcn", "data", "model"), (2, n // 4, 2),
                            device_type=device_type)
        ms_cfg = replace(cfg, n_heads=max(4, axis_size(ms_mesh, "model")))
        losses["multislice"] = _first_loss(
            ms_cfg, make_train_step, ms_mesh, 4, 2 * 2 * (n // 4),
            device_type)
    pipe = model_axis  # the largest factor as the stage count
    if pipe >= 2:
        pp_mesh = make_mesh(("pipe", "data"), (pipe, n // pipe),
                            device_type=device_type)
        pp_cfg = replace(cfg, n_layers=pipe, sequence_parallel=False,
                         attention="standard")

        def make_pp(c, m, device):
            return pipeline.make_pipeline_train_step(c, m, 2, device=device)

        losses["pipeline"] = _first_loss(pp_cfg, make_pp, pp_mesh, 3,
                                         2 * max(1, n // pipe), device_type)
    for mode, loss in losses.items():
        if not (math.isfinite(loss) and loss > 0):
            raise RuntimeError(f"dry run: mode {mode}'s first loss is "
                               f"{loss}")
    return losses


def dryrun_multichip(n_devices: int,
                     device: "str | torch.device" = "cuda") -> dict:
    """The full train step on tiny shapes in each mode over *n_devices*
    ranks (gloo ranks on "cpu", NCCL ranks one card each on "cuda"; one
    card's rank in this process); returns rank 0's ``{mode: first
    loss}``. Every rank's group ends before this returns or raises; the
    spawned ranks are held to ``spmd.DEADLINE_S``."""
    dev = resolve_device(device)
    if n_devices < 1:
        raise ValueError(f"a dry run over {n_devices} ranks")
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        if have < n_devices:
            raise ValueError(f"a dry run over {n_devices} ranks needs "
                             f"{n_devices} cards, the machine has {have}")
        if n_devices == 1:
            if dist.is_initialized():
                raise RuntimeError("dry run: this process already has a "
                                   "process group")
            try:
                return _dryrun_body("cuda")
            finally:
                if dist.is_initialized():
                    dist.destroy_process_group()
        backend = "nccl"
        library()  # built once here, so the ranks do not race to build it
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {dev}")
    with tempfile.TemporaryDirectory() as store:
        return spmd.spawn(_dryrun_body, n_devices, store,
                          args=(dev.type,), backend=backend)[0]


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda: a rank a card; cpu: 8 gloo ranks")
    args = ap.parse_args(argv)
    fn, (params, tokens) = entry(args.device)
    with torch.no_grad():
        print("entry ok:", tuple(fn(params, tokens).shape), flush=True)
    n = 8 if args.device == "cpu" else torch.cuda.device_count()
    print(f"dryrun_multichip({n}) ok:", dryrun_multichip(n, args.device),
          flush=True)
    return 0


if __name__ == "__main__":
    from dpu_operator_tpu_torch import graft_entry  # ranks import it by name
    sys.exit(graft_entry.main(sys.argv[1:]))
