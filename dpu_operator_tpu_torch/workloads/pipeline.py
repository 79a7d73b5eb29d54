"""Pipeline parallelism (pp) of the port: GPipe microbatches over a "pipe"
mesh axis.

Port of ``dpu_operator_tpu/workloads/pipeline.py``
(``init_pipeline_params``, ``pipeline_param_specs``,
``make_pipeline_forward``, ``make_pipeline_train_step``,
``sequential_forward``). Stages are consecutive groups of layers, one a
rank of "pipe"; every layer tensor is stacked (stages, layers a stage,
...), and a rank holds its stage's slice. The schedule is the reference's:
M + P - 1 ticks for M microbatches over P stages; at each tick stage 0
takes the next microbatch (the last one again once they run out, as the
reference's clipped index does), every other stage the activation the
previous stage handed it one tick before, and every stage hands its
output one hop on (``collectives.RingHop`` over "pipe"). Microbatch m
leaves the last stage at tick m + P - 1; the last stage's outputs are
summed over "pipe" (the other stages add zeros), so every rank holds
them, and ``out_norm`` and the tied logits follow.

**The stage layer is** ``model.layer`` with the one-device hooks, so its
norms are the RMSNorm kernel and its attention the flash VJP (the
hand-written forward with the logsumexp, dQ and dK/dV kernels on the
card), where the reference's stage runs a plain einsum attention: the
same function.

**The cyclic hop.** The reference's permutation (i -> i + 1) hands stage
0 zeros, which stage 0 never reads; here the last stage's output goes
round to stage 0, which does not read it either: the same values and the
same gradients. Stage 0 picks its input with ``torch.where`` on a tensor
condition, so every hop's output stays in every rank's graph and each
rank runs the hops' backwards (the reverse hops) in the same order. The
last tick's hop feeds no rank, and no rank runs its backward.

**Gradients.** Every rank computes the loss from the summed outputs and
takes 1 / P of it into its graph (:class:`~.model._ReduceFromModel` over
"pipe"); the sum's backward all-reduces the cotangent, so the last stage
receives the whole of it. The replicated leaves (``embed``, ``pos``,
``out_norm``) reach the loss through stage 0's input and through every
rank's 1 / P share of the logits, so the step sums their gradients over
"pipe"; then every gradient is averaged over "data" (pp x dp: each
microbatch's rows split over "data").
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from .. import resolve_device
from ..ops import flash_attention_vjp, fused_rmsnorm
from .collectives import RingHop
from .mesh import axis_size, mesh_device
from .model import (TransformerConfig, _all_reduce, _check_supported,
                    _MeanOver, _ReduceFromModel, _to_tensor, layer,
                    logits_of, shard_tree)
from .train import STAGE_LEAVES, _all_reduce_into, map_params, param_leaves

def _stages_of(cfg: TransformerConfig, n_stages: int) -> int:
    """Layers a stage; an uneven split raises ``ValueError``. The stages
    stack dense layers whatever ``cfg.moe_experts`` says, as the
    reference's ``init_pipeline_params`` and ``_layer_fwd`` (which never
    read it): a stage layer's dict has no ``"moe"`` key, so
    ``model.layer`` runs its dense FFN, and the pipeline's loss has no
    MoE term."""
    _check_supported(cfg)
    if cfg.n_layers % n_stages:
        raise ValueError(
            f"{cfg.n_layers} layers do not split over {n_stages} stages")
    return cfg.n_layers // n_stages


def init_pipeline_params(seed: int, cfg: TransformerConfig, n_stages: int,
                         device: "str | torch.device" = "cuda") -> dict:
    """Random parameters from *seed* with every layer tensor stacked
    (n_stages, layers a stage, ...): dense weights N(0, 1) / sqrt(fan_in)
    as the reference draws them (torch's generator is not JAX's), norm
    scales 1. Layers that do not split evenly over the stages raise
    ``ValueError``."""
    lps = _stages_of(cfg, n_stages)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, f = cfg.d_model, cfg.d_ff

    def dense(shape: tuple) -> torch.Tensor:
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return w.div_(float(np.sqrt(shape[0]))).to(cfg.dtype)

    def stacked(shape: tuple) -> torch.Tensor:
        return torch.stack([torch.stack([dense(shape) for _ in range(lps)])
                            for _ in range(n_stages)])

    ones = torch.ones((n_stages, lps, d), dtype=cfg.dtype, device=dev)
    stages = {"ln1": ones, "ln2": ones.clone(),
              "wqkv": stacked((d, 3 * d)), "wo": stacked((d, d)),
              "w1": stacked((d, f)), "w2": stacked((f, d))}
    return {"embed": dense((cfg.vocab, d)), "pos": dense((cfg.max_seq, d)),
            "out_norm": torch.ones(d, dtype=cfg.dtype, device=dev),
            "stages": stages}


def pipeline_params_from_numpy(tree: dict, cfg: TransformerConfig,
                               device: "str | torch.device" = "cuda"
                               ) -> dict:
    """The port's pipeline tree from a JAX ``init_pipeline_params`` tree
    whose leaves were converted with ``np.asarray``: same values,
    ``cfg.dtype``, on *device*."""
    _stages_of(cfg, np.shape(tree["stages"]["wqkv"])[0])
    dev = resolve_device(device)

    def conv(a: Any) -> torch.Tensor:
        return _to_tensor(a, cfg.dtype, dev)

    return {"embed": conv(tree["embed"]), "pos": conv(tree["pos"]),
            "out_norm": conv(tree["out_norm"]),
            "stages": {n: conv(tree["stages"][n]) for n in STAGE_LEAVES}}


def pipeline_param_specs() -> dict:
    """The reference's specs as ``model.param_specs`` tuples: the stage
    dim of every stacked leaf split over "pipe", the rest replicated."""
    return {"embed": (), "pos": (), "out_norm": (),
            "stages": dict.fromkeys(STAGE_LEAVES, ("pipe",))}


def check_pipeline_mesh(cfg: TransformerConfig, mesh: DeviceMesh) -> None:
    """Refuse a mesh without a "pipe" axis or with axes other than "pipe"
    and "data", and layers that do not split over the stages."""
    names = tuple(mesh.mesh_dim_names or ())
    if "pipe" not in names or set(names) - {"pipe", "data"}:
        raise ValueError(f"the pipeline takes a mesh of axes 'pipe' and "
                         f"optionally 'data', not {names}")
    _stages_of(cfg, axis_size(mesh, "pipe"))


def _data(mesh: DeviceMesh) -> tuple:
    """``(group or None, size, this rank's index)`` of "data"."""
    if "data" not in mesh.mesh_dim_names:
        return None, 1, 0
    return mesh.get_group("data"), axis_size(mesh, "data"), \
        mesh.get_local_rank("data")


def pipeline_batch_shard(t: torch.Tensor, mesh: DeviceMesh,
                         n_micro: int) -> torch.Tensor:
    """This rank's rows of a global batch tensor: the batch cut into
    *n_micro* microbatches of consecutive rows, each split over "data";
    the rank's pieces of every microbatch, microbatch-major."""
    b = t.shape[0]
    if b % n_micro:
        raise ValueError(
            f"batch {b} does not split into {n_micro} microbatches")
    mb = b // n_micro
    _, dp, rank = _data(mesh)
    if mb % dp:
        raise ValueError(f"microbatch size {mb} does not shard over data "
                         f"axis {dp}")
    return t.unflatten(0, (n_micro, mb)).chunk(dp, 1)[rank].flatten(0, 1)


class _SumOverPipe(torch.autograd.Function):
    """The sum over "pipe" of the stages' outputs, whose backward is the
    sum of the ranks' cotangents (each rank holds 1 / P of the loss's)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class PipelineForward:
    """``(params, tokens) -> logits``: *params* the rank's shards of a
    pipeline tree, *tokens* the rank's rows (:func:`pipeline_batch_shard`),
    the logits (rows, S, V) in fp32 for those rows. ``hops`` counts the
    stage-to-stage hops made so far, M + P - 1 a forward (none for one
    stage)."""

    def __init__(self, cfg: TransformerConfig, mesh: DeviceMesh,
                 n_micro: int) -> None:
        check_pipeline_mesh(cfg, mesh)
        self.cfg, self.n_micro = cfg, n_micro
        self.group = mesh.get_group("pipe")
        self.n, self.stage = axis_size(mesh, "pipe"), \
            mesh.get_local_rank("pipe")
        ranks = mesh.mesh.movedim(mesh.mesh_dim_names.index("pipe"), -1)
        coord = tuple(mesh.get_local_rank(a) for a in mesh.mesh_dim_names
                      if a != "pipe")
        line = ranks[coord].tolist()
        self.to = line[(self.stage + 1) % self.n]
        self.frm = line[(self.stage - 1) % self.n]
        self.hops = 0

    def _hop(self, y: torch.Tensor) -> torch.Tensor:
        if self.n == 1:  # one stage: no hop, as the reference
            return y
        self.hops += 1
        return RingHop.apply(y, self.group, self.to, self.frm)

    def _stage(self, x: torch.Tensor, layers: list) -> torch.Tensor:
        for lp in layers:
            x, _ = layer(x, lp, self.cfg, flash_attention_vjp)
        return x

    def __call__(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        cfg, m = self.cfg, self.n_micro
        tokens = tokens.to(params["embed"].device)
        rows, s = tokens.shape
        if rows % m:
            raise ValueError(
                f"batch {rows} does not split into {m} microbatches")
        layers = _layers(params["stages"], 0)
        x = (params["embed"][tokens] + params["pos"][:s]).to(cfg.dtype)
        xm = x.unflatten(0, (m, rows // m))
        first = torch.tensor(self.stage == 0, device=x.device)
        buf = torch.zeros_like(xm[0])
        ys = []
        for t in range(m + self.n - 1):
            y = self._stage(torch.where(first, xm[min(t, m - 1)], buf),
                            layers)
            buf = self._hop(y)
            ys.append(y)
        keep = 1.0 if self.stage == self.n - 1 else 0.0
        outs = torch.stack(ys[self.n - 1:]) * keep
        out = _SumOverPipe.apply(outs, self.group).flatten(0, 1)
        return logits_of(fused_rmsnorm(out, params["out_norm"]),
                         params["embed"])


def _layers(stages: dict, stage: int) -> list:
    """The layer dicts of stage *stage* of a stage-stacked tree, cut by
    one ``unbind`` a leaf: its backward stacks the layers' gradients
    once, where indexing each layer would add a whole stacked zero
    gradient a use."""
    cut = {n: t[stage].unbind(0) for n, t in stages.items()}
    return [dict(zip(cut, parts)) for parts in zip(*cut.values())]


def make_pipeline_forward(cfg: TransformerConfig, mesh: DeviceMesh,
                          n_micro: int) -> PipelineForward:
    """The pipelined forward over *mesh*'s "pipe" axis with *n_micro*
    microbatches (:class:`PipelineForward`)."""
    return PipelineForward(cfg, mesh, n_micro)


def pipeline_loss(fwd: PipelineForward, params: dict, batch: dict,
                  mesh: DeviceMesh) -> torch.Tensor:
    """The mean next-token loss of the global batch (the reference's
    ``loss_fn`` inside ``make_pipeline_train_step``), the same on every
    rank; its backward leaves on each rank its 1 / P share of the
    post-sum graph and its own data shard's gradient."""
    logits = fwd(params, batch["tokens"])
    targets = batch["targets"].to(logits.device).long()
    nll = F.cross_entropy(logits.flatten(0, 1), targets.flatten())
    loss = _ReduceFromModel.apply(nll / fwd.n, fwd.group)
    group, dp, _ = _data(mesh)
    return loss if group is None else _MeanOver.apply(loss, group, dp)


def _reduce_grads(params: dict, mesh: DeviceMesh) -> None:
    """The replicated leaves' gradients summed over "pipe", then every
    gradient averaged over "data"."""
    _all_reduce_into([params[n].grad for n in ("embed", "pos", "out_norm")],
                     mesh.get_group("pipe"), 1)
    group, dp, _ = _data(mesh)
    if group is not None:
        _all_reduce_into([p.grad for p in param_leaves(params)], group, dp)


def make_pipeline_train_step(cfg: TransformerConfig, mesh: DeviceMesh,
                             n_micro: int,
                             device: "str | torch.device" = "cuda") -> tuple:
    """``(step, init_state, place)`` as ``train.make_train_step`` returns
    them, pipelined over "pipe" (x dp over "data" when the mesh has it):

    * ``init_state(seed=0, params=None) -> (params, opt)``: the rank's
      shards of :func:`init_pipeline_params` (or of the given global
      tree) under :func:`pipeline_param_specs`, and their AdamW (optax's
      ``adamw(lr)`` settings, as ``train.make_train_step``);
    * ``step(params, opt, batch) -> (params, opt, loss)`` in place, the
      loss the global batch's;
    * ``place(batch)``: the rank's rows (:func:`pipeline_batch_shard`).

    The mesh's device type must be *device*'s."""
    dev = resolve_device(device)
    if mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh for device {dev}")
    dev = mesh_device(mesh)
    fwd = make_pipeline_forward(cfg, mesh, n_micro)
    specs = pipeline_param_specs()

    def init_state(seed: int = 0, params: Optional[dict] = None) -> tuple:
        if params is None:
            params = init_pipeline_params(seed, cfg, fwd.n, device=dev)
        params = shard_tree(map_params(
            lambda t: t.detach().to(dev, cfg.dtype), params), specs, mesh)
        for t in param_leaves(params):
            t.requires_grad_(True)
        opt = torch.optim.AdamW(param_leaves(params), lr=cfg.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
        return params, opt

    def step(params: dict, opt: torch.optim.Optimizer,
             batch: dict) -> tuple:
        opt.zero_grad(set_to_none=True)
        loss = pipeline_loss(fwd, params, batch, mesh)
        loss.backward()
        _reduce_grads(params, mesh)
        opt.step()
        return params, opt, loss.detach()

    def place(batch: dict) -> dict:
        return {k: pipeline_batch_shard(v, mesh, n_micro).to(dev)
                for k, v in batch.items()}

    step.forward = fwd
    return step, init_state, place


def sequential_forward(cfg: TransformerConfig, params: dict,
                       tokens: torch.Tensor) -> torch.Tensor:
    """The reference oracle: the same stacked layers applied one after
    another on one device (no pipelining): logits (B, S, V) in fp32."""
    tokens = tokens.to(params["embed"].device)
    x = (params["embed"][tokens] + params["pos"][:tokens.shape[1]]).to(
        cfg.dtype)
    for si in range(params["stages"]["wqkv"].shape[0]):
        for lp in _layers(params["stages"], si):
            x, _ = layer(x, lp, cfg, flash_attention_vjp)
    return logits_of(fused_rmsnorm(x, params["out_norm"]), params["embed"])
