"""Decoder-only transformer of the port: config, parameters, forward,
loss.

Port of ``dpu_operator_tpu/workloads/model.py`` (``TransformerConfig``,
``init_params``, ``forward``, ``loss_fn``, ``make_example_batch``) and of
``perf.flagship_config``. The layer: pre-norm attention and a tanh-GELU
MLP, learned position embeddings, tied output embedding, logits in fp32.
Every norm is the fused RMSNorm kernel and every attention of
:func:`forward` the differentiable flash attention (``ops/``), so
``attention="standard"`` and ``"flash"`` run the same kernels: they compute
the same function. Both are differentiable on the CPU and on the card
(``RmsNormFn``, ``FlashAttentionFn``); the training step is
``workloads/train.py``. MoE layers (``cfg.moe_experts > 0``: every
``moe_every``-th layer's FFN a top-1 routed mixture, ``workloads/moe.py``)
run in the one :func:`layer` that forward, decode, verify and both
prefills share.

**The dp/tp/sp-sharded forward** (JAX ``forward(..., mesh)`` and
``make_train_step(cfg, mesh)``). With a mesh (``workloads/mesh.py``, axes
"data" and "model") the parameters are the rank's shards
(:func:`shard_params` of :func:`param_specs`) and the tokens the rank's
batch shard. The SPMD region (:class:`_Spmd`, the counterpart of JAX's
``shard_map`` around the flash kernel and of its sharding constraints)
computes on plain local tensors, because the RMSNorm and flash kernels
launch on plain tensors; its collectives are small autograd functions
over the mesh's process groups. tp: each rank holds its heads' q, k, v
columns of ``wqkv``, its rows of ``wo``, its columns of ``w1`` and rows
of ``w2``, and its rows of the vocabulary of the tied ``embed``. sp
(``cfg.sequence_parallel``): the residual stream and the norms hold S /
tp rows a rank, gathered before ``wqkv`` and ``w1`` and reduce-scattered
after ``wo`` and ``w2``.

**The sequence modes** (``attention="ring"`` or ``"ulysses"``, JAX
``forward``'s long-context modes). With a mesh every parameter is
replicated and all of "model" is spent on the sequence: the residual
stream holds the rank's S / n rows from the embedding on
(:class:`_SeqSpmd`), and attention is ring attention
(``workloads/ring_attention.py``) or Ulysses attention
(``workloads/ulysses.py``) over "model". Without a mesh a sequence-mode
config runs the one-device forward, as the JAX ``forward`` does.

**MoE on a mesh.** The MoE layer is a hook of the region
(:meth:`_Hooks.moe`). Under tp its experts are split over "model" (expert
parallelism, ``moe.moe_param_specs``): the stream is made whole over
"model" (``enter``), every rank routes every token of its batch shard as
the unsharded router does, computes the tokens routed to its own experts,
and ``leave`` sums the ranks' outputs. In a sequence mode every expert is
replicated and a row's tokens are spread over "model": each rank routes
its columns with the capacity of the whole row, and a token's place in
its expert's queue counts the row's tokens on the lower ranks (their
per-expert counts are all-gathered). In both the router statistics are
the global batch's, and the aux loss enters the loss once.

**Multi-slice** (a mesh of axes "dcn", "data", "model";
``workloads/multislice.py``): the batch splits over ("dcn", "data"),
slice-major, and the parameters replicate over "dcn"; every mean over the
batch runs over that flattened pair (``mesh.axes_group``).

Parameters are a plain dict shaped like the JAX tree: ``embed (V, D)``,
``pos (max_seq, D)``, ``out_norm (D,)`` and ``layers``, a list of dicts
with ``ln1, wqkv (D, 3D), wo (D, D), ln2, w1 (D, F), w2 (F, D)``; a MoE
layer holds ``moe: {wg (D, E), w1 (E, D, F), w2 (E, F, D)}`` in place of
``w1`` and ``w2``. The serving path's int8 tree
(``decode.quantize_decode_params``) has the same shape with ``{"q": int8,
"scale": fp32}`` leaves for ``embed`` and the projections (a MoE layer's
subtree stays in the model's type); :func:`layer` multiplies through :func:`_mm`, which takes the
W8A8 product for such a leaf, so decode runs the same block over either
tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import resolve_device
from ..ops import flash_attention_vjp, fused_rmsnorm
from ..utils import tracing
from .mesh import axes_group, axis_size
from .moe import init_moe_params, moe_ffn, moe_param_specs
from .ring_attention import ring_attention
from .ulysses import ulysses_attention

#: the long-context attention modes: parameters replicated, the sequence
#: sharded over "model"
SEQUENCE_MODES = {"ring": ring_attention, "ulysses": ulysses_attention}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 8
    n_layers: int = 2
    d_ff: int = 512
    max_seq: int = 128
    dtype: torch.dtype = torch.bfloat16
    #: with a mesh, shard the residual stream and the norms over "model"
    #: on S (does nothing without a mesh)
    sequence_parallel: bool = True
    #: "standard" and "flash" both run the port's attention kernels; with a
    #: mesh "ring" and "ulysses" shard the sequence over "model" (without
    #: one they run the one-device forward)
    attention: str = "standard"
    #: recompute each layer on the backward pass (torch.utils.checkpoint,
    #: the port of jax.checkpoint): less activation memory, more FLOPs
    remat: bool = False
    #: > 0 makes every ``moe_every``-th layer's FFN a top-1 routed mixture
    #: of that many experts (``workloads/moe.py``)
    moe_experts: int = 0
    moe_every: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2
    learning_rate: float = 1e-3

    def is_moe_layer(self, i: int) -> bool:
        return self.moe_experts > 0 and i % self.moe_every == (
            self.moe_every - 1)

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads


def flagship_config(dtype: torch.dtype = torch.bfloat16) -> TransformerConfig:
    """The repository's flagship (JAX ``perf.flagship_config``): about 391M
    parameters, d_model 1536, 12 layers of 12 heads of 128, d_ff 6144,
    max_seq 1024, vocab 32768."""
    return TransformerConfig(vocab=32768, d_model=1536, n_heads=12,
                             n_layers=12, d_ff=6144, max_seq=1024,
                             dtype=dtype, attention="flash")


def _check_supported(cfg: TransformerConfig) -> None:
    if cfg.attention not in ("standard", "flash", *SEQUENCE_MODES):
        raise ValueError(f"unknown attention mode {cfg.attention!r}")


def _to_tensor(a: Any, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    arr = np.array(a, copy=True, order="C")  # owned and writable
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype)


def int8_weight(q: torch.Tensor, scale: torch.Tensor) -> dict:
    """A quantized projection leaf ``{"q": int8 (K, N), "scale": fp32
    (1, N)}`` with q stored column-major (strides (1, K)): the right
    operand of the int8 product (``torch._int_mm``), whose cuBLASLt route
    on the card takes that layout only. Shape and values are the JAX
    leaf's."""
    return {"q": q.t().contiguous().t(), "scale": scale}


#: the projections of a layer (int8 leaves in a quantized tree; a MoE
#: layer has no w1 / w2 of its own)
PROJECTIONS = ("wqkv", "wo", "w1", "w2")


def params_from_numpy(tree: dict, cfg: TransformerConfig,
                      device: "str | torch.device" = "cuda") -> dict:
    """The port's parameters from a JAX ``init_params`` tree whose leaves
    were converted with ``np.asarray``: same values, ``cfg.dtype``, on
    *device*. A quantized tree (``quantize_decode_params``) comes across as
    it is: each ``{"q", "scale"}`` leaf keeps int8 and fp32. A MoE layer's
    ``moe`` subtree comes across in ``cfg.dtype``."""
    _check_supported(cfg)
    dev = resolve_device(device)

    def conv(a: Any) -> torch.Tensor:
        return _to_tensor(a, cfg.dtype, dev)

    def weight(a: Any, projection: bool) -> Any:
        if not isinstance(a, dict):
            return conv(a)
        q = _to_tensor(a["q"], torch.int8, dev)
        scale = _to_tensor(a["scale"], torch.float32, dev)
        return int8_weight(q, scale) if projection \
            else {"q": q, "scale": scale}

    def layer_of(lp: dict) -> dict:
        out = {name: weight(a, name in PROJECTIONS)
               for name, a in lp.items() if name != "moe"}
        if "moe" in lp:
            out["moe"] = {name: conv(a) for name, a in lp["moe"].items()}
        return out

    return {
        "embed": weight(tree["embed"], projection=False),
        "pos": conv(tree["pos"]),
        "out_norm": conv(tree["out_norm"]),
        "layers": [layer_of(lp) for lp in tree["layers"]],
    }


def init_params(seed: int, cfg: TransformerConfig,
                device: "str | torch.device" = "cuda") -> dict:
    """Random parameters from *seed*, drawn on *device* with a
    ``torch.Generator``: dense weights N(0, 1) / sqrt(fan_in) as in the JAX
    ``init_params`` (other numbers: torch's generator is not JAX's), norm
    scales 1. A MoE layer (``cfg.is_moe_layer``) draws its ``moe`` subtree
    (:func:`~.moe.init_moe_params`) in place of ``w1`` and ``w2``."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def dense(shape: tuple) -> torch.Tensor:
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return w.div_(float(np.sqrt(shape[0]))).to(cfg.dtype)

    def ones() -> torch.Tensor:
        return torch.ones(cfg.d_model, dtype=cfg.dtype, device=dev)

    d, f = cfg.d_model, cfg.d_ff
    params = {"embed": dense((cfg.vocab, d)),
              "pos": dense((cfg.max_seq, d)),
              "out_norm": ones(), "layers": []}
    for i in range(cfg.n_layers):
        lp = {"ln1": ones(), "wqkv": dense((d, 3 * d)), "wo": dense((d, d)),
              "ln2": ones()}
        if cfg.is_moe_layer(i):
            lp["moe"] = init_moe_params(gen, d, f, cfg.moe_experts,
                                        cfg.dtype, dev)
        else:
            lp["w1"] = dense((d, f))
            lp["w2"] = dense((f, d))
        params["layers"].append(lp)
    return params


def param_bytes(params: Any) -> int:
    """Bytes of every parameter tensor, each at its own width (an int8
    leaf's q at 1 byte an element, its scale at 4)."""
    if isinstance(params, dict):
        return sum(param_bytes(t) for t in params.values())
    if isinstance(params, list):
        return sum(param_bytes(t) for t in params)
    return params.numel() * params.element_size()


def split_heads(qkv: torch.Tensor, cfg: TransformerConfig) -> tuple:
    """(B, S, 3W) -> q, k, v views of (B, S, W / Dh, Dh), no copy: W is
    d_model, or a tp rank's d_model / tp (its heads' columns)."""
    return tuple(t.unflatten(-1, (-1, cfg.d_head))
                 for t in qkv.split(qkv.shape[-1] // 3, dim=-1))


def _is_q(w: object) -> bool:
    return isinstance(w, dict) and "q" in w


def _act_quant(x: torch.Tensor) -> tuple:
    """Symmetric int8 over the last dim: (int8 values, fp32 scales with
    the last dim 1). ``torch.round`` rounds half to even, as ``jnp.round``
    does."""
    xf = x.float()
    xs = torch.clamp(xf.abs().amax(-1, keepdim=True), min=1e-8) / 127.0
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    return xq, xs


#: rows a CUDA ``torch._int_mm`` needs at least (it takes more than 16)
_INT_MM_ROWS = 32


def _int8_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq (..., K) int8 times wq (K, N) int8 -> (..., N) int32, exact. On
    the card ``torch._int_mm`` takes 2-D operands with more than 16 rows
    (K and N multiples of 8): the rows are flattened, and fewer than 17
    are padded with zero rows, which change no value of an exact
    product."""
    lead = xq.shape[:-1]
    a = xq.reshape(-1, xq.shape[-1])
    m = a.shape[0]
    if a.is_cuda and m <= 16:
        a = torch.cat([a, a.new_zeros((_INT_MM_ROWS - m, a.shape[1]))])
    return torch._int_mm(a, wq)[:m].reshape(*lead, wq.shape[1])


def _mm(x: torch.Tensor, w: "torch.Tensor | dict") -> torch.Tensor:
    """x @ w for a plain weight, or the W8A8 product for an int8 leaf
    (JAX ``decode._mm``): int8 activations times int8 weights, rescaled by
    the activation and weight scales in fp32 and rounded to x's type."""
    if not _is_q(w):
        return x @ w
    xq, xs = _act_quant(x)
    acc = _int8_mm(xq, w["q"])
    return (acc.float() * xs * w["scale"]).to(x.dtype)


def mlp(h: torch.Tensor, lp: dict) -> torch.Tensor:
    """tanh-GELU MLP (``jax.nn.gelu`` defaults to the tanh form)."""
    return _mm(F.gelu(_mm(h, lp["w1"]), approximate="tanh"), lp["w2"])


def logits_of(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Tied output projection, computed in the weights' type and returned
    in fp32 (``(x @ embed.T).astype(float32)`` in the JAX model)."""
    return (x @ embed.T).float()


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


class _Hooks:
    """The mesh hooks of :func:`layer` and :func:`forward` on one device:
    every hook leaves its tensor as it is, and ``attend`` is the causal
    flash attention."""

    enter = leave = batch_mean = staticmethod(_same)
    attend = staticmethod(flash_attention_vjp)

    def moe(self, params: dict, h: torch.Tensor,
            cfg: TransformerConfig) -> tuple:
        """The MoE FFN of a layer: ``(out, aux)``."""
        return moe_ffn(params, h, cfg.moe_capacity_factor,
                       mean=self.batch_mean)

    def embed(self, embed: torch.Tensor, tokens: torch.Tensor,
              pos: torch.Tensor) -> torch.Tensor:
        return embed[tokens] + pos[:tokens.shape[1]]

    def logits(self, x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
        return logits_of(x, embed)


_ONE_DEVICE = _Hooks()


def layer(x: torch.Tensor, lp: dict, cfg: TransformerConfig,
          attend: Callable[..., torch.Tensor],
          hooks: _Hooks = _ONE_DEVICE) -> tuple:
    """One pre-norm block on x (B, S, D): ``(x, aux)``, aux the MoE
    layer's load-balancing loss (None for a dense layer). *attend(q, k,
    v)* maps the layer's (B, S, H, Dh) projections to the attention
    output: over the same tokens in :func:`forward`, over the KV cache in
    decode. Each product with a projection is :func:`_mm`'s: ``@``, or
    W8A8 for an int8 leaf. A MoE layer routes each of the B rows on its
    own (``moe_ffn``), so a decode step's slots and a chunk's padded width
    route as the JAX serving functions do.

    *hooks* are the sharded forward's (:class:`_Spmd`): ``enter`` before
    the column-parallel ``wqkv`` and ``w1``, ``leave`` after the
    row-parallel ``wo`` and ``w2``, ``moe`` for a MoE layer's FFN; on one
    device each is the identity, and ``moe`` is ``moe_ffn``.

    Under a running profiler the attention half of the block (its norm,
    projections, attention and residual) is a ``model.attention`` range
    and the FFN half a ``model.mlp`` or ``model.moe`` one."""
    with tracing.profiled("model.attention"):
        h = fused_rmsnorm(x, lp["ln1"])
        o = attend(*split_heads(_mm(hooks.enter(h), lp["wqkv"]), cfg))
        x = x + hooks.leave(_mm(o.flatten(2), lp["wo"]))
    with tracing.profiled("model.moe" if "moe" in lp else "model.mlp"):
        h = fused_rmsnorm(x, lp["ln2"])
        if "moe" in lp:
            out, aux = hooks.moe(lp["moe"], h, cfg)
            return x + out, aux
        return x + hooks.leave(mlp(hooks.enter(h), lp)), None


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            mesh: Optional[DeviceMesh] = None,
            return_aux: bool = False) -> "torch.Tensor | tuple":
    """Logits (B, S, V) fp32 for next-token prediction; tokens (B, S).
    With *return_aux* also the sum of the MoE layers' load-balancing
    losses (an fp32 scalar, 0 for a dense model), as the JAX ``forward``.
    Differentiable in every parameter; with ``cfg.remat`` each layer is
    recomputed on the backward pass (its collectives too, in the same
    order on every rank).

    With a *mesh*, *params* are the rank's shards (:func:`shard_params`)
    and *tokens* the rank's batch shard; the logits are that shard's,
    over the whole vocabulary, and equal the unsharded forward's rows. In
    a sequence mode they are the rank's S / n columns of those rows
    (:func:`seq_columns`)."""
    _check_supported(cfg)
    tokens = tokens.to(params["embed"].device)
    hooks = _ONE_DEVICE if mesh is None else _region(cfg, mesh,
                                                     tokens.shape[1])
    # the position embedding is added before the cast, as in the JAX model
    x = hooks.embed(params["embed"], tokens, params["pos"]).to(cfg.dtype)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params["layers"]:
        if cfg.remat and torch.is_grad_enabled():
            x, aux = checkpoint(layer, x, lp, cfg, hooks.attend, hooks,
                                use_reentrant=False)
        else:
            x, aux = layer(x, lp, cfg, hooks.attend, hooks)  # causal
        if aux is not None:
            aux_total = aux_total + aux
    x = fused_rmsnorm(x, params["out_norm"])
    logits = hooks.logits(x, params["embed"])
    return (logits, aux_total) if return_aux else logits


def loss_fn(params: dict, batch: dict, cfg: TransformerConfig,
            mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Mean next-token negative log-likelihood of the fp32 logits plus
    ``cfg.moe_aux_weight`` times the MoE load-balancing loss (JAX
    ``loss_fn``): batch holds ``tokens`` and ``targets`` (B, S).

    With a *mesh* the batch is the rank's shard and the value is the
    global batch's loss, the mean of the batch ranks' means (equal
    shards; "data", or ("dcn", "data") on a multi-slice mesh). Its
    backward leaves on each rank the gradient of its own shard's loss;
    ``make_train_step`` averages the gradients over the batch ranks to
    match. In a sequence mode a rank's shard is its S / n columns of
    those rows: the value is also the mean over "model", the same on every
    rank, and the backward leaves on each rank the gradient of its own
    columns' share of it, which ``make_train_step`` sums over "model"."""
    logits, aux = forward(params, batch["tokens"], cfg, mesh,
                          return_aux=True)
    targets = batch["targets"].to(logits.device).long()
    if mesh is not None and cfg.attention in SEQUENCE_MODES:
        targets = seq_columns(targets, mesh)
    nll = F.cross_entropy(logits.flatten(0, 1), targets.flatten())
    loss = nll + cfg.moe_aux_weight * aux
    if mesh is None:
        return loss
    if cfg.attention in SEQUENCE_MODES:  # each rank's share of the sum
        loss = _ReduceFromModel.apply(loss / axis_size(mesh, "model"),
                                      mesh.get_group("model"))
    group, n, _ = axes_group(mesh, _batch_axes(mesh))
    return _MeanOver.apply(loss, group, n)


# -- the sharded forward ------------------------------------------------------

def param_specs(cfg: TransformerConfig) -> dict:
    """Which dim of each parameter is split over which mesh axis: the JAX
    ``param_specs`` as plain tuples, one entry a dim (the axis's name, or
    None for a whole dim); ``()`` is a replicated leaf. tp shards heads
    and ff over "model" (column-parallel ``wqkv`` / ``w1``, row-parallel
    ``wo`` / ``w2``), the tied embedding its vocabulary, and a MoE layer
    its experts (``moe_param_specs``); norms and ``pos`` replicate. In a
    sequence mode every leaf replicates, a MoE layer's too: all of "model"
    is spent on the sequence. No leaf splits over "dcn"."""
    _check_supported(cfg)
    if cfg.attention in SEQUENCE_MODES:
        layers = []
        for i in range(cfg.n_layers):
            lp = dict.fromkeys(("ln1", "wqkv", "wo", "ln2"), ())
            if cfg.is_moe_layer(i):
                lp["moe"] = dict.fromkeys(("wg", "w1", "w2"), ())
            else:
                lp.update(w1=(), w2=())
            layers.append(lp)
        return {"embed": (), "pos": (), "out_norm": (), "layers": layers}
    layers = []
    for i in range(cfg.n_layers):
        lp = {"ln1": (), "ln2": (), "wqkv": (None, "model"),
              "wo": ("model", None)}
        if cfg.is_moe_layer(i):
            lp["moe"] = moe_param_specs()
        else:
            lp.update({"w1": (None, "model"), "w2": ("model", None)})
        layers.append(lp)
    return {"embed": ("model", None), "pos": (), "out_norm": (),
            "layers": layers}


def _batch_axes(mesh: Optional[DeviceMesh]) -> Any:
    """Mesh axes carrying the batch dimension: "data"; a mesh with a
    leading "dcn" axis (multi-slice) shards it over both, each slice
    taking a batch shard."""
    if mesh is not None and "dcn" in mesh.mesh_dim_names:
        return ("dcn", "data")
    return "data"


def check_mesh(cfg: TransformerConfig, mesh: DeviceMesh,
               seq: Optional[int] = None) -> None:
    """Refuse what the sharded forward does not run: meshes without the
    axes "data" and "model" (and, multi-slice, a "dcn" axis before them),
    and shapes that do not split over "model": a sequence of *seq* tokens
    in a sequence mode or under sequence parallelism, the heads in tp and
    Ulysses, and the vocabulary, ``d_ff`` and the experts in tp (JAX's
    sharding cannot split them either)."""
    _check_supported(cfg)
    names = tuple(mesh.mesh_dim_names or ())
    if names not in (("data", "model"), ("dcn", "data", "model")):
        raise ValueError(f"the sharded forward takes a mesh of axes "
                         f"('data', 'model') or ('dcn', 'data', 'model'), "
                         f"not {names}")
    tp = axis_size(mesh, "model")
    seq_mode = cfg.attention in SEQUENCE_MODES
    split_seq = seq_mode or cfg.sequence_parallel
    if seq is not None and split_seq and seq % tp:
        what = f"{cfg.attention} attention" if seq_mode \
            else "sequence parallelism"
        raise ValueError(f"{what}: S {seq} does not split over a 'model' "
                         f"axis of {tp}")
    if cfg.attention == "ring":
        splits = ()
    elif cfg.attention == "ulysses":
        splits = (("n_heads", cfg.n_heads),)
    else:
        splits = (("n_heads", cfg.n_heads), ("vocab", cfg.vocab),
                  ("d_ff", cfg.d_ff), ("moe_experts", cfg.moe_experts))
    for what, n in splits:
        if n % tp:
            raise ValueError(f"{what} {n} does not split over a 'model' "
                             f"axis of {tp}")


def _map_specs(fn: Callable, tree: Any, specs: Any, key: str = "") -> Any:
    """*tree* with ``fn(leaf, spec, key)`` at every leaf, *key* the leaf's
    name in its dict."""
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, specs[k], k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_specs(fn, v, sp, key) for v, sp in zip(tree, specs)]
    return fn(tree, specs, key)


def shard_params(params: dict, cfg: TransformerConfig,
                 mesh: DeviceMesh) -> dict:
    """This rank's shards of a global tree (``params_from_numpy``,
    ``init_params``): each leaf split by :func:`param_specs` over the
    "model" axis, the rank's piece an owned contiguous copy on the tree's
    device.

    **The fused ``wqkv``.** Its JAX spec ``P(None, "model")`` gives a rank
    a contiguous block of the ``[q | k | v]`` columns, which is not the q,
    k and v of any heads (at tp 4 rank 0's block is three quarters of q).
    Here a rank holds ``[q_r | k_r | v_r]``, its heads' columns of each,
    3D / tp columns in all: the layout :func:`layer` splits into heads.
    :func:`gather_params` puts JAX's layout back."""
    check_mesh(cfg, mesh)
    return shard_tree(params, param_specs(cfg), mesh)


def _split_dims(spec: tuple) -> list:
    """``(dim, axis)`` of each dim of *spec* split over a mesh axis."""
    return [(dim, axis) for dim, axis in enumerate(spec) if axis]


def shard_tree(tree: Any, specs: Any, mesh: DeviceMesh) -> Any:
    """This rank's pieces of a global tree under *specs* (trees of
    :func:`param_specs` tuples; any axis of *mesh*): each piece an owned
    contiguous copy on the tree's device. A ``wqkv`` split over "model"
    takes the rank's heads' columns of q, k and v (:func:`shard_params`)."""

    def shard(t: torch.Tensor, spec: tuple, key: str) -> torch.Tensor:
        t = t.detach()
        for dim, axis in _split_dims(spec):
            n, rank = axis_size(mesh, axis), mesh.get_local_rank(axis)
            parts = t.chunk(3, dim) if (key, axis) == ("wqkv", "model") \
                else (t,)
            t = torch.cat([p.chunk(n, dim)[rank] for p in parts], dim)
        return t.clone(memory_format=torch.contiguous_format)

    return _map_specs(shard, tree, specs)


def global_shapes(tree: Any, specs: Any, mesh: DeviceMesh) -> Any:
    """*tree* with each leaf's global shape under *specs*: the rank's
    piece's shape, each split dim times its axis's size (the shape
    :func:`gather_tree` gives back)."""

    def whole(t: torch.Tensor, spec: tuple, key: str) -> torch.Size:
        shape = list(t.shape)
        for dim, axis in _split_dims(spec):
            shape[dim] *= axis_size(mesh, axis)
        return torch.Size(shape)

    return _map_specs(whole, tree, specs)


def gather_tree(tree: Any, specs: Any, mesh: DeviceMesh) -> Any:
    """The global tree from every rank's pieces under *specs* (a
    collective over each split axis's groups), detached: the inverse of
    :func:`shard_tree`."""

    def gather(t: torch.Tensor, spec: tuple, key: str) -> torch.Tensor:
        t = t.detach()
        for dim, axis in _split_dims(spec):
            n = axis_size(mesh, axis)
            t = _gather(t, mesh.get_group(axis), n, dim)
            if (key, axis) == ("wqkv", "model"):
                # rank-major [q_r | k_r | v_r] -> [q | k | v]
                t = t.unflatten(dim, (n, 3, -1)).transpose(
                    dim, dim + 1).flatten(dim, dim + 2)
        return t.clone(memory_format=torch.contiguous_format)

    return _map_specs(gather, tree, specs)


def gather_params(params: dict, cfg: TransformerConfig,
                  mesh: DeviceMesh) -> dict:
    """The global tree in the JAX layout from every rank's shards (a
    collective: every rank of the "model" group calls it), detached; for
    tests and checkpoints."""
    check_mesh(cfg, mesh)
    return gather_tree(params, param_specs(cfg), mesh)


def batch_shard(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's rows of a global batch tensor: the batch axes
    (:func:`_batch_axes`; on a multi-slice mesh ("dcn", "data"),
    slice-major) split the batch into equal shards."""
    axes = _batch_axes(mesh)
    _, dp, rank = axes_group(mesh, axes)
    if t.shape[0] % dp:
        name = axes if isinstance(axes, str) else " x ".join(axes)
        raise ValueError(f"batch {t.shape[0]} does not split over a "
                         f"'{name}' axis of {dp}")
    return t.chunk(dp, 0)[rank]


_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _all_reduce(t: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def _gather(t: torch.Tensor, group: dist.ProcessGroup, n: int,
            dim: int) -> torch.Tensor:
    """Every rank's *t* concatenated along *dim*, rank-major."""
    parts = t.new_empty((n * t.shape[0], *t.shape[1:]))
    _all_gather(parts, t.contiguous(), group=group)
    dim = dim % t.dim()
    return parts.unflatten(0, (n, -1)).movedim(0, dim).flatten(dim, dim + 1)


def _scatter(t: torch.Tensor, group: dist.ProcessGroup, n: int,
             dim: int) -> torch.Tensor:
    """This rank's piece along *dim* of the sum of every rank's *t*."""
    dim = dim % t.dim()
    parts = t.unflatten(dim, (n, -1)).movedim(dim, 0)
    out = t.new_empty(parts.shape[1:])
    _reduce_scatter(out, parts.flatten(0, 1), group=group)
    return out


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient over "model": a
    replicated activation entering column-parallel products."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward over "model", identity backward: the partial
    sums of row-parallel products."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    """sp: all-gather the S / tp rows of every rank along S; the backward
    reduce-scatters the gradient back to the rank's rows."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _gather(x, group, n, 1)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.group, ctx.n, 1), None, None


class _ScatterSeq(torch.autograd.Function):
    """sp: reduce-scatter the partial sums along S to each rank's rows;
    the backward all-gathers the gradient."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _scatter(x, group, n, 1)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.n, 1), None, None


class _GatherVocab(torch.autograd.Function):
    """All-gather the vocabulary-sharded logits along V. Every rank then
    computes the same loss, so the gradient of the rank's logits is its
    slice of the whole gradient: no collective in the backward."""

    @staticmethod
    def forward(ctx, x, group, n, rank):
        ctx.rank, ctx.width = rank, x.shape[-1]
        return _gather(x, group, n, -1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.width
        return g[..., lo:lo + ctx.width], None, None, None


class _MeanOver(torch.autograd.Function):
    """The mean over a group's ranks forward, identity backward: each rank
    keeps the gradient of its own term, and the train step's average of
    the gradients over the group makes it the mean's."""

    @staticmethod
    def forward(ctx, x, group, n):
        return _all_reduce(x, group) / n

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Spmd(_Hooks):
    """The SPMD region of a sharded forward: this rank's place on the mesh
    and the collectives of the hooks. Without sp the residual stream is
    replicated over "model": ``enter`` is :class:`_CopyToModel` and
    ``leave`` :class:`_ReduceFromModel`. With sp it holds the rank's S /
    tp rows: ``enter`` gathers S (:class:`_GatherSeq`) and ``leave``
    reduce-scatters it (:class:`_ScatterSeq`); the norm scales' and
    ``pos``'s gradients are then partial over "model", and the train step
    all-reduces them (the reduction Megatron's sp needs).

    A MoE layer (:meth:`moe`) is expert-parallel: the rank holds E / tp
    experts, routes the whole stream that ``enter`` makes, and computes
    its own experts' tokens; ``leave`` sums the ranks' outputs, as the tp
    MLP's partial sums. The router ``wg`` is replicated but reaches the
    output only through the rank's own experts, so its gradient is
    partial over "model" with or without sp, and the train step sums it
    (``train._reduce_grads``)."""

    def __init__(self, cfg: TransformerConfig, mesh: DeviceMesh,
                 seq: int) -> None:
        check_mesh(cfg, mesh, seq)
        self.group = mesh.get_group("model")
        self.n, self.rank = axis_size(mesh, "model"), \
            mesh.get_local_rank("model")
        self.data, self.dp, _ = axes_group(mesh, _batch_axes(mesh))
        self.sp = cfg.sequence_parallel

    def enter(self, h: torch.Tensor) -> torch.Tensor:
        if self.sp:
            return _GatherSeq.apply(h, self.group, self.n)
        return _CopyToModel.apply(h, self.group)

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        if self.sp:
            return _ScatterSeq.apply(y, self.group, self.n)
        return _ReduceFromModel.apply(y, self.group)

    def batch_mean(self, t: torch.Tensor) -> torch.Tensor:
        return _MeanOver.apply(t, self.data, self.dp)

    def moe(self, params: dict, h: torch.Tensor,
            cfg: TransformerConfig) -> tuple:
        """Expert parallelism. Every rank computes the same aux loss from
        the whole stream's router; each takes 1 / tp of it into its graph
        and the sum over "model" (:class:`_ReduceFromModel`, identity
        backward) gives the value, so the gradients that ``enter`` and
        the train step sum over "model" hold the aux term once."""
        out, aux = moe_ffn(params, self.enter(h), cfg.moe_capacity_factor,
                           mean=self.batch_mean,
                           first_expert=self.rank * params["w1"].shape[0])
        return self.leave(out), _ReduceFromModel.apply(aux / self.n,
                                                       self.group)

    def embed(self, embed: torch.Tensor, tokens: torch.Tensor,
              pos: torch.Tensor) -> torch.Tensor:
        """The vocabulary-sharded lookup: ids outside the rank's rows look
        up 0, and ``leave`` sums the ranks' lookups (each id is in one
        rank's rows, so the sum is exact)."""
        v = embed.shape[0]
        local = tokens - self.rank * v
        inside = (local >= 0) & (local < v)
        rows = embed[local.clamp(0, v - 1)]
        x = self.leave(torch.where(inside[..., None], rows,
                                   rows.new_zeros(())))
        s = tokens.shape[1]
        if self.sp:
            s //= self.n
            return x + pos[self.rank * s:(self.rank + 1) * s]
        return x + pos[:s]

    def logits(self, x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
        """The rank's vocabulary columns of ``x @ embed.T`` over all S,
        gathered into the whole vocabulary."""
        local = logits_of(self.enter(x), embed)
        return _GatherVocab.apply(local, self.group, self.n, self.rank)


def seq_columns(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's S / n columns of a (B, S, ...) tensor in a sequence
    mode: rank r of "model" holds columns [r S / n, (r+1) S / n)."""
    n, rank = axis_size(mesh, "model"), mesh.get_local_rank("model")
    s = t.shape[1] // n
    return t[:, rank * s:(rank + 1) * s]


class _SeqSpmd(_Hooks):
    """The SPMD region of a sequence mode: every parameter replicated, the
    residual stream the rank's S / n rows from the embedding on, so
    ``enter`` and ``leave`` are identities and the only collectives are
    attention's (ring hops, or Ulysses' all-to-alls, over "model") and the
    loss's. The logits are the rank's rows over the whole vocabulary.

    A MoE layer (:meth:`moe`) routes the rank's columns with the whole
    row's capacity and queue places (:meth:`_columns`); its router
    statistics are averaged over "model" and the batch ranks. The loss
    takes 1 / n of each rank's aux term, the same on every rank, and the
    train step sums the gradients over "model": the aux term comes out
    once."""

    def __init__(self, cfg: TransformerConfig, mesh: DeviceMesh,
                 seq: int) -> None:
        check_mesh(cfg, mesh, seq)
        self.mesh, self.seq = mesh, seq
        self.group = mesh.get_group("model")
        self.n, self.rank = axis_size(mesh, "model"), \
            mesh.get_local_rank("model")
        self.data, self.dp, _ = axes_group(mesh, _batch_axes(mesh))
        self.attend = SEQUENCE_MODES[cfg.attention](mesh, "model",
                                                    causal=True)

    def batch_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over every token of the global batch: over "model"
        (the rows' columns), then over the batch ranks."""
        t = _MeanOver.apply(t, self.group, self.n)
        return _MeanOver.apply(t, self.data, self.dp)

    def _columns(self, counts: torch.Tensor) -> tuple:
        """This rank's per-row expert counts (B, E) -> the counts of the
        same rows on the lower "model" ranks, and the rows' whole S."""
        every = _gather(counts[None], self.group, self.n, 0)   # (n, B, E)
        return every[:self.rank].sum(0), self.seq

    def moe(self, params: dict, h: torch.Tensor,
            cfg: TransformerConfig) -> tuple:
        return moe_ffn(params, h, cfg.moe_capacity_factor,
                       mean=self.batch_mean, columns=self._columns)

    def embed(self, embed: torch.Tensor, tokens: torch.Tensor,
              pos: torch.Tensor) -> torch.Tensor:
        """The replicated lookup of the rank's columns, plus their rows
        of ``pos``."""
        cols = seq_columns(tokens, self.mesh)
        s = cols.shape[1]
        return embed[cols] + pos[self.rank * s:(self.rank + 1) * s]


def _region(cfg: TransformerConfig, mesh: DeviceMesh, seq: int) -> _Hooks:
    """The SPMD region of a forward over *mesh* at *seq* tokens."""
    if cfg.attention in SEQUENCE_MODES:
        return _SeqSpmd(cfg, mesh, seq)
    return _Spmd(cfg, mesh, seq)


def make_example_batch(cfg: TransformerConfig, batch: int = 8,
                       seq: int = 0) -> dict:
    """The JAX ``make_example_batch``: ``np.random.default_rng(0)`` tokens
    (batch, seq + 1), split into inputs and next-token targets, as int64
    CPU tensors (the same tokens as the JAX batch)."""
    seq = seq or cfg.max_seq
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (batch, seq + 1), dtype=np.int32)
    return {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int64)),
            "targets": torch.from_numpy(toks[:, 1:].astype(np.int64))}
