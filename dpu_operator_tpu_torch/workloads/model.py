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
prefills share. The sharded and long-context modes are not ported yet.

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
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..ops import flash_attention_vjp, fused_rmsnorm
from .moe import init_moe_params, moe_ffn

_UNPORTED = {
    "ring": "ROADMAP queue 1, item 7: distributed modes",
    "ulysses": "ROADMAP queue 1, item 7: distributed modes",
}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 8
    n_layers: int = 2
    d_ff: int = 512
    max_seq: int = 128
    dtype: torch.dtype = torch.bfloat16
    #: "standard" and "flash" both run the port's attention kernels
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
    if cfg.attention in _UNPORTED:
        raise NotImplementedError(f"attention={cfg.attention!r} is not "
                                  f"ported yet ({_UNPORTED[cfg.attention]})")
    if cfg.attention not in ("standard", "flash"):
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
    """(B, S, 3D) -> q, k, v views of (B, S, H, Dh), no copy."""
    return tuple(t.unflatten(-1, (cfg.n_heads, cfg.d_head))
                 for t in qkv.split(cfg.d_model, dim=-1))


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


def layer(x: torch.Tensor, lp: dict, cfg: TransformerConfig,
          attend: Callable[..., torch.Tensor]) -> tuple:
    """One pre-norm block on x (B, S, D): ``(x, aux)``, aux the MoE
    layer's load-balancing loss (None for a dense layer). *attend(q, k,
    v)* maps the layer's (B, S, H, Dh) projections to the attention
    output: over the same tokens in :func:`forward`, over the KV cache in
    decode. Each product with a projection is :func:`_mm`'s: ``@``, or
    W8A8 for an int8 leaf. A MoE layer routes each of the B rows on its
    own (``moe_ffn``), so a decode step's slots and a chunk's padded width
    route as the JAX serving functions do."""
    h = fused_rmsnorm(x, lp["ln1"])
    o = attend(*split_heads(_mm(h, lp["wqkv"]), cfg))
    x = x + _mm(o.flatten(2), lp["wo"])
    h = fused_rmsnorm(x, lp["ln2"])
    if "moe" in lp:
        out, aux = moe_ffn(lp["moe"], h, cfg.moe_capacity_factor)
        return x + out, aux
    return x + mlp(h, lp), None


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            return_aux: bool = False) -> "torch.Tensor | tuple":
    """Logits (B, S, V) fp32 for next-token prediction; tokens (B, S).
    With *return_aux* also the sum of the MoE layers' load-balancing
    losses (an fp32 scalar, 0 for a dense model), as the JAX ``forward``.
    Differentiable in every parameter; with ``cfg.remat`` each layer is
    recomputed on the backward pass."""
    _check_supported(cfg)
    s = tokens.shape[1]
    tokens = tokens.to(params["embed"].device)
    # the position embedding is added before the cast, as in the JAX model
    x = (params["embed"][tokens] + params["pos"][:s]).to(cfg.dtype)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params["layers"]:
        if cfg.remat and torch.is_grad_enabled():
            x, aux = checkpoint(layer, x, lp, cfg, flash_attention_vjp,
                                use_reentrant=False)
        else:
            x, aux = layer(x, lp, cfg, flash_attention_vjp)  # causal
        if aux is not None:
            aux_total = aux_total + aux
    x = fused_rmsnorm(x, params["out_norm"])
    logits = logits_of(x, params["embed"])
    return (logits, aux_total) if return_aux else logits


def loss_fn(params: dict, batch: dict, cfg: TransformerConfig
            ) -> torch.Tensor:
    """Mean next-token negative log-likelihood of the fp32 logits plus
    ``cfg.moe_aux_weight`` times the MoE load-balancing loss (JAX
    ``loss_fn``): batch holds ``tokens`` and ``targets`` (B, S)."""
    logits, aux = forward(params, batch["tokens"], cfg, return_aux=True)
    targets = batch["targets"].to(logits.device).long()
    nll = F.cross_entropy(logits.flatten(0, 1), targets.flatten())
    return nll + cfg.moe_aux_weight * aux


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
