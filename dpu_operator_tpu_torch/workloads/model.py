"""Decoder-only transformer of the port: config, parameters, forward.

Port of ``dpu_operator_tpu/workloads/model.py`` (``TransformerConfig``,
``init_params``, ``forward``) and of ``perf.flagship_config``. The layer:
pre-norm attention and a tanh-GELU MLP, learned position embeddings, tied
output embedding, logits in fp32. Every norm is the fused RMSNorm kernel
and every attention the offset attention kernel (``ops/``), so
``attention="standard"`` and ``"flash"`` run the same kernel: they compute
the same function. The sharded and long-context modes and MoE layers are
not ported yet.

Parameters are a plain dict shaped like the JAX tree: ``embed (V, D)``,
``pos (max_seq, D)``, ``out_norm (D,)`` and ``layers``, a list of dicts
with ``ln1, wqkv (D, 3D), wo (D, D), ln2, w1 (D, F), w2 (F, D)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops import attention_fwd, fused_rmsnorm

_UNPORTED = {
    "ring": "ROADMAP queue 1, item 8: distributed modes",
    "ulysses": "ROADMAP queue 1, item 8: distributed modes",
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
    #: "standard" and "flash" both run the port's attention kernel
    attention: str = "standard"
    moe_experts: int = 0

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
    if cfg.moe_experts:
        raise NotImplementedError("MoE layers are not ported yet "
                                  "(ROADMAP queue 1, item 7: MoE)")


def _to_tensor(a: Any, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    arr = np.array(a, copy=True, order="C")  # owned and writable
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype)


def params_from_numpy(tree: dict, cfg: TransformerConfig,
                      device: "str | torch.device" = "cuda") -> dict:
    """The port's parameters from a JAX ``init_params`` tree whose leaves
    were converted with ``np.asarray``: same values, ``cfg.dtype``, on
    *device*."""
    _check_supported(cfg)
    dev = resolve_device(device)

    def conv(a: Any) -> torch.Tensor:
        return _to_tensor(a, cfg.dtype, dev)

    return {
        "embed": conv(tree["embed"]),
        "pos": conv(tree["pos"]),
        "out_norm": conv(tree["out_norm"]),
        "layers": [{name: conv(lp[name]) for name in
                    ("ln1", "wqkv", "wo", "ln2", "w1", "w2")}
                   for lp in tree["layers"]],
    }


def init_params(seed: int, cfg: TransformerConfig,
                device: "str | torch.device" = "cuda") -> dict:
    """Random parameters from *seed*, drawn on *device* with a
    ``torch.Generator``: dense weights N(0, 1) / sqrt(fan_in) as in the JAX
    ``init_params`` (other numbers: torch's generator is not JAX's), norm
    scales 1."""
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
    for _ in range(cfg.n_layers):
        params["layers"].append({"ln1": ones(), "wqkv": dense((d, 3 * d)),
                                 "wo": dense((d, d)), "ln2": ones(),
                                 "w1": dense((d, f)), "w2": dense((f, d))})
    return params


def param_bytes(params: dict) -> int:
    """Bytes of every parameter tensor."""
    total = 0
    for name, t in params.items():
        if name == "layers":
            total += sum(x.numel() * x.element_size()
                         for lp in t for x in lp.values())
        else:
            total += t.numel() * t.element_size()
    return total


def split_heads(qkv: torch.Tensor, cfg: TransformerConfig) -> tuple:
    """(B, S, 3D) -> q, k, v views of (B, S, H, Dh), no copy."""
    return tuple(t.unflatten(-1, (cfg.n_heads, cfg.d_head))
                 for t in qkv.split(cfg.d_model, dim=-1))


def mlp(h: torch.Tensor, lp: dict) -> torch.Tensor:
    """tanh-GELU MLP (``jax.nn.gelu`` defaults to the tanh form)."""
    return F.gelu(h @ lp["w1"], approximate="tanh") @ lp["w2"]


def logits_of(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Tied output projection, computed in the weights' type and returned
    in fp32 (``(x @ embed.T).astype(float32)`` in the JAX model)."""
    return (x @ embed.T).float()


def layer(x: torch.Tensor, lp: dict, cfg: TransformerConfig,
          attend: Callable[..., torch.Tensor]) -> torch.Tensor:
    """One pre-norm block on x (B, S, D). *attend(q, k, v)* maps the
    layer's (B, S, H, Dh) projections to the attention output: over the
    same tokens in :func:`forward`, over the KV cache in decode."""
    h = fused_rmsnorm(x, lp["ln1"])
    o = attend(*split_heads(h @ lp["wqkv"], cfg))
    x = x + o.flatten(2) @ lp["wo"]
    return x + mlp(fused_rmsnorm(x, lp["ln2"]), lp)


def forward(params: dict, tokens: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """Logits (B, S, V) fp32 for next-token prediction; tokens (B, S)."""
    _check_supported(cfg)
    b, s = tokens.shape
    tokens = tokens.to(params["embed"].device)
    # the position embedding is added before the cast, as in the JAX model
    x = (params["embed"][tokens] + params["pos"][:s]).to(cfg.dtype)
    zeros = torch.zeros(b, dtype=torch.int32, device=x.device)

    def attend(q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
        return attention_fwd(q, k, v, zeros, causal=True)

    for lp in params["layers"]:
        x = layer(x, lp, cfg, attend)
    x = fused_rmsnorm(x, params["out_norm"])
    return logits_of(x, params["embed"])
