"""Autoregressive decode with a slotted KV cache: the serving path.

Port of ``dpu_operator_tpu/workloads/decode.py``: ``init_kv_cache``,
``decode_step``, ``verify_step``, ``prefill``, ``prefill_chunk`` and
``generate``, with the int8 weights (W8A8: ``quantize_decode_params``,
``_embed_rows``, ``_logits``; the projections' ``_act_quant`` and ``_mm``
live beside ``model.layer``, which calls them) and the int8 KV
cache (KV8: ``init_kv_cache(kv_int8=True)``, ``_kv_quant``). The cache is
one dict per layer: ``k`` and ``v`` of (B, max_seq, H, Dh) in the model's
type, or with KV8 ``k_q``, ``v_q`` int8 of that shape and ``k_s``, ``v_s``
fp32 of (B, max_seq, H, 1), one scale per (token, head). Every function
takes either cache and either tree, as the JAX ones do.

One body, :func:`_hidden`, serves decode (width 1), speculative verify
(width k + 1), chunked prefill (one slot's row, width C) and whole-prompt
prefill (a fresh cache, width P), so they cannot drift apart. Attention
runs through the offset attention kernel over the cache row itself (read
through its strides), over an int8 cache through the KV8 kernels (no bf16
copy of it is made), and every norm through the fused RMSNorm kernel.
Whole prefill with KV8 attends its fresh K / V in the model's type and
stores them quantized, as the reference does.

MoE layers route each batch row on its own (``moe.moe_ffn``): a decode
step's slot (one token, capacity 8) never drops a token; a verify row
routes its k + 1 tokens, a chunk its whole padded width C (the capacity
comes from C, the padding after the real tokens, as the JAX
``prefill_chunk`` routes), and whole prefill the prompt. So chunked
prefill equals whole prefill only where the capacity covers the chunk,
the caveat the JAX module states for its training forward.

W8A8: each projection and the tied logits take an int8 x int8 -> int32
product (``torch._int_mm``; the JAX package leaves its ``dot_general`` to
XLA, outside any Pallas kernel) of per-token int8 activations against
per-output-channel int8 weights, rescaled in fp32.

**In place.** Unlike the JAX functions, which donate the cache and return
a new one, these functions write the cache tensors they are given and
return the same list: a caller that needs the old cache afterwards passes
a copy. Rows at or past ``max_seq`` are not written (the JAX scatters drop
them with ``mode="drop"``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import resolve_device
from ..ops import attention_fwd, attention_fwd_kv8, fused_rmsnorm
from ..utils import tracing
from .model import (PROJECTIONS, TransformerConfig, _act_quant,
                    _check_supported, _int8_mm, _is_q, int8_weight, layer,
                    logits_of)


# -- int8 weights (W8A8) ------------------------------------------------------

def _quantize_weight(w: torch.Tensor, axis: int = 0) -> dict:
    """Symmetric per-channel int8 (JAX ``_quantize_weight``): the scale
    runs over *axis*, the contraction axis, so dequantization is a
    per-output-column (or per-row) multiply."""
    w32 = w.float()
    scale = torch.clamp(w32.abs().amax(dim=axis, keepdim=True) / 127.0,
                        min=1e-8)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def quantize_decode_params(params: dict) -> dict:
    """The tree of the quantized serving path (JAX
    ``quantize_decode_params``): the embedding (scale per vocab row,
    (V, 1)) and the four projections of every layer (scale (1, N)) become
    ``{"q": int8, "scale": fp32}`` leaves; norms and ``pos`` stay in the
    model's type, and so do a MoE layer's router and experts (``moe``, as
    the JAX tree keeps them: the routed activations are small and
    data-dependent). On the tree's device."""
    out = {"embed": _quantize_weight(params["embed"], axis=1),
           "pos": params["pos"], "out_norm": params["out_norm"],
           "layers": []}
    for lp in params["layers"]:
        ql = {"ln1": lp["ln1"], "ln2": lp["ln2"]}
        for name in PROJECTIONS:
            if name in lp:
                ql[name] = int8_weight(**_quantize_weight(lp[name]))
        if "moe" in lp:
            ql["moe"] = lp["moe"]
        out["layers"].append(ql)
    return out


def params_device(params: dict) -> torch.device:
    """The device a (bf16, fp32 or int8) parameter tree lives on."""
    embed = params["embed"]
    return (embed["q"] if _is_q(embed) else embed).device


def _embed_rows(embed: "torch.Tensor | dict",
                tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows of *tokens*; an int8 embedding's rows dequantized
    in fp32."""
    if not _is_q(embed):
        return embed[tokens]
    return embed["q"][tokens].float() * embed["scale"][tokens]


def _logits(x: torch.Tensor, embed: "torch.Tensor | dict") -> torch.Tensor:
    """x @ embed.T in fp32; an int8 embedding contracts over its d (axis
    1 of q, read through the transposed view) and rescales by the
    per-vocab-row scales, without rounding to x's type."""
    with tracing.profiled("model.logits"):
        if not _is_q(embed):
            return logits_of(x, embed)
        xq, xs = _act_quant(x)
        acc = _int8_mm(xq, embed["q"].t())
        return acc.float() * xs * embed["scale"][:, 0]


# -- the cache ----------------------------------------------------------------

def init_kv_cache(cfg: TransformerConfig, batch: int,
                  device: "str | torch.device" = "cuda",
                  kv_int8: bool = False) -> list:
    """Per-layer ``{"k", "v"}`` of (batch, max_seq, H, Dh), zeros, in
    ``cfg.dtype`` on *device*; with *kv_int8* ``{"k_q", "k_s", "v_q",
    "v_s"}``: int8 of that shape and fp32 scales of (batch, max_seq, H, 1)
    (KV8: 1 + 4 / Dh bytes an element against 2 in bf16)."""
    dev = resolve_device(device)
    shape = (batch, cfg.max_seq, cfg.n_heads, cfg.d_head)
    if kv_int8:
        sshape = (*shape[:3], 1)
        return [{"k_q": torch.zeros(shape, dtype=torch.int8, device=dev),
                 "k_s": torch.zeros(sshape, dtype=torch.float32, device=dev),
                 "v_q": torch.zeros(shape, dtype=torch.int8, device=dev),
                 "v_s": torch.zeros(sshape, dtype=torch.float32, device=dev)}
                for _ in range(cfg.n_layers)]
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
            for _ in range(cfg.n_layers)]


#: K / V of the int8 cache are quantized as the activations are (JAX
#: ``_kv_quant``): one implementation, so the two cannot diverge
_kv_quant = _act_quant


def _write_rows(cache_t: torch.Tensor, new_t: torch.Tensor,
                rows: torch.Tensor) -> None:
    """cache_t[b, rows[b, i]] = new_t[b, i] in place, skipping rows at or
    past max_seq without a host round trip: such a row is sent to position
    ``row - max_seq`` (distinct from every written row of its batch entry
    while the width is at most max_seq) and writes back the value already
    there."""
    b, width = rows.shape
    max_seq = cache_t.shape[1]
    if width > max_seq:
        raise ValueError(f"write width {width} exceeds max_seq {max_seq}")
    b_idx = torch.arange(b, device=rows.device)[:, None].expand(b, width)
    valid = rows < max_seq
    target = torch.where(valid, rows, rows - max_seq)
    value = torch.where(valid[..., None, None], new_t.to(cache_t.dtype),
                        cache_t[b_idx, target])
    cache_t.index_put_((b_idx, target), value)


def _embed(params: dict, cfg: TransformerConfig, tokens: torch.Tensor,
           rows: torch.Tensor) -> torch.Tensor:
    pos_emb = params["pos"][rows.clamp(0, cfg.max_seq - 1)]
    return (_embed_rows(params["embed"], tokens) + pos_emb).to(cfg.dtype)


def _hidden(params: dict, cfg: TransformerConfig, cache: list,
            tokens: torch.Tensor, pos: torch.Tensor,
            fresh: bool = False) -> torch.Tensor:
    """The body: tokens (B, W) at per-row base positions pos (B,) int32.
    Row (b, i) writes its K/V at ``pos[b] + i`` and attends over the whole
    cache row under a causal-at-offset mask; an int8 cache is written
    quantized and attended through the KV8 kernels, except in whole
    prefill (*fresh*: a new cache, pos 0), which attends its K/V in the
    model's type (JAX ``prefill`` :348). Returns the final-normed hidden
    state (B, W, D). Under a running profiler the embedding is a
    ``model.embed`` range and each layer's cache write a
    ``model.cache_write`` range inside its ``model.attention``."""
    with tracing.profiled("model.embed"):
        rows = pos.long()[:, None] + torch.arange(tokens.shape[1],
                                                  device=pos.device)
        x = _embed(params, cfg, tokens, rows)
    for lp, kv in zip(params["layers"], cache):

        def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv: dict = kv) -> torch.Tensor:
            if "k_q" not in kv:
                with tracing.profiled("model.cache_write"):
                    _write_rows(kv["k"], k, rows)
                    _write_rows(kv["v"], v, rows)
                return attention_fwd(q, kv["k"], kv["v"], pos, causal=True)
            with tracing.profiled("model.cache_write"):
                (kq, ks), (vq, vs) = _kv_quant(k), _kv_quant(v)
                for name, t in (("k_q", kq), ("k_s", ks), ("v_q", vq),
                                ("v_s", vs)):
                    _write_rows(kv[name], t, rows)
            if fresh:
                return attention_fwd(q, k, v, None, causal=True)
            return attention_fwd_kv8(q, kv["k_q"], kv["k_s"], kv["v_q"],
                                     kv["v_s"], pos, causal=True)

        x, _ = layer(x, lp, cfg, attend)
    return fused_rmsnorm(x, params["out_norm"])


def _as_pos(pos: "int | torch.Tensor", batch: int,
            device: torch.device) -> torch.Tensor:
    p = torch.as_tensor(pos, dtype=torch.int32, device=device)
    return p.expand(batch).contiguous() if p.ndim == 0 else p


def _verify_one(params: dict, cfg: TransformerConfig, cache: list,
                tokens: torch.Tensor, pos: "int | torch.Tensor") -> tuple:
    """tokens (B, K1) from per-row base positions pos (B,) -> (logits
    (B, K1, V) fp32, cache): ``logits[b, i]`` is what sequential decode
    steps would have produced at position ``pos[b] + i``."""
    _check_supported(cfg)
    tokens = tokens.to(params_device(params))
    pos = _as_pos(pos, tokens.shape[0], tokens.device)
    x = _hidden(params, cfg, cache, tokens, pos)
    return _logits(x, params["embed"]), cache


def _decode_one(params: dict, cfg: TransformerConfig, cache: list,
                tokens: torch.Tensor, pos: "int | torch.Tensor") -> tuple:
    """Decode IS verify at width 1: one body for the generate loop, the
    serve decode step and speculative verify."""
    logits, cache = _verify_one(params, cfg, cache, tokens[:, None], pos)
    return logits[:, 0], cache


def decode_step(params: dict, cfg: TransformerConfig, cache: list,
                tokens: torch.Tensor, pos: "int | torch.Tensor") -> tuple:
    """One decode iteration: tokens (B,) at pos (a scalar, or (B,)
    per-slot positions) -> (logits (B, V), cache written in place)."""
    return _decode_one(params, cfg, cache, tokens, pos)


def verify_step(params: dict, cfg: TransformerConfig, cache: list,
                tokens: torch.Tensor, pos: "int | torch.Tensor") -> tuple:
    """Speculative verify: tokens (B, K1) = ``[last committed, drafts..]``
    with the committed token's K/V landing at pos (B,) -> (logits
    (B, K1, V), cache written in place)."""
    return _verify_one(params, cfg, cache, tokens, pos)


def prefill(params: dict, cfg: TransformerConfig, prompt: torch.Tensor,
            kv_int8: bool = False) -> tuple:
    """Warm a fresh cache with one forward over the whole prompt (B, P),
    the body at position 0: returns (cache, last-position logits (B, V)).
    Causal attention from position 0 visits no key block past the prompt,
    so it costs what attention over the prompt alone costs. With *kv_int8*
    the cache is stored quantized; the prompt attends its K/V in the
    model's type."""
    _check_supported(cfg)
    dev = params_device(params)
    prompt = prompt.to(dev)
    b, p = prompt.shape
    if p > cfg.max_seq:
        raise ValueError(f"prompt {p} exceeds max_seq {cfg.max_seq}")
    cache = init_kv_cache(cfg, b, device=dev, kv_int8=kv_int8)
    x = _hidden(params, cfg, cache, prompt,
                torch.zeros(b, dtype=torch.int32, device=dev), fresh=True)
    return cache, _logits(x[:, -1], params["embed"])


def prefill_chunk(params: dict, cfg: TransformerConfig, cache: list,
                  slot: int, tokens: torch.Tensor, offset: int,
                  n_valid: int) -> tuple:
    """One chunk of a prefill into row *slot* of a slotted cache at
    *offset*: tokens (C,) padded, the first *n_valid* real. Returns
    (cache written in place, logits (V,) of the last valid row). Padding
    rows write K/V above every real position, where the next chunk or
    decode step overwrites them before a causal mask admits them; rows
    past max_seq are not written. An int8 cache is written quantized and
    the chunk attends it through the KV8 kernels, as decode does."""
    _check_supported(cfg)
    c = tokens.shape[0]
    if not 0 < n_valid <= c:
        raise ValueError(f"n_valid {n_valid} outside (0, {c}]")
    row = [{name: t[slot:slot + 1] for name, t in layer.items()}
           for layer in cache]
    tokens = tokens.to(params_device(params))[None]
    pos = torch.full((1,), offset, dtype=torch.int32, device=tokens.device)
    x = _hidden(params, cfg, row, tokens, pos)
    return cache, _logits(x[0, n_valid - 1], params["embed"])


def _pick(logits: torch.Tensor, temperature: float, top_k: int,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    if temperature <= 0.0:
        return logits.argmax(-1)
    scaled = logits / temperature
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled >= kth, scaled, float("-inf"))
    probs = torch.softmax(scaled, -1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate(params: dict, cfg: TransformerConfig, prompt: torch.Tensor,
             steps: int, temperature: float = 0.0, top_k: int = 0,
             generator: Optional[torch.Generator] = None,
             device: "str | torch.device" = "cuda",
             kv_int8: bool = False) -> torch.Tensor:
    """(B, P) prompt -> (B, steps) continuation: prefill, then *steps*
    decode iterations through :func:`decode_step`'s body. temperature 0 is
    greedy; otherwise sampling from logits / temperature, optionally cut to
    the top_k logits, with *generator* (required) as the source of
    randomness. *kv_int8* keeps the cache in int8 (KV8). Runs on *device*,
    where params (bf16, fp32 or int8) must live."""
    dev = resolve_device(device)
    if params_device(params).type != dev.type:
        raise ValueError(f"params live on {params_device(params)}, "
                         f"not {dev}")
    prompt = torch.as_tensor(prompt, device=dev)
    b, p = prompt.shape
    if p + steps > cfg.max_seq:
        raise ValueError(
            f"prompt {p} + steps {steps} exceeds max_seq {cfg.max_seq}")
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) requires a generator")
    cache, logits = prefill(params, cfg, prompt, kv_int8=kv_int8)
    out = []
    for i in range(steps):
        tok = _pick(logits, temperature, top_k, generator)
        out.append(tok)
        if i + 1 < steps:
            logits, cache = _decode_one(params, cfg, cache, tok, p + i)
    return torch.stack(out, 1) if out else prompt.new_zeros((b, 0))
