"""Autoregressive decode with a slotted KV cache: the serving path.

Port of ``dpu_operator_tpu/workloads/decode.py`` for bf16 / fp32 caches:
``init_kv_cache``, ``decode_step``, ``verify_step``, ``prefill``,
``prefill_chunk`` and ``generate``. The cache is one dict per layer with
``k`` and ``v`` of (B, max_seq, H, Dh) in the model's type.

One body, :func:`_hidden`, serves decode (width 1), speculative verify
(width k + 1), chunked prefill (one slot's row, width C) and whole-prompt
prefill (a fresh cache, width P), so they cannot drift apart. Attention runs through the offset attention
kernel over the cache row itself (read through its strides) and every norm
through the fused RMSNorm kernel.

**In place.** Unlike the JAX functions, which donate the cache and return
a new one, these functions write the cache tensors they are given and
return the same list: a caller that needs the old cache afterwards passes
a copy. Rows at or past ``max_seq`` are not written (the JAX scatters drop
them with ``mode="drop"``).

The int8 weight (W8A8) and int8 KV-cache (KV8) paths are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import resolve_device
from ..ops import attention_fwd, fused_rmsnorm
from .model import TransformerConfig, _check_supported, layer, logits_of


def init_kv_cache(cfg: TransformerConfig, batch: int,
                  device: "str | torch.device" = "cuda") -> list:
    """Per-layer ``{"k", "v"}`` of (batch, max_seq, H, Dh), zeros, in
    ``cfg.dtype`` on *device*."""
    dev = resolve_device(device)
    shape = (batch, cfg.max_seq, cfg.n_heads, cfg.d_head)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
            for _ in range(cfg.n_layers)]


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
    return (params["embed"][tokens] + pos_emb).to(cfg.dtype)


def _hidden(params: dict, cfg: TransformerConfig, cache: list,
            tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The body: tokens (B, W) at per-row base positions pos (B,) int32.
    Row (b, i) writes its K/V at ``pos[b] + i`` and attends over the whole
    cache row under a causal-at-offset mask. Returns the final-normed
    hidden state (B, W, D)."""
    rows = pos.long()[:, None] + torch.arange(tokens.shape[1],
                                              device=pos.device)
    x = _embed(params, cfg, tokens, rows)
    for lp, kv in zip(params["layers"], cache):

        def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv: dict = kv) -> torch.Tensor:
            _write_rows(kv["k"], k, rows)
            _write_rows(kv["v"], v, rows)
            return attention_fwd(q, kv["k"], kv["v"], pos, causal=True)

        x = layer(x, lp, cfg, attend)
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
    tokens = tokens.to(params["embed"].device)
    pos = _as_pos(pos, tokens.shape[0], tokens.device)
    x = _hidden(params, cfg, cache, tokens, pos)
    return logits_of(x, params["embed"]), cache


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
            ) -> tuple:
    """Warm a fresh cache with one forward over the whole prompt (B, P),
    the body at position 0: returns (cache, last-position logits (B, V)).
    Causal attention from position 0 visits no key block past the prompt,
    so it costs what attention over the prompt alone costs."""
    _check_supported(cfg)
    dev = params["embed"].device
    prompt = prompt.to(dev)
    b, p = prompt.shape
    if p > cfg.max_seq:
        raise ValueError(f"prompt {p} exceeds max_seq {cfg.max_seq}")
    cache = init_kv_cache(cfg, b, device=dev)
    x = _hidden(params, cfg, cache, prompt,
                torch.zeros(b, dtype=torch.int32, device=dev))
    return cache, logits_of(x[:, -1], params["embed"])


def prefill_chunk(params: dict, cfg: TransformerConfig, cache: list,
                  slot: int, tokens: torch.Tensor, offset: int,
                  n_valid: int) -> tuple:
    """One chunk of a prefill into row *slot* of a slotted cache at
    *offset*: tokens (C,) padded, the first *n_valid* real. Returns
    (cache written in place, logits (V,) of the last valid row). Padding
    rows write K/V above every real position, where the next chunk or
    decode step overwrites them before a causal mask admits them; rows
    past max_seq are not written."""
    _check_supported(cfg)
    c = tokens.shape[0]
    if not 0 < n_valid <= c:
        raise ValueError(f"n_valid {n_valid} outside (0, {c}]")
    row = [{"k": layer["k"][slot:slot + 1], "v": layer["v"][slot:slot + 1]}
           for layer in cache]
    tokens = tokens.to(params["embed"].device)[None]
    pos = torch.full((1,), offset, dtype=torch.int32, device=tokens.device)
    x = _hidden(params, cfg, row, tokens, pos)
    return cache, logits_of(x[0, n_valid - 1], params["embed"])


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
             device: "str | torch.device" = "cuda") -> torch.Tensor:
    """(B, P) prompt -> (B, steps) continuation: prefill, then *steps*
    decode iterations through :func:`decode_step`'s body. temperature 0 is
    greedy; otherwise sampling from logits / temperature, optionally cut to
    the top_k logits, with *generator* (required) as the source of
    randomness. Runs on *device*, where params must live."""
    dev = resolve_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params live on {params['embed'].device}, "
                         f"not {dev}")
    prompt = torch.as_tensor(prompt, device=dev)
    b, p = prompt.shape
    if p + steps > cfg.max_seq:
        raise ValueError(
            f"prompt {p} + steps {steps} exceeds max_seq {cfg.max_seq}")
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) requires a generator")
    cache, logits = prefill(params, cfg, prompt)
    out = []
    for i in range(steps):
        tok = _pick(logits, temperature, top_k, generator)
        out.append(tok)
        if i + 1 < steps:
            logits, cache = _decode_one(params, cfg, cache, tok, p + i)
    return torch.stack(out, 1) if out else prompt.new_zeros((b, 0))
