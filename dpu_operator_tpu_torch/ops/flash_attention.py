"""Flash attention: hand-written CUDA kernels and their plain PyTorch
versions, forward with a per-row query offset and the training backward.

Port of ``dpu_operator_tpu/ops/flash_attention.py``: ``flash_attention``
and its Pallas ``_kernel`` (with the diagonal-only masking of
``hack/flash_lab2.py::_kernel_v2``) in ``csrc/flash_attention_fwd.cu``;
the custom VJP ``flash_attention_vjp`` with ``_fwd_with_lse``,
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` in the same forward kernel
(which then also writes the logsumexp) and ``csrc/flash_attention_bwd.cu``.

:func:`attention_fwd` takes ``q (B, Sq, H, D)``, ``k, v (B, Skv, H, D)``
and ``q_pos0 (B,)``: row i of batch b sits at absolute position
``q_pos0[b] + i`` and, when causal, admits key j iff ``j <= q_pos0[b] + i``.
With ``q_pos0 = 0`` and ``Skv = Sq`` this is :func:`flash_attention`; with
a slot's cache row as k / v it is the attention of decode, verify and
chunked prefill. K and V are read through their strides, so a view of the
slotted cache is passed as it is.

Numerics as the TPU kernel: scores scaled into the exp2 domain, online
softmax with fp32 max / sum / accumulator over key blocks of 64 anchored
at key 0, P rounded to the input type before the PV product, and
``out = acc / max(l, 1e-20)``.

Kernels by route (:func:`_attn_route`, :func:`_dq_route`,
:func:`_dkv_route`): bf16 at head dim 64 or 128 takes the tensor-core
(``wgmma``) forward, dQ and dK/dV kernels, in query or key tiles of
:func:`_tile_rows`; fp32 and head dim 32 take the CUDA-core kernels
(``wgmma`` has no fp32 operand, and TF32 would not hold fp32's limits); one
query row without the lse takes the decode kernels, which split each row's
keys into chunks of ``DECODE_CHUNK`` across blocks and fold the chunks'
partials in chunk order (:func:`_decode_chunks`;
:func:`attention_decode_plain` is the same split in plain PyTorch). A
launch that fails raises: no route falls back to another.

Training: :func:`flash_attention_vjp` (a :class:`FlashAttentionFn`) saves
the per-row logsumexp of :func:`attention_fwd_lse`; its backward computes
``delta = rowsum(dO * O)`` with a torch op (as the JAX package does, outside
Pallas), then :func:`attention_bwd_dq` and :func:`attention_bwd_dkv`, which
recompute P from the logsumexp. The Function is the same on the CPU and on
the card: only the inner calls change, plain versions for CPU tensors and
kernels for CUDA tensors.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

_NEG_INF = -1e30
_LOG2E = math.log2(math.e)
BLOCK_K = 64
#: query rows per block of the dK/dV walk (the kernel's query tile)
BLOCK_Q = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
#: head dims the tensor-core kernels take (bf16 only)
_TC_HEAD_DIMS = (64, 128)
#: route codes of the C entry points (one query row takes its own entry
#: point, ``attention_decode``)
_ROUTE_CODES = {"simt": 0, "tc": 2}
#: keys per chunk of the decode kernels' split (the kernel's kDecChunk)
DECODE_CHUNK = 128


def _attn_route(dtype: torch.dtype, d: int, sq: int, with_lse: bool) -> str:
    """The forward kernel a CUDA launch takes: ``"decode"`` for one query
    row without the lse, ``"tc"`` (tensor cores) for bf16 at head dim 64 or
    128, ``"simt"`` (the tiled CUDA-core kernel) otherwise."""
    if sq == 1 and not with_lse:
        return "decode"
    if dtype == torch.bfloat16 and d in _TC_HEAD_DIMS:
        return "tc"
    return "simt"


def _dkv_route(dtype: torch.dtype, d: int) -> str:
    """The dK/dV kernel a CUDA launch takes: ``"tc"`` for bf16 at head
    dim 64 or 128, ``"simt"`` otherwise."""
    return "tc" if dtype == torch.bfloat16 and d in _TC_HEAD_DIMS else "simt"


#: the dQ kernel a CUDA launch takes: the same rule as dK/dV's
_dq_route = _dkv_route


def _decode_chunks(pos: int, skv: int, causal: bool = True) -> int:
    """Chunks of ``DECODE_CHUNK`` keys, anchored at key 0, that the decode
    row at absolute position *pos* works through over a cache row of *skv*
    keys: its ``min(pos + 1, skv)`` admitted keys (all *skv* when not
    causal). The grid holds ``_decode_chunks(skv - 1, skv)`` blocks a row;
    block ``c`` works iff ``c`` is below the row's count and exits at once
    otherwise."""
    n = min(pos + 1, skv) if causal else skv
    return -(-max(n, 0) // DECODE_CHUNK)


def _tile_rows(b: int, n: int, h: int, sms: int) -> int:
    """Query rows (forward) or keys (dK/dV) per block of a tensor-core
    kernel: 128 (two consumer warpgroups) unless that grid of
    ``ceil(n / 128) * h * b`` blocks has fewer blocks than the card has
    SMs, then 64 (one warpgroup, twice the blocks)."""
    return 128 if -(-n // 128) * h * b >= sms else 64


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _positions(q: torch.Tensor, q_pos0: Optional[torch.Tensor]
               ) -> torch.Tensor:
    if q_pos0 is None:
        return torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    return torch.as_tensor(q_pos0, device=q.device).to(torch.int32)


def attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos0: Optional[torch.Tensor] = None,
                        causal: bool = True, return_lse: bool = False):
    """The kernel's function in plain PyTorch, walking key blocks of
    ``BLOCK_K`` as the kernel does. Every block holds exactly BLOCK_K keys
    (a ragged tail is zero-padded and masked) and each dot product is a
    reduction over the contiguous last dimension, so a row's result does
    not depend on the other rows or on keys past its position: chunked
    prefill reproduces whole-prompt prefill bit for bit on the CPU too.

    With *return_lse*, also the per-row logsumexp (B, H, Sq) fp32 in
    natural log, from the walk's own max and sum:
    ``(m + log2(max(l, 1e-20))) / log2(e)``."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    pos = _positions(q, q_pos0).long()
    rows = pos[:, None] + torch.arange(sq, device=q.device)      # (B, Sq)
    last = skv - 1
    if causal:
        last = min(last, int(rows.max()))
    nkb = last // BLOCK_K + 1
    pad = nkb * BLOCK_K - skv
    if pad > 0:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    scale2 = _LOG2E / math.sqrt(d)
    qf = q.float().permute(0, 2, 1, 3).unsqueeze(3)             # (B,H,Sq,1,D)
    m = torch.full((b, h, sq, 1), _NEG_INF, device=q.device)
    l = torch.zeros((b, h, sq, 1), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    for kb in range(nkb):
        sl = slice(kb * BLOCK_K, (kb + 1) * BLOCK_K)
        kf = k[:, sl].float().permute(0, 2, 1, 3).unsqueeze(2)  # (B,H,1,K,D)
        s = (qf * kf).sum(-1) * scale2                          # (B,H,Sq,K)
        keys = torch.arange(kb * BLOCK_K, (kb + 1) * BLOCK_K,
                            device=q.device)
        ok = (keys < skv)[None, None, :]
        if causal:
            ok = ok & (keys[None, None, :] <= rows[:, :, None])
        s = torch.where(ok[:, None], s, _NEG_INF)
        new_m = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s - new_m)
        corr = torch.exp2(m - new_m)
        l = l * corr + p.sum(-1, keepdim=True)
        pv = p.to(v.dtype).float().unsqueeze(3)                 # (B,H,Sq,1,K)
        vt = v[:, sl].float().permute(0, 2, 3, 1).unsqueeze(2)  # (B,H,1,D,K)
        acc = acc * corr + (pv * vt).sum(-1)
        m = new_m
    denom = torch.clamp(l, min=1e-20)
    out = (acc / denom).to(q.dtype).permute(0, 2, 1, 3)
    if return_lse:
        return out, ((m + torch.log2(denom)) / _LOG2E)[..., 0]
    return out


def attention_decode_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           q_pos0: Optional[torch.Tensor] = None,
                           causal: bool = True) -> torch.Tensor:
    """The decode kernels' split-and-combine in plain PyTorch, for one query
    row: q (B, 1, H, D) over k, v (B, Skv, H, D). Each row's admitted keys
    are cut into chunks of ``DECODE_CHUNK`` anchored at key 0; a chunk's
    softmax is taken against its own max, with P rounded to the input type
    before the PV product; the chunks' (m, l, acc) are then folded in chunk
    order into ``acc / max(l, 1e-20)``. A row's arithmetic involves no other
    row, so its result does not depend on the batch it sits in. The tests
    and ``chip_smoke.py`` hold the kernels' design to it;
    :func:`attention_fwd_plain` stays the kernels' plain version."""
    b, sq, h, d = q.shape
    if sq != 1:
        raise ValueError(f"attention_decode_plain: one query row, got {sq}")
    skv = k.shape[1]
    pos = _positions(q, q_pos0).long()
    n_keys = torch.clamp(pos + 1, max=skv) if causal \
        else torch.full_like(pos, skv)
    nch = _decode_chunks(skv - 1, skv)
    pad = nch * DECODE_CHUNK - skv
    if pad > 0:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    scale2 = _LOG2E / math.sqrt(d)
    qf = q.float()[:, 0, :, None, :]                            # (B,H,1,D)
    parts = []
    for c in range(nch):
        sl = slice(c * DECODE_CHUNK, (c + 1) * DECODE_CHUNK)
        keys = torch.arange(sl.start, sl.stop, device=q.device)
        ok = (keys[None, :] < n_keys[:, None])[:, None]         # (B,1,C)
        s = (qf * k[:, sl].float().permute(0, 2, 1, 3)).sum(-1) * scale2
        s = torch.where(ok, s, _NEG_INF)                        # (B,H,C)
        m = s.amax(-1)
        # a chunk past the row's keys: m = -1e30, l = 0, acc = 0
        p = torch.where(ok, torch.exp2(s - m[..., None]), 0.0)
        pv = p.to(v.dtype).float().unsqueeze(2)                 # (B,H,1,C)
        vt = v[:, sl].float().permute(0, 2, 3, 1)               # (B,H,D,C)
        parts.append((m, p.sum(-1), (pv * vt).sum(-1)))
    m_all = torch.stack([m for m, _, _ in parts]).amax(0)      # (B,H)
    l = torch.zeros_like(m_all)
    acc = torch.zeros((b, h, d), device=q.device)
    for m, lc, ac in parts:
        w = torch.exp2(m - m_all)
        l = l + lc * w
        acc = acc + ac * w[..., None]
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.to(q.dtype)[:, None]


def _check_cuda(what: str, *ts: torch.Tensor) -> None:
    q = ts[0]
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: dtype {q.dtype} (fp32 or bf16)")
    if any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"{what}: q, k, v (and dO) must share a dtype")
    if any(t.device != q.device for t in ts):
        raise ValueError(f"{what}: inputs on different devices")
    if q.shape[3] not in _HEAD_DIMS:
        raise ValueError(f"{what}: head dim {q.shape[3]} not in "
                         f"{_HEAD_DIMS}")


def _aligned(t: torch.Tensor) -> bool:
    """Last dim contiguous, 16-byte aligned base and 16-byte strides: what
    the kernel's vector loads need."""
    e = t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all((t.stride(i) * e) % 16 == 0 for i in range(3)))


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos0: Optional[torch.Tensor] = None,
                  causal: bool = True) -> torch.Tensor:
    """Attention of q (B, Sq, H, D) over k, v (B, Skv, H, D) with row i of
    batch b at absolute position ``q_pos0[b] + i`` (default 0).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel of :func:`_attn_route` (one query row: the decode kernels, split
    over keys; more: the tensor cores in bf16 at head dim 64 / 128, else the
    tiled CUDA-core kernel) or raises. Returns a new contiguous
    (B, Sq, H, D) tensor."""
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[2:] != (h, d) or v.shape != k.shape:
        raise ValueError(f"attention_fwd: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return attention_fwd_plain(q, k, v, q_pos0, causal)
    if q.device.type != "cuda":
        raise ValueError(f"attention_fwd: unsupported device {q.device}")
    _check_cuda("attention_fwd", q, k, v)
    q, k, v = (t if _aligned(t) else t.contiguous() for t in (q, k, v))
    pos = _positions(q, q_pos0).contiguous()
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    route = _attn_route(q.dtype, d, sq, with_lse=False)
    lib = _build.library()
    skv = k.shape[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == "decode":
        # the chunks' partials (m, l, acc[D]) in fp32, (B, H, chunks, D + 2)
        part = torch.empty((b, h, _decode_chunks(skv - 1, skv), d + 2),
                           dtype=torch.float32, device=q.device)
        rc = lib.attention_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            pos.data_ptr(), part.data_ptr(), b, skv, h, d,
            *_strides(q, k, v, out), int(causal), _LOG2E / math.sqrt(d),
            _DTYPE_CODES[q.dtype], DECODE_CHUNK, stream)
    else:
        rc = lib.attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            pos.data_ptr(), b, sq, skv, h, d, *_strides(q, k, v, out),
            int(causal), _LOG2E / math.sqrt(d), _DTYPE_CODES[q.dtype],
            _ROUTE_CODES[route], _tile_rows(b, sq, h, _sms(q.device)),
            stream)
    attention_fwd.launches += 1
    if route == "decode":
        attention_fwd.decode_launches += 1
    elif route == "tc":
        attention_fwd.tc_launches += 1
    _build.check(rc, "attention_fwd")
    return out


#: launches of every route, of the decode kernel (Sq == 1) and of the
#: tensor-core kernel alone
attention_fwd.launches = 0  # type: ignore[attr-defined]
attention_fwd.decode_launches = 0  # type: ignore[attr-defined]
attention_fwd.tc_launches = 0  # type: ignore[attr-defined]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """(B, S, H, D) self-attention: ``attention_fwd`` at offset 0 (the
    signature of the JAX ``flash_attention``, without its TPU block
    arguments: any S is taken)."""
    if k.shape[1] != q.shape[1]:
        raise ValueError("flash_attention: q and k must share S")
    return attention_fwd(q, k, v, None, causal)


# -- training path ------------------------------------------------------------

def _self_shapes(what: str, q: torch.Tensor, *ts: torch.Tensor) -> None:
    if q.dim() != 4 or any(t.shape != q.shape for t in ts):
        raise ValueError(f"{what}: q, k, v (and dO) must share one "
                         f"(B, S, H, D) shape, got "
                         f"{[tuple(t.shape) for t in (q, *ts)]}")


def _device_of(what: str, q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {q.device}")
    return q.device.type


def _strides(*ts: torch.Tensor) -> list:
    return [t.stride(i) for t in ts for i in range(3)]


def attention_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True) -> tuple:
    """Self-attention of q, k, v (B, S, H, D) at offset 0 and the per-row
    logsumexp: ``(out (B, S, H, D), lse (B, H, S) fp32)``, lse in natural
    log (JAX ``_fwd_with_lse``). A CPU tensor takes the plain version; a
    CUDA tensor launches a forward kernel with its lse output (every S, 1
    included: the tensor cores in bf16 at head dim 64 / 128, else the tiled
    CUDA-core kernel) or raises."""
    _self_shapes("attention_fwd_lse", q, k, v)
    if _device_of("attention_fwd_lse", q) == "cpu":
        return attention_fwd_plain(q, k, v, None, causal, return_lse=True)
    _check_cuda("attention_fwd_lse", q, k, v)
    q, k, v = (t if _aligned(t) else t.contiguous() for t in (q, k, v))
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    route = _attn_route(q.dtype, d, s, with_lse=True)
    rc = _build.library().attention_fwd_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, s, h, d, *_strides(q, k, v, out),
        int(causal), _LOG2E / math.sqrt(d), _DTYPE_CODES[q.dtype],
        _ROUTE_CODES[route], _tile_rows(b, s, h, _sms(q.device)),
        torch.cuda.current_stream(q.device).cuda_stream)
    attention_fwd_lse.launches += 1
    if route == "tc":
        attention_fwd_lse.tc_launches += 1
    _build.check(rc, "attention_fwd_lse")
    return out, lse


#: launches of both routes, and of the tensor-core kernel alone
attention_fwd_lse.launches = 0  # type: ignore[attr-defined]
attention_fwd_lse.tc_launches = 0  # type: ignore[attr-defined]


def attention_delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in fp32, (B, S, H, D) -> (B, H, S): the
    softmax-normalisation term of the backward (a torch op, as the JAX
    package computes it outside Pallas)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_scales(d: int) -> tuple:
    sm_scale = 1.0 / math.sqrt(d)
    return sm_scale, sm_scale * _LOG2E


def _ds(p: torch.Tensor, dp: torch.Tensor, delta: torch.Tensor,
        sm_scale: float, dtype: torch.dtype) -> torch.Tensor:
    """dS = P * (dP - delta) * sm_scale, rounded to the input type before
    it enters a product (``_bwd_dq_kernel`` :197, ``_bwd_dkv_kernel``
    :247)."""
    return (p * (dp - delta) * sm_scale).to(dtype).float()


def attention_bwd_dq_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, do: torch.Tensor,
                           lse: torch.Tensor, delta: torch.Tensor,
                           causal: bool = True) -> torch.Tensor:
    """dQ in plain PyTorch, walking key blocks of ``BLOCK_K`` as the kernel
    does: P recomputed as ``exp2(s * scale2 - lse * log2 e)`` (0 where
    masked), dS rounded to the input type, dq accumulated in fp32."""
    b, s, h, d = q.shape
    sm_scale, scale2 = _bwd_scales(d)
    qf, dof = (t.float().transpose(1, 2) for t in (q, do))   # (B, H, S, D)
    lse2 = (lse.float() * _LOG2E)[..., None]                  # (B, H, S, 1)
    dl = delta.float()[..., None]
    rows = torch.arange(s, device=q.device)[:, None]
    dq = torch.zeros((b, h, s, d), device=q.device)
    for j0 in range(0, s, BLOCK_K):
        kb, vb = (t[:, j0:j0 + BLOCK_K].float().transpose(1, 2)
                  for t in (k, v))                            # (B, H, K, D)
        sc = qf @ kb.transpose(-1, -2) * scale2               # (B, H, S, K)
        p = torch.exp2(sc - lse2)
        if causal:
            keys = torch.arange(j0, j0 + kb.shape[2], device=q.device)
            p = torch.where(keys[None, :] <= rows, p, 0.0)
        ds = _ds(p, dof @ vb.transpose(-1, -2), dl, sm_scale, k.dtype)
        dq = dq + ds @ kb
    return dq.to(q.dtype).transpose(1, 2)


def attention_bwd_dkv_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor,
                            causal: bool = True) -> tuple:
    """dK, dV in plain PyTorch, walking query blocks of ``BLOCK_Q`` as the
    kernel does: ``dv += round(P)^T dO`` (P in dO's type) and
    ``dk += round(dS)^T Q``, accumulated in fp32."""
    b, s, h, d = q.shape
    sm_scale, scale2 = _bwd_scales(d)
    kf, vf = (t.float().transpose(1, 2) for t in (k, v))     # (B, H, S, D)
    lse2 = (lse.float() * _LOG2E)[..., None]
    dl = delta.float()[..., None]
    keys = torch.arange(s, device=q.device)[None, :]
    dk = torch.zeros((b, h, s, d), device=q.device)
    dv = torch.zeros((b, h, s, d), device=q.device)
    for i0 in range(0, s, BLOCK_Q):
        qb, dob = (t[:, i0:i0 + BLOCK_Q].float().transpose(1, 2)
                   for t in (q, do))                          # (B, H, Q, D)
        n = qb.shape[2]
        sc = qb @ kf.transpose(-1, -2) * scale2               # (B, H, Q, S)
        p = torch.exp2(sc - lse2[:, :, i0:i0 + n])
        if causal:
            rows = torch.arange(i0, i0 + n, device=q.device)[:, None]
            p = torch.where(keys <= rows, p, 0.0)
        dv = dv + p.to(do.dtype).float().transpose(-1, -2) @ dob
        ds = _ds(p, dob @ vf.transpose(-1, -2), dl[:, :, i0:i0 + n],
                 sm_scale, q.dtype)
        dk = dk + ds.transpose(-1, -2) @ qb
    return dk.to(k.dtype).transpose(1, 2), dv.to(v.dtype).transpose(1, 2)


def _bwd_prepare(what: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                 delta: torch.Tensor) -> tuple:
    """Checks shared by the two backward wrappers; returns the inputs as
    the kernel takes them."""
    _check_cuda(what, q, k, v, do)
    b, s, h, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, s) or t.dtype != torch.float32 \
                or t.device != q.device:
            raise ValueError(f"{what}: {name} must be (B, H, S) fp32 on "
                             f"q's device, got {tuple(t.shape)} {t.dtype}")
    q, k, v, do = (t if _aligned(t) else t.contiguous()
                   for t in (q, k, v, do))
    return q, k, v, do, lse.contiguous(), delta.contiguous()


def attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     do: torch.Tensor, lse: torch.Tensor,
                     delta: torch.Tensor, causal: bool = True
                     ) -> torch.Tensor:
    """dQ (B, S, H, D) in q's type from q, k, v, dO (B, S, H, D), the
    forward's lse and delta (B, H, S) fp32 (JAX ``_bwd_dq_kernel``). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel of
    :func:`_dq_route` (the tensor cores in bf16 at head dim 64 / 128, else
    the CUDA-core kernel) or raises."""
    _self_shapes("attention_bwd_dq", q, k, v, do)
    if _device_of("attention_bwd_dq", q) == "cpu":
        return attention_bwd_dq_plain(q, k, v, do, lse, delta, causal)
    q, k, v, do, lse, delta = _bwd_prepare("attention_bwd_dq", q, k, v, do,
                                           lse, delta)
    b, s, h, d = q.shape
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    sm_scale, scale2 = _bwd_scales(d)
    route = _dq_route(q.dtype, d)
    rc = _build.library().attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, s, h, d,
        *_strides(q, k, v, do, dq), int(causal), scale2, sm_scale,
        _DTYPE_CODES[q.dtype], _ROUTE_CODES[route],
        _tile_rows(b, s, h, _sms(q.device)),
        torch.cuda.current_stream(q.device).cuda_stream)
    attention_bwd_dq.launches += 1
    if route == "tc":
        attention_bwd_dq.tc_launches += 1
    _build.check(rc, "attention_bwd_dq")
    return dq


#: launches of both routes, and of the tensor-core kernel alone
attention_bwd_dq.launches = 0  # type: ignore[attr-defined]
attention_bwd_dq.tc_launches = 0  # type: ignore[attr-defined]


def attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lse: torch.Tensor,
                      delta: torch.Tensor, causal: bool = True) -> tuple:
    """(dK, dV), each (B, S, H, D) in the input type, from the same inputs
    as :func:`attention_bwd_dq` (JAX ``_bwd_dkv_kernel``). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel of
    :func:`_dkv_route` (the tensor cores in bf16 at head dim 64 / 128, else
    the CUDA-core kernel) or raises."""
    _self_shapes("attention_bwd_dkv", q, k, v, do)
    if _device_of("attention_bwd_dkv", q) == "cpu":
        return attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal)
    q, k, v, do, lse, delta = _bwd_prepare("attention_bwd_dkv", q, k, v,
                                           do, lse, delta)
    b, s, h, d = q.shape
    dk = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dk.numel() == 0:
        return dk, dv
    sm_scale, scale2 = _bwd_scales(d)
    route = _dkv_route(q.dtype, d)
    rc = _build.library().attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, s, h, d, *_strides(q, k, v, do, dk), int(causal), scale2,
        sm_scale, _DTYPE_CODES[q.dtype], _ROUTE_CODES[route],
        _tile_rows(b, s, h, _sms(q.device)),
        torch.cuda.current_stream(q.device).cuda_stream)
    attention_bwd_dkv.launches += 1
    if route == "tc":
        attention_bwd_dkv.tc_launches += 1
    _build.check(rc, "attention_bwd_dkv")
    return dk, dv


#: launches of both routes, and of the tensor-core kernel alone
attention_bwd_dkv.launches = 0  # type: ignore[attr-defined]
attention_bwd_dkv.tc_launches = 0  # type: ignore[attr-defined]


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention (JAX ``flash_attention_vjp``'s custom
    VJP): the forward saves q, k, v, out and the logsumexp; the backward
    runs the delta prologue, then dQ, then dK/dV."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor,  # type: ignore[override]
                v: torch.Tensor, causal: bool) -> torch.Tensor:
        out, lse = attention_fwd_lse(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do: torch.Tensor) -> tuple:  # type: ignore[override]
        q, k, v, out, lse = ctx.saved_tensors
        delta = attention_delta(do, out)
        dq = attention_bwd_dq(q, k, v, do, lse, delta, ctx.causal)
        dk, dv = attention_bwd_dkv(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Differentiable (B, S, H, D) self-attention. When autograd records
    (grad enabled and an input requires grad) it runs
    :class:`FlashAttentionFn`; otherwise the primal alone,
    :func:`flash_attention`, as a JAX ``custom_vjp`` does outside a
    gradient."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal)
    return flash_attention(q, k, v, causal)
