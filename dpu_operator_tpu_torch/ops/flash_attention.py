"""Attention forward with a per-row query offset: a hand-written CUDA
kernel and its plain PyTorch version.

Port of the forward kernel of ``dpu_operator_tpu/ops/flash_attention.py``
(``flash_attention`` and its Pallas ``_kernel``), with the diagonal-only
masking of ``hack/flash_lab2.py::_kernel_v2``; the kernel is
``csrc/flash_attention_fwd.cu``.

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
``out = acc / max(l, 1e-20)``. The training forward (with logsumexp) and
the backward kernels are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

_NEG_INF = -1e30
_LOG2E = math.log2(math.e)
BLOCK_K = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def _positions(q: torch.Tensor, q_pos0: Optional[torch.Tensor]
               ) -> torch.Tensor:
    if q_pos0 is None:
        return torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    return torch.as_tensor(q_pos0, device=q.device).to(torch.int32)


def attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos0: Optional[torch.Tensor] = None,
                        causal: bool = True) -> torch.Tensor:
    """The kernel's function in plain PyTorch, walking key blocks of
    ``BLOCK_K`` as the kernel does. Every block holds exactly BLOCK_K keys
    (a ragged tail is zero-padded and masked) and each dot product is a
    reduction over the contiguous last dimension, so a row's result does
    not depend on the other rows or on keys past its position: chunked
    prefill reproduces whole-prompt prefill bit for bit on the CPU too."""
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
    out = acc / torch.clamp(l, min=1e-20)
    return out.to(q.dtype).permute(0, 2, 1, 3)


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"attention_fwd: dtype {q.dtype} (fp32 or bf16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("attention_fwd: q, k, v must share a dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("attention_fwd: q, k, v on different devices")
    if q.shape[3] not in _HEAD_DIMS:
        raise ValueError(f"attention_fwd: head dim {q.shape[3]} not in "
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
    kernel (one query row: the decode launch shape; more: the tiled one)
    or raises. Returns a new contiguous (B, Sq, H, D) tensor."""
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[2:] != (h, d) or v.shape != k.shape:
        raise ValueError(f"attention_fwd: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return attention_fwd_plain(q, k, v, q_pos0, causal)
    if q.device.type != "cuda":
        raise ValueError(f"attention_fwd: unsupported device {q.device}")
    _check_cuda(q, k, v)
    q, k, v = (t if _aligned(t) else t.contiguous() for t in (q, k, v))
    pos = _positions(q, q_pos0).contiguous()
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    rc = lib.attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        pos.data_ptr(), b, sq, k.shape[1], h, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        int(causal), _LOG2E / math.sqrt(d), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    attention_fwd.launches += 1
    if sq == 1:
        attention_fwd.decode_launches += 1
    _build.check(rc, "attention_fwd")
    return out


#: launches of either shape, and of the decode shape (Sq == 1) alone
attention_fwd.launches = 0  # type: ignore[attr-defined]
attention_fwd.decode_launches = 0  # type: ignore[attr-defined]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """(B, S, H, D) self-attention: ``attention_fwd`` at offset 0 (the
    signature of the JAX ``flash_attention``, without its TPU block
    arguments: any S is taken)."""
    if k.shape[1] != q.shape[1]:
        raise ValueError("flash_attention: q and k must share S")
    return attention_fwd(q, k, v, None, causal)
