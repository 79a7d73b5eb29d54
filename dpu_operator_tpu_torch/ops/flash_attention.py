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
:func:`_dkv_route`): bf16 takes the tensor-core (``wgmma``) forward, dQ and
dK/dV kernels, in query or key tiles of :func:`_tile_rows`; fp32 takes the
3xTF32 tensor-core forward (TF32 ``wgmma``), dQ and dK/dV (``mma.sync``),
each operand split into a TF32 high and low part (fp32's limits, which one
TF32 product would miss); one query row without the lse takes the decode
kernels, which split each row's keys into chunks of
``DECODE_CHUNK`` across blocks and fold the chunks' partials in chunk order
(:func:`_decode_chunks`; :func:`attention_decode_plain` is the same split in
plain PyTorch). A launch that fails raises: no route falls back to another.

Head dims: the kernels are compiled at 32, 64, 128 and 256 (the bf16
tensor-core kernels at 64, 128 and 256). Every head dim from 1 to 256 runs:
a route takes the smallest of its head dims at or above D
(:func:`_padded_dim`), the wrapper zero-pads the last dim of its inputs to
it, launches there and slices the outputs back to D. Zero columns add exact
zeros to every q . k and P . v, so the lse, delta and the first D columns
are unchanged (the padded columns of dQ, dK and dV are zero); the scale
stays ``1 / sqrt(D)`` of the true D. A padded cache view is copied on every
call. A head dim above 256 raises. At 256 some kernels hold a smaller tile
than at 128 (:func:`_capped_tile`): the fp32 forward takes a design of its
own (``attn_fwd_tf32_wide_kernel``), and the bf16 and fp32 dK/dV kernels
split each key tile's columns between two warpgroups or warps.

The int8 KV cache (KV8): :func:`attention_fwd_kv8` attends q over int8
K / V with one fp32 scale per (key, head), the cache of
``dpu_operator_tpu/workloads/decode.py`` ``init_kv_cache(kv_int8=True)``,
whose attention (the ``"k_q"`` branches of ``_verify_one`` and
``prefill_chunk``) is XLA there; ``csrc/attention_kv8.cu`` holds its
kernels. Up to ``KV8_ROWS_MAX`` query rows (decode, verify) take one
launch over a thread-block cluster a (head, batch), whose blocks split the
keys in chunks of ``DECODE_CHUNK`` and share each row's softmax statistics
through distributed shared memory; more rows take the tensor cores: in bf16
on ``wgmma`` at head dim 64 / 128 / 256 (int8 tiles converted to bf16 in
shared memory; a head dim of 32 or less padded to 64), in fp32 on
``mma.sync`` with q and P split into TF32 high and low parts against the
int8 K and V, which TF32 holds exactly (:func:`_kv8_route`). Every route takes
two passes over the keys, so that P * v_s is rounded to the input type with
P the row's normalized softmax, where the reference rounds it. Its plain
version is :func:`attention_kv8_plain`. No bf16 copy of the cache is made.

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
#: head dims the kernels are compiled at; a route pads D up to the next
_HEAD_DIMS = (32, 64, 128, 256)
#: head dims the bf16 tensor-core kernels take
_TC_HEAD_DIMS = (64, 128, 256)
#: the largest tile (query rows a block; keys a block for dK/dV) of the
#: kernels that hold less at head dim 256 than :func:`_tile_rows` gives:
#: the bf16 forward and the KV8 tensor-core kernel (one warpgroup: its O
#: takes 128 registers a thread), the bf16 dQ (its Q, dO and two K / V
#: stages take 192 KB for one warpgroup), the bf16 dK/dV (two warpgroups
#: split one 64-key tile's columns) and the 3xTF32 dK/dV (32-key blocks: 64
#: would take 266 KB)
_TILE_CAP_256 = {"fwd_tc": 64, "kv8_tc": 64, "dq_tc": 64, "dkv_tc": 64,
                 "dkv_tf32": 32}
#: route codes of the C entry points (one query row takes its own entry
#: point, ``attention_decode``): ``tc`` the bf16 tensor-core kernels,
#: ``tf32`` the fp32 3xTF32 kernels
_ROUTE_CODES = {"tc": 2, "tf32": 3}
#: keys per chunk of the decode kernels' split (the kernel's kDecChunk)
DECODE_CHUNK = 128
#: the most query rows a KV8 call takes on the cluster kernel (decode and
#: verify; the kernel's kRowsMax)
KV8_ROWS_MAX = 8
#: route codes of the C entry point ``attention_kv8``
_KV8_ROUTE_CODES = {"rows": 1, "tc": 2, "tf32": 3}


def _padded_dim(route: str, d: int) -> int:
    """D', the head dim a launch of *route* runs at: the smallest head dim
    its kernels are compiled at that is >= *d* (the bf16 tensor-core
    routes: 64, 128 or 256; every other route: 32, 64, 128 or 256). Above
    256 no kernel is compiled: ValueError."""
    dims = _TC_HEAD_DIMS if route == "tc" else _HEAD_DIMS
    if d < 1 or d > dims[-1]:
        raise ValueError(f"head dim {d}: the CUDA kernels take head dims 1 "
                         f"to {dims[-1]}")
    return next(x for x in dims if x >= d)


def _attn_route(dtype: torch.dtype, d: int, sq: int, with_lse: bool) -> str:
    """The forward kernel a CUDA launch takes: ``"decode"`` for one query
    row without the lse, ``"tc"`` (the bf16 tensor-core kernel) for bf16,
    ``"tf32"`` (the fp32 3xTF32 kernel) for fp32. The head dim *d* is
    padded to :func:`_padded_dim` of the route."""
    if sq == 1 and not with_lse:
        return "decode"
    return "tc" if dtype == torch.bfloat16 else "tf32"


def _kv8_route(dtype: torch.dtype, d: int, sq: int) -> str:
    """The KV8 kernel a CUDA launch takes: ``"rows"`` (the cluster kernel)
    for 1 to ``KV8_ROWS_MAX`` query rows; for more rows ``"tc"`` (the bf16
    tensor-core kernel, at a padded head dim of 64, 128 or 256) in bf16 and
    ``"tf32"`` (the fp32 kernel on the tensor cores, 32 to 256) in
    fp32."""
    if sq <= KV8_ROWS_MAX:
        return "rows"
    return "tc" if dtype == torch.bfloat16 else "tf32"


def _dkv_route(dtype: torch.dtype, d: int) -> str:
    """The dK/dV kernel a CUDA launch takes: ``"tc"`` for bf16, ``"tf32"``
    (3xTF32) for fp32."""
    return "tc" if dtype == torch.bfloat16 else "tf32"


def _dq_route(dtype: torch.dtype, d: int) -> str:
    """The dQ kernel a CUDA launch takes: ``"tc"`` for bf16, ``"tf32"``
    (3xTF32) for fp32."""
    return "tc" if dtype == torch.bfloat16 else "tf32"


def _decode_chunks(pos: int, skv: int, causal: bool = True) -> int:
    """Chunks of ``DECODE_CHUNK`` keys, anchored at key 0, that the decode
    row at absolute position *pos* works through over a cache row of *skv*
    keys: its ``min(pos + 1, skv)`` admitted keys (all *skv* when not
    causal). The grid holds ``_decode_chunks(skv - 1, skv)`` blocks a row;
    block ``c`` works iff ``c`` is below the row's count and exits at once
    otherwise."""
    n = min(pos + 1, skv) if causal else skv
    return -(-max(n, 0) // DECODE_CHUNK)


def _tile_rows(b: int, n: int, h: int, sms: int, big: int = 128) -> int:
    """Query rows (forward) or keys (dK/dV) per block of a tensor-core
    kernel: *big* (128 for the bf16 kernels: two consumer warpgroups; 64
    for the 3xTF32 dK/dV kernel: four key groups) unless that grid of
    ``ceil(n / big) * h * b`` blocks has fewer blocks than the card has
    SMs, then half of it (twice the blocks)."""
    return big if -(-n // big) * h * b >= sms else big // 2


def _capped_tile(kernel: str, dp: int, rows: int) -> int:
    """*rows* (a tile of :func:`_tile_rows`), at most the cap
    :data:`_TILE_CAP_256` sets *kernel* at head dim 256 (any other padded
    head dim *dp*: *rows*)."""
    return min(rows, _TILE_CAP_256[kernel]) if dp == 256 else rows


def _fwd_tile_rows(route: str, dp: int, b: int, n: int, h: int,
                   device: torch.device) -> int:
    """Query rows per block of a forward launch at padded head dim *dp*:
    :func:`_tile_rows` for the bf16 kernel (at most 64 at head dim 256); 64
    (one warpgroup, or four warps at head dim 256) for the 3xTF32 kernels,
    whose 224 KB (200 KB at 256) of shared memory take one block an SM
    either way."""
    if route != "tc":
        return 64
    return _capped_tile("fwd_tc", dp, _tile_rows(b, n, h, _sms(device)))


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _positions(q: torch.Tensor, q_pos0: Optional[torch.Tensor]
               ) -> torch.Tensor:
    if q_pos0 is None:
        return torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    return torch.as_tensor(q_pos0, device=q.device).to(torch.int32)


def attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos0: Optional[torch.Tensor] = None,
                        causal: bool = True, return_lse: bool = False,
                        sm_scale: Optional[float] = None):
    """The kernel's function in plain PyTorch, walking key blocks of
    ``BLOCK_K`` as the kernel does. Every block holds exactly BLOCK_K keys
    (a ragged tail is zero-padded and masked) and each dot product is a
    reduction over the contiguous last dimension, so a row's result does
    not depend on the other rows or on keys past its position: chunked
    prefill reproduces whole-prompt prefill bit for bit on the CPU too.

    With *return_lse*, also the per-row logsumexp (B, H, Sq) fp32 in
    natural log, from the walk's own max and sum:
    ``(m + log2(max(l, 1e-20))) / log2(e)``. Scores are scaled by
    *sm_scale* (default ``1 / sqrt(D)`` of q's last dim; a head dim padded
    with zeros passes its true D's)."""
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
    scale2 = _LOG2E * _scale(d, sm_scale)
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


def attention_kv8_plain(q: torch.Tensor, k_q: torch.Tensor,
                        k_s: torch.Tensor, v_q: torch.Tensor,
                        v_s: torch.Tensor,
                        q_pos0: Optional[torch.Tensor] = None,
                        causal: bool = True,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention over the int8 KV cache in plain PyTorch: the JAX function
    of ``decode.py::_verify_one``'s ``"k_q"`` branch (:247-256). q (B, Sq,
    H, D); k_q, v_q (B, Skv, H, D) int8; k_s, v_s (B, Skv, H, 1) fp32. The
    scores are ``(q . k_q) * k_s / sqrt(D)`` in fp32, masked causally at
    the per-row offset (row i of batch b at ``q_pos0[b] + i``, -1e9 as
    there), softmax in fp32, then ``out = sum_j round(P_j * v_s_j) *
    v_q_j`` with the product rounded to q's type (the reference's
    ``att_v``) and the sum rounded once to q's type. Each dot product is a
    reduction over the contiguous last dimension (key blocks of
    ``BLOCK_K``) and the softmax is per row, so a row's result does not
    depend on the other rows of its batch. *sm_scale* replaces ``1 /
    sqrt(D)`` (a head dim padded with zeros passes its true D's)."""
    b, sq, h, d = q.shape
    skv = k_q.shape[1]
    pos = _positions(q, q_pos0).long()
    rows = pos[:, None] + torch.arange(sq, device=q.device)      # (B, Sq)
    qf = q.float().permute(0, 2, 1, 3).unsqueeze(3)             # (B,H,Sq,1,D)
    blocks = [slice(j, j + BLOCK_K) for j in range(0, skv, BLOCK_K)]
    s = torch.cat([(qf * k_q[:, sl].float().permute(0, 2, 1, 3)
                    .unsqueeze(2)).sum(-1) for sl in blocks], -1)
    s = s * k_s[..., 0].float().permute(0, 2, 1)[:, :, None] \
        * _scale(d, sm_scale)                                    # (B,H,Sq,Skv)
    if causal:
        keys = torch.arange(skv, device=q.device)
        ok = keys[None, None, :] <= rows[:, :, None]             # (B, Sq, Skv)
        s = torch.where(ok[:, None], s, -1e9)
    p = torch.softmax(s, -1)
    pv = (p * v_s[..., 0].float().permute(0, 2, 1)[:, :, None]
          ).to(q.dtype).float()
    out = torch.zeros((b, h, sq, d), device=q.device)
    for sl in blocks:
        vt = v_q[:, sl].float().permute(0, 2, 3, 1).unsqueeze(2)  # (B,H,1,D,K)
        out = out + (pv[..., sl].unsqueeze(3) * vt).sum(-1)
    return out.to(q.dtype).permute(0, 2, 1, 3)


def _check_cuda(what: str, *ts: torch.Tensor) -> None:
    q = ts[0]
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: dtype {q.dtype} (fp32 or bf16)")
    if any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"{what}: q, k, v (and dO) must share a dtype")
    if any(t.device != q.device for t in ts):
        raise ValueError(f"{what}: inputs on different devices")


def _pad_dim(dp: int, *ts: torch.Tensor) -> list:
    """Each tensor with its last dim zero-padded to *dp* (a new contiguous
    tensor), or as it is when it already has *dp* columns."""
    return [t if t.shape[-1] == dp
            else torch.nn.functional.pad(t, (0, dp - t.shape[-1]))
            for t in ts]


def _unpad(t: torch.Tensor, d: int) -> torch.Tensor:
    """The first *d* columns of a padded output, contiguous."""
    return t if t.shape[-1] == d else t[..., :d].contiguous()


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

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    of :func:`_attn_route` (one query row: the decode kernels, split over
    keys; more: the tensor cores, bf16 on ``wgmma``, fp32 in 3xTF32) at the
    route's padded head dim, or raises. Returns a new contiguous
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
    route = _attn_route(q.dtype, d, sq, with_lse=False)
    dp = _padded_dim(route, d)
    q, k, v = (t if _aligned(t) else t.contiguous()
               for t in _pad_dim(dp, q, k, v))
    pos = _positions(q, q_pos0).contiguous()
    out = torch.empty((b, sq, h, dp), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return _unpad(out, d)
    lib = _build.library()
    skv = k.shape[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale2 = _LOG2E / math.sqrt(d)          # the true head dim's scale
    if route == "decode":
        # the chunks' partials (m, l, acc[D']) in fp32, (B, H, chunks, D' + 2)
        part = torch.empty((b, h, _decode_chunks(skv - 1, skv), dp + 2),
                           dtype=torch.float32, device=q.device)
        rc = lib.attention_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            pos.data_ptr(), part.data_ptr(), b, skv, h, dp,
            *_strides(q, k, v, out), int(causal), scale2,
            _DTYPE_CODES[q.dtype], DECODE_CHUNK, stream)
    else:
        rc = lib.attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            pos.data_ptr(), b, sq, skv, h, dp, *_strides(q, k, v, out),
            int(causal), scale2, _DTYPE_CODES[q.dtype],
            _ROUTE_CODES[route], _fwd_tile_rows(route, dp, b, sq, h,
                                                q.device),
            stream)
    attention_fwd.launches += 1
    if route == "decode":
        attention_fwd.decode_launches += 1
    elif route == "tc":
        attention_fwd.tc_launches += 1
    _build.check(rc, "attention_fwd")
    return _unpad(out, d)


#: launches of every route, of the decode kernel (Sq == 1) and of the bf16
#: tensor-core kernel alone (the rest: the 3xTF32 kernel)
attention_fwd.launches = 0  # type: ignore[attr-defined]
attention_fwd.decode_launches = 0  # type: ignore[attr-defined]
attention_fwd.tc_launches = 0  # type: ignore[attr-defined]


def attention_fwd_kv8(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor,
                      v_q: torch.Tensor, v_s: torch.Tensor,
                      q_pos0: Optional[torch.Tensor] = None,
                      causal: bool = True) -> torch.Tensor:
    """Attention of q (B, Sq, H, D) over the int8 KV cache: k_q, v_q (B,
    Skv, H, D) int8 with k_s, v_s (B, Skv, H, 1) fp32 scales, row i of
    batch b at absolute position ``q_pos0[b] + i`` (default 0), as
    :func:`attention_fwd`. The function of :func:`attention_kv8_plain`.

    A CPU tensor takes the plain version; a CUDA tensor launches the KV8
    kernel of :func:`_kv8_route` (up to ``KV8_ROWS_MAX`` rows: the cluster
    kernel; more rows: the tensor cores, bf16 on ``wgmma``, fp32 on
    ``mma.sync`` in two TF32 products) at the route's padded head dim, or
    raises. Returns a new contiguous (B, Sq, H, D) tensor in q's type."""
    b, sq, h, d = q.shape
    if (k_q.shape[0] != b or k_q.shape[2:] != (h, d)
            or v_q.shape != k_q.shape
            or k_s.shape != (*k_q.shape[:3], 1) or v_s.shape != k_s.shape):
        raise ValueError(f"attention_fwd_kv8: shapes q {tuple(q.shape)} "
                         f"k_q {tuple(k_q.shape)} k_s {tuple(k_s.shape)} "
                         f"v_q {tuple(v_q.shape)} v_s {tuple(v_s.shape)}")
    if q.device.type == "cpu":
        return attention_kv8_plain(q, k_q, k_s, v_q, v_s, q_pos0, causal)
    if q.device.type != "cuda":
        raise ValueError(f"attention_fwd_kv8: unsupported device {q.device}")
    _check_cuda("attention_fwd_kv8", q)
    if k_q.dtype != torch.int8 or v_q.dtype != torch.int8 \
            or k_s.dtype != torch.float32 or v_s.dtype != torch.float32:
        raise TypeError("attention_fwd_kv8: k_q, v_q must be int8 and k_s, "
                        f"v_s fp32, got {k_q.dtype} {v_q.dtype} "
                        f"{k_s.dtype} {v_s.dtype}")
    if any(t.device != q.device for t in (k_q, k_s, v_q, v_s)):
        raise ValueError("attention_fwd_kv8: inputs on different devices")
    route = _kv8_route(q.dtype, d, sq)
    dp = _padded_dim(route, d)
    # the scales are per (key, head): never padded
    q, k_q, v_q = (t if _aligned(t) else t.contiguous()
                   for t in _pad_dim(dp, q, k_q, v_q))
    pos = _positions(q, q_pos0).contiguous()
    out = torch.empty((b, sq, h, dp), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return _unpad(out, d)
    # the fp32 kernel's blocks are fixed (16 rows); the C entry ignores rows
    rows = 0 if route == "tf32" else \
        _capped_tile("kv8_tc", dp, _tile_rows(b, sq, h, _sms(q.device)))
    rc = _build.library().attention_kv8(
        q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
        v_s.data_ptr(), out.data_ptr(), pos.data_ptr(), b, sq, k_q.shape[1],
        h, dp, *_strides(q, k_q, k_s, v_q, v_s, out), int(causal),
        _LOG2E / math.sqrt(d), _DTYPE_CODES[q.dtype],
        _KV8_ROUTE_CODES[route], DECODE_CHUNK, rows,
        torch.cuda.current_stream(q.device).cuda_stream)
    attention_fwd_kv8.launches += 1
    if route == "rows":
        attention_fwd_kv8.rows_launches += 1
    elif route == "tc":
        attention_fwd_kv8.tc_launches += 1
    _build.check(rc, "attention_fwd_kv8")
    return _unpad(out, d)


#: launches of every KV8 route, of the cluster kernel and of the bf16
#: tensor-core kernel alone (the rest: the fp32 kernel)
attention_fwd_kv8.launches = 0  # type: ignore[attr-defined]
attention_fwd_kv8.rows_launches = 0  # type: ignore[attr-defined]
attention_fwd_kv8.tc_launches = 0  # type: ignore[attr-defined]


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
    included: bf16 on ``wgmma``, fp32 in 3xTF32) at the route's padded head
    dim, or raises."""
    _self_shapes("attention_fwd_lse", q, k, v)
    if _device_of("attention_fwd_lse", q) == "cpu":
        return attention_fwd_plain(q, k, v, None, causal, return_lse=True)
    _check_cuda("attention_fwd_lse", q, k, v)
    b, s, h, d = q.shape
    route = _attn_route(q.dtype, d, s, with_lse=True)
    dp = _padded_dim(route, d)
    q, k, v = (t if _aligned(t) else t.contiguous()
               for t in _pad_dim(dp, q, k, v))
    out = torch.empty((b, s, h, dp), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return _unpad(out, d), lse
    rc = _build.library().attention_fwd_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, s, h, dp, *_strides(q, k, v, out),
        int(causal), _LOG2E / math.sqrt(d), _DTYPE_CODES[q.dtype],
        _ROUTE_CODES[route], _fwd_tile_rows(route, dp, b, s, h, q.device),
        torch.cuda.current_stream(q.device).cuda_stream)
    attention_fwd_lse.launches += 1
    if route == "tc":
        attention_fwd_lse.tc_launches += 1
    _build.check(rc, "attention_fwd_lse")
    return _unpad(out, d), lse


#: launches of both routes, and of the bf16 tensor-core kernel alone (the
#: rest: the 3xTF32 kernel)
attention_fwd_lse.launches = 0  # type: ignore[attr-defined]
attention_fwd_lse.tc_launches = 0  # type: ignore[attr-defined]


def attention_delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in fp32, (B, S, H, D) -> (B, H, S): the
    softmax-normalisation term of the backward (a torch op, as the JAX
    package computes it outside Pallas)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _scale(d: int, sm_scale: Optional[float] = None) -> float:
    """The softmax scale: *sm_scale*, or ``1 / sqrt(d)`` when None."""
    return 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)


def _bwd_scales(d: int, sm_scale: Optional[float] = None) -> tuple:
    sm_scale = _scale(d, sm_scale)
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
                           causal: bool = True,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """dQ in plain PyTorch, walking key blocks of ``BLOCK_K`` as the kernel
    does: P recomputed as ``exp2(s * scale2 - lse * log2 e)`` (0 where
    masked), dS rounded to the input type, dq accumulated in fp32.
    *sm_scale* as :func:`attention_fwd_plain`'s."""
    b, s, h, d = q.shape
    sm_scale, scale2 = _bwd_scales(d, sm_scale)
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
                            causal: bool = True,
                            sm_scale: Optional[float] = None) -> tuple:
    """dK, dV in plain PyTorch, walking query blocks of ``BLOCK_Q`` as the
    kernel does: ``dv += round(P)^T dO`` (P in dO's type) and
    ``dk += round(dS)^T Q``, accumulated in fp32. *sm_scale* as
    :func:`attention_fwd_plain`'s."""
    b, s, h, d = q.shape
    sm_scale, scale2 = _bwd_scales(d, sm_scale)
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


def _bwd_prepare(what: str, route: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                 delta: torch.Tensor) -> tuple:
    """Checks shared by the two backward wrappers; returns the inputs as
    the kernel of *route* takes them (head dim padded to its D')."""
    _check_cuda(what, q, k, v, do)
    b, s, h, d = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, s) or t.dtype != torch.float32 \
                or t.device != q.device:
            raise ValueError(f"{what}: {name} must be (B, H, S) fp32 on "
                             f"q's device, got {tuple(t.shape)} {t.dtype}")
    q, k, v, do = (t if _aligned(t) else t.contiguous()
                   for t in _pad_dim(_padded_dim(route, d), q, k, v, do))
    return q, k, v, do, lse.contiguous(), delta.contiguous()


def attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     do: torch.Tensor, lse: torch.Tensor,
                     delta: torch.Tensor, causal: bool = True
                     ) -> torch.Tensor:
    """dQ (B, S, H, D) in q's type from q, k, v, dO (B, S, H, D), the
    forward's lse and delta (B, H, S) fp32 (JAX ``_bwd_dq_kernel``). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel of
    :func:`_dq_route` (bf16 on ``wgmma``, fp32 in 3xTF32) at the route's
    padded head dim, or raises."""
    _self_shapes("attention_bwd_dq", q, k, v, do)
    if _device_of("attention_bwd_dq", q) == "cpu":
        return attention_bwd_dq_plain(q, k, v, do, lse, delta, causal)
    d = q.shape[3]
    route = _dq_route(q.dtype, d)
    q, k, v, do, lse, delta = _bwd_prepare("attention_bwd_dq", route, q, k,
                                           v, do, lse, delta)
    b, s, h, dp = q.shape
    dq = torch.empty((b, s, h, dp), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return _unpad(dq, d)
    sm_scale, scale2 = _bwd_scales(d)        # the true head dim's scale
    rc = _build.library().attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, s, h, dp,
        *_strides(q, k, v, do, dq), int(causal), scale2, sm_scale,
        _DTYPE_CODES[q.dtype], _ROUTE_CODES[route],
        0 if route == "tf32" else    # the 3xTF32 dQ's blocks are fixed
        _capped_tile("dq_tc", dp, _tile_rows(b, s, h, _sms(q.device))),
        torch.cuda.current_stream(q.device).cuda_stream)
    attention_bwd_dq.launches += 1
    if route == "tc":
        attention_bwd_dq.tc_launches += 1
    _build.check(rc, "attention_bwd_dq")
    return _unpad(dq, d)


#: launches of both routes, and of the bf16 tensor-core kernel alone (the
#: rest: the 3xTF32 kernel)
attention_bwd_dq.launches = 0  # type: ignore[attr-defined]
attention_bwd_dq.tc_launches = 0  # type: ignore[attr-defined]


def attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lse: torch.Tensor,
                      delta: torch.Tensor, causal: bool = True) -> tuple:
    """(dK, dV), each (B, S, H, D) in the input type, from the same inputs
    as :func:`attention_bwd_dq` (JAX ``_bwd_dkv_kernel``). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel of
    :func:`_dkv_route` (bf16 on ``wgmma``, fp32 in 3xTF32) at the route's
    padded head dim, or raises."""
    _self_shapes("attention_bwd_dkv", q, k, v, do)
    if _device_of("attention_bwd_dkv", q) == "cpu":
        return attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal)
    d = q.shape[3]
    route = _dkv_route(q.dtype, d)
    q, k, v, do, lse, delta = _bwd_prepare("attention_bwd_dkv", route, q,
                                           k, v, do, lse, delta)
    b, s, h, dp = q.shape
    dk = torch.empty((b, s, h, dp), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dk.numel() == 0:
        return _unpad(dk, d), _unpad(dv, d)
    sm_scale, scale2 = _bwd_scales(d)        # the true head dim's scale
    rc = _build.library().attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, s, h, dp, *_strides(q, k, v, do, dk), int(causal), scale2,
        sm_scale, _DTYPE_CODES[q.dtype], _ROUTE_CODES[route],
        _capped_tile("dkv_" + route, dp, _tile_rows(
            b, s, h, _sms(q.device), 128 if route == "tc" else 64)),
        torch.cuda.current_stream(q.device).cuda_stream)
    attention_bwd_dkv.launches += 1
    if route == "tc":
        attention_bwd_dkv.tc_launches += 1
    _build.check(rc, "attention_bwd_dkv")
    return _unpad(dk, d), _unpad(dv, d)


#: launches of both routes, and of the bf16 tensor-core kernel alone (the
#: rest: the 3xTF32 kernel)
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
