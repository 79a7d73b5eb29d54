"""Fused RMSNorm: a hand-written CUDA kernel and its plain PyTorch version.

Port of ``dpu_operator_tpu/ops/rmsnorm.py`` (``fused_rmsnorm`` and its
Pallas ``_kernel``); the kernel is ``csrc/rmsnorm.cu``. The function: per
row of x (..., D), the mean of squares in fp32, then
``x * rsqrt(var + eps) * scale`` in fp32 and one cast to x's type.

The model's serving path calls this where the JAX model calls
``model._rmsnorm``. The two differ in one rounding: ``_rmsnorm`` rounds
``rsqrt(var + eps)`` to x's type and multiplies in that type, while
``fused_rmsnorm`` keeps the whole product in fp32. In fp32 they agree to
rounding; in bf16 only to bf16 tolerance. The port uses ``fused_rmsnorm``'s
numerics throughout.
"""

from __future__ import annotations

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fused_rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                        eps: float = 1e-6) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the CPU path and the
    reference the kernel is held against on the card)."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def fused_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim of x (..., D) with per-channel scale (D,).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (fp32 or bf16, scale of x's type) or raises."""
    if x.device.type == "cpu":
        return fused_rmsnorm_plain(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rmsnorm: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_rmsnorm: dtype {x.dtype} (fp32 or bf16)")
    d = x.shape[-1]
    if scale.shape != (d,) or scale.dtype != x.dtype \
            or scale.device != x.device:
        raise ValueError("fused_rmsnorm: scale must be (D,) of x's dtype "
                         "on x's device")
    x2 = x.reshape(-1, d).contiguous()
    scale = scale.contiguous()
    out = torch.empty_like(x2)
    rows = x2.shape[0]
    if rows == 0:
        return out.reshape(x.shape)
    vec = 16 // x.element_size()
    vectorized = int(d % vec == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x2, scale, out)))
    lib = _build.library()
    rc = lib.rmsnorm_fwd(x2.data_ptr(), scale.data_ptr(), out.data_ptr(),
                         rows, d, eps, _DTYPE_CODES[x.dtype], vectorized,
                         torch.cuda.current_stream(x.device).cuda_stream)
    fused_rmsnorm.launches += 1
    _build.check(rc, "rmsnorm_fwd")
    return out.reshape(x.shape)


fused_rmsnorm.launches = 0  # type: ignore[attr-defined]
