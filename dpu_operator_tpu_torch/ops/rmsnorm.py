"""Fused RMSNorm: a hand-written CUDA kernel and its plain PyTorch version.

Port of ``dpu_operator_tpu/ops/rmsnorm.py`` (``fused_rmsnorm`` and its
Pallas ``_kernel``); the kernel is ``csrc/rmsnorm.cu``. The function: per
row of x (..., D), the mean of squares in fp32, then
``x * rsqrt(var + eps) * scale`` in fp32 and one cast to x's type.

On the card a row of whole aligned 16-byte pieces, at most 32 x 8 of them
in bf16 and 32 x 12 in fp32, takes the warp layout (:func:`_rms_pieces`
picks how many pieces a lane holds): one warp a row with the row held in
registers, or, for fewer rows than the card has SMs, one block a row with
the same arithmetic to the bit; any other row one block a row of its own
design. The choice of arithmetic depends on D, the type and the alignment
alone, never on the number of rows, so a row's result does not depend on
the rows launched with it.

The model's serving path calls this where the JAX model calls
``model._rmsnorm``. The two differ in one rounding: ``_rmsnorm`` rounds
``rsqrt(var + eps)`` to x's type and multiplies in that type, while
``fused_rmsnorm`` keeps the whole product in fp32. In fp32 they agree to
rounding; in bf16 only to bf16 tolerance. The port uses ``fused_rmsnorm``'s
numerics throughout.

Training: when autograd records, :func:`fused_rmsnorm` runs
:class:`RmsNormFn`, whose forward is the same call (kernel on the card,
plain version on the CPU) and whose backward is the gradient of the fp32
formula in plain torch ops: the JAX package has no backward kernel for
RMSNorm (XLA differentiates its ``jnp`` norm).
"""

from __future__ import annotations

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: 16-byte pieces a lane holds of a row on the warp-per-row route (the
#: kernel is compiled for each; 12 in fp32 only: bf16 pieces hold twice the
#: values, and ptxas spills there)
_RMS_PIECES = (1, 2, 4, 6, 8, 12)


def _rms_pieces(d: int, elt: int, vectorized: bool) -> int:
    """Pieces of 16 bytes each of the 32 lanes holds of a row of *d*
    elements of *elt* bytes on the warp-per-row route: the fewest of
    :data:`_RMS_PIECES` that hold the row; 0 (the block-per-row route) for
    a row not in aligned 16-byte pieces or longer than the warp holds (bf16
    D above 2048, fp32 above 1536)."""
    if not vectorized:
        return 0
    need = -(-(d * elt // 16) // 32)
    most = 12 if elt == 4 else 8
    return next((p for p in _RMS_PIECES if need <= p <= most), 0)


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
    kernel (fp32 or bf16, scale of x's type) or raises. Differentiable:
    through :class:`RmsNormFn` when autograd records."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RmsNormFn.apply(x, scale, eps)
    return _rmsnorm(x, scale, eps)


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
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
    vectorized = d % vec == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x2, scale, out))
    lib = _build.library()
    rc = lib.rmsnorm_fwd(x2.data_ptr(), scale.data_ptr(), out.data_ptr(),
                         rows, d, eps, _DTYPE_CODES[x.dtype], int(vectorized),
                         _rms_pieces(d, x.element_size(), vectorized),
                         torch.cuda.current_stream(x.device).cuda_stream)
    fused_rmsnorm.launches += 1
    _build.check(rc, "rmsnorm_fwd")
    return out.reshape(x.shape)


fused_rmsnorm.launches = 0  # type: ignore[attr-defined]


class RmsNormFn(torch.autograd.Function):
    """RMSNorm with the gradient of ``y = x * r * scale``,
    ``r = rsqrt(mean(x^2) + eps)``, all in fp32:
    ``dx = r * g - r^3 * x * mean(g * x)`` with ``g = dy * scale``, and
    ``dscale = sum over rows of dy * x * r``; each rounded once to its
    input's type."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: torch.Tensor,  # type: ignore[override]
                eps: float) -> torch.Tensor:
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rmsnorm(x, scale, eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy: torch.Tensor) -> tuple:  # type: ignore[override]
        x, scale = ctx.saved_tensors
        xf, dyf = x.float(), dy.float()
        r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + ctx.eps)
        g = dyf * scale.float()
        dx = r * g - r.pow(3) * xf * (g * xf).mean(-1, keepdim=True)
        dscale = (dyf * xf * r).reshape(-1, x.shape[-1]).sum(0)
        return dx.to(x.dtype), dscale.to(scale.dtype), None
