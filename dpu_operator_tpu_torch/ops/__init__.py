"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. A wrapper takes the plain version for a CPU tensor and launches
its kernel for a CUDA tensor; each counts its launches."""

from .flash_attention import (FlashAttentionFn, attention_bwd_dkv,
                              attention_bwd_dkv_plain, attention_bwd_dq,
                              attention_bwd_dq_plain, attention_delta,
                              attention_fwd, attention_fwd_lse,
                              attention_fwd_plain, flash_attention,
                              flash_attention_vjp)
from .rmsnorm import RmsNormFn, fused_rmsnorm, fused_rmsnorm_plain

__all__ = ["FlashAttentionFn", "RmsNormFn", "attention_bwd_dkv",
           "attention_bwd_dkv_plain", "attention_bwd_dq",
           "attention_bwd_dq_plain", "attention_delta", "attention_fwd",
           "attention_fwd_lse", "attention_fwd_plain", "flash_attention",
           "flash_attention_vjp", "fused_rmsnorm", "fused_rmsnorm_plain",
           "launch_counts", "reset_launch_counts"]

#: the wrappers whose launches :func:`launch_counts` reports besides the
#: two shapes of ``attention_fwd``
_COUNTED = (attention_fwd_lse, attention_bwd_dq, attention_bwd_dkv)


def launch_counts() -> dict:
    """Kernel launches so far, by kernel (decode-shaped attention counted
    apart from the tiled shape)."""
    counts = {"fused_rmsnorm": fused_rmsnorm.launches,
              "attention_fwd_tiled": (attention_fwd.launches
                                      - attention_fwd.decode_launches),
              "attention_fwd_decode": attention_fwd.decode_launches}
    counts.update((fn.__name__, fn.launches) for fn in _COUNTED)
    return counts


def reset_launch_counts() -> None:
    fused_rmsnorm.launches = 0
    attention_fwd.launches = 0
    attention_fwd.decode_launches = 0
    for fn in _COUNTED:
        fn.launches = 0
