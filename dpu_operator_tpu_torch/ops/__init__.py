"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. A wrapper takes the plain version for a CPU tensor and launches
its kernel for a CUDA tensor; each counts its launches."""

from .flash_attention import (FlashAttentionFn, attention_bwd_dkv,
                              attention_bwd_dkv_plain, attention_bwd_dq,
                              attention_bwd_dq_plain, attention_decode_plain,
                              attention_delta, attention_fwd,
                              attention_fwd_lse, attention_fwd_plain,
                              flash_attention, flash_attention_vjp)
from .rmsnorm import RmsNormFn, fused_rmsnorm, fused_rmsnorm_plain

__all__ = ["FlashAttentionFn", "RmsNormFn", "attention_bwd_dkv",
           "attention_bwd_dkv_plain", "attention_bwd_dq",
           "attention_bwd_dq_plain", "attention_decode_plain",
           "attention_delta", "attention_fwd", "attention_fwd_lse",
           "attention_fwd_plain", "flash_attention",
           "flash_attention_vjp", "fused_rmsnorm", "fused_rmsnorm_plain",
           "launch_counts", "reset_launch_counts"]

def launch_counts() -> dict:
    """Kernel launches so far, by kernel: each wrapper's launches split by
    the route they took (``_tc``: the tensor-core kernel; the other name of
    a wrapper: its CUDA-core kernel; decode-shaped attention apart)."""
    fwd, lse = attention_fwd, attention_fwd_lse
    dq, dkv = attention_bwd_dq, attention_bwd_dkv
    return {
        "fused_rmsnorm": fused_rmsnorm.launches,
        "attention_fwd_tiled": (fwd.launches - fwd.decode_launches
                                - fwd.tc_launches),
        "attention_fwd_decode": fwd.decode_launches,
        "attention_fwd_tc": fwd.tc_launches,
        "attention_fwd_lse": lse.launches - lse.tc_launches,
        "attention_fwd_lse_tc": lse.tc_launches,
        "attention_bwd_dq": dq.launches - dq.tc_launches,
        "attention_bwd_dq_tc": dq.tc_launches,
        "attention_bwd_dkv": dkv.launches - dkv.tc_launches,
        "attention_bwd_dkv_tc": dkv.tc_launches,
    }


def reset_launch_counts() -> None:
    fused_rmsnorm.launches = attention_fwd.decode_launches = 0
    for fn in (attention_fwd, attention_fwd_lse, attention_bwd_dq,
               attention_bwd_dkv):
        fn.launches = fn.tc_launches = 0
