"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. A wrapper takes the plain version for a CPU tensor and launches
its kernel for a CUDA tensor; each counts its launches."""

from .flash_attention import (FlashAttentionFn, attention_bwd_dkv,
                              attention_bwd_dkv_plain, attention_bwd_dq,
                              attention_bwd_dq_plain, attention_decode_plain,
                              attention_delta, attention_fwd,
                              attention_fwd_kv8, attention_fwd_lse,
                              attention_fwd_plain, attention_kv8_plain,
                              flash_attention, flash_attention_vjp)
from .rmsnorm import RmsNormFn, fused_rmsnorm, fused_rmsnorm_plain

__all__ = ["FlashAttentionFn", "RmsNormFn", "attention_bwd_dkv",
           "attention_bwd_dkv_plain", "attention_bwd_dq",
           "attention_bwd_dq_plain", "attention_decode_plain",
           "attention_delta", "attention_fwd", "attention_fwd_kv8",
           "attention_fwd_lse", "attention_fwd_plain",
           "attention_kv8_plain", "flash_attention",
           "flash_attention_vjp", "fused_rmsnorm", "fused_rmsnorm_plain",
           "launch_counts", "reset_launch_counts"]

def launch_counts() -> dict:
    """Kernel launches so far, by kernel: each wrapper's launches split by
    the route they took (``_tc``: the bf16 tensor-core kernel; ``_tf32``:
    the fp32 3xTF32 tensor-core kernel; decode-shaped attention apart; the
    int8-cache attention under ``attention_kv8_*``: ``_rows`` the cluster
    kernel, ``_tc`` the bf16 tensor-core kernel, ``_tf32`` the fp32 one)."""
    fwd, lse, kv8 = attention_fwd, attention_fwd_lse, attention_fwd_kv8
    dq, dkv = attention_bwd_dq, attention_bwd_dkv
    return {
        "fused_rmsnorm": fused_rmsnorm.launches,
        "attention_fwd_tf32": (fwd.launches - fwd.decode_launches
                               - fwd.tc_launches),
        "attention_fwd_decode": fwd.decode_launches,
        "attention_fwd_tc": fwd.tc_launches,
        "attention_kv8_rows": kv8.rows_launches,
        "attention_kv8_tc": kv8.tc_launches,
        "attention_kv8_tf32": (kv8.launches - kv8.rows_launches
                               - kv8.tc_launches),
        "attention_fwd_lse_tf32": lse.launches - lse.tc_launches,
        "attention_fwd_lse_tc": lse.tc_launches,
        "attention_bwd_dq_tf32": dq.launches - dq.tc_launches,
        "attention_bwd_dq_tc": dq.tc_launches,
        "attention_bwd_dkv_tf32": dkv.launches - dkv.tc_launches,
        "attention_bwd_dkv_tc": dkv.tc_launches,
    }


def reset_launch_counts() -> None:
    fused_rmsnorm.launches = attention_fwd.decode_launches = 0
    attention_fwd_kv8.rows_launches = 0
    for fn in (attention_fwd, attention_fwd_kv8, attention_fwd_lse,
               attention_bwd_dq, attention_bwd_dkv):
        fn.launches = fn.tc_launches = 0
