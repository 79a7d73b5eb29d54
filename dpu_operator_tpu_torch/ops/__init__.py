"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. A wrapper takes the plain version for a CPU tensor and launches
its kernel for a CUDA tensor; each counts its launches."""

from .flash_attention import (attention_fwd, attention_fwd_plain,
                              flash_attention)
from .rmsnorm import fused_rmsnorm, fused_rmsnorm_plain

__all__ = ["attention_fwd", "attention_fwd_plain", "flash_attention",
           "fused_rmsnorm", "fused_rmsnorm_plain", "launch_counts",
           "reset_launch_counts"]


def launch_counts() -> dict:
    """Kernel launches so far, by kernel (decode-shaped attention counted
    apart from the tiled shape)."""
    return {"fused_rmsnorm": fused_rmsnorm.launches,
            "attention_fwd_tiled": (attention_fwd.launches
                                    - attention_fwd.decode_launches),
            "attention_fwd_decode": attention_fwd.decode_launches}


def reset_launch_counts() -> None:
    fused_rmsnorm.launches = 0
    attention_fwd.launches = 0
    attention_fwd.decode_launches = 0
