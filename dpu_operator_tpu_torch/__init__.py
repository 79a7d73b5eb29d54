"""PyTorch / CUDA port of the serving compute layer of ``dpu_operator_tpu``.

The JAX package stays the reference; this package imports neither JAX nor
anything of ``dpu_operator_tpu``. Kernels live in :mod:`.ops` (CUDA C++
sources in ``csrc/``, built at first use), the model, KV-cache decode,
block pool and continuous-batching scheduler in :mod:`.workloads`.
Entry points run on ``device="cuda"`` unless the caller passes another
device, and raise when CUDA is asked for and absent.
"""

import torch


def resolve_device(device: "str | torch.device") -> torch.device:
    """The device an entry point runs on. Asking for CUDA without a usable
    CUDA device raises: the port never moves to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev
