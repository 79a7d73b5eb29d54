"""The system under test, as the benchmark calls it: the port's
configuration from the benchmark's configuration file, and device
helpers."""

from __future__ import annotations

import contextlib
import time

import torch

from .weights import dtype_of

#: the host clock of every time the benchmark takes (the scheduler's too)
clock = time.monotonic


def program_config(config: dict):
    """The port's ``TransformerConfig`` of a configuration file."""
    from dpu_operator_tpu_torch.workloads.model import TransformerConfig
    m = config["model"]
    return TransformerConfig(
        vocab=m["vocab"], d_model=m["d_model"], n_heads=m["n_heads"],
        n_layers=m["n_layers"], d_ff=m["d_ff"], max_seq=m["max_seq"],
        dtype=dtype_of(m), attention=m["attention"],
        moe_experts=m["moe_experts"], moe_every=m["moe_every"],
        moe_capacity_factor=m["moe_capacity_factor"],
        moe_aux_weight=m["moe_aux_weight"])


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def span(name: str, traced: bool = True):
    """A ``record_function`` range the traced slice attributes host time
    to; nothing in a run without a trace."""
    if not traced:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)
