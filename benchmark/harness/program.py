"""The system under test, as the benchmark calls it: the port's
configuration from the benchmark's configuration file (through its
block), and device helpers."""

from __future__ import annotations

import contextlib
import time

import torch

from .manifest import block_of

#: the host clock of every time the benchmark takes (the scheduler's too)
clock = time.monotonic


def program_config(config: dict):
    """The port's configuration of a configuration file."""
    return block_of(config).program_config(config["model"])


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def span(name: str, traced: bool = True):
    """A ``record_function`` range the traced slice attributes host time
    to; nothing in a run without a trace."""
    if not traced:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)
