"""Model-FLOP accounting, train-step timing and decode throughput on the
card.

The port's trimmed copy of ``dpu_operator_tpu/workloads/perf.py``:
``param_count``, ``train_step_flops``, ``attention_flops`` and
``FLAGSHIP_BATCH`` as there; :func:`measure_train`, timed with CUDA events
after a warm-up step (a CUDA event pair around eagerly enqueued steps
excludes nothing but the host's lead over the card); and, for the serving
path, ``marginal_time`` / ``best_marginal_time`` and ``measure_decode``
(JAX ``decode.py:540``), whose two-length slope cancels what a generation
costs besides its decode steps (prefill, the first host round trip).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from .. import resolve_device
from .decode import generate, quantize_decode_params
from .model import (TransformerConfig, init_params, make_example_batch,
                    param_bytes)
from .train import make_train_step

#: data-sheet rates by the exact ``torch.cuda.get_device_name()``: dense
#: FLOP/s by dtype (bf16 on the tensor cores, fp32 outside them) and HBM
#: bytes/s. NVIDIA's data sheet for the SXM part at its full 700 W power
#: limit; a card set below it runs slower under load. The PCIe and NVL
#: parts have lower rates and other names, so they are not matched.
CARD_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989e12, "float32": 67e12,
                              "hbm_bytes_per_s": 3.35e12},
}

#: the JAX package's flagship batch (``perf.FLAGSHIP_BATCH``)
FLAGSHIP_BATCH = 8

#: :func:`measure_decode` on the CPU: the JAX package's stand-ins
#: (``perf._CPU_FALLBACK_HBM_GBPS``, ``decode._CPU_DECODE_EFFECTIVE_TFLOPS``),
#: smoke constants that give a CPU run finite ratios. No device's rates.
CPU_DECODE_HBM_BYTES_PER_S = 20e9
CPU_DECODE_FLOPS = 0.015e12

#: :func:`measure_decode`'s prompt: this many ones per row (the JAX
#: default, which bench.py keeps)
DECODE_PROMPT_LEN = 16


def param_count(cfg: TransformerConfig) -> int:
    """Parameters of the dense model (the port has no MoE layers yet)."""
    per_layer = (2 * cfg.d_model                       # ln1, ln2
                 + cfg.d_model * 3 * cfg.d_model       # wqkv
                 + cfg.d_model * cfg.d_model           # wo
                 + 2 * cfg.d_model * cfg.d_ff)         # w1, w2
    return (cfg.vocab * cfg.d_model + cfg.max_seq * cfg.d_model
            + cfg.d_model + cfg.n_layers * per_layer)


def train_step_flops(cfg: TransformerConfig, batch: int, seq: int) -> float:
    """Model FLOPs of one forward + backward step: 6 per parameter per
    token, plus causal attention (6 * layers * B * S^2 * D)."""
    tokens = batch * seq
    return (6.0 * param_count(cfg) * tokens
            + 6.0 * cfg.n_layers * batch * seq * seq * cfg.d_model)


def attention_flops(b: int, s: int, h: int, d: int, causal: bool) -> float:
    """Forward attention FLOPs: QK^T + PV, 2 flops/MAC, halved if causal."""
    full = 4.0 * b * h * s * s * d
    return full / 2.0 if causal else full


def peak_tflops(device_name: str) -> Optional[float]:
    """The card's dense bf16 peak in TFLOP/s from :data:`CARD_PEAKS`, or
    None for a card the table does not know."""
    peaks = CARD_PEAKS.get(device_name)
    return None if peaks is None else peaks["bfloat16"] / 1e12


@dataclasses.dataclass
class TrainPerf:
    device: str
    step_ms: float
    tokens_per_s: float
    model_tflops: float      # achieved model TFLOP/s
    peak_tflops: Optional[float]
    mfu: Optional[float]     # None when the card's peak is not known
    params: int
    steps_timed: int
    losses: list             # warm-up step first
    peak_memory_bytes: int


def measure_train(cfg: TransformerConfig, batch: int = FLAGSHIP_BATCH,
                  steps: int = 5, device: "str | torch.device" = "cuda",
                  seed: int = 0) -> TrainPerf:
    """Train-step time on a CUDA card: random parameters from *seed*, the
    example batch of :func:`make_example_batch` at ``cfg.max_seq``, one
    warm-up step, then *steps* steps between two CUDA events. Raises on
    any device but CUDA: a CPU time is no measurement of the card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"measure_train times a CUDA card, not {dev}")
    step, init_state, place = make_train_step(cfg, dev)
    params, opt = init_state(seed)
    data = place(make_example_batch(cfg, batch=batch))
    torch.cuda.reset_peak_memory_stats(dev)
    params, opt, loss = step(params, opt, data)   # warm-up
    losses = [loss]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        params, opt, loss = step(params, opt, data)
        losses.append(loss)
    end.record()
    torch.cuda.synchronize(dev)
    dt = start.elapsed_time(end) / 1e3 / steps
    seq = cfg.max_seq
    achieved = train_step_flops(cfg, batch, seq) / dt / 1e12
    name = torch.cuda.get_device_name(dev)
    peak = peak_tflops(name)
    return TrainPerf(
        device=name, step_ms=dt * 1e3, tokens_per_s=batch * seq / dt,
        model_tflops=achieved, peak_tflops=peak,
        mfu=None if peak is None else achieved / peak,
        params=param_count(cfg), steps_timed=steps,
        losses=[float(x) for x in losses],
        peak_memory_bytes=torch.cuda.max_memory_allocated(dev))


def _marginal_step_s(make_chained: Callable[[int], Callable[[], None]],
                     n_short: int, n_long: int, repeats: int,
                     best_of: int) -> float:
    """Seconds per iteration by the two-length slope (JAX
    ``perf.marginal_time`` under ``best_marginal_time``): *make_chained(n)*
    returns a callable that runs n chained iterations and returns when
    they are done. Both lengths run once to warm up, then *repeats* times
    interleaved (short, long, ...); the slope of the two minima, ``(min
    long - min short) / (n_long - n_short)``, cancels every fixed cost of
    a call. The least of *best_of* such slopes."""
    fn_short, fn_long = make_chained(n_short), make_chained(n_long)
    fn_short()
    fn_long()
    best = float("inf")
    for _ in range(max(1, best_of)):
        shorts, longs = [], []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn_short()
            shorts.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            fn_long()
            longs.append(time.perf_counter() - t0)
        best = min(best, max((min(longs) - min(shorts))
                             / (n_long - n_short), 1e-9))
    return best


def measure_decode(cfg: TransformerConfig, batch: int = 8, steps: int = 64,
                   iters: int = 4, best_of: int = 3,
                   quantized: bool = False, kv_int8: bool = False,
                   device: "str | torch.device" = "cuda") -> dict:
    """Steady-state decode throughput (JAX ``decode.measure_decode``):
    seconds per decode step as the slope of greedy :func:`generate` runs of
    ``max(4, steps // 4)`` and *steps* tokens (:func:`_marginal_step_s`,
    *iters* repeats, best of *best_of*), over random parameters from seed
    0 (``quantized``: the W8A8 tree) and a prompt of
    :data:`DECODE_PROMPT_LEN` ones, with an int8 cache when *kv_int8*. On
    the card each chain ends in ``torch.cuda.synchronize()``.

    The roofline: a step streams every parameter byte (the real leaf
    widths of the tree) and the K / V of the keys its rows admit (2 bytes
    an element in the model's type, ``1 + 4 / d_head`` with KV8), over
    the card's HBM rate, and takes ``2 * params * batch + 4 * layers *
    batch * keys * d_model`` FLOPs at its rate for ``cfg.dtype``
    (``CARD_PEAKS``, by the exact device name; an unknown card raises).
    ``keys`` is the mean over the slope's steps (the ones the long chain
    runs beyond the short one) of the keys a row at that position admits:
    the port's attention kernels read those and no more, where the JAX
    package's einsum reads the whole ``max_seq`` cache, which its
    ``measure_decode`` charges. ``roofline_frac`` is the larger of the
    two times over the measured step; ``bound`` says which. On the CPU
    the rates are the stated constants :data:`CPU_DECODE_HBM_BYTES_PER_S`
    and :data:`CPU_DECODE_FLOPS`."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        if name not in CARD_PEAKS:
            raise ValueError(f"measure_decode: no data-sheet rates for "
                             f"{name!r} in CARD_PEAKS")
        peaks = CARD_PEAKS[name]
        hbm = peaks["hbm_bytes_per_s"]
        rate = peaks[str(cfg.dtype).replace("torch.", "")]
    elif dev.type == "cpu":
        name = "cpu"
        hbm, rate = CPU_DECODE_HBM_BYTES_PER_S, CPU_DECODE_FLOPS
    else:
        raise ValueError(f"measure_decode: unsupported device {dev}")
    params = init_params(0, cfg, device=dev)
    if quantized:
        params = quantize_decode_params(params)
    prompt = torch.ones((batch, DECODE_PROMPT_LEN), dtype=torch.int64,
                        device=dev)

    def make_chained(n: int) -> Callable[[], None]:
        def go() -> None:
            generate(params, cfg, prompt, n, device=dev, kv_int8=kv_int8)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return go

    n_short = max(4, steps // 4)
    per_step = _marginal_step_s(make_chained, n_short=n_short, n_long=steps,
                                repeats=iters, best_of=best_of)
    # generate(n) runs its decode steps at positions P .. P + n - 2, the
    # one at P + i admitting P + i + 1 keys; the slope's steps are
    # i = n_short - 1 .. steps - 2
    keys = DECODE_PROMPT_LEN + (n_short + steps - 1) / 2.0
    kv_width = (1.0 + 4.0 / cfg.d_head) if kv_int8 else 2.0
    kv_bytes = 2.0 * cfg.n_layers * keys * cfg.d_model * kv_width * batch
    hbm_s = (param_bytes(params) + kv_bytes) / hbm
    flops = (2.0 * param_count(cfg) * batch
             + 4.0 * cfg.n_layers * batch * keys * cfg.d_model)
    compute_s = flops / rate
    min_s = max(hbm_s, compute_s)
    return {"batch": batch, "steps": steps,
            "ms_per_token": per_step * 1e3,
            "tokens_per_s": batch / per_step,
            "roofline_ms_per_token": min_s * 1e3,
            "hbm_ms_per_token": hbm_s * 1e3,
            "compute_ms_per_token": compute_s * 1e3,
            "bound": "hbm" if hbm_s >= compute_s else "compute",
            "hbm_frac": hbm_s / per_step,
            "roofline_frac": min_s / per_step,
            "device": name}
