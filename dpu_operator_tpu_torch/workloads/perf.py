"""Model-FLOP accounting, train-step timing, attention and decode
throughput on the card.

The port's trimmed copy of ``dpu_operator_tpu/workloads/perf.py``:
``param_count``, ``active_param_count``, ``train_step_flops``,
``attention_flops`` and
``FLAGSHIP_BATCH`` as there; :func:`measure_train`, timed with CUDA events
after a warm-up step (a CUDA event pair around eagerly enqueued steps
excludes nothing but the host's lead over the card); and
``marginal_time`` / ``best_marginal_time`` as one helper, which times
:func:`measure_flash_attention` (calls chained q -> out -> q) and
``measure_decode`` (JAX ``decode.py:540``): a two-length slope cancels
every fixed cost of a call (prefill, the first host round trip). The
card's rates are :data:`CARD_PEAKS`'s, read through :func:`card_peaks`.
"""

from __future__ import annotations

import dataclasses
import subprocess
import time
from typing import Callable, Optional

import torch

from .. import resolve_device
from ..ops.flash_attention import flash_attention
from .decode import generate, quantize_decode_params
from .model import (TransformerConfig, init_params, make_example_batch,
                    param_bytes)
from .train import make_train_step

#: data-sheet rates by the exact ``torch.cuda.get_device_name()``: dense
#: FLOP/s by dtype (bf16 on the tensor cores, fp32 outside them, TF32 on
#: the tensor cores: fp32 attention takes three TF32 products a product,
#: so its least time is at a third of that rate) and HBM bytes/s. NVIDIA's
#: data sheet for the SXM part at its full 700 W power limit; a card set
#: below it runs slower under load. The PCIe and NVL parts have lower rates
#: and other names, so they are not matched.
CARD_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989e12, "float32": 67e12,
                              "tf32": 495e12, "hbm_bytes_per_s": 3.35e12},
}

#: the JAX package's flagship batch (``perf.FLAGSHIP_BATCH``)
FLAGSHIP_BATCH = 8

#: :func:`measure_train` and :func:`measure_flash_attention` on the CPU:
#: the JAX package's stand-in peak (``perf._CPU_FALLBACK_TFLOPS``), a smoke
#: constant that gives a CPU run finite ratios. No device's rate.
CPU_PEAK_FLOPS = 0.2e12

#: :func:`measure_decode` on the CPU: the JAX package's stand-ins
#: (``perf._CPU_FALLBACK_HBM_GBPS``, ``decode._CPU_DECODE_EFFECTIVE_TFLOPS``),
#: smoke constants that give a CPU run finite ratios. No device's rates.
CPU_DECODE_HBM_BYTES_PER_S = 20e9
CPU_DECODE_FLOPS = 0.015e12

#: :func:`measure_decode`'s prompt: this many ones per row (the JAX
#: default, which bench.py keeps)
DECODE_PROMPT_LEN = 16


def param_count(cfg: TransformerConfig) -> int:
    """Parameters of the model (JAX ``perf.param_count``): a MoE layer
    counts its router and every expert."""
    attn = (2 * cfg.d_model                            # ln1, ln2
            + cfg.d_model * 3 * cfg.d_model            # wqkv
            + cfg.d_model * cfg.d_model)               # wo
    dense_ffn = 2 * cfg.d_model * cfg.d_ff             # w1, w2
    total = cfg.vocab * cfg.d_model + cfg.max_seq * cfg.d_model + cfg.d_model
    for i in range(cfg.n_layers):
        total += attn
        if cfg.is_moe_layer(i):
            total += (cfg.d_model * cfg.moe_experts        # router
                      + cfg.moe_experts * dense_ffn)       # expert w1 / w2
        else:
            total += dense_ffn
    return total


def active_param_count(cfg: TransformerConfig) -> int:
    """Parameters each token multiplies against (JAX
    ``perf.active_param_count``): :func:`param_count` for a dense model;
    a top-1 MoE layer counts its router and one expert."""
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    return param_count(cfg) - n_moe * max(cfg.moe_experts - 1, 0) \
        * 2 * cfg.d_model * cfg.d_ff


def train_step_flops(cfg: TransformerConfig, batch: int, seq: int) -> float:
    """Model FLOPs of one forward + backward step: 6 per active parameter
    (:func:`active_param_count`) per token, plus causal attention (6 *
    layers * B * S^2 * D)."""
    tokens = batch * seq
    return (6.0 * active_param_count(cfg) * tokens
            + 6.0 * cfg.n_layers * batch * seq * seq * cfg.d_model)


def attention_flops(b: int, s: int, h: int, d: int, causal: bool) -> float:
    """Forward attention FLOPs: QK^T + PV, 2 flops/MAC, halved if causal."""
    full = 4.0 * b * h * s * s * d
    return full / 2.0 if causal else full


def card_peaks(device: "str | torch.device" = "cuda") -> dict:
    """The :data:`CARD_PEAKS` entry of the CUDA card *device*, by its exact
    name; a card the table does not know raises (no rate is guessed)."""
    name = torch.cuda.get_device_name(device)
    if name not in CARD_PEAKS:
        raise ValueError(f"no data-sheet rates for {name!r} in CARD_PEAKS")
    return CARD_PEAKS[name]


def nvidia_smi_line() -> Optional[str]:
    """nvidia-smi's ``name, power.limit`` of the first card (the power
    limit a measurement must be read beside), or None where nvidia-smi is
    missing or prints nothing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out[0] if out else None


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
    peak_memory_bytes: Optional[int]   # None on the CPU


def measure_train(cfg: TransformerConfig, batch: int = FLAGSHIP_BATCH,
                  steps: int = 5, device: "str | torch.device" = "cuda",
                  seed: int = 0) -> TrainPerf:
    """Train-step time: random parameters from *seed*, the example batch
    of :func:`make_example_batch` at ``cfg.max_seq``, one warm-up step,
    then *steps* steps between two CUDA events on the card. On the CPU
    (small sizes, for tests) the steps are timed on the host clock and
    MFU is taken against :data:`CPU_PEAK_FLOPS`, a smoke constant."""
    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"measure_train: unsupported device {dev}")
    cuda = dev.type == "cuda"
    step, init_state, place = make_train_step(cfg, dev)
    params, opt = init_state(seed)
    data = place(make_example_batch(cfg, batch=batch))
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    params, opt, loss = step(params, opt, data)   # warm-up
    losses = [loss]
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(steps):
        params, opt, loss = step(params, opt, data)
        losses.append(loss)
    if cuda:
        end.record()
        torch.cuda.synchronize(dev)
        dt = start.elapsed_time(end) / 1e3 / steps
        name = torch.cuda.get_device_name(dev)
        peak = peak_tflops(name)
    else:
        dt = (time.perf_counter() - t0) / steps
        name, peak = "cpu", CPU_PEAK_FLOPS / 1e12
    seq = cfg.max_seq
    achieved = train_step_flops(cfg, batch, seq) / dt / 1e12
    return TrainPerf(
        device=name, step_ms=dt * 1e3, tokens_per_s=batch * seq / dt,
        model_tflops=achieved, peak_tflops=peak,
        mfu=None if peak is None else achieved / peak,
        params=param_count(cfg), steps_timed=steps,
        losses=[float(x) for x in losses],
        peak_memory_bytes=torch.cuda.max_memory_allocated(dev) if cuda
        else None)


#: :func:`_marginal_step_s`: how many times a round's repeats are run
#: before the round gives no slope (under six concurrent CPU runs a round
#: of chains 4 and 8 long still crossed after 4)
SLOPE_TRIES = 8
#: :func:`_marginal_step_s`: a slope at or below this share of the short
#: chain's time an iteration (fixed costs included) is a stalled short
#: chain. Low, because a loaded host inflates the short chain's time far
#: more than the slope: under six concurrent CPU runs a sound slope read
#: 1/37 of it
SLOPE_FLOOR_FRAC = 1.0 / 256


def _marginal_step_s(make_chained: Callable[[int], Callable[[], None]],
                     n_short: int, n_long: int, repeats: int,
                     best_of: int) -> float:
    """Seconds per iteration by the two-length slope (JAX
    ``perf.marginal_time`` under ``best_marginal_time``): *make_chained(n)*
    returns a callable that runs n chained iterations and returns when
    they are done. Both lengths run once to warm up, then *repeats* times
    interleaved (short, long, ...); the slope of the two minima, ``(min
    long - min short) / (n_long - n_short)``, cancels every fixed cost of
    a call. The least of *best_of* such slopes.

    Where this differs from the JAX helper: a slope at or below
    :data:`SLOPE_FLOOR_FRAC` of the short chain's minimum over *n_short*
    (crossed minima, where the slope is not positive, included) is a host
    that stalled the short runs, not a measurement. The JAX helper clamps
    a non-positive slope to 1e-9 s and keeps a barely positive one, and
    either then reads as a step thousands of times faster than the card's
    bound. Here such a round runs its *repeats* again, its minima taken
    over every run so far, up to :data:`SLOPE_TRIES` times; a round whose
    slope is still refused gives none, and ``ValueError`` is raised only
    if no round of *best_of* gives one. On a quiet host each round's first
    *repeats* stand, so the chain lengths and the minimum of slopes mean
    what they mean in the JAX helper."""
    fn_short, fn_long = make_chained(n_short), make_chained(n_long)
    fn_short()
    fn_long()

    def run(shorts: list, longs: list) -> None:
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn_short()
            shorts.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            fn_long()
            longs.append(time.perf_counter() - t0)

    best, refused = float("inf"), []
    for _ in range(max(1, best_of)):
        shorts, longs = [], []
        for _ in range(SLOPE_TRIES):
            run(shorts, longs)
            s = (min(longs) - min(shorts)) / (n_long - n_short)
            if s > SLOPE_FLOOR_FRAC * min(shorts) / n_short:
                best = min(best, s)
                break
            refused.append(s)
    if best == float("inf"):
        raise ValueError(
            f"collapsed slope: every one of {len(refused)} tries of chains "
            f"of {n_short} and {n_long} iterations read at or below "
            f"{SLOPE_FLOOR_FRAC} of the short chain's time an iteration "
            f"(slopes {refused} s)")
    return best


@dataclasses.dataclass
class FlashPerf:
    device: str
    call_ms: float
    tflops_causal: float
    frac_of_peak: float
    peak_tflops: float


def measure_flash_attention(b: int = 4, s: int = 2048, h: int = 8,
                            d: int = 128, iters: int = 400, best_of: int = 3,
                            device: "str | torch.device" = "cuda"
                            ) -> FlashPerf:
    """The attention forward's time per call (JAX
    ``perf.measure_flash_attention``): causal :func:`flash_attention` over
    bf16 q, k, v of (b, s, h, d) from seed 0, calls chained q -> out -> q,
    timed by the slope of chains of ``max(2, iters // 5)`` and *iters* calls
    (:func:`_marginal_step_s`, 5 repeats, best of *best_of*), each chain
    ending in ``torch.cuda.synchronize()`` on the card. TFLOP/s count
    :func:`attention_flops` (causal: halved) against the card's bf16
    peak from :func:`card_peaks`; on the CPU against
    :data:`CPU_PEAK_FLOPS`, a smoke constant."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        peak = card_peaks(dev)["bfloat16"]
    elif dev.type == "cpu":
        name, peak = "cpu", CPU_PEAK_FLOPS
    else:
        raise ValueError(f"measure_flash_attention: unsupported device "
                         f"{dev}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))

    def make_chained(n: int) -> Callable[[], None]:
        def go() -> None:
            out = q
            for _ in range(n):
                out = flash_attention(out, k, v, causal=True)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return go

    dt = _marginal_step_s(make_chained, n_short=max(2, iters // 5),
                          n_long=iters, repeats=5, best_of=best_of)
    tflops = attention_flops(b, s, h, d, causal=True) / dt / 1e12
    return FlashPerf(device=name, call_ms=dt * 1e3, tflops_causal=tflops,
                     frac_of_peak=tflops / (peak / 1e12),
                     peak_tflops=peak / 1e12)


def measure_decode(cfg: TransformerConfig, batch: int = 8, steps: int = 64,
                   iters: int = 4, best_of: int = 3,
                   quantized: bool = False, kv_int8: bool = False,
                   device: "str | torch.device" = "cuda",
                   max_sane_frac: Optional[float] = None) -> dict:
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
    the card's HBM rate, and takes ``2 * active params * batch + 4 *
    layers * batch * keys * d_model`` FLOPs at its rate for ``cfg.dtype``
    (``CARD_PEAKS``, by the exact device name; an unknown card raises).
    ``keys`` is the mean over the slope's steps (the ones the long chain
    runs beyond the short one) of the keys a row at that position admits:
    the port's attention kernels read those and no more, where the JAX
    package's einsum reads the whole ``max_seq`` cache, which its
    ``measure_decode`` charges. ``roofline_frac`` is the larger of the
    two times over the measured step; ``bound`` says which. On the CPU
    the rates are the stated constants :data:`CPU_DECODE_HBM_BYTES_PER_S`
    and :data:`CPU_DECODE_FLOPS`. A *max_sane_frac* makes a
    ``roofline_frac`` outside ``(0, max_sane_frac]`` raise ``ValueError``
    (a slope that collapsed), instead of returning it."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        peaks = card_peaks(dev)
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
    flops = (2.0 * active_param_count(cfg) * batch
             + 4.0 * cfg.n_layers * batch * keys * cfg.d_model)
    compute_s = flops / rate
    min_s = max(hbm_s, compute_s)
    if max_sane_frac is not None \
            and not 0.0 < min_s / per_step <= max_sane_frac:
        raise ValueError(
            f"degenerate decode measurement: roofline_frac "
            f"{min_s / per_step:.3g} outside (0, {max_sane_frac}] "
            f"(step {per_step:.3g} s against a bound of {min_s:.3g} s)")
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
