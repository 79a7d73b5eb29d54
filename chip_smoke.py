#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``dpu_operator_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU (H100):

    python3 chip_smoke.py

Phases, each of which passes or raises (a failure exits non-zero):

1. device: CUDA present; prints the card's name and nvidia-smi's
   ``name, power.limit`` line;
2. build: compiles the kernels from ``dpu_operator_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version at the shapes the
   serving and training paths give it, with its time, the plain version's,
   one PyTorch library call's (a yardstick the port never calls) and the
   least time the card could take (its bound). bf16 at head dim 64 and 128
   takes the tensor-core kernels (D 64 at 1x1000 and 2x1024), fp32 the
   CUDA-core ones, one query row the decode kernels split over keys; a
   256-row chunk at offset 256 must equal rows 256-511 of the whole 512-row
   prefill bit for bit, and slot 0's decode row launched alone must equal
   its row of the 8-slot launch bit for bit;
4. port on the card against port on the CPU (tiny fp32 config): greedy
   streams equal, logits close; then a tiny fp32 serve on the card whose
   streams equal ``generate``; then one tiny fp32 train step whose loss and
   gradients match the CPU's;
5. serve the flagship (bf16, about 391M parameters, random weights from a
   seed) through ``Scheduler`` and ``TorchSlotExecutor``: 16 requests on 8
   slots with chunked prefill; every kernel of the path must have launched,
   every multi-row attention launch on the tensor cores;
6. train the flagship (bf16, batch 8 x 1024 tokens) through
   ``make_train_step`` and ``measure_train``: 1 warm-up and 5 timed AdamW
   steps, loss finite and falling, every gradient leaf finite and not all
   zero, the three training kernels launched 12 times a step, all on the
   tensor cores; one profiled step shows where the device time goes.

The last two lines of standard output are the kernels' JSON line and the
device JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

#: kernel vs plain: the largest :func:`scaled_err` of an output, per
#: dtype. fp32 differs only in summation order; bf16 also in where P, dS
#: and the output round (one bf16 step is 2^-8 to 2^-7 of a value). The
#: H100 readings at this script's shapes and seed: fp32 at most 4.9e-6;
#: bf16 at most 7.2e-3 (dV at 8x1024, on the CUDA cores and on the tensor
#: cores alike), and the bf16 limit lies two bf16 steps (2 * 2^-8) above
#: that
TOL = {"float32": 1e-4, "bfloat16": 1.5e-2}
#: bf16 serving: a served token's logit must lie within this of the best
#: logit under a teacher-forced forward (the random-weight flagship's top
#: logits sit about 0.05 apart; bf16 logits near 1 round in steps of 0.004)
SERVE_LOGIT_TOL = 0.05
#: the kernels each main path must launch (names of ``launch_counts``:
#: ``_tc`` the tensor-core route), and the CUDA-core kernels whose bf16
#: work moved to the tensor cores, which it must not launch
SERVE_KERNELS = ("fused_rmsnorm", "attention_fwd_tc", "attention_fwd_decode")
TRAIN_KERNELS = ("attention_fwd_lse_tc", "attention_bwd_dq_tc",
                 "attention_bwd_dkv_tc")
SERVE_NOT = ("attention_fwd_tiled",)
TRAIN_NOT = ("attention_fwd_lse", "attention_bwd_dq", "attention_bwd_dkv")


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Per-call time of eager calls between two CUDA events: includes the
    host's launch cost whenever the host is the slower side."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Device time per call: *reps* calls captured in one CUDA graph,
    replayed between two CUDA events, so no host launch cost is counted.
    Inputs stay where the previous call left them (L2-warm when they fit
    the 50 MB L2, as on the serving path, where each input was just
    written by the op before)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def scaled_err(got, ref) -> tuple:
    """``(max |got - ref|, max |got - ref| / (|ref| + rms(ref)))``: each
    element's error in units of its own size plus the reference tensor's
    RMS, so a large element is held to its own rounding and a small one,
    where a missed term hides, to the tensor's typical size."""
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    rms = max(float(r.square().mean().sqrt()), 1e-30)
    return float(diff.max()), float((diff / (r.abs() + rms)).max())


def card_peaks() -> dict:
    """This card's data-sheet rates (``perf.CARD_PEAKS``): the bounds
    need them."""
    import torch
    from dpu_operator_tpu_torch.workloads.perf import CARD_PEAKS
    name = torch.cuda.get_device_name(0)
    require(name in CARD_PEAKS, f"no data-sheet rates for {name!r}")
    return CARD_PEAKS[name]


# -- phase 1 ------------------------------------------------------------------
def phase_device() -> dict:
    import torch
    require(torch.cuda.is_available(), "no CUDA device")
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; devices {torch.cuda.device_count()}")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        raise PhaseError(f"nvidia-smi failed: {e}") from e
    require(bool(smi), "nvidia-smi printed nothing")
    print(smi[0], flush=True)
    card_peaks()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"name": name, "smi": smi[0]}


# -- phase 2 ------------------------------------------------------------------
def phase_build() -> None:
    from dpu_operator_tpu_torch.ops import _build
    t0 = time.monotonic()
    _build.library()
    log(f"[build] libkernels.so ready in {time.monotonic() - t0:.1f} s "
        f"(nvcc {_build.build_seconds:.1f} s)")
    report = _build.BUILD_DIR / "ptxas.txt"
    if report.exists():
        for line in report.read_text().splitlines():
            if any(w in line for w in ("registers", "spill",
                                       "Compiling entry")):
                log("[build] " + line.strip())


# -- phase 3 ------------------------------------------------------------------
def _bound(nbytes: float, flops: float, dname: str) -> tuple:
    peaks = card_peaks()
    t_bytes = nbytes / peaks["hbm_bytes_per_s"] * 1e3
    t_ops = flops / peaks[dname] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _rms_case(gen, rows: int, d: int, dtype) -> dict:
    import torch
    import torch.nn.functional as F
    from dpu_operator_tpu_torch.ops import fused_rmsnorm, fused_rmsnorm_plain
    x = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
    scale = (1.0 + 0.1 * torch.randn((d,), generator=gen,
                                     device="cuda")).to(dtype)
    got = fused_rmsnorm(x, scale)
    ref = fused_rmsnorm_plain(x, scale)
    torch.cuda.synchronize()
    max_abs, scaled = scaled_err(got, ref)
    name = str(dtype).replace("torch.", "")
    elt = x.element_size()
    bound, by = _bound((2 * rows * d + d) * elt, 4.0 * rows * d, "float32")
    return {
        "name": f"fused_rmsnorm[{rows}x{d} {name}]",
        "kernel": "fused_rmsnorm", "dtype": name,
        "source": "dpu_operator_tpu_torch/csrc/rmsnorm.cu",
        "replaces": "dpu_operator_tpu/ops/rmsnorm.py:20",
        "max_abs_err": max_abs, "scaled_err": scaled,
        "ms": graph_ms(lambda: fused_rmsnorm(x, scale)),
        "eager_ms": cuda_ms(lambda: fused_rmsnorm(x, scale), 50),
        "plain_ms": cuda_ms(lambda: fused_rmsnorm_plain(x, scale), 20),
        "library_ms": graph_ms(
            lambda: F.rms_norm(x, (d,), weight=scale, eps=1e-6)),
        "bound_ms": bound, "bound_by": by,
    }


def launched(fn):
    """``(fn(), the launch_counts name of the one kernel it launched)``:
    the route a call took, read from the counters it moved."""
    from dpu_operator_tpu_torch.ops import launch_counts
    before = launch_counts()
    out = fn()
    after = launch_counts()
    moved = [k for k in after if after[k] != before[k]]
    require(len(moved) == 1 and after[moved[0]] == before[moved[0]] + 1,
            f"one launch expected; counters moved: {moved}")
    return out, moved[0]


def _attn_case(gen, label: str, q, k, v, pos) -> dict:
    import torch
    import torch.nn.functional as F
    from dpu_operator_tpu_torch.ops import attention_fwd, attention_fwd_plain
    got, kernel = launched(lambda: attention_fwd(q, k, v, pos, causal=True))
    ref = attention_fwd_plain(q, k, v, pos, causal=True)
    torch.cuda.synchronize()
    max_abs, scaled = scaled_err(got, ref)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    pos_h = pos.cpu().numpy().astype(np.int64)
    # admitted (row, key) pairs and the keys each batch entry must read
    pairs = sum(min(int(p) + i + 1, skv) for p in pos_h for i in range(sq))
    keys = sum(min(int(p) + sq, skv) for p in pos_h)
    elt = q.element_size()
    dname = str(q.dtype).replace("torch.", "")
    bound, by = _bound((2 * b * sq * h * d + 2 * keys * h * d) * elt,
                       4.0 * pairs * h * d, dname)
    # library yardstick: SDPA in (B, H, S, D) views with the same mask
    rows = torch.as_tensor(pos_h, device="cuda")[:, None] \
        + torch.arange(sq, device="cuda")
    mask = (torch.arange(skv, device="cuda")[None, None, :]
            <= rows[:, :, None])[:, None]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    return {
        "name": f"{kernel}[{label}]", "kernel": kernel, "dtype": dname,
        "source": "dpu_operator_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "dpu_operator_tpu/ops/flash_attention.py:35",
        "max_abs_err": max_abs, "scaled_err": scaled,
        "ms": graph_ms(lambda: attention_fwd(q, k, v, pos)),
        "eager_ms": cuda_ms(lambda: attention_fwd(q, k, v, pos), 20),
        "plain_ms": cuda_ms(lambda: attention_fwd_plain(q, k, v, pos), 3,
                            warmup=1),
        "library_ms": graph_ms(lib),
        "bound_ms": bound, "bound_by": by,
    }


def _train_cases(gen, b: int, s: int, h: int, d: int, dtype) -> list:
    """The training path's three kernels at one (B, S, H, D) shape, causal,
    q / k / v as views of one (B, S, 3HD) projection as in the model: the
    forward with lse, dQ and dK/dV, each against its plain version on the
    same inputs, with the library's SDPA forward and backward as
    yardsticks."""
    import torch
    import torch.nn.functional as F
    from dpu_operator_tpu_torch.ops import (
        attention_bwd_dkv, attention_bwd_dkv_plain, attention_bwd_dq,
        attention_bwd_dq_plain, attention_delta, attention_fwd_lse,
        attention_fwd_plain)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen,
                      device="cuda").to(dtype)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, -1))
    do = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
    (out, lse), fwd_name = launched(lambda: attention_fwd_lse(q, k, v))
    out_p, lse_p = attention_fwd_plain(q, k, v, None, True, return_lse=True)
    delta = attention_delta(do, out)
    dq, dq_name = launched(lambda: attention_bwd_dq(q, k, v, do, lse, delta))
    dq_p = attention_bwd_dq_plain(q, k, v, do, lse, delta)
    (dk, dv), dkv_name = launched(
        lambda: attention_bwd_dkv(q, k, v, do, lse, delta))
    dk_p, dv_p = attention_bwd_dkv_plain(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    elt = q.element_size()
    pairs = b * h * s * (s + 1) / 2          # admitted (row, key) pairs
    tensor = b * s * h * d * elt             # one (B, S, H, D) tensor
    stats = b * h * s * 4                    # one (B, H, S) fp32 tensor
    # library yardsticks: SDPA causal forward, and its backward (dq, dk,
    # dv together) from a recorded forward, on (B, H, S, D) views
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    do_t = do.transpose(1, 2)
    lib_fwd = graph_ms(lambda: F.scaled_dot_product_attention(
        qt.detach(), kt.detach(), vt.detach(), is_causal=True))
    # the backward cannot be captured in a graph apart from its forward:
    # its device time comes from the profiler's kernel events instead
    def sdpa_bwd():
        return torch.autograd.grad(o_lib, (qt, kt, vt), do_t,
                                   retain_graph=True)

    eager_bwd = cuda_ms(sdpa_bwd, 10)
    lib_bwd = sum(device_times(sdpa_bwd, 10).values())
    log(f"[kernels] library SDPA backward [{b}x{s}x{h}x{d} {dtype}]: "
        f"device {lib_bwd:.4f} ms, eager call {eager_bwd:.4f} ms")
    label = f"{b}x{s}x{h}x{d} {dname}"
    fwd_src = "dpu_operator_tpu_torch/csrc/flash_attention_fwd.cu"
    bwd_src = "dpu_operator_tpu_torch/csrc/flash_attention_bwd.cu"
    specs = [
        (fwd_name, fwd_src, ":81",
         {"out": (out, out_p), "lse": (lse, lse_p)},
         lambda: attention_fwd_lse(q, k, v),
         lambda: attention_fwd_plain(q, k, v, None, True, return_lse=True),
         4 * tensor + stats, 4.0 * pairs * d, lib_fwd),
        (dq_name, bwd_src, ":169", {"dq": (dq, dq_p)},
         lambda: attention_bwd_dq(q, k, v, do, lse, delta),
         lambda: attention_bwd_dq_plain(q, k, v, do, lse, delta),
         5 * tensor + 2 * stats, 6.0 * pairs * d, lib_bwd),
        (dkv_name, bwd_src, ":210",
         {"dk": (dk, dk_p), "dv": (dv, dv_p)},
         lambda: attention_bwd_dkv(q, k, v, do, lse, delta),
         lambda: attention_bwd_dkv_plain(q, k, v, do, lse, delta),
         6 * tensor + 2 * stats, 8.0 * pairs * d, lib_bwd),
    ]
    cases = []
    for name, src, line, outs, fn, plain, nbytes, flops, lib in specs:
        errs = {k: scaled_err(g, r) for k, (g, r) in outs.items()}
        log(f"[kernels] {name}[{label}] per output: " + "; ".join(
            f"{k} max_abs_err {e[0]:.3g} scaled {e[1]:.3g} (plain: max "
            f"{float(outs[k][1].float().abs().max()):.3g}, rms "
            f"{float(outs[k][1].float().square().mean().sqrt()):.3g})"
            for k, e in errs.items()))
        bound, by = _bound(nbytes, flops, dname)
        cases.append({
            "name": f"{name}[{label}]", "kernel": name, "dtype": dname,
            "source": src,
            "replaces": "dpu_operator_tpu/ops/flash_attention.py" + line,
            "max_abs_err": max(e[0] for e in errs.values()),
            "scaled_err": max(e[1] for e in errs.values()),
            "ms": graph_ms(fn, reps=5, replays=4),
            "eager_ms": cuda_ms(fn, 5),
            "plain_ms": cuda_ms(plain, 2, warmup=1),
            "library_ms": lib, "bound_ms": bound, "bound_by": by})
    return cases


def _chunk_equals_whole(q, k, v, ck, cv) -> None:
    """The forward's invariant on the card: the 256-row chunk at offset
    256, over slot 3's cache row holding the prompt's K / V, equals rows
    256-511 of the whole 512-row prefill under ``torch.equal``."""
    import torch
    from dpu_operator_tpu_torch.ops import attention_fwd
    p = q.shape[1]
    whole, kernel = launched(lambda: attention_fwd(q, k, v))
    ck[3, :p], cv[3, :p] = k[0], v[0]
    off = torch.full((1,), 256, dtype=torch.int32, device="cuda")
    part, kernel_c = launched(lambda: attention_fwd(q[:, 256:p], ck[3:4],
                                                    cv[3:4], off))
    torch.cuda.synchronize()
    same = torch.equal(part, whole[:, 256:p])
    log(f"[kernels] chunk 256@256 ({kernel_c}) equals rows 256-{p - 1} of "
        f"the whole prefill ({kernel}) bit for bit: {same}")
    require(same, "the chunk at offset 256 differs from the whole prefill")


def _decode_row_alone(q, ck, cv, pos) -> None:
    """The decode kernels' invariant on the card: slot 0's row launched
    alone (B = 1) equals its row of the 8-slot launch under ``torch.equal``,
    and a second launch gives the same output. Also the kernels against
    the plain split-and-combine (the same chunk maxima)."""
    import torch
    from dpu_operator_tpu_torch.ops import (attention_decode_plain,
                                            attention_fwd)
    batch, kernel = launched(lambda: attention_fwd(q, ck, cv, pos))
    one = attention_fwd(q[:1], ck[:1], cv[:1], pos[:1])
    again = attention_fwd(q, ck, cv, pos)
    torch.cuda.synchronize()
    same, repeat = torch.equal(one, batch[:1]), torch.equal(again, batch)
    _, err = scaled_err(batch, attention_decode_plain(q, ck, cv, pos))
    log(f"[kernels] decode ({kernel}): slot 0 alone equals its row of the "
        f"{q.shape[0]}-slot launch bit for bit: {same}; a second launch "
        f"equal: {repeat}; scaled error against the plain split {err:.3g}")
    require(same, "slot 0's decode row differs between B = 1 and the "
            "8-slot launch")
    require(repeat, "two decode launches on the same inputs differ")
    require(err <= TOL["bfloat16"], f"decode vs the plain split: {err:.3g}")


def phase_kernels(cfg) -> list:
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    bf16, f32 = torch.bfloat16, torch.float32
    d = cfg.d_model
    cases = [_rms_case(gen, rows, d, dt)
             for rows, dt in ((8, bf16), (256, bf16), (512, bf16),
                              (8, f32), (512, f32))]
    h, dh, s_max = cfg.n_heads, cfg.d_head, cfg.max_seq

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf16)

    # prefill: one 512-token prompt, causal from position 0
    q, k, v = rnd(1, 512, h, dh), rnd(1, 512, h, dh), rnd(1, 512, h, dh)
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    shape = f"{h}x{dh}"
    cases.append(_attn_case(gen, f"prefill 1x512x{shape}", q, k, v, zero))
    # the same prompt in fp32: the tiled CUDA-core kernel (fp32 serving)
    cases.append(_attn_case(gen, f"prefill 1x512x{shape} float32", q.float(),
                            k.float(), v.float(), zero))
    # chunk: 256 queries at offset 256 against one slot's row of the cache
    ck, cv = rnd(8, s_max, h, dh), rnd(8, s_max, h, dh)
    qc = rnd(1, 256, h, dh)
    off = torch.full((1,), 256, dtype=torch.int32, device="cuda")
    cases.append(_attn_case(gen, f"chunk 1x256x{shape}@256 vs slot row of "
                            f"8x{s_max}",
                            qc, ck[3:4], cv[3:4], off))
    # decode: 8 slots x 1 query against the whole cache, random positions
    qd = rnd(8, 1, h, dh)
    pos = torch.randint(0, s_max, (8,), generator=gen, device="cuda",
                        dtype=torch.int32)
    cases.append(_attn_case(gen, f"decode 8x1 vs 8x{s_max}x{shape}", qd, ck, cv,
                            pos))
    # decode at the serve profile's shape: 8 slots at position 511
    p511 = torch.full((8,), 511, dtype=torch.int32, device="cuda")
    cases.append(_attn_case(gen, f"decode 8x1@511 vs 8x{s_max}x{shape}", qd,
                            ck, cv, p511))
    _decode_row_alone(qd, ck, cv, pos)
    _chunk_equals_whole(q, k, v, ck, cv)
    # training: the flagship's train batch, one of its sequences, and a
    # ragged length; then head dim 64 (the n64 products) at one and two
    # warpgroups a block
    for b, s, hd, dt in ((8, s_max, dh, bf16), (1, s_max, dh, bf16),
                         (1, 1000, dh, bf16), (1, s_max, dh, f32),
                         (1, 1000, dh, f32), (1, 1000, 64, bf16),
                         (2, s_max, 64, bf16)):
        cases.extend(_train_cases(gen, b, s, h, hd, dt))
    for c in cases:
        log(f"[kernels] {c['name']}: max_abs_err {c['max_abs_err']:.3g} "
            f"(scaled {c['scaled_err']:.3g}, tol {TOL[c['dtype']]}) "
            f"kernel {c['ms']:.4f} ms (eager call {c['eager_ms']:.4f} ms) "
            f"plain {c['plain_ms']:.4f} ms "
            f"library {c['library_ms']:.4f} ms bound {c['bound_ms']:.4f} ms "
            f"({c['bound_by']})")
    for c in cases:
        require(c["scaled_err"] <= TOL[c["dtype"]],
                f"{c['name']} disagrees with its plain version: scaled error "
                f"{c['scaled_err']:.3g} > {TOL[c['dtype']]}")
    return cases


# -- phase 4 ------------------------------------------------------------------
def _serve(params, cfg, reqs, slots: int, chunk: int, device: str,
           executor_cls=None, clock=None):
    from dpu_operator_tpu_torch.workloads.serve import (
        Scheduler, ServeConfig, TorchSlotExecutor)
    cls = executor_cls or TorchSlotExecutor
    ex = cls(params, cfg, slots=slots, chunk_tokens=chunk, device=device)
    blocks = slots * cfg.max_seq // 16
    sched = Scheduler(ServeConfig(slots=slots, kv_blocks=blocks,
                                  kv_block_size=16,
                                  prefill_chunk_tokens=chunk),
                      ex, clock=clock)
    for r in reqs:
        r.arrival_s = sched.now  # all arrive at once, on the run's clock
        sched.submit(r)
    sched.run()
    return sched, ex


def _requests(rng, n: int, vocab: int, plen: tuple, olen: tuple) -> list:
    from dpu_operator_tpu_torch.workloads.serve import Request
    out = []
    for i in range(n):
        p = int(rng.integers(plen[0], plen[1] + 1))
        prompt = tuple(int(t) for t in rng.integers(0, vocab, p))
        out.append(Request(rid=f"req-{i:02d}", prompt_len=p,
                           output_len=int(rng.integers(olen[0],
                                                       olen[1] + 1)),
                           prompt=prompt))
    return out


def phase_cpu_parity() -> None:
    import torch
    from dpu_operator_tpu_torch.workloads.decode import generate
    from dpu_operator_tpu_torch.workloads.model import (
        TransformerConfig, forward, init_params)
    cfg = TransformerConfig(vocab=512, d_model=256, n_heads=4, n_layers=2,
                            d_ff=512, max_seq=128, dtype=torch.float32)
    p_cpu = init_params(7, cfg, device="cpu")
    p_gpu = {k: (v.cuda() if torch.is_tensor(v)
                 else [{n: t.cuda() for n, t in lp.items()} for lp in v])
             for k, v in p_cpu.items()}
    rng = np.random.default_rng(7)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)))
    s_cpu = generate(p_cpu, cfg, prompt, 32, device="cpu")
    s_gpu = generate(p_gpu, cfg, prompt, 32, device="cuda").cpu()
    require(torch.equal(s_cpu, s_gpu),
            f"fp32 greedy streams differ card vs CPU:\n{s_cpu}\n{s_gpu}")
    l_cpu = forward(p_cpu, prompt, cfg)
    l_gpu = forward(p_gpu, prompt, cfg).cpu()
    err = float((l_cpu - l_gpu).abs().max())
    log(f"[parity] tiny fp32: 2x32 greedy tokens equal card vs CPU; "
        f"forward logits max |diff| {err:.3g} (tol 1e-3)")
    require(err <= 1e-3, f"fp32 logits card vs CPU differ by {err}")
    reqs = _requests(rng, 6, cfg.vocab, (5, 60), (4, 24))
    sched, ex = _serve(p_gpu, cfg, reqs, slots=2, chunk=16, device="cuda")
    require(len(sched.completed) == len(reqs), "tiny serve incomplete")
    for r in reqs:
        want = generate(p_gpu, cfg, torch.tensor([r.prompt]), r.output_len,
                        device="cuda")[0].tolist()
        require(r.tokens == want, f"tiny fp32 serve {r.rid}: stream "
                f"{r.tokens} != generate {want}")
    require(sched.pool.outstanding() == 0, "tiny serve leaked KV blocks")
    log(f"[parity] tiny fp32 serve on the card: {len(reqs)} requests on 2 "
        "slots, chunk 16, every stream equals generate")
    _train_parity(cfg, p_cpu)


def _train_parity(cfg, p_cpu) -> None:
    """One fp32 train step of the tiny config on the card and on the CPU
    from the same weights and batch: loss within 1e-4, every gradient leaf
    within 1e-4 (:func:`scaled_err` against the CPU's)."""
    import dataclasses
    from dpu_operator_tpu_torch.workloads.model import make_example_batch
    from dpu_operator_tpu_torch.workloads.train import (make_train_step,
                                                        param_leaves)
    cfg = dataclasses.replace(cfg, attention="flash")
    batch = make_example_batch(cfg, batch=2)
    out = {}
    for dev in ("cpu", "cuda"):
        step, init_state, place = make_train_step(cfg, device=dev)
        params, opt = init_state(params=p_cpu)
        _, _, loss = step(params, opt, place(batch))
        out[dev] = (float(loss), [p.grad.cpu() for p in param_leaves(params)])
    loss_err = abs(out["cuda"][0] - out["cpu"][0])
    grad_err = max(scaled_err(a, b)[1]
                   for a, b in zip(out["cuda"][1], out["cpu"][1]))
    log(f"[parity] tiny fp32 train step card vs CPU: loss {out['cpu'][0]:.6f}"
        f" |diff| {loss_err:.3g}; worst gradient leaf scaled error "
        f"{grad_err:.3g} over {len(out['cpu'][1])} leaves (tol 1e-4)")
    require(loss_err <= 1e-4, f"train loss card vs CPU differs by {loss_err}")
    require(grad_err <= 1e-4, f"a gradient leaf differs card vs CPU by "
            f"{grad_err}")


# -- phase 5 ------------------------------------------------------------------
def phase_serve(cfg, params) -> dict:
    import torch
    from dpu_operator_tpu_torch.ops import launch_counts, reset_launch_counts
    from dpu_operator_tpu_torch.workloads.decode import generate
    from dpu_operator_tpu_torch.workloads.model import forward, param_bytes
    from dpu_operator_tpu_torch.workloads.serve import TorchSlotExecutor

    kv_row_bytes = 2 * cfg.n_layers * cfg.n_heads * cfg.d_head * 2

    class TimedExecutor(TorchSlotExecutor):
        """Wall time of each decode iteration (it ends in a host copy,
        so the host clock sees the device's work) and the KV bytes its
        attention reads."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.iters: list = []

        def step(self, active):
            keys = int(np.sum(np.minimum(
                np.clip(self.pos, 0, self.cfg.max_seq - 1) + 1,
                self.cfg.max_seq)))
            t0 = time.perf_counter()
            out = super().step(active)
            self.iters.append((time.perf_counter() - t0, keys * kv_row_bytes))
            return out

    wbytes = param_bytes(params)
    rng = np.random.default_rng(2026)
    reqs = _requests(rng, 16, cfg.vocab, (128, 512), (32, 64))
    # warm-up outside the counted run (library handles, allocator)
    generate(params, cfg, torch.tensor([reqs[0].prompt[:64]]), 4,
             device="cuda")
    torch.cuda.synchronize()

    reset_launch_counts()
    t0 = time.monotonic()
    sched, ex = _serve(params, cfg, reqs, slots=8, chunk=256, device="cuda",
                       executor_cls=TimedExecutor, clock=time.monotonic)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = launch_counts()
    log(f"[serve] launches during the serve run: {counts}")

    require(len(sched.completed) == 16 and not sched.failed
            and not sched.rejected,
            f"completed {len(sched.completed)} failed {len(sched.failed)} "
            f"rejected {len(sched.rejected)}")
    for r in reqs:
        require(len(r.tokens) == r.output_len,
                f"{r.rid}: {len(r.tokens)} tokens, wanted {r.output_len}")
        require(all(0 <= t < cfg.vocab for t in r.tokens),
                f"{r.rid}: token out of vocab")
    require(sched.pool.outstanding() == 0, "KV blocks leaked")
    for name in SERVE_KERNELS:
        require(counts[name] > 0,
                f"kernel {name} never launched on the serving path")
    for name in SERVE_NOT:
        require(counts[name] == 0, f"{name} launched {counts[name]} times on "
                "the bf16 serving path (its work belongs to the tensor cores)")

    # two streams against generate and a teacher-forced forward
    for r in (reqs[0], reqs[9]):
        want = generate(params, cfg, torch.tensor([r.prompt]),
                        r.output_len, device="cuda")[0].tolist()
        same = next((i for i, (a, b) in enumerate(zip(r.tokens, want))
                     if a != b), len(want))
        seq = torch.tensor([list(r.prompt) + r.tokens[:-1]], device="cuda")
        logits = forward(params, cfg=cfg, tokens=seq)[0, r.prompt_len - 1:]
        served = torch.tensor(r.tokens, device="cuda")
        margin = logits.max(-1).values - logits.gather(
            1, served[:, None])[:, 0]
        worst = float(margin.max())
        log(f"[serve] {r.rid} (prompt {r.prompt_len}, {r.output_len} "
            f"tokens): equals generate for {same}/{len(want)} tokens; "
            f"worst teacher-forced margin {worst:.4f} "
            f"(tol {SERVE_LOGIT_TOL})")
        require(worst <= SERVE_LOGIT_TOL,
                f"{r.rid}: a served token is {worst:.4f} below the best "
                "logit of a full forward")
        if same < len(want):
            log(f"[serve] {r.rid}: first difference at token {same} is a "
                "bf16 near-tie (both tokens within tolerance of the best)")

    gen_tokens = sum(len(r.tokens) for r in reqs)
    ttfts = sorted(r.ttft_s for r in reqs)
    dec = np.array([t for t, _ in ex.iters])
    kvb = np.array([b for _, b in ex.iters], dtype=np.float64)
    hbm = card_peaks()["hbm_bytes_per_s"]
    bound = (wbytes + kvb) / hbm
    full_bound = (wbytes + 8 * cfg.max_seq * kv_row_bytes) / hbm
    out = {
        "requests": 16, "slots": 8, "chunk": 256,
        "generated_tokens": gen_tokens, "wall_s": wall,
        "tokens_per_s": gen_tokens / wall,
        "ttft_p50_s": ttfts[len(ttfts) // 2],
        "ttft_max_s": ttfts[-1],
        "decode_iterations": len(dec),
        "decode_ms_mean": float(dec.mean() * 1e3),
        "decode_ms_p50": float(np.median(dec) * 1e3),
        "decode_bound_ms_mean": float(bound.mean() * 1e3),
        "decode_bound_ms_full_cache": full_bound * 1e3,
        "prefill_chunks": sched.prefill_chunks_total,
        "iterations": sched.iterations, "launches": counts,
    }
    log(f"[serve] {gen_tokens} tokens in {wall:.3f} s = "
        f"{out['tokens_per_s']:.1f} tokens/s; TTFT p50 "
        f"{out['ttft_p50_s'] * 1e3:.1f} ms (max "
        f"{out['ttft_max_s'] * 1e3:.1f} ms); decode {len(dec)} iterations, "
        f"mean {out['decode_ms_mean']:.3f} ms p50 "
        f"{out['decode_ms_p50']:.3f} ms vs bound "
        f"{out['decode_bound_ms_mean']:.3f} ms (this run's weights + KV "
        f"read; {full_bound * 1e3:.3f} ms with all 8 caches full)")
    log("[serve] " + json.dumps(out))
    return out


def profile_window(params, cfg) -> None:
    """Where a serving iteration's time goes at the flagship shape: the
    device's busy time (torch.profiler's kernel times) per decode
    iteration of 8 slots holding 512-token prompts and per 256-token
    prefill chunk, beside the same work's wall time without the profiler.
    A measurement, not a check: prints "not measured" when the profiler
    sees no device time."""
    from dpu_operator_tpu_torch.workloads.serve import (Request,
                                                        TorchSlotExecutor)
    ex = TorchSlotExecutor(params, cfg, slots=8, chunk_tokens=256,
                           device="cuda")
    rng = np.random.default_rng(99)
    active = []
    for slot in range(8):
        ids = tuple(int(t) for t in rng.integers(0, cfg.vocab, 512))
        req = Request(rid=f"p{slot}", prompt_len=512, output_len=64,
                      prompt=ids)
        ex.prefill_chunk(req, slot, 0, 256)
        ex.prefill_chunk(req, slot, 256, 256)
        active.append((slot, req))
    work = {"decode iteration (8 slots)": lambda: ex.step(active),
            "prefill chunk (256 tokens)":
                lambda: ex.prefill_chunk(active[0][1], 0, 0, 256)}
    for label, fn in work.items():
        profile_calls(label, fn, 10)


def device_times(fn, n: int) -> dict:
    """Device milliseconds per call of *fn* by kernel name, from
    torch.profiler over *n* calls. Device-side events only (kernels,
    copies: they have no CPU time); an aten op also reports its kernels'
    time as its own "self" device time, and a user annotation (such as
    ``Optimizer.step``) spans the kernels inside it, so neither is
    counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by_kernel: dict = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0 and e.self_cpu_time_total == 0 \
                and not getattr(e, "is_user_annotation", False):
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / n / 1e3
    return by_kernel


def profile_calls(label: str, fn, n: int, warmup: int = 3) -> None:
    """Wall time per call of *fn* without the profiler, then the device's
    busy time per call (:func:`device_times`), its idle share and the
    largest device items. A measurement, not a check: prints "not
    measured" when the profiler sees no device time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    try:
        by_kernel = device_times(fn, n)
    except RuntimeError as e:
        log(f"[profile] {label}: wall {wall_ms:.3f} ms; device busy "
            f"not measured (profiler failed: {e})")
        return
    busy_ms = sum(by_kernel.values())
    if busy_ms <= 0:
        log(f"[profile] {label}: wall {wall_ms:.3f} ms; device busy "
            "not measured (the profiler saw no device time)")
        return
    log(f"[profile] {label}: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, device idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    for name, ms in top:
        log(f"[profile]   {ms:8.4f} ms/call  {name[:90]}")


# -- phase 6 ------------------------------------------------------------------
def phase_train(cfg) -> dict:
    """The flagship's training path: ``measure_train`` (1 warm-up and 5
    timed steps at batch 8 x 1024) with the launch counters read around
    it, then the gradient guard and one profiled step on a fresh state."""
    import torch
    from dpu_operator_tpu_torch.ops import launch_counts, reset_launch_counts
    from dpu_operator_tpu_torch.workloads.model import make_example_batch
    from dpu_operator_tpu_torch.workloads.perf import (FLAGSHIP_BATCH,
                                                       measure_train)
    from dpu_operator_tpu_torch.workloads.train import (make_train_step,
                                                        param_leaves)
    steps = 5
    reset_launch_counts()
    perf = measure_train(cfg, batch=FLAGSHIP_BATCH, steps=steps,
                         device="cuda")
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"[train] launches during the train run ({steps + 1} steps): "
        f"{counts}")
    losses = perf.losses
    mfu = "not known" if perf.mfu is None else f"{perf.mfu:.4f}"
    log(f"[train] flagship bf16 batch {FLAGSHIP_BATCH}x{cfg.max_seq}: "
        f"step {perf.step_ms:.2f} ms, {perf.tokens_per_s:.0f} tokens/s, "
        f"{perf.model_tflops:.2f} model TFLOP/s, MFU {mfu} (peak "
        f"{perf.peak_tflops} TFLOP/s, {perf.device}), peak memory "
        f"{perf.peak_memory_bytes / 1e9:.2f} GB; losses "
        + ", ".join(f"{x:.4f}" for x in losses))
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for name in TRAIN_KERNELS:
        require(counts[name] == cfg.n_layers * (steps + 1),
                f"{name} launched {counts[name]} times, wanted "
                f"{cfg.n_layers} a step")
    for name in TRAIN_NOT:
        require(counts[name] == 0, f"{name} launched {counts[name]} times in "
                "the bf16 train run (its work belongs to the tensor cores)")
    require(counts["fused_rmsnorm"] == (2 * cfg.n_layers + 1) * (steps + 1),
            f"fused_rmsnorm launched {counts['fused_rmsnorm']} times")

    # the guard against gradients that stop at a kernel: every leaf
    step, init_state, place = make_train_step(cfg, device="cuda")
    params, opt = init_state(1)
    batch = place(make_example_batch(cfg, batch=FLAGSHIP_BATCH))
    step(params, opt, batch)
    leaves = param_leaves(params)
    for i, p in enumerate(leaves):
        require(p.grad is not None, f"parameter leaf {i} got no gradient")
        require(bool(torch.isfinite(p.grad).all()),
                f"parameter leaf {i} has a non-finite gradient")
        require(float(p.grad.abs().max()) > 0,
                f"parameter leaf {i} has an all-zero gradient")
    log(f"[train] all {len(leaves)} gradient leaves finite and non-zero")
    profile_calls(f"train step (batch {FLAGSHIP_BATCH}x{cfg.max_seq})",
                  lambda: step(params, opt, batch), 2, warmup=1)
    out = {"step_ms": perf.step_ms, "tokens_per_s": perf.tokens_per_s,
           "model_tflops": perf.model_tflops, "mfu": perf.mfu,
           "peak_memory_gb": perf.peak_memory_bytes / 1e9,
           "losses": losses, "launches": counts}
    log("[train] " + json.dumps(out))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dpu_operator_tpu_torch.workloads.model import (
        flagship_config, init_params, param_bytes)

    t_start = time.monotonic()
    dev = phase_device()
    phase_build()
    cfg = flagship_config()
    cases = phase_kernels(cfg)
    phase_cpu_parity()
    t0 = time.monotonic()
    params = init_params(0, cfg, device="cuda")
    torch.cuda.synchronize()
    wbytes = param_bytes(params)
    log(f"[serve] flagship bf16: {wbytes / 2 / 1e6:.1f}M parameters, "
        f"{wbytes / 1e6:.1f} MB, made on the card in "
        f"{time.monotonic() - t0:.1f} s")
    counts = phase_serve(cfg, params)["launches"]  # the serve run's
    profile_window(params, cfg)
    del params
    torch.cuda.empty_cache()
    train_counts = phase_train(cfg)["launches"]
    # each kernel's launches on the two main paths, each read from zero
    counts = {k: counts[k] + train_counts[k] for k in counts}
    kernels = [{
        "name": c["name"], "route": "cuda", "source": c["source"],
        "replaces": c["replaces"], "launches": counts[c["kernel"]],
        "max_abs_err": c["max_abs_err"], "ms": c["ms"],
        "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"], "library_ms": c["library_ms"],
    } for c in cases]
    log(f"[done] all phases passed in {time.monotonic() - t_start:.1f} s "
        f"on {dev['smi']}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
