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
   least time the card could take (its bound). bf16 takes the tensor-core
   kernels (D 64 at 1x1000 and 2x1024, D 32 padded to 64 at 1x1000), fp32
   the 3xTF32 forward, dQ and dK/dV on the tensor cores, one query row the
   decode kernels split over keys (the fp32 prefill and training cases log
   the earlier CUDA-core design's time beside the new one); a 256-row chunk
   at offset 256 must equal rows 256-511 of the whole
   512-row prefill bit for bit, in bf16 and in fp32, and slot 0's decode row
   launched alone must equal
   its row of the 8-slot launch bit for bit; speculative verify's shape (8
   slots x 5 rows at random positions) and the flash bench's (4 x 2048 x
   8 x 128, causal) take the tensor-core forward. Over
   the same cache quantized to int8 (KV8), the decode and verify shapes
   take the KV8 cluster kernel and the 256-row chunk the KV8 tensor-core
   kernel in bf16 (fp32: the cluster kernel, and the fp32 KV8 kernel on the
   tensor cores for the chunk; the chunk also at head dims 16 and 32, bf16
   padded to 64), each held to ``attention_kv8_plain`` beside the earlier
   design's time (slot 0's KV8 decode row alone equals its row of the
   8-slot launch, each verify row equals a one-row launch at its position,
   and the fp32 KV8 chunk equals the whole KV8 prefill's rows bit for
   bit); the W8A8 products at the decode shapes are timed beside the
   bf16 GEMMs. Then every route again at head dim 256 (the flagship's
   d_model over 6 heads of 256): prefill, chunk, decode (bf16 and fp32),
   verify, the training batch (bf16) and one fp32 sequence, and over the
   KV8 cache decode, verify and chunk in both types, with the same
   invariants (the chunk equals the whole prefill in bf16 and fp32, a
   decode row and a KV8 verify row equal their one-row launches);
4. port on the card against port on the CPU (tiny fp32 config): greedy
   streams equal, logits close; then a tiny fp32 serve on the card whose
   streams equal ``generate``; then a tiny fp32 serve that speculates
   (oracle drafts, the last one corrupted) and preempts a batch request
   mid-speculation, every stream equal to ``generate``; then verify over a
   KV8 cache (bf16-free and W8A8 weights) with corrupted oracle drafts,
   its stream equal to ``generate(kv_int8=True)``; then one tiny fp32
   train step whose loss and gradients match the CPU's; then the port's
   default ``TransformerConfig()`` (head dim 16, which every kernel takes
   zero-padded): in fp32 greedy streams equal, logits close, a serve whose
   streams equal ``generate`` and one train step matching the CPU's; in
   bf16 forward logits close to the CPU's; last a KV8 chunked prefill of
   the tiny fp32 model (the fp32 KV8 kernel) and 8 decode steps, tokens
   equal to the CPU's. The phase's launches are counted from 0 (the fp32
   kernels' launches on the kernels' line);
5. serve the flagship (bf16, about 391M parameters, random weights from a
   seed) through ``Scheduler`` and ``TorchSlotExecutor``: 16 requests on 8
   slots with chunked prefill; every kernel of the path must have launched,
   every multi-row attention launch on the tensor cores. Then the same 16
   requests twice more with speculation (k = 4): drafted by prompt lookup
   (``NgramDrafter``), and by an oracle fed the plain run's streams with
   the last draft of each proposal corrupted; verify must run on the
   tensor-core forward, and each run is reported beside the plain one;
6. serve the same requests under faults, on the scheduler's virtual clock,
   through ``ChaosExecutor(TorchSlotExecutor(...))``: (a) plain decode
   under a prefill Oom, a decode-step reset, a poisoned rid, a deadline
   missed at admission, one missed mid-stream, a cancel and late batch
   arrivals the degradation ladder sheds, its trace equal entry for entry
   to the same run over a host ``SimExecutor``; (b) speculation at k = 4
   with the oracle drafter, four verify faults in a row walking the ladder
   to ``no_spec``, after which no verify may run. Every executor
   exception must be one the plan injected (or the poisoned rid's), every
   completed stream must hold to the plain run's, no block may leak;
7. train the flagship (bf16, batch 8 x 1024 tokens) through
   ``make_train_step`` and ``measure_train``: 1 warm-up and 5 timed AdamW
   steps, loss finite and falling, every gradient leaf finite and not all
   zero, the three training kernels launched 12 times a step, all on the
   tensor cores; one profiled step shows where the device time goes;
8. the quantized serving path of the flagship: ``quantize_decode_params``
   on the card, W8A8 prefill logits correlated above 0.99 with bf16, a
   W8A8 + KV8 stream's agreement with bf16 (reported), a decode_step loop
   equal to ``generate(kv_int8=True)``, a KV8 chunked prefill that
   decodes; ``measure_decode``'s rows B1 bf16, B1 W8A8 and B8 W8A8 + KV8;
   phase 5's requests served on the W8A8 tree between two bf16 runs; the
   KV8 cluster and tensor-core kernels must launch; a profile of the
   quantized decode iterations;
9. measurement and calibration of the flagship: ``calibrate_cost_model``
   three times (every field finite and positive, each fit beside the JAX
   defaults, the spread), the chunk budget of ``chunked_config``, the
   virtual-clock ``bench_serving`` over the first fit (no block leaked),
   then ``wall_open_loop``: ``open_loop_arrivals`` at 0.8 of the modelled
   capacity over 10 s of virtual time (seeded prompt ids) through
   ``run_open_loop`` over ``TorchSlotExecutor``: its record must equal a
   ``SimExecutor`` run's
   key for key, RMSNorm, the tensor-core forward and split decode must
   launch, no block may leak and the first 4 completed streams must hold
   to the teacher-forced margin; it is reported in wall tokens/s beside
   the virtual ones. Last ``measure_flash_attention`` at 4 x 2048 x 8 x
   128 bf16 causal beside SDPA and the bound (phase 3 holds the kernel
   against its plain version at that shape);
10. the flagship at head dim 256 (``flagship_config()`` with 6 heads of
   256: the same 391.7M parameters, bf16, random weights from a seed):
   6 requests served on 4 slots with chunked prefill through
   ``Scheduler.step``, every served token within the teacher-forced margin,
   then 3 on one slot without chunks (``generate``'s shapes), every stream
   equal to ``generate``; a W8A8 + KV8 decode_step loop equal to
   ``generate(kv_int8=True)`` and a KV8 chunked prefill that decodes; two
   AdamW steps at batch 8 x 1024 (losses finite, every gradient leaf finite
   and non-zero); a tiny fp32 config at head dim 256 on the card against
   the CPU as phase 4 holds the default config, with a KV8 chunked prefill.
   Every route of head dim 256 must launch in this phase; its counts are
   the head-dim-256 cases' launches on the kernels' line;
11. serve over the wire (run after phase 6, on phase 5's flagship):
   ``DecodeService`` over ``Scheduler(clock=time.monotonic)`` and the
   flagship's ``TorchSlotExecutor`` (8 slots, chunks of 256), its
   ``start_http`` ingress and a ``MetricsServer`` carrying its
   ``/debug/serve*`` handlers; phase 5's 16 requests, each POSTed by its
   own client thread at once (one with a caller ``traceparent``): every
   stream equal to phase 5's plain stream of its rid, one token a chunk,
   the ledger reconciled on the host clock, the token counter's delta
   equal to the tokens generated, the three endpoints answering with all
   8 slots free at the end, the traced request's phase spans on its trace
   id; then a 17th client hangs up after its first token and its request
   must be cancelled (slot and blocks back); no fault, ``stop()`` within
   5 s. ``DecodeService.start`` arms the sampling profiler and the
   metrics history: ``/debug/profile`` must have sampled the step loop's
   thread, ``/debug/history`` must hold the serving families' series (TTFT
   and ITL quantiles among them) with a sample each, the digest's
   ``trendAnomalies`` must be a list. Prints wire TTFT p50 / p99, wire
   tokens/s beside phase 5's plain tokens/s and TTFT, the ledger's mean ms
   per phase, the profiler's overhead ratio and the step loop's top three
   sites;
12. MoE (run last): the flagship with 8 experts (every second layer's FFN
   a top-1 mixture, about 1.18B parameters, bf16, random weights from a
   seed): (a) the tiny fp32 MoE of tests/test_decode.py on the card
   against the CPU (streams equal, logits close, a served run equal to
   ``generate``); (b) phase 5's 16 requests at capacity factor 8, each
   stream equal to ``generate`` or off at a bf16 near-tie within the
   teacher-forced margin; (c) the same twice at the default 1.25, every
   request complete, no block leaked, the two runs' streams equal, and a
   profiled decode iteration beside the dense flagship's; (d) a W8A8 +
   KV8 decode loop over the MoE tree (experts unquantized) equal to
   ``generate(kv_int8=True)``, W8A8 prefill logits correlated above 0.99
   with bf16; (e) ``measure_train`` at batch 8 x 1024 (a warm-up and two
   timed steps, loss falling, MFU from active parameters) and one step
   whose every gradient leaf is finite and non-zero, the routers
   included. Its launches join the kernels' line.
13. sharded train on a one-rank mesh (run last), as a lone pod runs the
   dp/tp/sp-sharded step: ``initialize_from_operator_env({})`` does
   nothing and ``make_mesh`` forms a one-rank NCCL group; (a) the four
   collectives on a 64 MB fp32 payload, each output equal to its input,
   and the three ``measure_*`` results, labelled one rank (no link
   crossed); (b) the fp32 2-layer model 3 steps sharded against the
   one-device step (losses within 1e-4 relative, parameters within 3 x
   lr); (c) ``measure_train(cfg, mesh)`` of the flagship with
   ``sequence_parallel`` on: the loss falls, the first 3 losses within
   1e-2 of phase 7's, the training kernels launched as in phase 7, the
   step's ms beside phase 7's. Its launches join the kernels' line.

A profile window between phases 6 and 7 shows where the time of a decode
iteration, a verify iteration and a prefill chunk goes. Phase 3 also times
an empty kernel, the card's floor for one launch.

The last two lines of standard output are the kernels' JSON line and the
device JSON line.

``python3 chip_smoke.py --time CASE ARGS`` runs phases 1-2 and times one
case (no other phase, no JSON lines): ``train B S H D DTYPE`` the training
path's three kernels at that shape, ``kv8-chunk H D DTYPE`` phase 3's KV8
chunk at H heads of head dim D. It uses the public wrappers alone, so the
same script run beside an older checkout of the package times that
checkout's kernels.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import sys
import time

import numpy as np

#: kernel vs plain: the largest :func:`scaled_err` of an output, per
#: dtype. fp32 differs only in summation order; bf16 also in where P, dS
#: and the output round (one bf16 step is 2^-8 to 2^-7 of a value). The
#: H100 readings at this script's shapes and seed: fp32 at most 4.9e-6 on
#: the CUDA cores (3xTF32: see PERF.md);
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
#: a speculating serve run: verify replaces decode wherever a row has drafts
#: (an oracle drafts on every iteration, so the decode kernels may not run)
SPEC_KERNELS = ("fused_rmsnorm", "attention_fwd_tc")
TRAIN_KERNELS = ("attention_fwd_lse_tc", "attention_bwd_dq_tc",
                 "attention_bwd_dkv_tc")
SERVE_NOT = ("attention_fwd_tf32",)
#: phase 9's flash bench shape (B, S, H, D), bf16 causal (bench.py's)
FLASH_BENCH = (4, 2048, 8, 128)
TRAIN_NOT = ("attention_fwd_lse_tf32", "attention_bwd_dq_tf32",
             "attention_bwd_dkv_tf32")
#: the fp32 and head-dim-32 cases' times under the earlier design (the
#: tiled CUDA-core forward and dK/dV kernels, which also took bf16 at head
#: dim 32; the CUDA-core dQ and tiled KV8 kernels, which also took bf16 KV8
#: chunks at head dim 16 / 32), us a launch under graph replay, NVIDIA H100
#: 80GB HBM3 at 700 W (PERF.md's kernel table; the head-dim-32 times from
#: ``--time train`` run over the checkout before the change; the dQ and KV8
#: times from this script, and its ``--time kv8-chunk`` at head dims 16 /
#: 32, run over the checkout before the change on the same card in turns
#: with the change: the mean of its two runs), by the case name
TF32_EARLIER_US = {
    "attention_fwd_tf32[prefill 1x512x12x128 float32]": 132.7,
    "attention_fwd_lse_tf32[1x1024x12x128 float32]": 334.8,
    "attention_fwd_lse_tf32[1x1000x12x128 float32]": 336.9,
    "attention_bwd_dkv_tf32[1x1024x12x128 float32]": 501.2,
    "attention_bwd_dkv_tf32[1x1000x12x128 float32]": 493.1,
    "attention_fwd_lse_tc[1x1000x12x32 bfloat16]": 95.6,
    "attention_bwd_dq_tc[1x1000x12x32 bfloat16]": 97.0,
    "attention_bwd_dkv_tc[1x1000x12x32 bfloat16]": 185.1,
    "attention_bwd_dq_tf32[1x1024x12x128 float32]": 393.2,
    "attention_bwd_dq_tf32[1x1000x12x128 float32]": 391.8,
    "attention_bwd_dq_tf32[1x1024x6x256 float32]": 652.9,
    "attention_kv8_tf32[chunk 1x256x12x128@256 vs slot row of 8x1024 "
    "float32]": 117.0,
    "attention_kv8_tf32[chunk 1x256x6x256@256 vs slot row of 8x1024 "
    "float32]": 185.8,
    "attention_kv8_tc[chunk 1x256x12x16@256 vs slot row of 8x1024]": 58.5,
    "attention_kv8_tf32[chunk 1x256x12x16@256 vs slot row of 8x1024 "
    "float32]": 58.5,
    "attention_kv8_tc[chunk 1x256x12x32@256 vs slot row of 8x1024]": 45.6,
    "attention_kv8_tf32[chunk 1x256x12x32@256 vs slot row of 8x1024 "
    "float32]": 45.4,
}


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


@functools.lru_cache(maxsize=None)
def _side_stream():
    """The one stream :func:`graph_ms` warms its calls on. cuBLAS keeps a
    workspace (32 MiB on Hopper) for every stream it has run on, for the
    life of the process: a new stream per call would pile them up (0.67 GB
    after phase 3's W8A8 products, read as the train phase's peak
    memory)."""
    import torch
    return torch.cuda.Stream()


def graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Device time per call: *reps* calls captured in one CUDA graph,
    replayed between two CUDA events, so no host launch cost is counted.
    Inputs stay where the previous call left them (L2-warm when they fit
    the 50 MB L2, as on the serving path, where each input was just
    written by the op before)."""
    import torch
    side = _side_stream()
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
    """This card's data-sheet rates (``perf.card_peaks``, the entry
    ``measure_decode`` and ``measure_flash_attention`` read): the bounds
    need them."""
    from dpu_operator_tpu_torch.workloads import perf
    try:
        return perf.card_peaks(0)
    except ValueError as e:
        raise PhaseError(str(e)) from e


# -- phase 1 ------------------------------------------------------------------
def phase_device() -> dict:
    import torch
    require(torch.cuda.is_available(), "no CUDA device")
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; devices {torch.cuda.device_count()}")
    from dpu_operator_tpu_torch.workloads.perf import nvidia_smi_line
    smi = nvidia_smi_line()
    require(smi is not None, "nvidia-smi failed or printed nothing")
    print(smi, flush=True)
    card_peaks()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"name": name, "smi": smi}


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
    """The least time (ms) for *nbytes* over HBM and *flops* at the rate of
    *dname*, the larger, and which one it is. ``"tf32xN"``: fp32-exact
    products as N TF32 products on the tensor cores (an N-th of the TF32
    rate), the fp32 attention kernels' work: three a product, two where one
    operand is exact in TF32 (int8 K and V)."""
    peaks = card_peaks()
    rate = peaks["tf32"] / int(dname[5:]) if dname.startswith("tf32x") \
        else peaks[dname]
    t_bytes = nbytes / peaks["hbm_bytes_per_s"] * 1e3
    t_ops = flops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _attn_bound(nbytes: float, flops: float, dname: str,
                products: int = 3) -> dict:
    """An attention case's bound: bf16 at the bf16 rate, fp32 at the TF32
    rate over *products* TF32 products a term, with (fp32) the bound at the
    CUDA cores' 67 TFLOP/s beside it (the earlier designs' yardstick)."""
    if dname != "float32":
        bound, by = _bound(nbytes, flops, dname)
        return {"bound_ms": bound, "bound_by": by}
    bound, by = _bound(nbytes, flops, f"tf32x{products}")
    return {"bound_ms": bound, "bound_by": by,
            "bound_cores_ms": _bound(nbytes, flops, "float32")[0]}


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
        "kernel": "fused_rmsnorm", "dtype": name, "head_dim": None,
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


def _launch_floor() -> float:
    """Device time of one launch of an empty kernel under the same
    graph replay as the kernels' times: the card's floor for a launch."""
    import torch
    from dpu_operator_tpu_torch.ops import _build
    lib = _build.library()

    def launch():
        _build.check(lib.launch_floor(torch.cuda.current_stream().cuda_stream),
                     "launch_floor")

    ms, eager = graph_ms(launch), cuda_ms(launch, 50)
    log(f"[kernels] empty kernel (the launch floor): {ms * 1e3:.2f} us a "
        f"launch under graph replay; eager call {eager * 1e3:.2f} us")
    return ms


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
    bound = _attn_bound((2 * b * sq * h * d + 2 * keys * h * d) * elt,
                        4.0 * pairs * h * d, dname)
    # library yardstick: SDPA in (B, H, S, D) views with the same mask
    rows = torch.as_tensor(pos_h, device="cuda")[:, None] \
        + torch.arange(sq, device="cuda")
    mask = (torch.arange(skv, device="cuda")[None, None, :]
            <= rows[:, :, None])[:, None]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    name = f"{kernel}[{label}]"
    return {
        "name": name, "kernel": kernel, "dtype": dname, "head_dim": d,
        "source": "dpu_operator_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "dpu_operator_tpu/ops/flash_attention.py:35",
        "max_abs_err": max_abs, "scaled_err": scaled,
        "earlier_us": TF32_EARLIER_US.get(name),
        "ms": graph_ms(lambda: attention_fwd(q, k, v, pos)),
        "eager_ms": cuda_ms(lambda: attention_fwd(q, k, v, pos), 20),
        "plain_ms": cuda_ms(lambda: attention_fwd_plain(q, k, v, pos), 3,
                            warmup=1),
        "library_ms": graph_ms(lib), **bound,
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
    require(torch.equal(dq, attention_bwd_dq(q, k, v, do, lse, delta)),
            f"two {dq_name} launches on the same inputs differ")
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
        cases.append({
            "name": f"{name}[{label}]", "kernel": name, "dtype": dname,
            "head_dim": d, "source": src,
            "replaces": "dpu_operator_tpu/ops/flash_attention.py" + line,
            "max_abs_err": max(e[0] for e in errs.values()),
            "scaled_err": max(e[1] for e in errs.values()),
            "earlier_us": TF32_EARLIER_US.get(f"{name}[{label}]"),
            "ms": graph_ms(fn, reps=5, replays=4),
            "eager_ms": cuda_ms(fn, 5),
            "plain_ms": cuda_ms(plain, 2, warmup=1),
            "library_ms": lib, **_attn_bound(nbytes, flops, dname)})
    return cases


def time_train(b: int, s: int, h: int, d: int, dname: str) -> None:
    """``--time train``: the training path's three kernels at (B, S, H, D)
    in *dname*, causal, each timed under graph replay as phase 3 times
    them, with the ``launch_counts`` name of the kernel each call took.
    Only the public wrappers: an older checkout's kernels time the same
    way."""
    import torch
    from dpu_operator_tpu_torch.ops import (attention_bwd_dkv,
                                            attention_bwd_dq,
                                            attention_delta,
                                            attention_fwd_lse)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    dtype = getattr(torch, dname)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen,
                      device="cuda").to(dtype)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, -1))
    do = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
    (out, lse), fwd = launched(lambda: attention_fwd_lse(q, k, v))
    delta = attention_delta(do, out)
    _, dq = launched(lambda: attention_bwd_dq(q, k, v, do, lse, delta))
    _, dkv = launched(lambda: attention_bwd_dkv(q, k, v, do, lse, delta))
    for name, fn in ((fwd, lambda: attention_fwd_lse(q, k, v)),
                     (dq, lambda: attention_bwd_dq(q, k, v, do, lse, delta)),
                     (dkv, lambda: attention_bwd_dkv(q, k, v, do, lse,
                                                     delta))):
        log(f"[time train] {name}[{b}x{s}x{h}x{d} {dname}]: kernel "
            f"{graph_ms(fn, reps=5, replays=4):.4f} ms under graph replay")


def _kv8_chunk_inputs(h: int, d: int, s_max: int) -> tuple:
    """Phase 3's KV8 chunk at H heads of head dim D, from a generator of its
    own: ``(q (1, 256, H, D) fp32, slot 3's row (k_q, k_s, v_q, v_s) of an
    8 x s_max int8 cache, the offset 256)``."""
    import torch
    from dpu_operator_tpu_torch.workloads.decode import _kv_quant
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    row = tuple(t[3:4] for t in (*_kv_quant(torch.randn(
        (8, s_max, h, d), generator=gen, device="cuda")), *_kv_quant(
        torch.randn((8, s_max, h, d), generator=gen, device="cuda"))))
    q = torch.randn((1, 256, h, d), generator=gen, device="cuda")
    return q, row, torch.full((1,), 256, dtype=torch.int32, device="cuda")


def time_kv8_chunk(h: int, d: int, dname: str) -> None:
    """``--time kv8-chunk``: phase 3's KV8 chunk (256 rows at offset 256
    over slot 3's row of an 8 x 1024 int8 cache) at H heads of head dim D in
    *dname*, timed under graph replay as phase 3 times it, with the
    ``launch_counts`` name of the kernel it took. Only the public wrapper:
    an older checkout's kernels time the same way."""
    import torch
    from dpu_operator_tpu_torch.ops import attention_fwd_kv8
    q, row, off = _kv8_chunk_inputs(h, d, 1024)
    q = q.to(getattr(torch, dname))
    _, name = launched(lambda: attention_fwd_kv8(q, *row, off))
    ms = graph_ms(lambda: attention_fwd_kv8(q, *row, off))
    log(f"[time kv8-chunk] {name}[chunk 1x256x{h}x{d}@256 vs slot row of "
        f"8x1024 {dname}]: kernel {ms:.4f} ms under graph replay")


def _chunk_equals_whole(q, k, v, ck, cv) -> None:
    """The forward's invariant on the card: the 256-row chunk at offset
    256, over slot 3's cache row holding the prompt's K / V, equals rows
    256-511 of the whole 512-row prefill under ``torch.equal``, in q's type
    (bf16: the tensor-core kernel; fp32: the 3xTF32 kernel)."""
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
    log(f"[kernels] chunk 256@256 ({kernel_c}, {q.dtype}) equals rows "
        f"256-{p - 1} of the whole prefill ({kernel}) bit for bit: {same}")
    require(same, f"the {q.dtype} chunk at offset 256 differs from the "
            "whole prefill")


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


#: the KV8 cases' times under the earlier design (PR 8's two-pass decode
#: kernels and the tiled KV8 kernel, us a launch under graph replay, NVIDIA
#: H100 80GB HBM3 at 700 W; PERF.md), by the case label's first word
KV8_EARLIER_US = {"decode": 22.4, "verify": 232.7, "chunk": 119.2}


def _kv8_case(label: str, q, kv8: tuple, pos, route: str) -> dict:
    """A KV8 kernel against :func:`attention_kv8_plain` on the same inputs,
    with its time, the plain version's, the library yardstick's (SDPA with
    the same mask over a copy of the dequantized K / V in q's type; making
    the copy is not timed) and its bound: int8 K / V at 1 byte an element
    plus the fp32 scale per (key, head), q and the output in q's type, or
    the score and PV operations at q's type's rate (the fp32 kernel: two
    TF32 products a term, int8 K / V being exact in TF32), the larger. The
    call must take the ``launch_counts`` name *route*."""
    import torch
    import torch.nn.functional as F
    from dpu_operator_tpu_torch.ops import (attention_fwd_kv8,
                                            attention_kv8_plain)
    kq, ks, vq, vs = kv8
    got, kernel = launched(lambda: attention_fwd_kv8(q, kq, ks, vq, vs, pos))
    require(kernel == route, f"KV8 {label} took {kernel}, not {route}")
    ref = attention_kv8_plain(q, kq, ks, vq, vs, pos)
    torch.cuda.synchronize()
    max_abs, scaled = scaled_err(got, ref)
    b, sq, h, d = q.shape
    skv = kq.shape[1]
    pos_h = pos.cpu().numpy().astype(np.int64)
    pairs = sum(min(int(p) + i + 1, skv) for p in pos_h for i in range(sq))
    keys = sum(min(int(p) + sq, skv) for p in pos_h)
    dname = str(q.dtype).replace("torch.", "")
    bound = _attn_bound(2 * b * sq * h * d * q.element_size()
                        + 2 * keys * h * (d + 4), 4.0 * pairs * h * d, dname,
                        products=2 if kernel == "attention_kv8_tf32" else 3)
    rows = torch.as_tensor(pos_h, device="cuda")[:, None] \
        + torch.arange(sq, device="cuda")
    mask = (torch.arange(skv, device="cuda")[None, None, :]
            <= rows[:, :, None])[:, None]
    qt = q.transpose(1, 2)
    kt, vt = ((t.float() * sc).to(q.dtype).transpose(1, 2)
              for t, sc in ((kq, ks), (vq, vs)))

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    def run():
        return attention_fwd_kv8(q, kq, ks, vq, vs, pos)

    earlier = KV8_EARLIER_US.get(label.split()[0]) \
        if dname == "bfloat16" and d == 128 \
        else TF32_EARLIER_US.get(f"{kernel}[{label}]")
    return {
        "name": f"{kernel}[{label}]", "kernel": kernel, "dtype": dname,
        "head_dim": d, "source": "dpu_operator_tpu_torch/csrc/" + (
            "attention_kv8_tf32.cu" if kernel == "attention_kv8_tf32"
            else "attention_kv8.cu"),
        "replaces": "dpu_operator_tpu/ops/flash_attention.py:35",
        "max_abs_err": max_abs, "scaled_err": scaled, "earlier_us": earlier,
        "ms": graph_ms(run), "eager_ms": cuda_ms(run, 20),
        "plain_ms": cuda_ms(lambda: attention_kv8_plain(q, kq, ks, vq, vs,
                                                        pos), 3, warmup=1),
        "library_ms": graph_ms(lib), **bound,
    }


def _kv8_decode_row_alone(q, kv8: tuple, pos, qv, pv) -> None:
    """The KV8 cluster kernel's invariants: slot 0's decode row launched
    alone equals its row of the 8-slot launch under ``torch.equal``, a
    second launch gives the same output, and row i of the verify launch
    (qv at positions pv) equals the one-row launch of its query at pv + i
    under ``torch.equal``."""
    import torch
    from dpu_operator_tpu_torch.ops import attention_fwd_kv8
    batch, kernel = launched(lambda: attention_fwd_kv8(q, *kv8, pos))
    one = attention_fwd_kv8(q[:1], *(t[:1] for t in kv8), pos[:1])
    again = attention_fwd_kv8(q, *kv8, pos)
    verify, vkernel = launched(lambda: attention_fwd_kv8(qv, *kv8, pv))
    rows = [attention_fwd_kv8(qv[:, i:i + 1], *kv8, pv + i)
            for i in range(qv.shape[1])]
    torch.cuda.synchronize()
    same, repeat = torch.equal(one, batch[:1]), torch.equal(again, batch)
    apart = [i for i, r in enumerate(rows)
             if not torch.equal(r, verify[:, i:i + 1])]
    log(f"[kernels] KV8 decode ({kernel}): slot 0 alone equals its row of "
        f"the {q.shape[0]}-slot launch bit for bit: {same}; a second launch "
        f"equal: {repeat}; KV8 verify ({vkernel}): each of its "
        f"{qv.shape[1]} rows equals the one-row launch at its position bit "
        f"for bit: {not apart}")
    require(same, "slot 0's KV8 decode row differs between B = 1 and the "
            "8-slot launch")
    require(repeat, "two KV8 decode launches on the same inputs differ")
    require(not apart, f"KV8 verify rows {apart} differ from the one-row "
            "launches at their positions")


def _kv8_chunk_equals_whole(q, kv8: tuple) -> None:
    """The fp32 KV8 kernel's invariants: the 256-row chunk at offset 256
    over slot 3's int8 cache row equals rows 256-511 of the whole 512-row
    KV8 prefill over the same row's first 512 keys under ``torch.equal``,
    and a second launch of the chunk gives the same output."""
    import torch
    from dpu_operator_tpu_torch.ops import attention_fwd_kv8
    p = q.shape[1]
    row = tuple(t[3:4] for t in kv8)
    whole, kernel = launched(lambda: attention_fwd_kv8(
        q, *(t[:, :p] for t in row)))
    off = torch.full((1,), 256, dtype=torch.int32, device="cuda")
    part, kernel_c = launched(lambda: attention_fwd_kv8(q[:, 256:p], *row,
                                                        off))
    again = attention_fwd_kv8(q[:, 256:p], *row, off)
    torch.cuda.synchronize()
    same, repeat = torch.equal(part, whole[:, 256:p]), torch.equal(again,
                                                                   part)
    log(f"[kernels] KV8 chunk 256@256 ({kernel_c}, {q.dtype}, head dim "
        f"{q.shape[3]}) equals rows 256-{p - 1} of the whole KV8 prefill "
        f"({kernel}) bit for bit: {same}; a second launch equal: {repeat}")
    require(kernel == kernel_c == "attention_kv8_tf32",
            f"the fp32 KV8 prefill took {kernel} / {kernel_c}")
    require(same, "the fp32 KV8 chunk at offset 256 differs from the whole "
            "KV8 prefill")
    require(repeat, "two fp32 KV8 chunk launches on the same inputs differ")


def _kv8_small_dim_cases(cfg) -> list:
    """The KV8 chunk (:func:`_kv8_chunk_inputs` at *cfg*'s heads) at head
    dims 16 (the default config's) and 32: bf16 on the KV8 tensor-core
    kernel at head dim 64 (zero-padded), fp32 on the fp32 KV8 kernel at 32.
    Its own generator leaves the later cases' inputs those of a run without
    these cases."""
    import torch
    h, s_max = cfg.n_heads, cfg.max_seq
    cases = []
    for dh in (16, 32):
        qc, row, off = _kv8_chunk_inputs(h, dh, s_max)
        for dt, route in ((torch.bfloat16, "attention_kv8_tc"),
                          (torch.float32, "attention_kv8_tf32")):
            tag = "" if dt == torch.bfloat16 else " float32"
            cases.append(_kv8_case(
                f"chunk 1x256x{h}x{dh}@256 vs slot row of 8x{s_max}{tag}",
                qc.to(dt), row, off, route))
    return cases


def _int8_gemm_log(gen, cfg) -> None:
    """The W8A8 products at the flagship's decode shapes (8 rows): the
    padded int8 GEMM (``model._int8_mm``: ``torch._int_mm`` on 32 rows,
    the weight column-major as the int8 tree stores it, and row-major),
    the whole W8A8 product (activation quantization, int8 GEMM, fp32
    rescale) and the bf16 GEMM it replaces, each under graph replay,
    beside the weight bytes over the HBM rate. A measurement, not a
    check."""
    import torch
    from dpu_operator_tpu_torch.workloads.decode import (_logits,
                                                         _quantize_weight)
    from dpu_operator_tpu_torch.workloads.model import (_act_quant, _int8_mm,
                                                        _mm, int8_weight)
    hbm = card_peaks()["hbm_bytes_per_s"]
    d, f = cfg.d_model, cfg.d_ff
    for k, n, what in ((d, 3 * d, "wqkv"), (d, d, "wo"), (d, f, "w1"),
                       (f, d, "w2"), (d, cfg.vocab, "logits")):
        x = torch.randn((8, k), generator=gen, device="cuda").to(torch.bfloat16)
        xq, _ = _act_quant(x)
        if what == "logits":   # the tied embedding (V, D), contracted over D
            w = torch.randn((n, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            leaf = _quantize_weight(w, axis=1)
            col, row = leaf["q"].t(), leaf["q"].t().contiguous()
            full, plain = (lambda: _logits(x, leaf)), (lambda: x @ w.t())
        else:
            w = torch.randn((k, n), generator=gen, device="cuda").to(
                torch.bfloat16)
            leaf = int8_weight(**_quantize_weight(w))
            col, row = leaf["q"], leaf["q"].contiguous()
            full, plain = (lambda: _mm(x, leaf)), (lambda: x @ w)
        t_col = graph_ms(lambda: _int8_mm(xq, col))
        t_row = graph_ms(lambda: _int8_mm(xq, row))
        log(f"[kernels] W8A8 {what} 8x{k}x{n}: _int_mm (padded to 32 rows) "
            f"{t_col * 1e3:.2f} us column-major weight, {t_row * 1e3:.2f} us "
            f"row-major; whole W8A8 product {graph_ms(full) * 1e3:.2f} us; "
            f"bf16 GEMM {graph_ms(plain) * 1e3:.2f} us; weight bytes over "
            f"HBM: int8 {k * n / hbm * 1e6:.2f} us, bf16 "
            f"{2 * k * n / hbm * 1e6:.2f} us")


def wide_config(cfg):
    """The flagship at head dim 256: 6 heads of 256 over the same d_model
    1536 (the same 391.7M parameters), the head dim of Gemma's published
    configs."""
    return dataclasses.replace(cfg, n_heads=cfg.d_model // 256)


def _route_cases(gen, cfg, decodes: tuple, trains: tuple) -> list:
    """Every attention route at *cfg*'s heads against its plain version,
    timed beside SDPA and its bound, at the serving and training shapes:
    prefill (bf16, and fp32 on the 3xTF32 kernel), a chunk, decode (each of
    *decodes*: (dtype, position or None for random ones)), the training
    shapes *trains* ((B, S, head dim, dtype)), verify, and over the same
    cache quantized to int8 (KV8) decode, verify and the chunk in bf16 and
    fp32; and the invariants (:func:`_decode_row_alone`,
    :func:`_chunk_equals_whole` in bf16 and fp32,
    :func:`_kv8_decode_row_alone`)."""
    import torch
    from dpu_operator_tpu_torch.workloads.decode import _kv_quant
    bf16, f32 = torch.bfloat16, torch.float32
    h, dh, s_max = cfg.n_heads, cfg.d_head, cfg.max_seq

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf16)

    # prefill: one 512-token prompt, causal from position 0
    q, k, v = rnd(1, 512, h, dh), rnd(1, 512, h, dh), rnd(1, 512, h, dh)
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    shape = f"{h}x{dh}"
    cases = [_attn_case(gen, f"prefill 1x512x{shape}", q, k, v, zero)]
    # the same prompt in fp32: the 3xTF32 kernel (fp32 serving)
    cases.append(_attn_case(gen, f"prefill 1x512x{shape} float32", q.float(),
                            k.float(), v.float(), zero))
    # chunk: 256 queries at offset 256 against one slot's row of the cache
    ck, cv = rnd(8, s_max, h, dh), rnd(8, s_max, h, dh)
    qc = rnd(1, 256, h, dh)
    off = torch.full((1,), 256, dtype=torch.int32, device="cuda")
    cases.append(_attn_case(gen, f"chunk 1x256x{shape}@256 vs slot row of "
                            f"8x{s_max}",
                            qc, ck[3:4], cv[3:4], off))
    # decode: 8 slots x 1 query against the whole cache, at random positions
    # or all at one (511: the serve profile's shape)
    qd = rnd(8, 1, h, dh)
    pos = torch.randint(0, s_max, (8,), generator=gen, device="cuda",
                        dtype=torch.int32)
    for dt, at in decodes:
        tag = "" if dt == bf16 else " float32"
        p = pos if at is None else torch.full((8,), at, dtype=torch.int32,
                                               device="cuda")
        where = "" if at is None else f"@{at}"
        cases.append(_attn_case(gen, f"decode 8x1{where} vs "
                                f"8x{s_max}x{shape}{tag}", qd.to(dt),
                                ck.to(dt), cv.to(dt), p))
    _decode_row_alone(qd, ck, cv, pos)
    _chunk_equals_whole(q, k, v, ck, cv)
    _chunk_equals_whole(q.float(), k.float(), v.float(), ck.float(),
                        cv.float())
    for b, s, hd, dt in trains:
        cases.extend(_train_cases(gen, b, s, h, hd, dt))
    # speculative verify (k = 4 drafts): 8 slots x 5 rows against the whole
    # cache at random positions, on the tensor-core forward
    qv = rnd(8, 5, h, dh)
    pv = torch.randint(0, s_max - 4, (8,), generator=gen, device="cuda",
                       dtype=torch.int32)
    cases.append(_attn_case(gen, f"verify 8x5 vs 8x{s_max}x{shape}", qv, ck,
                            cv, pv))
    require(cases[-1]["kernel"] == "attention_fwd_tc",
            f"verify took {cases[-1]['kernel']}, not the tensor cores")
    # the int8 cache (KV8): the same cache quantized as decode stores it,
    # the same queries and positions (decode, verify, chunk)
    (ckq, cks), (cvq, cvs) = _kv_quant(ck), _kv_quant(cv)
    kv8 = (ckq, cks, cvq, cvs)
    for dt, chunk_route in ((bf16, "attention_kv8_tc"),
                            (f32, "attention_kv8_tf32")):
        tag = "" if dt == bf16 else " float32"
        cases.append(_kv8_case(f"decode 8x1 vs 8x{s_max}x{shape}{tag}",
                               qd.to(dt), kv8, pos, "attention_kv8_rows"))
        cases.append(_kv8_case(f"verify 8x5 vs 8x{s_max}x{shape}{tag}",
                               qv.to(dt), kv8, pv, "attention_kv8_rows"))
        cases.append(_kv8_case(
            f"chunk 1x256x{shape}@256 vs slot row of 8x{s_max}{tag}",
            qc.to(dt), tuple(t[3:4] for t in kv8), off, chunk_route))
    _kv8_decode_row_alone(qd, kv8, pos, qv, pv)
    _kv8_chunk_equals_whole(q.float(), kv8)
    return cases


def phase_kernels(cfg) -> list:
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    bf16, f32 = torch.bfloat16, torch.float32
    d = cfg.d_model
    cases = [_rms_case(gen, rows, d, dt)
             for rows, dt in ((8, bf16), (256, bf16), (512, bf16),
                              (8, f32), (512, f32))]
    dh, s_max = cfg.d_head, cfg.max_seq
    # training: the flagship's train batch, one of its sequences, and a
    # ragged length (fp32: the 3xTF32 forward and dK/dV); then head dim 64
    # (the n64 products) at one and two warpgroups a block, and head dim 32
    # (padded to 64)
    cases.extend(_route_cases(
        gen, cfg, ((bf16, None), (bf16, 511)),
        ((8, s_max, dh, bf16), (1, s_max, dh, bf16), (1, 1000, dh, bf16),
         (1, s_max, dh, f32), (1, 1000, dh, f32), (1, 1000, 64, bf16),
         (2, s_max, 64, bf16), (1, 1000, 32, bf16))))
    # the KV8 chunk at head dims 16 and 32
    cases.extend(_kv8_small_dim_cases(cfg))
    # RMSNorm at the training shape (batch 8 x 1024 tokens)
    cases.append(_rms_case(gen, 8 * s_max, d, bf16))
    # the flash bench's shape (phase 9's measure_flash_attention):
    # 4 x 2048 x 8 x 128, causal from position 0
    fb = [torch.randn(FLASH_BENCH, generator=gen, device="cuda").to(bf16)
          for _ in range(3)]
    cases.append(_attn_case(gen, "flash bench " + "x".join(
        map(str, FLASH_BENCH)), *fb, torch.zeros(FLASH_BENCH[0],
                                                dtype=torch.int32,
                                                device="cuda")))
    require(cases[-1]["kernel"] == "attention_fwd_tc",
            f"the flash bench took {cases[-1]['kernel']}, not the tensor "
            "cores")
    # every route again at head dim 256: decode in both types, the train
    # batch in bf16 and one sequence in fp32
    wide = wide_config(cfg)
    cases.extend(_route_cases(
        gen, wide, ((bf16, None), (f32, None)),
        ((8, s_max, wide.d_head, bf16), (1, s_max, wide.d_head, f32))))
    _launch_floor()
    _int8_gemm_log(gen, cfg)
    log("[kernels] library for attention_kv8_*: SDPA with the same mask over "
        "a copy of the dequantized K / V in q's type, the copy made outside "
        "the timing; 'earlier' is the earlier design's time (KV8: the "
        "two-pass decode kernels and the tiled KV8 kernel; fp32, and bf16 at "
        "head dim 16 / 32: the CUDA-core kernels); fp32 attention bounds at "
        "a third of the TF32 rate (3xTF32)")
    for c in cases:
        earlier = "" if c.get("earlier_us") is None \
            else f" (earlier {c['earlier_us'] * 1e-3:.4f} ms)"
        cores = "" if c.get("bound_cores_ms") is None \
            else f"; at the CUDA cores' fp32 rate {c['bound_cores_ms']:.4f} ms"
        log(f"[kernels] {c['name']}: max_abs_err {c['max_abs_err']:.3g} "
            f"(scaled {c['scaled_err']:.3g}, tol {TOL[c['dtype']]}) "
            f"kernel {c['ms']:.4f} ms{earlier} (eager call "
            f"{c['eager_ms']:.4f} ms) plain {c['plain_ms']:.4f} ms "
            f"library {c['library_ms']:.4f} ms bound {c['bound_ms']:.4f} ms "
            f"({c['bound_by']}{cores})")
    for c in cases:
        require(c["scaled_err"] <= TOL[c["dtype"]],
                f"{c['name']} disagrees with its plain version: scaled error "
                f"{c['scaled_err']:.3g} > {TOL[c['dtype']]}")
    return cases


# -- phase 4 ------------------------------------------------------------------
def _serve(params, cfg, reqs, slots: int, chunk: int, device: str,
           executor_cls=None, clock=None, spec_k: int = 0, drafter=None):
    from dpu_operator_tpu_torch.workloads.serve import (
        Scheduler, ServeConfig, TorchSlotExecutor)
    cls = executor_cls or TorchSlotExecutor
    ex = cls(params, cfg, slots=slots, chunk_tokens=chunk, spec_k=spec_k,
             device=device)
    blocks = slots * cfg.max_seq // 16
    sched = Scheduler(ServeConfig(slots=slots, kv_blocks=blocks,
                                  kv_block_size=16,
                                  prefill_chunk_tokens=chunk, spec_k=spec_k),
                      ex, clock=clock, drafter=drafter)
    for r in reqs:
        r.arrival_s = sched.now  # all arrive at once, on the run's clock
        sched.submit(r)
    sched.run()
    return sched, ex


def _require_fault_free(label: str, sched) -> None:
    """A fault-free run on the card: the fault engine catches every
    executor exception, so a launch that failed and then passed on retry
    would otherwise go unseen. No retry, no failure, no step fault."""
    faults = [t for t in sched.trace if t[0] in ("step_fault", "retry",
                                                 "fail", "poison")]
    require(sched.retries_total == 0 and sched.failed_total == 0
            and not faults,
            f"{label}: the executor faulted: retries {sched.retries_total} "
            f"failed {sched.failed_total}, first fault tuples {faults[:3]}")


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


def _parity(cfg, seed: int, label: str) -> tuple:
    """The port on the card against the port on the CPU for *cfg* (fp32):
    2 x 32 greedy tokens equal, forward logits within 1e-3, then a serve of
    6 requests on 2 slots whose streams equal ``generate``. Returns the
    weights ``(on the CPU, on the card)``."""
    import torch
    from dpu_operator_tpu_torch.workloads.decode import generate
    from dpu_operator_tpu_torch.workloads.model import forward, init_params
    p_cpu = init_params(seed, cfg, device="cpu")
    p_gpu = {k: (v.cuda() if torch.is_tensor(v)
                 else [{n: t.cuda() for n, t in lp.items()} for lp in v])
             for k, v in p_cpu.items()}
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)))
    s_cpu = generate(p_cpu, cfg, prompt, 32, device="cpu")
    s_gpu = generate(p_gpu, cfg, prompt, 32, device="cuda").cpu()
    require(torch.equal(s_cpu, s_gpu),
            f"{label}: greedy streams differ card vs CPU:\n{s_cpu}\n{s_gpu}")
    l_cpu = forward(p_cpu, prompt, cfg)
    l_gpu = forward(p_gpu, prompt, cfg).cpu()
    err = float((l_cpu - l_gpu).abs().max())
    log(f"[parity] {label}: 2x32 greedy tokens equal card vs CPU; "
        f"forward logits max |diff| {err:.3g} (tol 1e-3)")
    require(err <= 1e-3, f"{label}: logits card vs CPU differ by {err}")
    reqs = _requests(rng, 6, cfg.vocab, (5, 60), (4, 24))
    sched, ex = _serve(p_gpu, cfg, reqs, slots=2, chunk=16, device="cuda")
    require(len(sched.completed) == len(reqs), f"{label} serve incomplete")
    for r in reqs:
        want = generate(p_gpu, cfg, torch.tensor([r.prompt]), r.output_len,
                        device="cuda")[0].tolist()
        require(r.tokens == want, f"{label} serve {r.rid}: stream "
                f"{r.tokens} != generate {want}")
    require(sched.pool.outstanding() == 0, f"{label} serve leaked KV blocks")
    _require_fault_free(f"{label} serve", sched)
    log(f"[parity] {label} serve on the card: {len(reqs)} requests on 2 "
        "slots, chunk 16, every stream equals generate")
    return p_cpu, p_gpu


#: the default config's bf16 forward, card against CPU: the largest
#: scaled error of the logits (:func:`scaled_err`). Each side rounds every
#: activation to bf16 and sums in its own order; the CPU's bf16 logits lie
#: 2.5e-2 (scaled) from its fp32 logits at this config and seed, so two
#: bf16 runs may lie up to twice that apart
DEFAULT_BF16_LOGIT_TOL = 5e-2


def _pad_copy_log(cfg) -> None:
    """What the head-dim pad costs at the default config: the decode call
    over a 2-slot fp32 cache row of head dim 16 (padded to 32 on every
    call), and the pad copies of q, k, v alone, each under graph replay. A
    measurement, not a check."""
    import torch
    from dpu_operator_tpu_torch.ops import attention_fwd
    from dpu_operator_tpu_torch.ops.flash_attention import (_pad_dim,
                                                            _padded_dim)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    h, d = cfg.n_heads, cfg.d_head
    q = torch.randn((2, 1, h, d), generator=gen, device="cuda")
    ck, cv = (torch.randn((2, cfg.max_seq, h, d), generator=gen,
                          device="cuda") for _ in range(2))
    pos = torch.tensor([60, cfg.max_seq - 1], dtype=torch.int32,
                       device="cuda")
    dp = _padded_dim("decode", d)
    pad_ms = graph_ms(lambda: _pad_dim(dp, q, ck, cv))
    call_ms = graph_ms(lambda: attention_fwd(q, ck, cv, pos))
    log(f"[parity] the head-dim pad at the default config: decode over a "
        f"2x{cfg.max_seq}x{h}x{d} fp32 cache, {call_ms * 1e3:.2f} us a call "
        f"under graph replay, of which the copies of q, k, v padded to "
        f"{dp} columns take {pad_ms * 1e3:.2f} us")


def _default_config_parity() -> None:
    """The port's default ``TransformerConfig()`` (d_model 128 over 8
    heads: head dim 16, which every kernel takes zero-padded to its
    route's head dim) on the card: in fp32 :func:`_parity` and one train
    step matching the CPU's; in bf16 (its own dtype) forward logits close to
    the CPU's."""
    import torch
    from dpu_operator_tpu_torch.ops import launch_counts
    from dpu_operator_tpu_torch.workloads.model import (
        TransformerConfig, forward, init_params)
    base = TransformerConfig()
    cfg = dataclasses.replace(base, dtype=torch.float32)
    before = launch_counts()
    p_cpu, _ = _parity(cfg, 9, f"default config fp32 (head dim "
                       f"{cfg.d_head})")
    _train_parity(cfg, p_cpu)
    moved = {n: c - before[n] for n, c in launch_counts().items()
             if c != before[n]}
    log(f"[parity] default config fp32 launches: {moved}")
    for name in ("attention_fwd_tf32", "attention_fwd_decode",
                 "attention_fwd_lse_tf32", "attention_bwd_dq_tf32",
                 "attention_bwd_dkv_tf32"):
        require(moved.get(name, 0) > 0, f"default config fp32: {name} "
                "never launched")
    _pad_copy_log(cfg)
    p16 = init_params(9, base, device="cpu")
    p16_gpu = {k: (v.cuda() if torch.is_tensor(v)
                   else [{n: t.cuda() for n, t in lp.items()} for lp in v])
               for k, v in p16.items()}
    prompt = torch.from_numpy(np.random.default_rng(9).integers(
        0, base.vocab, (2, 40)))
    l_cpu = forward(p16, prompt, base)
    l_gpu = forward(p16_gpu, prompt, base).cpu()
    max_abs, err = scaled_err(l_gpu, l_cpu)
    log(f"[parity] default config bf16 (head dim {base.d_head}): forward "
        f"logits card vs CPU max |diff| {max_abs:.3g}, scaled {err:.3g} (tol "
        f"{DEFAULT_BF16_LOGIT_TOL})")
    require(err <= DEFAULT_BF16_LOGIT_TOL, f"default config bf16 logits "
            f"card vs CPU: scaled error {err:.3g}")


#: phase 4 must launch each of these (the fp32 routes of the tiny and the
#: default config)
CPU_PARITY_KERNELS = ("attention_fwd_tf32", "attention_fwd_decode",
                      "attention_fwd_lse_tf32", "attention_bwd_dq_tf32",
                      "attention_bwd_dkv_tf32", "attention_kv8_rows",
                      "attention_kv8_tf32")


def phase_cpu_parity() -> dict:
    """Phase 4; the launch counters are set to 0 before it and read after
    it (the fp32 kernels' launches on the kernels' line). Returns the
    launches."""
    import torch
    from dpu_operator_tpu_torch.ops import launch_counts, reset_launch_counts
    from dpu_operator_tpu_torch.workloads.model import TransformerConfig
    reset_launch_counts()
    cfg = TransformerConfig(vocab=512, d_model=256, n_heads=4, n_layers=2,
                            d_ff=512, max_seq=128, dtype=torch.float32)
    p_cpu, p_gpu = _parity(cfg, 7, "tiny fp32")
    _spec_preempt_parity(p_gpu, cfg)
    _spec_kv8_parity(p_gpu, cfg)
    _train_parity(cfg, p_cpu)
    _kv8_chunk_parity(p_cpu, p_gpu, cfg, "tiny fp32")
    _default_config_parity()
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"[parity] launches of the phase: {counts}")
    for name in CPU_PARITY_KERNELS:
        require(counts[name] > 0, f"phase 4: {name} never launched")
    return counts


class OracleDrafter:
    """Drafts copied from reference streams (keyed by prompt), the last of
    two or more drafts corrupted: acceptance and rejection forced on the
    real verify path."""

    def __init__(self, refs: dict, prompts: dict, vocab: int) -> None:
        self.refs, self.prompts, self.vocab = refs, prompts, vocab

    def propose(self, ids, k: int) -> list:
        ids = list(ids)
        for rid, p in self.prompts.items():
            if len(ids) >= len(p) and tuple(ids[:len(p)]) == p:
                done = len(ids) - len(p)
                d = list(self.refs[rid][done:done + k])
                if len(d) >= 2:
                    d[-1] = (d[-1] + 1) % self.vocab
                return d
        return []


def _spec_preempt_parity(params, cfg) -> None:
    """Speculation through a preemption on the card (tiny fp32, virtual
    clock): two batch requests fill 2 slots and all 6 KV blocks, and an
    interactive arrival evicts one of them after it has speculated. Every
    stream must equal ``generate``, and no block may leak."""
    import torch
    from dpu_operator_tpu_torch.workloads.decode import generate
    from dpu_operator_tpu_torch.workloads.serve import (
        BATCH, INTERACTIVE, Request, Scheduler, ServeConfig,
        TorchSlotExecutor)
    rng = np.random.default_rng(8)
    prompts = {rid: tuple(int(t) for t in rng.integers(0, cfg.vocab, n))
               for rid, n in (("b1", 20), ("b2", 13), ("hot", 9))}
    out_len = 24
    refs = {rid: generate(params, cfg, torch.tensor([p]), out_len,
                          device="cuda")[0].tolist()
            for rid, p in prompts.items()}
    ex = TorchSlotExecutor(params, cfg, slots=2, chunk_tokens=16, spec_k=3,
                           device="cuda")
    sched = Scheduler(ServeConfig(slots=2, kv_blocks=6, kv_block_size=16,
                                  prefill_chunk_tokens=16, spec_k=3,
                                  preemption=True),
                      ex, drafter=OracleDrafter(refs, prompts, cfg.vocab))
    for rid, cls, t in (("b1", BATCH, 0.0), ("b2", BATCH, 0.0),
                        ("hot", INTERACTIVE, 0.1)):
        sched.submit(Request(rid=rid, prompt_len=len(prompts[rid]),
                             output_len=out_len, prompt=prompts[rid],
                             slo_class=cls, arrival_s=t))
    sched.run()
    trace = sched.trace
    require(len(sched.completed) == 3 and not sched.failed,
            "tiny spec serve incomplete")
    for r in sched.completed:
        require(r.tokens == refs[r.rid], f"tiny fp32 spec serve {r.rid}: "
                f"stream {r.tokens} != generate {refs[r.rid]}")
    pre = next((i for i, t in enumerate(trace) if t[0] == "preempt"), None)
    require(pre is not None, "the interactive request preempted nothing")
    victim = trace[pre][2]
    require(any(t[0] == "spec" and t[2] == victim for t in trace[:pre]),
            f"{victim} was preempted before it speculated")
    require(sched.pool.outstanding() == 0, "tiny spec serve leaked KV blocks")
    _require_fault_free("tiny fp32 spec serve", sched)
    spec = [t for t in trace if t[0] == "spec"]
    log(f"[parity] tiny fp32 spec serve on the card (k 3, 2 slots, 6 KV "
        f"blocks): {victim} preempted by {trace[pre][3]} mid-speculation "
        f"({trace[pre][4]} phase); {len(spec)} verify rows, "
        f"{sum(t[4] for t in spec)}/{sum(t[3] for t in spec)} drafts "
        "accepted; every stream equals generate")


def _spec_kv8_parity(params, cfg) -> None:
    """The twin of tests/test_spec.py's ``kv8`` verify identity on the card
    (tiny fp32), with bf16-free weights and with the W8A8 tree: verify over
    a KV8 cache at k 4, the last oracle draft of each proposal corrupted,
    emits exactly ``generate(kv_int8=True)``'s stream. Verify (5 rows a
    pass) and generate's decode steps both take the KV8 cluster kernel."""
    import torch
    from dpu_operator_tpu_torch.ops import launch_counts
    from dpu_operator_tpu_torch.workloads.decode import (
        generate, prefill, quantize_decode_params, verify_step)
    from dpu_operator_tpu_torch.workloads.spec import greedy_accept
    prompt, out_len, k = [3, 7, 11, 5, 2, 9, 4], 24, 4
    for mode, p in (("kv8", params),
                    ("int8 + kv8", quantize_decode_params(params))):
        ref = generate(p, cfg, torch.tensor([prompt]), out_len,
                       device="cuda", kv_int8=True)[0].tolist()
        before = launch_counts()
        cache, logits = prefill(p, cfg, torch.tensor([prompt]), kv_int8=True)
        toks, pos, rows = [int(logits[0].argmax())], len(prompt), 0
        while len(toks) < out_len:
            drafts = list(ref[len(toks):len(toks) + min(k, out_len
                                                         - len(toks) - 1)])
            if drafts:
                drafts[-1] = (drafts[-1] + 1) % cfg.vocab
            row = [toks[-1]] + drafts + [toks[-1]] * (k - len(drafts))
            logits, cache = verify_step(
                p, cfg, cache, torch.tensor([row]),
                torch.tensor([pos], dtype=torch.int32))
            arg = logits.argmax(-1)[0].tolist()
            _, emitted = greedy_accept(drafts, arg[:len(drafts) + 1])
            toks.extend(emitted)
            pos += len(emitted)
            rows += 1
        after = launch_counts()
        moved = {n: after[n] - before[n] for n in after
                 if n.startswith("attention_kv8") and after[n] != before[n]}
        require(toks[:out_len] == ref, f"tiny fp32 {mode} verify stream "
                f"{toks[:out_len]} != generate(kv_int8=True) {ref}")
        require(moved == {"attention_kv8_rows": rows * cfg.n_layers},
                f"{mode} verify: KV8 launches {moved} for {rows} verify "
                "passes")
        log(f"[parity] tiny fp32 {mode} verify on the card (k {k}, last "
            f"draft corrupted): {rows} verify passes on the KV8 cluster "
            f"kernel, stream equals generate(kv_int8=True)")


def _train_parity(cfg, p_cpu) -> None:
    """One fp32 train step of the tiny config on the card and on the CPU
    from the same weights and batch: loss within 1e-4, every gradient leaf
    within 1e-4 (:func:`scaled_err` against the CPU's)."""
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
def _timed_executor(cfg):
    """TorchSlotExecutor that records each decode and verify iteration's
    wall time (each ends in a host copy, so the host clock sees the
    device's work), the KV bytes its attention reads, and the tensor-core
    forward's launches inside verify."""
    from dpu_operator_tpu_torch.ops import launch_counts
    from dpu_operator_tpu_torch.workloads.serve import TorchSlotExecutor
    kv_row_bytes = 2 * cfg.n_layers * cfg.n_heads * cfg.d_head * 2

    class TimedExecutor(TorchSlotExecutor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.iters: list = []
            self.verifies: list = []
            self.verify_tc = 0

        def _kv_bytes(self, width: int) -> int:
            keys = np.minimum(np.clip(self.pos, 0, self.cfg.max_seq - 1)
                              + width, self.cfg.max_seq)
            return int(keys.sum()) * kv_row_bytes

        def step(self, active):
            kv = self._kv_bytes(1)
            t0 = time.perf_counter()
            out = super().step(active)
            self.iters.append((time.perf_counter() - t0, kv))
            return out

        def spec_step(self, active, drafts):
            kv = self._kv_bytes(self.spec_width)
            tc = launch_counts()["attention_fwd_tc"]
            t0 = time.perf_counter()
            out = super().spec_step(active, drafts)
            self.verifies.append((time.perf_counter() - t0, kv))
            self.verify_tc += launch_counts()["attention_fwd_tc"] - tc
            return out

    return TimedExecutor


def _margin(params, cfg, r) -> float:
    """The worst teacher-forced margin of *r*'s served tokens: how far
    each lies below the best logit of ``verify_step`` over prompt + the
    tokens before it, in a fresh cache (one forward of the served model,
    bf16 or int8 tree)."""
    import torch
    from dpu_operator_tpu_torch.workloads.decode import (
        init_kv_cache, params_device, verify_step)
    dev = params_device(params)
    seq = torch.tensor([list(r.prompt) + r.tokens[:-1]], device=dev)
    full, _ = verify_step(params, cfg, init_kv_cache(cfg, 1, device=dev),
                          seq, 0)
    logits = full[0, r.prompt_len - 1:]
    served = torch.tensor(r.tokens, device=dev)
    margin = logits.max(-1).values - logits.gather(1, served[:, None])[:, 0]
    return float(margin.max())


def _serve_run(params, cfg, label: str, reqs: list, wbytes: int,
               spec_k: int = 0, drafter=None) -> dict:
    """One timed serve run of *reqs* (16 on 8 slots, chunk 256): checks the
    run's gates and returns its numbers, its launches the counters' change
    from just before the run to just after. The counters are not set to 0
    here, so a phase that set them to 0 before calling this goes on
    counting through it."""
    import torch
    from dpu_operator_tpu_torch.ops import launch_counts
    before = launch_counts()
    t0 = time.monotonic()
    sched, ex = _serve(params, cfg, reqs, slots=8, chunk=256, device="cuda",
                       executor_cls=_timed_executor(cfg),
                       clock=time.monotonic, spec_k=spec_k, drafter=drafter)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = {k: n - before[k] for k, n in launch_counts().items()}
    log(f"[serve] {label}: launches during the run: {counts}")
    _require_fault_free(label, sched)
    require(len(sched.completed) == len(reqs) and not sched.rejected,
            f"{label}: completed {len(sched.completed)} rejected "
            f"{len(sched.rejected)}")
    for r in reqs:
        require(len(r.tokens) == r.output_len,
                f"{label} {r.rid}: {len(r.tokens)} tokens, wanted "
                f"{r.output_len}")
        require(all(0 <= t < cfg.vocab for t in r.tokens),
                f"{label} {r.rid}: token out of vocab")
    require(sched.pool.outstanding() == 0, f"{label}: KV blocks leaked")
    for name in SPEC_KERNELS if spec_k else SERVE_KERNELS:
        require(counts[name] > 0,
                f"{label}: kernel {name} never launched on the serving path")
    for name in SERVE_NOT:
        require(counts[name] == 0, f"{label}: {name} launched {counts[name]} "
                "times on the bf16 serving path (its work belongs to the "
                "tensor cores)")
    hbm = card_peaks()["hbm_bytes_per_s"]

    def iters(pairs):
        t = np.array([w for w, _ in pairs]) * 1e3
        bound = (wbytes + np.array([b for _, b in pairs], np.float64)) \
            / hbm * 1e3
        return (len(pairs), float(t.mean()) if len(t) else None,
                float(np.median(t)) if len(t) else None,
                float(bound.mean()) if len(t) else None)

    gen_tokens = sum(len(r.tokens) for r in reqs)
    ttfts = sorted(r.ttft_s for r in reqs)
    n_dec, dec_mean, dec_p50, dec_bound = iters(ex.iters)
    n_ver, ver_mean, ver_p50, ver_bound = iters(ex.verifies)
    spec = sched._spec
    rows = sched.spec_rows_total
    out = {
        "run": label, "requests": len(reqs), "slots": 8, "chunk": 256,
        "spec_k": spec_k, "generated_tokens": gen_tokens, "wall_s": wall,
        "tokens_per_s": gen_tokens / wall,
        "ttft_p50_s": ttfts[len(ttfts) // 2], "ttft_max_s": ttfts[-1],
        "decode_iterations": n_dec, "decode_ms_mean": dec_mean,
        "decode_ms_p50": dec_p50, "decode_bound_ms_mean": dec_bound,
        "verify_iterations": n_ver, "verify_ms_mean": ver_mean,
        "verify_ms_p50": ver_p50, "verify_bound_ms_mean": ver_bound,
        # tokens after each request's first, per decode or verify iteration
        "tokens_per_iteration": (gen_tokens - len(reqs))
        / max(n_dec + n_ver, 1),
        "drafts_proposed": spec.proposed_total,
        "drafts_accepted": spec.accepted_total,
        "acceptance_rate": spec.acceptance_rate(),
        "tokens_per_verify_row": (spec.accepted_total + rows) / rows
        if rows else None,
        "verify_tc_launches": ex.verify_tc,
        "prefill_chunks": sched.prefill_chunks_total,
        "iterations": sched.iterations, "launches": counts,
    }

    def ms(x):
        return "n/a" if x is None else f"{x:.3f} ms"

    log(f"[serve] {label}: {gen_tokens} tokens in {wall:.3f} s = "
        f"{out['tokens_per_s']:.1f} tokens/s; TTFT p50 "
        f"{out['ttft_p50_s'] * 1e3:.1f} ms (max "
        f"{out['ttft_max_s'] * 1e3:.1f} ms); decode {n_dec} iterations, "
        f"mean {ms(dec_mean)} (p50 {ms(dec_p50)}) vs bound {ms(dec_bound)}; "
        f"verify {n_ver} iterations, mean {ms(ver_mean)} (p50 "
        f"{ms(ver_p50)}) vs bound {ms(ver_bound)} (weights + the KV the "
        f"iteration reads); drafts {spec.proposed_total} proposed, "
        f"{spec.accepted_total} accepted (rate "
        f"{spec.acceptance_rate():.3f}); tokens per verify row "
        f"{out['tokens_per_verify_row']}; tokens per iteration "
        f"{out['tokens_per_iteration']:.3f}")
    return out


def phase_serve(cfg, params) -> dict:
    """The plain serve run, then the same requests with speculation (k 4)
    drafted by prompt lookup and by a corrupted oracle of the plain run's
    streams, then plain again. Returns each run's numbers, the launches
    of all four and the plain run's requests (the chaos runs' reference
    streams)."""
    import torch
    from dpu_operator_tpu_torch.workloads.decode import generate
    from dpu_operator_tpu_torch.workloads.model import param_bytes
    from dpu_operator_tpu_torch.workloads.serve import Request
    from dpu_operator_tpu_torch.workloads.spec import NgramDrafter

    wbytes = param_bytes(params)
    rng = np.random.default_rng(2026)
    reqs = _requests(rng, 16, cfg.vocab, (128, 512), (32, 64))
    # warm-up outside the counted run (library handles, allocator)
    generate(params, cfg, torch.tensor([reqs[0].prompt[:64]]), 4,
             device="cuda")
    torch.cuda.synchronize()

    def fresh():
        return [Request(rid=r.rid, prompt_len=r.prompt_len,
                        output_len=r.output_len, prompt=r.prompt)
                for r in reqs]

    plain = _serve_run(params, cfg, "plain", reqs, wbytes)
    prompts = {r.rid: r.prompt for r in reqs}
    streams = {r.rid: list(r.tokens) for r in reqs}
    runs = {"plain": plain}
    served = {"plain": {r.rid: r for r in reqs}}
    for label, drafter in (
            ("spec ngram", NgramDrafter()),
            ("spec oracle", OracleDrafter(streams, prompts, cfg.vocab))):
        again = fresh()
        run = _serve_run(params, cfg, label, again, wbytes, spec_k=4,
                         drafter=drafter)
        require(run["verify_iterations"] > 0,
                f"{label}: no verify iteration ran")
        require(run["verify_tc_launches"] > 0,
                f"{label}: verify never launched the tensor-core forward")
        runs[label] = run
        served[label] = {r.rid: r for r in again}
    require(runs["spec oracle"]["drafts_accepted"] > 0,
            "spec oracle: no draft accepted")
    # the plain run once more: the spread of the host-paced wall times
    # between two runs of the same work in this process
    runs["plain again"] = _serve_run(params, cfg, "plain again", fresh(),
                                     wbytes)

    # two streams of each run against generate and a teacher-forced forward
    for rid in ("req-00", "req-09"):
        r0 = served["plain"][rid]
        want = generate(params, cfg, torch.tensor([r0.prompt]),
                        r0.output_len, device="cuda")[0].tolist()
        for label, by_rid in served.items():
            r = by_rid[rid]
            same = next((i for i, (a, b) in enumerate(zip(r.tokens, want))
                         if a != b), len(want))
            worst = _margin(params, cfg, r)
            log(f"[serve] {label} {rid} (prompt {r.prompt_len}, "
                f"{r.output_len} tokens): equals generate for "
                f"{same}/{len(want)} tokens; worst teacher-forced margin "
                f"{worst:.4f} (tol {SERVE_LOGIT_TOL})")
            require(worst <= SERVE_LOGIT_TOL,
                    f"{label} {rid}: a served token is {worst:.4f} below the "
                    "best logit of a full forward")
            if same < len(want):
                log(f"[serve] {label} {rid}: first difference at token "
                    f"{same} is a bf16 near-tie (both tokens within "
                    "tolerance of the best)")
    for label, run in runs.items():
        log("[serve] " + json.dumps({k: v for k, v in run.items()
                                     if k != "launches"}))
    launches = {k: sum(run["launches"][k] for run in runs.values())
                for k in plain["launches"]}
    return {"runs": runs, "launches": launches, "plain": reqs}


# -- phase 6 ------------------------------------------------------------------
#: the chaos runs' fault plans are seeded with this
CHAOS_SEED = 7
#: the cast of chaos run (a), by rid of phase 5's generator: a rid that
#: fails every executor call; one whose deadline (s) its least finish time
#: misses at admission; one admitted under its deadline (least finish
#: 0.98 s) and overtaken by batched service; one cancelled after an
#: iteration, mid-decode; and the sources of batch copies arriving at 1.0 s
#: while the ladder sheds batch traffic (the SimExecutor rehearsal of the
#: same plan puts each event there)
POISONED = "req-05"
ADMISSION_DEADLINE = ("req-13", 0.05)
MID_STREAM_DEADLINE = ("req-03", 1.2)
CANCELLED = ("req-07", 30)
LATE_BATCH = ("req-01", "req-04", "req-06")
LATE_AT_S = 1.0


def _audited(base):
    """*base* (the port's ``ChaosExecutor``) logging every exception its
    calls raise, injected or not, for the injected-faults-only gate."""

    class Audited(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.raised: list = []

        def _call(self, name, fn, *args):
            try:
                return fn(*args)
            except Exception as e:
                self.raised.append((name, e))
                raise

        def begin(self, req, slot):
            return self._call("begin", super().begin, req, slot)

        def prefill_chunk(self, req, slot, offset, n):
            return self._call("prefill_chunk", super().prefill_chunk, req,
                              slot, offset, n)

        def step(self, active):
            return self._call("step", super().step, active)

        def spec_step(self, active, drafts):
            return self._call("spec_step", super().spec_step, active,
                              drafts)

    return Audited


def _chaos_plan(spec: bool):
    """Run (a): an Oom on the 4th chunk and a reset on the 3rd decode
    step; run (b): resets on 4 verify passes in a row after 5 clean ones,
    two rungs' worth of consecutive bad iterations."""
    from dpu_operator_tpu_torch.testing import chaos
    plan = chaos.FaultPlan(seed=CHAOS_SEED)
    if spec:
        plan.script("spec_step", chaos.Ok(times=5), chaos.Fail(times=4))
    else:
        plan.script("prefill_chunk", chaos.Ok(times=3), chaos.Oom())
        plan.script("step", chaos.Ok(times=2), chaos.Fail())
    return plan


def _chaos_requests(plain: list, spec: bool) -> list:
    """Fresh copies of phase 5's requests, arriving at 0; run (a) adds
    its deadlines and the late batch copies."""
    from dpu_operator_tpu_torch.workloads.serve import Request
    reqs = [Request(rid=r.rid, prompt_len=r.prompt_len,
                    output_len=r.output_len, prompt=r.prompt) for r in plain]
    if spec:
        return reqs
    by_rid = {r.rid: r for r in reqs}
    for rid, budget in (ADMISSION_DEADLINE, MID_STREAM_DEADLINE):
        by_rid[rid].deadline_budget_s = budget
    for i, rid in enumerate(LATE_BATCH):
        src = by_rid[rid]
        reqs.append(Request(rid=f"late-{i}", prompt_len=src.prompt_len,
                            output_len=src.output_len, prompt=src.prompt,
                            arrival_s=LATE_AT_S + 0.05 * i))
    return reqs


def _chaos_serve(executor, reqs: list, spec_k: int, drafter=None):
    """The flagship's serve config on the virtual clock over *executor*,
    cancelling run (a)'s request after its iteration."""
    from dpu_operator_tpu_torch.workloads.serve import Scheduler, ServeConfig
    sched = Scheduler(ServeConfig(slots=8, kv_blocks=512, kv_block_size=16,
                                  prefill_chunk_tokens=256, spec_k=spec_k),
                      executor, drafter=drafter)
    for r in reqs:
        sched.submit(r)
    rid, at = CANCELLED
    while sched.step():
        if not spec_k and sched.iterations == at:
            require(sched.cancel(rid), f"cancel({rid}) found nothing")
    return sched


def _injected_only(label: str, sched, ex) -> None:
    """Every exception out of the executor answers a fault the plan
    injected or a poisoned rid, and every step_fault / retry / poison
    tuple answers one of them; a fault the plan did not inject fails the
    phase with its text."""
    from dpu_operator_tpu_torch.testing.chaos import ExecutorOom, PoisonedRid
    kinds = {"Oom": ExecutorOom, "Fail": ConnectionResetError}
    injected = iter(ex.plan.injected)
    for method, e in ex.raised:
        text = f"{method}: {type(e).__name__}: {e}"
        if isinstance(e, PoisonedRid) and e.rid == POISONED:
            continue
        key, fault = next(injected, (None, None))
        require(key == method and type(e) is kinds.get(fault)
                and str(e).startswith("chaos:"),
                f"{label}: a fault the plan did not inject: {text}")
    require(next(injected, None) is None,
            f"{label}: the plan injected faults the executor never raised")
    kinds = [t[0] for t in sched.trace]
    require("fail" not in kinds, f"{label}: a request failed: "
            f"{[t for t in sched.trace if t[0] == 'fail']}")
    require(kinds.count("retry") + kinds.count("poison") == len(ex.raised),
            f"{label}: {len(ex.raised)} executor faults but "
            f"{kinds.count('retry')} retries and {kinds.count('poison')} "
            "poisonings")
    batched = sum(m in ("step", "spec_step") for m, _ in ex.raised)
    require(kinds.count("step_fault") == batched,
            f"{label}: {batched} batched-pass faults but "
            f"{kinds.count('step_fault')} step_fault tuples")


def _streams_hold(label: str, params, cfg, sched, plain: list) -> None:
    """Every completed stream equals phase 5's plain stream of its prompt,
    or leaves it only at a bf16 near-tie (the teacher-forced margin)."""
    by_prompt = {r.prompt: r for r in plain}
    for r in sched.completed:
        want = by_prompt[r.prompt].tokens
        require(len(r.tokens) == r.output_len,
                f"{label} {r.rid}: {len(r.tokens)} tokens of {r.output_len}")
        if r.tokens != want:
            first = next(i for i, (a, b) in enumerate(zip(r.tokens, want))
                         if a != b)
            worst = _margin(params, cfg, r)
            log(f"[chaos] {label} {r.rid} (retries {r.retries}) leaves the "
                f"plain stream at token {first}; worst teacher-forced margin "
                f"{worst:.4f} (tol {SERVE_LOGIT_TOL})")
            require(worst <= SERVE_LOGIT_TOL,
                    f"{label} {r.rid}: a served token is {worst:.4f} below "
                    "the best logit of a full forward")


def _rung_before(trace: list, it: int) -> int:
    """The ladder's rung during iteration *it* (a change is traced at the
    end of the iteration that commits it)."""
    rung = 0
    for t in trace:
        if t[0] == "rung" and t[1] < it:
            rung = t[3]
    return rung


def _chaos_report(label: str, sched, ex, counts: dict) -> dict:
    out = {
        "run": label, "iterations": sched.iterations,
        "virtual_s": sched.now,
        **{k: getattr(sched, k) for k in (
            "completed_total", "rejected_total", "failed_total",
            "poisoned_total", "deadline_exceeded_total", "retries_total",
            "prefill_tokens_discarded")},
        "injected": ex.plan.injected,
        "rungs": [t[1:] for t in sched.trace if t[0] == "rung"],
        "mttr_s": sched.retry_recoveries,
        "outcomes": {r.rid: r.reject_reason for r in sched.failed
                     + sched.rejected},
        "launches": counts,
    }
    log("[chaos] " + json.dumps(out))
    return out


def _gate_plain(label: str, sched, ex, reqs: list, counts: dict) -> None:
    """Run (a)'s gates: its kernels, its trace against the same requests,
    plan and cancel over a host ``SimExecutor`` of the same chunk width
    (plain decode makes the trace independent of token values), and each
    member of the cast where the plan puts it."""
    from dpu_operator_tpu_torch.testing.chaos import ChaosExecutor
    from dpu_operator_tpu_torch.workloads.serve import (RETRY_BUDGET,
                                                        SimExecutor)
    for name in SERVE_KERNELS:
        require(counts[name] > 0, f"{label}: {name} never launched")
    for name in SERVE_NOT:
        require(counts[name] == 0, f"{label}: {name} launched")
    trace = sched.trace
    sim = SimExecutor()
    sim.chunk_capacity = ex.chunk_capacity
    twin = _chaos_serve(_audited(ChaosExecutor)(
        sim, plan=_chaos_plan(False)).poison(POISONED),
        [r.fresh_copy() for r in reqs], 0).trace
    diff = next((i for i, (a, b) in enumerate(zip(trace, twin)) if a != b),
                min(len(trace), len(twin)))
    require(trace == twin, f"{label}: the trace leaves the SimExecutor's at "
            f"entry {diff}: {trace[diff:diff + 3]} vs {twin[diff:diff + 3]}")
    log(f"[chaos] {label}: trace equals the SimExecutor run's, {len(trace)} "
        "entries")
    require(sorted(ex.plan.injected)
            == [("prefill_chunk", "Oom"), ("step", "Fail")],
            f"{label}: injected {ex.plan.injected}")
    require(any(t[0] == "step_fault" and t[2] == "decode"
                and t[4] == "ConnectionResetError" for t in trace),
            f"{label}: no decode step fault")
    require(any(t[0] == "poison"
                and t[2:] == (POISONED, RETRY_BUDGET)
                for t in trace), f"{label}: {POISONED} was not poisoned")
    by_rid = {r.rid: r for r in reqs}
    late = by_rid[ADMISSION_DEADLINE[0]]
    require(late.reject_reason == "deadline_exceeded" and not late.tokens,
            f"{label}: {late.rid} not excised at admission")
    mid = by_rid[MID_STREAM_DEADLINE[0]]
    require(mid.reject_reason == "deadline_exceeded"
            and 0 < len(mid.tokens) < mid.output_len,
            f"{label}: {mid.rid} not excised mid-stream "
            f"({mid.reject_reason!r}, {len(mid.tokens)} tokens)")
    gone = by_rid[CANCELLED[0]]
    require(gone.reject_reason == "cancelled"
            and 0 < len(gone.tokens) < gone.output_len,
            f"{label}: {gone.rid} not cancelled mid-decode")
    shed = [r.rid for r in sched.rejected
            if r.reject_reason == "degraded_shed"]
    require(shed, f"{label}: the ladder shed no batch arrival")
    cast = {POISONED, ADMISSION_DEADLINE[0], MID_STREAM_DEADLINE[0],
            CANCELLED[0], *shed}
    require(sorted(r.rid for r in sched.completed)
            == sorted(r.rid for r in reqs if r.rid not in cast),
            f"{label}: a request outside the cast did not complete")
    require(sched.retry_recoveries, f"{label}: no retried request completed")


def _gate_spec(label: str, sched, ex, reqs: list, counts: dict) -> None:
    """Run (b)'s gates: its kernels, every request complete, the four
    verify faults, the ladder at ``no_spec`` or above, and no verify
    iteration while it was there."""
    from dpu_operator_tpu_torch.workloads.degrade import RUNG_NO_SPEC
    for name in SPEC_KERNELS:
        require(counts[name] > 0, f"{label}: {name} never launched")
    require(len(sched.completed) == len(reqs),
            f"{label}: {len(sched.completed)} of {len(reqs)} completed")
    trace = sched.trace
    faults = [t for t in trace if t[0] == "step_fault" and t[2] == "verify"]
    require(len(faults) == 4, f"{label}: {len(faults)} verify faults")
    require(max((t[3] for t in trace if t[0] == "rung"), default=0)
            >= RUNG_NO_SPEC, f"{label}: the ladder never reached no_spec")
    verified = sorted({t[1] for t in trace if t[0] == "spec"})
    bad = [it for it in verified if _rung_before(trace, it) >= RUNG_NO_SPEC]
    require(not bad, f"{label}: verify ran at rung >= no_spec in iterations "
            f"{bad}")
    log(f"[chaos] {label}: {len(verified)} verify iterations, none at rung "
        f">= {RUNG_NO_SPEC}; "
        f"{sum(t[0] == 'decode' for t in trace) - len(verified)} plain "
        "decode iterations")


def phase_chaos(params, cfg, plain: list) -> dict:
    """Serving under faults on the flagship, on the virtual clock: (a)
    plain decode under a prefill Oom, a decode reset, a poisoned rid, two
    deadlines, a cancel and late batch arrivals the ladder sheds; (b)
    speculation at k 4 with the oracle drafter, verify faults walking the
    ladder past ``no_spec``. Both: injected faults only, streams held to
    the plain run's, no leaked block. Returns each run's report and the
    launches of both."""
    import torch
    from dpu_operator_tpu_torch.ops import launch_counts, reset_launch_counts
    from dpu_operator_tpu_torch.testing.chaos import ChaosExecutor
    from dpu_operator_tpu_torch.workloads.serve import TorchSlotExecutor
    dev = params["embed"].device
    runs = {}
    for label, spec_k, gates in (("chaos plain", 0, _gate_plain),
                                 ("chaos spec oracle", 4, _gate_spec)):
        reqs = _chaos_requests(plain, bool(spec_k))
        drafter = OracleDrafter({r.rid: list(r.tokens) for r in plain},
                                {r.rid: r.prompt for r in plain},
                                cfg.vocab) if spec_k else None
        inner = TorchSlotExecutor(params, cfg, slots=8, chunk_tokens=256,
                                  spec_k=spec_k, device=dev)
        ex = _audited(ChaosExecutor)(inner, plan=_chaos_plan(bool(spec_k)))
        ex.poison(*(() if spec_k else (POISONED,)))
        reset_launch_counts()
        t0 = time.monotonic()
        sched = _chaos_serve(ex, reqs, spec_k, drafter)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = launch_counts()
        log(f"[chaos] {label}: {sched.iterations} iterations in {wall:.3f} s "
            f"wall; launches during the run: {counts}")
        _injected_only(label, sched, ex)
        _streams_hold(label, params, cfg, sched, plain)
        require(sched.pool.outstanding() == 0, f"{label}: KV blocks leaked")
        gates(label, sched, ex, reqs, counts)
        runs[label] = _chaos_report(label, sched, ex, counts)
    launches = {k: sum(run["launches"][k] for run in runs.values())
                for k in launch_counts()}
    return {"runs": runs, "launches": launches}


# -- phase 11 -----------------------------------------------------------------
#: phase 11's traced request, its caller trace id and span, and the client
#: that hangs up after its first token
WIRE_TRACED = "req-00"
WIRE_TRACE_ID = "5e" * 16
WIRE_PARENT = f"00-{WIRE_TRACE_ID}-{'ab' * 8}-01"
WIRE_HANGUP = "wire-hangup"
#: the longest a wire client or a wait of phase 11 may take (s)
WIRE_WAIT_S = 300.0
#: the serving families' series ``/debug/history`` must hold after phase
#: 11's streams, each with at least one sample (``tpu_slo_burn_rate.*``
#: appears only once an SLO has been evaluated, so it is not required)
WIRE_HISTORY_SERIES = (
    "tpu_serve_prefill_chunk_backlog_tokens", "tpu_serve_kv_blocks.used",
    "tpu_serve_kv_blocks.free", "tpu_serve_spec_acceptance_rate",
    "tpu_serve_degraded_rung",
    *(f"tpu_serve_{h}_seconds.{q}" for h in ("ttft", "itl")
      for q in ("p50", "p95", "p99", "rate")))
#: phase 11's wire tokens/s in an earlier run of this script, named beside
#: this run's: the first version of the phase, before it armed the profiler
#: and history planes (PERF.md §6, on "NVIDIA H100 80GB HBM3, 700.00 W")
WIRE_PRIOR_TOKENS_PER_S = 208.4


def _wire_post(port: int, body: dict, headers=None,
               hang_up_after: int = 0) -> dict:
    """POST /v1/generate over a bare socket and read the chunked NDJSON
    response chunk by chunk (each chunk must hold exactly one JSON line):
    the chunks, the send time, the first token chunk's and the end's
    arrival on the host clock. With *hang_up_after* the client closes its
    socket after that many token chunks."""
    import socket
    data = json.dumps(body).encode()
    head = ["POST /v1/generate HTTP/1.1", "Host: 127.0.0.1",
            "Content-Type: application/json", f"Content-Length: {len(data)}"]
    head += [f"{k}: {v}" for k, v in (headers or {}).items()]
    out = {"chunks": [], "t_first": None}
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=WIRE_WAIT_S) as sock:
        f = sock.makefile("rb")
        out["t_send"] = time.monotonic()
        sock.sendall("\r\n".join(head).encode() + b"\r\n\r\n" + data)
        status = f.readline()
        require(b" 200 " in status, f"wire {body['rid']}: {status!r}")
        while f.readline() not in (b"\r\n", b""):
            pass
        while True:
            size = int(f.readline().strip(), 16)
            payload = f.read(size + 2)
            if size == 0:
                break
            lines = payload[:-2].split(b"\n")
            require(payload.endswith(b"\r\n") and len(lines) == 2
                    and lines[1] == b"",
                    f"wire {body['rid']}: a chunk that is not one NDJSON "
                    f"line: {payload[:120]!r}")
            chunk = json.loads(lines[0])
            out["chunks"].append(chunk)
            if "token" in chunk and out["t_first"] is None:
                out["t_first"] = time.monotonic()
            if hang_up_after and len(out["chunks"]) >= hang_up_after:
                f.close()
                break
    out["t_end"] = time.monotonic()
    return out


def phase_wire(params, cfg, serve: dict, smi: str) -> dict:
    """Phase 11: phase 5's 16 requests, each POSTed by its own client
    thread at once, through ``DecodeService.start_http`` over the
    flagship's ``TorchSlotExecutor`` (8 slots, chunks of 256) on the host
    clock, ``WIRE_TRACED`` with a caller traceparent; then a 17th client
    that hangs up after its first token. Gates: every stream equals phase
    5's plain stream of its rid, one token a chunk, the ledger reconciles,
    the token counter's delta equals the tokens generated, the three
    ``/debug/serve*`` endpoints answer over a MetricsServer, every phase
    span of the traced request carries its trace id, the hung-up request
    is cancelled (slot and blocks back), no fault, ``stop()`` within 5 s.
    ``DecodeService.start`` arms the sampling profiler and the metrics
    history over the serving families: ``/debug/profile`` must have
    sampled the step loop's thread (``serve-scheduler``), ``/debug/history``
    must hold :data:`WIRE_HISTORY_SERIES` with a sample each, and the
    headroom digest's ``trendAnomalies`` must be a list. Prints wire TTFT
    p50 / p99 and wire tokens/s beside phase 5's plain run in process,
    the ledger's mean ms per phase, the profiler's overhead ratio and the
    step loop's top three sites. The profiler is stopped at the end, so
    the later phases' timings run without it. Returns the launches of the
    traffic."""
    import threading
    import torch
    from dpu_operator_tpu_torch.ops import launch_counts, reset_launch_counts
    from dpu_operator_tpu_torch.utils import flight, history, metrics, \
        profiler
    from dpu_operator_tpu_torch.utils.metrics import MetricsServer
    from dpu_operator_tpu_torch.workloads.serve import (
        LEDGER_PHASES, DecodeService, Request, Scheduler, ServeConfig,
        TorchSlotExecutor)
    from dpu_operator_tpu_torch.utils.stats import nearest_rank
    plain = serve["plain"]
    ex = TorchSlotExecutor(params, cfg, slots=8, chunk_tokens=256,
                           device="cuda")
    sched = Scheduler(ServeConfig(slots=8, kv_blocks=8 * cfg.max_seq // 16,
                                  kv_block_size=16, prefill_chunk_tokens=256),
                      ex, clock=time.monotonic)
    # every route warm before the service thread steps: one chunked
    # prefill (two chunks) and its decodes
    warm = Request(rid="wire-warm", prompt_len=300, output_len=4,
                   prompt=tuple(i % cfg.vocab for i in range(300)),
                   arrival_s=sched.now)
    sched.submit(warm)
    sched.run()
    require(warm.state == "done", "phase 11: the warm-up request failed")
    torch.cuda.synchronize()
    warm_iterations = sched.iterations
    cancelled = threading.Event()
    cancel_at: list = []
    cancel = sched.cancel

    def watched_cancel(rid):
        hit = cancel(rid)
        cancel_at.append(time.monotonic())
        cancelled.set()
        return hit

    sched.cancel = watched_cancel
    service = DecodeService(sched, idle_interval_s=0.005)
    tokens_before = metrics.SERVE_TOKENS.total()
    flight.RECORDER.clear()
    reset_launch_counts()
    # the profiler's overhead is metered over this phase alone
    profiler.PROFILER.reset()
    samples_before = history.HISTORY.samples
    service.start()
    port = service.start_http("127.0.0.1", 0)
    server = MetricsServer(host="127.0.0.1", port=0,
                           debug_handlers=service.debug_handlers())
    server.start()
    results: dict = {}
    errors: list = []
    barrier = threading.Barrier(len(plain))

    def client(r):
        try:
            barrier.wait(timeout=WIRE_WAIT_S)
            results[r.rid] = _wire_post(
                port, {"rid": r.rid, "prompt": list(r.prompt),
                       "output_len": r.output_len, "slo_class": "batch"},
                headers={"traceparent": WIRE_PARENT}
                if r.rid == WIRE_TRACED else None)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"{r.rid}: {type(e).__name__}: {e}")

    try:
        threads = [threading.Thread(target=client, args=(r,), daemon=True)
                   for r in plain]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WIRE_WAIT_S)
        require(not errors and not any(t.is_alive() for t in threads),
                f"phase 11: clients failed: {errors[:3]}")
        t_last = max(res["t_end"] for res in results.values())
        t_start = min(res["t_send"] for res in results.values())
        # the 17th client: its first token, then it hangs up
        src = plain[0]
        hung = _wire_post(port, {"rid": WIRE_HANGUP,
                                 "prompt": list(src.prompt),
                                 "output_len": cfg.max_seq - src.prompt_len},
                          hang_up_after=1)
        require(cancelled.wait(WIRE_WAIT_S),
                "phase 11: the hung-up client's request was never cancelled")
        torch.cuda.synchronize()
        counts = launch_counts()
        # two history passes over the traffic (a histogram's quantiles
        # need a window: its first pass is the reference)
        deadline = time.monotonic() + 3 * history.HISTORY.interval_s + 5
        while history.HISTORY.samples < samples_before + 3 \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        addr = f"127.0.0.1:{server.port}"
        snap = flight.fetch(addr, path="/debug/serve")
        ledger = flight.fetch(addr, path="/debug/serve/ledger")
        headroom = flight.fetch(addr, path="/debug/serve/headroom")
        prof = flight.fetch(addr, path="/debug/profile")
        hist = flight.fetch(addr, path="/debug/history")
    finally:
        t0 = time.monotonic()
        service.stop()
        stop_s = time.monotonic() - t0
        server.stop()
        profiler.PROFILER.stop()
    require(stop_s < 5.0, f"phase 11: stop() took {stop_s:.2f} s")
    require(prof["samples"] > 0 and "serve-scheduler" in prof["threads"],
            f"phase 11: /debug/profile took {prof['samples']} samples of "
            f"threads {sorted(prof['threads'])}, not the step loop's")
    require("jax" not in prof, "phase 11: /debug/profile carries a jax block")
    missing = [name for name in WIRE_HISTORY_SERIES
               if not hist["series"].get(name, {}).get("raw")]
    require(not missing, f"phase 11: /debug/history after "
            f"{hist['samples']} samples lacks {missing}")
    require(isinstance(headroom.get("trendAnomalies"), list),
            f"phase 11: trendAnomalies {headroom.get('trendAnomalies')!r}")
    log(f"[wire] launches during the phase: {counts}")
    for name in SERVE_KERNELS:
        require(counts[name] > 0,
                f"phase 11: kernel {name} never launched over the wire")
    _require_fault_free("wire", sched)
    streamed = 0
    for r in plain:
        chunks = results[r.rid]["chunks"]
        got = [c["token"] for c in chunks if "token" in c]
        require(chunks[-1] == {"done": True, "tokens": r.output_len},
                f"wire {r.rid}: terminal record {chunks[-1]}")
        first = next((i for i, (a, b) in enumerate(zip(got, r.tokens))
                      if a != b), min(len(got), len(r.tokens)))
        require(got == r.tokens, f"wire {r.rid}: the stream leaves phase "
                f"5's plain stream at token {first}")
        streamed += len(got)
    hung_req = next((q for q in sched.rejected if q.rid == WIRE_HANGUP), None)
    require(hung_req is not None and hung_req.reject_reason == "cancelled",
            "phase 11: the hung-up request is not among the cancelled")
    require(hung["chunks"] and "token" in hung["chunks"][0],
            "phase 11: the hung-up client saw no token")
    require(sched.pool.outstanding() == 0,
            f"phase 11: {sched.pool.outstanding()} KV blocks outstanding")
    require(snap["capacity"]["freeSlots"] == 8
            and headroom["freeSlots"] == 8,
            f"phase 11: free slots {snap['capacity']['freeSlots']} / "
            f"{headroom['freeSlots']} at the end, not 8")
    require(ledger["reconciliation"]["ok"] and sched.ledger.reconcile()["ok"],
            f"phase 11: the ledger does not reconcile: "
            f"{ledger['reconciliation']}")
    generated = streamed + len(hung_req.tokens)
    delta = metrics.SERVE_TOKENS.total() - tokens_before
    require(delta == generated,
            f"phase 11: tpu_serve_tokens_total moved {delta}, the streams "
            f"carried {streamed} and the cancelled request generated "
            f"{len(hung_req.tokens)}")
    spans = [e for e in flight.RECORDER.events(kind="serve")
             if (e.get("attributes") or {}).get("rid") == WIRE_TRACED]
    require(spans and {e.get("trace_id") for e in spans} == {WIRE_TRACE_ID},
            f"phase 11: {WIRE_TRACED}'s phase spans carry "
            f"{sorted({str(e.get('trace_id')) for e in spans})}")
    ttfts = [res["t_first"] - res["t_send"] for res in results.values()]
    wall = t_last - t_start
    entries = [e for e in sched.ledger.entries()
               if e["iteration"] > warm_iterations]
    mean_ms = {k: 1e3 * sum(e["phases"][k] for e in entries) / len(entries)
               for k in LEDGER_PHASES}
    total_ms = 1e3 * sum(e["total_s"] for e in entries) / len(entries)
    # the step loop's share of the 16 streams' wall time: the ledger's
    # iterations that ended inside it (now_s is on the clients' clock)
    in_step = sum(e["total_s"] for e in entries
                  if t_start <= e["now_s"] <= t_last)
    loop_sites = prof["threads"]["serve-scheduler"][:3]
    out = {
        "requests": len(plain), "generated_tokens": streamed,
        "wall_s": wall, "tokens_per_s": streamed / wall,
        "plain_tokens_per_s": serve["runs"]["plain"]["tokens_per_s"],
        "plain_ttft_p50_s": serve["runs"]["plain"]["ttft_p50_s"],
        "wire_ttft_p50_s": nearest_rank(ttfts, 0.50),
        "wire_ttft_p99_s": nearest_rank(ttfts, 0.99),
        "profile_overhead_ratio": prof["overheadRatio"],
        "profile_samples": prof["samples"],
        "step_loop_top_sites": loop_sites,
        "history_samples": hist["samples"],
        "history_series": len(hist["series"]),
        "trend_anomalies": headroom["trendAnomalies"],
        "iterations": len(entries), "ledger_mean_ms": mean_ms,
        "ledger_total_ms": total_ms, "in_step_share": in_step / wall,
        "stop_s": stop_s, "hung_up_tokens": len(hung_req.tokens),
        "cancel_after_hangup_s": cancel_at[0] - hung["t_end"],
        "launches": counts,
    }
    log(f"[wire] {len(plain)} streams over HTTP, profiler and history "
        f"armed: wire TTFT p50 {out['wire_ttft_p50_s'] * 1e3:.1f} ms, p99 "
        f"{out['wire_ttft_p99_s'] * 1e3:.1f} ms (phase 5 plain, in process: "
        f"TTFT p50 {out['plain_ttft_p50_s'] * 1e3:.1f} ms); {streamed} "
        f"tokens in {wall:.3f} s = {out['tokens_per_s']:.1f} tokens/s over "
        f"the wire (phase 5 plain, in process: "
        f"{out['plain_tokens_per_s']:.1f}; a prior run of this phase "
        f"without the planes: {WIRE_PRIOR_TOKENS_PER_S} tokens/s); on "
        f"{smi}")
    log(f"[wire] tpu_profile_overhead_ratio {prof['overheadRatio']:.6f} "
        f"over {prof['samples']} samples ({prof['sampleCostS']:.4f} s of "
        f"sampling in {prof['elapsedS']:.3f} s); the step loop's "
        f"(serve-scheduler) top sites by self samples: "
        + "; ".join(f"{r['site']} self {r['self']} total {r['total']}"
                    for r in loop_sites)
        + f"; /debug/history: {hist['samples']} samples, "
        f"{len(hist['series'])} series; trendAnomalies "
        f"{headroom['trendAnomalies']}")
    log(f"[wire] ledger over {len(entries)} iterations, mean ms a phase: "
        + ", ".join(f"{k} {v:.3f}" for k, v in mean_ms.items())
        + f"; total {total_ms:.3f} (host clock; device time lands where "
        f"the tokens' copy synchronizes); the step loop ran "
        f"{in_step / wall:.3f} of the streams' wall time; on {smi}")
    log(f"[wire] the hung-up client's request cancelled "
        f"{out['cancel_after_hangup_s'] * 1e3:.1f} ms after the hang-up, "
        f"after {len(hung_req.tokens)} tokens; stop() {stop_s:.3f} s")
    log("[wire] " + json.dumps({k: v for k, v in out.items()
                                if k != "launches"}))
    return out


def _held_slots(ex, cfg, rng) -> list:
    """Fill the 8 slots of *ex* with 512-token prompts drawn from *rng*
    (two chunks of 256 each): the ``(slot, request)`` pairs of a full
    decode batch."""
    from dpu_operator_tpu_torch.workloads.serve import Request
    active = []
    for slot in range(8):
        ids = tuple(int(t) for t in rng.integers(0, cfg.vocab, 512))
        req = Request(rid=f"p{slot}", prompt_len=512, output_len=64,
                      prompt=ids)
        ex.prefill_chunk(req, slot, 0, 256)
        ex.prefill_chunk(req, slot, 256, 256)
        active.append((slot, req))
    return active


def profile_window(params, cfg) -> dict:
    """Where a serving iteration's time goes at the flagship shape: the
    device's busy time (torch.profiler's kernel times) per decode
    iteration of 8 slots holding 512-token prompts, per verify iteration
    of the same 8 slots at width 5 (4 drafts each), and per 256-token
    prefill chunk, beside the same work's wall time without the profiler.
    A measurement, not a check: prints "not measured" when the profiler
    sees no device time. Returns :func:`profile_calls`' numbers by
    label."""
    from dpu_operator_tpu_torch.workloads.serve import TorchSlotExecutor
    ex = TorchSlotExecutor(params, cfg, slots=8, chunk_tokens=256,
                           spec_k=4, device="cuda")
    rng = np.random.default_rng(99)
    active = _held_slots(ex, cfg, rng)
    drafts = {slot: [int(t) for t in rng.integers(0, cfg.vocab, 4)]
              for slot in range(8)}
    work = {"decode iteration (8 slots)": lambda: ex.step(active),
            "verify iteration (8 slots x 5 rows)":
                lambda: ex.spec_step(active, drafts),
            "prefill chunk (256 tokens)":
                lambda: ex.prefill_chunk(active[0][1], 0, 0, 256)}
    return {label: profile_calls(label, fn, 10)
            for label, fn in work.items()}


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


def profile_calls(label: str, fn, n: int, warmup: int = 3) -> dict:
    """Wall time per call of *fn* without the profiler, then the device's
    busy time per call (:func:`device_times`), its idle share and the
    largest device items. A measurement, not a check: prints "not
    measured" when the profiler sees no device time. Returns ``{"wall_ms",
    "busy_ms"}``, ``busy_ms`` None where not measured."""
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
        return {"wall_ms": wall_ms, "busy_ms": None}
    busy_ms = sum(by_kernel.values())
    if busy_ms <= 0:
        log(f"[profile] {label}: wall {wall_ms:.3f} ms; device busy "
            "not measured (the profiler saw no device time)")
        return {"wall_ms": wall_ms, "busy_ms": None}
    log(f"[profile] {label}: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, device idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    for name, ms in top:
        log(f"[profile]   {ms:8.4f} ms/call  {name[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms}


# -- phase 7 ------------------------------------------------------------------
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


# -- phase 8 ------------------------------------------------------------------
#: measure_decode's rows (bench.py's three decode sections): label, batch,
#: int8 weights, int8 cache, chain length (B8 at 3/4 of B1's, as bench.py)
DECODE_ROWS = (("B1 bf16", 1, False, False, 48),
               ("B1 W8A8", 1, True, False, 48),
               ("B8 W8A8 + KV8", 8, True, True, 36))


def _quant_checks(params, qparams, cfg) -> None:
    """W8A8 against bf16 on the flagship, and the KV8 invariants: prefill
    logits correlated above 0.99 (tests/test_decode.py's gate), the
    W8A8 + KV8 stream's agreement with bf16 reported, a decode_step loop
    equal to ``generate(kv_int8=True)`` token for token, and a KV8 chunked
    prefill whose continuation decodes to finite logits."""
    import torch
    from dpu_operator_tpu_torch.workloads.decode import (
        decode_step, generate, init_kv_cache, prefill, prefill_chunk)
    rng = np.random.default_rng(88)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64))).cuda()
    _, lb = prefill(params, cfg, prompt)
    _, lq = prefill(qparams, cfg, prompt)
    corr = float(np.corrcoef(lb.cpu().numpy().ravel(),
                             lq.cpu().numpy().ravel())[0, 1])
    log(f"[quant] W8A8 prefill logits (2 x 64 tokens) against bf16: "
        f"correlation {corr:.6f} (gate > 0.99), max |diff| "
        f"{float((lb - lq).abs().max()):.4f}")
    require(corr > 0.99, f"W8A8 prefill logits correlate {corr} with bf16")
    steps = 32
    sb = generate(params, cfg, prompt, steps, device="cuda")
    sq = generate(qparams, cfg, prompt, steps, device="cuda", kv_int8=True)
    log(f"[quant] W8A8 + KV8 greedy stream against bf16 (random weights, "
        f"reported): {float((sb == sq).float().mean()):.3f} of {sq.numel()} "
        f"tokens agree; first difference at token "
        f"{[next((i for i in range(steps) if sb[b, i] != sq[b, i]), steps) for b in range(2)]}")
    cache, logits = prefill(qparams, cfg, prompt, kv_int8=True)
    pos = torch.full((2,), prompt.shape[1], dtype=torch.int32, device="cuda")
    out = []
    for i in range(steps):
        tok = logits.argmax(-1)
        out.append(tok)
        logits, cache = decode_step(qparams, cfg, cache, tok, pos + i)
    require(torch.equal(torch.stack(out, 1), sq),
            "a W8A8 + KV8 decode_step loop differs from generate(kv_int8)")
    cache = init_kv_cache(cfg, 8, device="cuda", kv_int8=True)
    ids = rng.integers(0, cfg.vocab, 300)
    for off in (0, 256):
        chunk = np.zeros(256, np.int64)
        n = min(256, len(ids) - off)
        chunk[:n] = ids[off:off + n]
        cache, lc = prefill_chunk(qparams, cfg, cache, 2,
                                  torch.from_numpy(chunk), off, n)
    last = torch.zeros(8, dtype=torch.int64, device="cuda")
    last[2] = lc.argmax()
    pos8 = torch.zeros(8, dtype=torch.int32, device="cuda")
    pos8[2] = len(ids)
    step, _ = decode_step(qparams, cfg, cache, last, pos8)
    require(bool(torch.isfinite(step).all()),
            "KV8 decode after a chunked prefill gave non-finite logits")
    log(f"[quant] decode_step loop ({steps} steps) equals "
        "generate(kv_int8=True) token for token; a KV8 chunked prefill "
        "(300 tokens in 2 chunks of 256 into slot 2 of 8) decodes to finite "
        "logits")


def _quant_profile(qparams, cfg) -> None:
    """Where a quantized decode iteration's time goes: the W8A8 executor's
    decode iteration (8 slots holding 512-token prompts, bf16 cache) and a
    W8A8 + KV8 ``decode_step`` over the same 8 slots. A measurement, not a
    check."""
    import torch
    from dpu_operator_tpu_torch.workloads.decode import (
        decode_step, init_kv_cache, prefill_chunk)
    from dpu_operator_tpu_torch.workloads.serve import (Request,
                                                        TorchSlotExecutor)
    ex = TorchSlotExecutor(qparams, cfg, slots=8, chunk_tokens=256,
                           device="cuda")
    cache = init_kv_cache(cfg, 8, device="cuda", kv_int8=True)
    rng = np.random.default_rng(99)
    active = []
    for slot in range(8):
        ids = tuple(int(t) for t in rng.integers(0, cfg.vocab, 512))
        req = Request(rid=f"p{slot}", prompt_len=512, output_len=64,
                      prompt=ids)
        for off in (0, 256):
            ex.prefill_chunk(req, slot, off, 256)
            prefill_chunk(qparams, cfg, cache, slot,
                          torch.tensor(ids[off:off + 256]), off, 256)
        active.append((slot, req))
    tokens = torch.from_numpy(ex.last.astype(np.int64)).cuda()
    pos = torch.full((8,), 512, dtype=torch.int32, device="cuda")
    profile_calls("W8A8 decode iteration (8 slots, bf16 cache)",
                  lambda: ex.step(active), 10)
    profile_calls("W8A8 + KV8 decode_step (8 slots at 512)",
                  lambda: decode_step(qparams, cfg, cache, tokens, pos), 10)


def phase_quant(cfg) -> dict:
    """The quantized serving path of the flagship (bf16, random weights
    from the seed of phases 5-6): ``quantize_decode_params`` on the card,
    :func:`_quant_checks`, ``measure_decode``'s three rows, then phase 5's
    16 requests served on the W8A8 tree through ``Scheduler`` and
    ``TorchSlotExecutor`` (bf16 cache, as the executor keeps it) between
    two bf16 runs of the same requests, and :func:`_quant_profile`. The
    KV8 kernels must launch. Returns the rows, the serve runs and the
    launches of the phase's main path."""
    import torch
    from dpu_operator_tpu_torch.ops import launch_counts, reset_launch_counts
    from dpu_operator_tpu_torch.workloads.decode import (
        generate, quantize_decode_params)
    from dpu_operator_tpu_torch.workloads.model import init_params, param_bytes
    from dpu_operator_tpu_torch.workloads.perf import measure_decode
    from dpu_operator_tpu_torch.workloads.serve import Request
    params = init_params(0, cfg, device="cuda")
    reset_launch_counts()
    t0 = time.monotonic()
    qparams = quantize_decode_params(params)
    torch.cuda.synchronize()
    wb, qb = param_bytes(params), param_bytes(qparams)
    log(f"[quant] quantize_decode_params on the card in "
        f"{time.monotonic() - t0:.2f} s: {qb / 1e6:.1f} MB of int8 tree "
        f"against {wb / 1e6:.1f} MB in bf16")
    _quant_checks(params, qparams, cfg)
    rows = {}
    for label, batch, quantized, kv_int8, steps in DECODE_ROWS:
        r = measure_decode(cfg, batch=batch, steps=steps, iters=2, best_of=1,
                           quantized=quantized, kv_int8=kv_int8,
                           device="cuda")
        rows[label] = r
        log(f"[quant] measure_decode {label}: {r['tokens_per_s']:.1f} "
            f"tokens/s, {r['ms_per_token']:.3f} ms a step against the "
            f"{r['bound']} bound {r['roofline_ms_per_token']:.4f} ms (HBM "
            f"{r['hbm_ms_per_token']:.4f} ms), roofline_frac "
            f"{r['roofline_frac']:.4f}")
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"[quant] launches of the checks and measure_decode: {counts}")
    # the flagship's KV8 routes: decode on the cluster kernel, chunks of
    # 256 rows on the tensor cores
    for name in ("attention_kv8_rows", "attention_kv8_tc"):
        require(counts[name] > 0, f"{name} never launched on the KV8 path")

    reqs = _requests(np.random.default_rng(2026), 16, cfg.vocab, (128, 512),
                     (32, 64))
    generate(qparams, cfg, torch.tensor([reqs[0].prompt[:64]]), 4,
             device="cuda")

    def fresh():
        return [Request(rid=r.rid, prompt_len=r.prompt_len,
                        output_len=r.output_len, prompt=r.prompt)
                for r in reqs]

    runs, served = {}, {}
    for label, p, nbytes in (("bf16", params, wb), ("w8a8", qparams, qb),
                             ("w8a8 again", qparams, qb),
                             ("bf16 again", params, wb)):
        served[label] = fresh()
        runs[label] = _serve_run(p, cfg, f"quant {label}", served[label],
                                 nbytes)
    for rid in ("req-00", "req-09"):
        for label in ("w8a8", "w8a8 again"):
            r = next(x for x in served[label] if x.rid == rid)
            worst = _margin(qparams, cfg, r)
            log(f"[quant] {label} {rid}: worst teacher-forced margin under "
                f"the W8A8 model {worst:.4f} (tol {SERVE_LOGIT_TOL})")
            require(worst <= SERVE_LOGIT_TOL,
                    f"{label} {rid}: a served token is {worst:.4f} below the "
                    "best logit of the W8A8 model")
    log("[quant] serve tokens/s, bf16 / w8a8 / w8a8 again / bf16 again: "
        + " / ".join(f"{runs[k]['tokens_per_s']:.1f}" for k in runs))
    for run in runs.values():
        counts = {k: counts[k] + run["launches"][k] for k in counts}
    _quant_profile(qparams, cfg)
    out = {"measure_decode": rows,
           "serve": {k: {n: v for n, v in run.items() if n != "launches"}
                     for k, run in runs.items()},
           "launches": counts}
    log("[quant] " + json.dumps(out))
    return out


# -- phase 9 ------------------------------------------------------------------
#: the open loop over the real executor: this much virtual time of
#: arrivals (the reference's horizon is 60 s; cut to fit the script's time)
OPEN_LOOP_HORIZON_S = 10.0
#: served tokens held to the teacher-forced margin: the first completed
MARGIN_REQUESTS = 4


def _cost_line(cm) -> str:
    return (f"decode_base {cm.decode_base_s * 1e3:.4f} ms, decode_per_seq "
            f"{cm.decode_per_seq_s * 1e3:.6f} ms, prefill_per_token "
            f"{cm.prefill_per_token_s * 1e3:.5f} ms, spec_verify_per_token "
            f"{cm.spec_verify_per_token_s * 1e3:.6f} ms; decode_s(1) "
            f"{cm.decode_s(1) * 1e3:.4f} ms, decode_s(8) "
            f"{cm.decode_s(8) * 1e3:.4f} ms, prefill_s(32) "
            f"{cm.prefill_s(32) * 1e3:.4f} ms, verify_s(8, 4) "
            f"{cm.verify_s(8, 4) * 1e3:.4f} ms")


def _calibrate(cfg) -> list:
    """``calibrate_cost_model`` of the flagship on the card three times:
    each fit beside the JAX defaults, and each field's spread."""
    from dpu_operator_tpu_torch.workloads.serve import (CostModel,
                                                        calibrate_cost_model)
    fits = [calibrate_cost_model(cfg, device="cuda") for _ in range(3)]
    for i, cm in enumerate(fits):
        log(f"[measure] calibrated CostModel {i + 1} of 3: {_cost_line(cm)}")
    log(f"[measure] the JAX defaults: {_cost_line(CostModel())}")
    for f in dataclasses.fields(CostModel):
        vals = [getattr(cm, f.name) for cm in fits]
        require(all(np.isfinite(v) and v > 0 for v in vals),
                f"calibrated {f.name} not finite and positive: {vals}")
        log(f"[measure] spread of {f.name} over the 3 fits: "
            f"{min(vals) * 1e3:.6f} - {max(vals) * 1e3:.6f} ms "
            f"(max / min {max(vals) / min(vals):.3f})")
    return fits


def _virtual_bench(cm, config) -> dict:
    """``bench_serving`` over the calibrated model (virtual clock,
    ``SimExecutor``): tokens/s, TTFT and ITL per load, the batching
    speedup, no leak."""
    from dpu_operator_tpu_torch.workloads.serve import bench_serving
    t0 = time.monotonic()
    rec = bench_serving(seed=0, loads=(0.5, 0.8, 1.1), cost_model=cm,
                        config=config)
    for load, row in rec["loads"].items():
        log(f"[measure] virtual bench load {load} ({row['offered_rps']} "
            f"requests/s, {row['requests']} requests): "
            f"{row['tokens_per_s']} tokens/s, TTFT p50 / p99 "
            f"{row['ttft_p50_s']} / {row['ttft_p99_s']} s, ITL p50 / p99 "
            f"{row['itl_p50_s']} / {row['itl_p99_s']} s, rejected "
            f"{row['rejected']}, KV occupancy max {row['kv_occupancy_max']}")
        require(row["kv_blocks_leaked"] == 0,
                f"virtual bench load {load} leaked KV blocks")
    cvs = rec["continuous_vs_static"]
    for mode in ("continuous", "static"):
        require(cvs[mode]["kv_blocks_leaked"] == 0,
                f"virtual bench {mode} batching leaked KV blocks")
    log(f"[measure] virtual bench: modelled peak "
        f"{rec['peak_tokens_per_s_modeled']} tokens/s; continuous vs static "
        f"{cvs['continuous']['tokens_per_s']} / "
        f"{cvs['static']['tokens_per_s']} tokens/s = speedup "
        f"{cvs['speedup']}; host time {time.monotonic() - t0:.1f} s")
    return rec


def _real_open_loop(params, cfg, cm, config) -> dict:
    """``wall_open_loop``: arrivals at 0.8 of the modelled capacity for
    :data:`OPEN_LOOP_HORIZON_S` of virtual time, with seeded prompt ids,
    served by ``TorchSlotExecutor`` on the card; its record must equal a
    ``SimExecutor`` run's on the same arrivals (the function raises
    otherwise), the serving kernels must launch, no block may leak.
    Returns ``wall_open_loop``'s result with the run's launches."""
    from dpu_operator_tpu_torch.ops import launch_counts
    from dpu_operator_tpu_torch.workloads.serve import WALL_LOAD, wall_open_loop
    before = launch_counts()
    ol = wall_open_loop(params, cfg, cm, config, OPEN_LOOP_HORIZON_S)
    after = launch_counts()
    counts = {k: after[k] - before[k] for k in after}
    real = ol["record"]
    log(f"[measure] open loop over TorchSlotExecutor: {real['requests']} "
        f"arrivals at {ol['offered_rps']:.3f} requests/s ({WALL_LOAD} of "
        f"the modelled capacity) over {OPEN_LOOP_HORIZON_S} s of virtual "
        f"time (the reference's horizon of 60 s cut to fit the script); "
        f"{config.slots} slots, chunk budget {config.prefill_chunk_tokens} "
        f"(executor width {ol['chunk_width']}), prefix sharing off (the "
        "executor is not prefix-aware)")
    log(f"[measure] open loop launches: {counts}")
    log(f"[measure] open loop record: {json.dumps(real)}")
    require(real["kv_blocks_leaked"] == 0, "open loop leaked KV blocks")
    require(real["completed"] == real["requests"],
            f"open loop completed {real['completed']} of {real['requests']}")
    for name in SERVE_KERNELS:
        require(counts[name] > 0,
                f"open loop: kernel {name} never launched")
    log(f"[measure] open loop: {real['tokens']} tokens in {ol['wall_s']:.3f}"
        f" s of wall = {ol['wall_tokens_per_s']:.1f} tokens/s on the card, "
        f"against {real['tokens_per_s']} tokens/s of virtual time (makespan "
        f"{real['makespan_s']} s); TTFT p50 / p99 {real['ttft_p50_s']} / "
        f"{real['ttft_p99_s']} s virtual; the record equals the "
        "SimExecutor's key for key")
    return {**ol, "launches": counts}


def phase_measure(cfg) -> dict:
    """Measurement and calibration of the flagship (bf16, random weights
    from seed 0): :func:`_calibrate`, the chunk budget, the virtual bench
    over the first fit, the open loop over the real executor, then
    ``measure_flash_attention`` at :data:`FLASH_BENCH` beside SDPA
    (causal) and phase 3's case at that shape. The launch counters are
    set to 0 before the phase's main path and read after it; the served
    tokens' margins are checked after that. Returns the phase's numbers
    and launches."""
    import torch
    import torch.nn.functional as F
    from dpu_operator_tpu_torch.ops import launch_counts, reset_launch_counts
    from dpu_operator_tpu_torch.workloads.model import init_params
    from dpu_operator_tpu_torch.workloads.perf import measure_flash_attention
    from dpu_operator_tpu_torch.workloads.serve import (chunked_config,
                                                        prefill_budget_tokens)
    t_phase = time.monotonic()
    reset_launch_counts()
    fits = _calibrate(cfg)
    cm = fits[0]
    config = chunked_config(cm)
    log(f"[measure] prefill_budget_tokens(first fit, {config.slots} slots) = "
        f"{prefill_budget_tokens(cm, config.slots)}; chunked_config: "
        f"{config}")
    rec = _virtual_bench(cm, config)
    params = init_params(0, cfg, device="cuda")
    ol = _real_open_loop(params, cfg, cm, config)
    b, s, h, d = FLASH_BENCH
    fp = measure_flash_attention(b=b, s=s, h=h, d=d, iters=200, best_of=3,
                                 device="cuda")
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"[measure] launches of the phase's main path: {counts}")
    done = sorted((r for r in ol["served"] if r.finish_s is not None),
                  key=lambda r: (r.finish_s, r.rid))[:MARGIN_REQUESTS]
    for r in done:
        worst = _margin(params, cfg, r)
        log(f"[measure] open loop {r.rid} (prompt {r.prompt_len}, "
            f"{len(r.tokens)} tokens): worst teacher-forced margin "
            f"{worst:.4f} (tol {SERVE_LOGIT_TOL})")
        require(worst <= SERVE_LOGIT_TOL, f"open loop {r.rid}: a served "
                f"token is {worst:.4f} below the best logit")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    qt, kt, vt = (torch.randn((b, h, s, d), generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(3))
    sdpa = graph_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), reps=5, replays=4)
    peaks = card_peaks()
    flops = 4.0 * b * h * s * s * d / 2.0
    nbytes = 4.0 * b * s * h * d * 2
    log(f"[measure] measure_flash_attention {b}x{s}x{h}x{d} bf16 causal: "
        f"{fp.call_ms:.4f} ms a call (chained slope), "
        f"{fp.tflops_causal:.1f} TFLOP/s, frac_of_peak "
        f"{fp.frac_of_peak:.4f} of {fp.peak_tflops:.0f}; SDPA (is_causal) "
        f"{sdpa:.4f} ms under graph replay; bound: {flops / 1e9:.2f} GFLOP "
        f"at {peaks['bfloat16'] / 1e12:.0f} TFLOP/s = "
        f"{flops / peaks['bfloat16'] * 1e3:.4f} ms, {nbytes / 1e6:.1f} MB at "
        f"{peaks['hbm_bytes_per_s'] / 1e12:.2f} TB/s = "
        f"{nbytes / peaks['hbm_bytes_per_s'] * 1e3:.4f} ms (phase 3's case "
        "at this shape holds the kernel against its plain version and "
        "times both)")
    out = {"cost_models": [dataclasses.asdict(cm) for cm in fits],
           "prefill_chunk_tokens": config.prefill_chunk_tokens,
           "virtual": {load: {k: row[k] for k in (
               "offered_rps", "requests", "tokens_per_s", "ttft_p50_s",
               "ttft_p99_s", "itl_p50_s", "itl_p99_s")}
               for load, row in rec["loads"].items()},
           "continuous_speedup": rec["continuous_vs_static"]["speedup"],
           "open_loop": ol["record"], "open_loop_wall_s": ol["wall_s"],
           "open_loop_wall_tokens_per_s": ol["wall_tokens_per_s"],
           "flash": {"call_ms": fp.call_ms,
                     "tflops_causal": fp.tflops_causal,
                     "frac_of_peak": fp.frac_of_peak, "sdpa_ms": sdpa},
           "seconds": time.monotonic() - t_phase, "launches": counts}
    log("[measure] " + json.dumps({k: v for k, v in out.items()
                                   if k != "launches"}))
    return out


# -- phase 10 -----------------------------------------------------------------
#: phase 10's main path must launch each of these (every route of head dim
#: 256: the flagship's bf16 serving, KV8 and training kernels, and the
#: tiny fp32 config's 3xTF32, decode and KV8 kernels)
WIDE_KERNELS = ("fused_rmsnorm", "attention_fwd_tc", "attention_fwd_decode",
                "attention_kv8_rows", "attention_kv8_tc",
                "attention_fwd_lse_tc", "attention_bwd_dq_tc",
                "attention_bwd_dkv_tc", "attention_fwd_tf32",
                "attention_fwd_lse_tf32", "attention_bwd_dq_tf32",
                "attention_bwd_dkv_tf32", "attention_kv8_tf32")


def _wide_serve(params, cfg) -> None:
    """The head-dim-256 flagship served through ``Scheduler.step``: 6
    requests on 4 slots with chunked prefill (batched decode, whose bf16
    GEMMs run at other row counts than ``generate``'s, so each stream is
    held to generate's tokens or to a near-tie within the teacher-forced
    margin, as phase 5's), then 3 requests on one slot without chunks, the
    shapes ``generate`` runs, whose streams must equal ``generate``'s token
    for token."""
    import torch
    from dpu_operator_tpu_torch.workloads.decode import generate
    rng = np.random.default_rng(256)
    reqs = _requests(rng, 6, cfg.vocab, (40, 300), (16, 32))
    sched, _ = _serve(params, cfg, reqs, slots=4, chunk=256, device="cuda")
    _require_fault_free("head dim 256 serve", sched)
    require(len(sched.completed) == len(reqs),
            "head dim 256 serve incomplete")
    require(sched.pool.outstanding() == 0,
            "head dim 256 serve leaked KV blocks")
    equal = 0
    for r in reqs:
        want = generate(params, cfg, torch.tensor([r.prompt]), r.output_len,
                        device="cuda")[0].tolist()
        equal += r.tokens == want
        worst = _margin(params, cfg, r)
        require(worst <= SERVE_LOGIT_TOL, f"head dim 256 serve {r.rid}: a "
                f"served token is {worst:.4f} below the best logit")
    log(f"[wide] serve, 4 slots, chunk 256: {len(reqs)} requests, "
        f"{equal} streams equal generate token for token, every served "
        f"token within the teacher-forced margin (tol {SERVE_LOGIT_TOL})")
    one = _requests(rng, 3, cfg.vocab, (40, 300), (16, 32))
    sched, _ = _serve(params, cfg, one, slots=1, chunk=0, device="cuda")
    _require_fault_free("head dim 256 one-slot serve", sched)
    for r in one:
        want = generate(params, cfg, torch.tensor([r.prompt]), r.output_len,
                        device="cuda")[0].tolist()
        require(r.tokens == want, f"head dim 256 one-slot serve {r.rid}: "
                f"stream {r.tokens} != generate {want}")
    log(f"[wide] serve, 1 slot, whole prefill: {len(one)} requests, every "
        "stream equals generate token for token")


def _wide_quant(params, cfg) -> None:
    """W8A8 + KV8 at head dim 256: a decode_step loop over an int8 cache
    (the KV8 cluster kernel) equal to ``generate(kv_int8=True)``, and a KV8
    chunked prefill (300 tokens in two chunks of 256 into slot 2 of 8: the
    KV8 tensor-core kernel) whose continuation decodes to finite logits."""
    import torch
    from dpu_operator_tpu_torch.workloads.decode import (
        decode_step, generate, init_kv_cache, prefill, prefill_chunk,
        quantize_decode_params)
    qparams = quantize_decode_params(params)
    rng = np.random.default_rng(257)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64))).cuda()
    steps = 24
    want = generate(qparams, cfg, prompt, steps, device="cuda", kv_int8=True)
    cache, logits = prefill(qparams, cfg, prompt, kv_int8=True)
    pos = torch.full((2,), prompt.shape[1], dtype=torch.int32, device="cuda")
    out = []
    for i in range(steps):
        tok = logits.argmax(-1)
        out.append(tok)
        logits, cache = decode_step(qparams, cfg, cache, tok, pos + i)
    require(torch.equal(torch.stack(out, 1), want), "head dim 256: a W8A8 "
            "+ KV8 decode_step loop differs from generate(kv_int8=True)")
    cache = init_kv_cache(cfg, 8, device="cuda", kv_int8=True)
    ids = rng.integers(0, cfg.vocab, 300)
    for off in (0, 256):
        chunk = np.zeros(256, np.int64)
        n = min(256, len(ids) - off)
        chunk[:n] = ids[off:off + n]
        cache, lc = prefill_chunk(qparams, cfg, cache, 2,
                                  torch.from_numpy(chunk), off, n)
    last = torch.zeros(8, dtype=torch.int64, device="cuda")
    last[2] = lc.argmax()
    pos8 = torch.zeros(8, dtype=torch.int32, device="cuda")
    pos8[2] = len(ids)
    step, _ = decode_step(qparams, cfg, cache, last, pos8)
    require(bool(torch.isfinite(step).all()), "head dim 256: KV8 decode "
            "after a chunked prefill gave non-finite logits")
    log(f"[wide] W8A8 + KV8: a decode_step loop ({steps} steps, 2 rows) "
        "equals generate(kv_int8=True); a KV8 chunked prefill (300 tokens, "
        "2 chunks of 256 into slot 2 of 8) decodes to finite logits")


def _wide_train(cfg) -> None:
    """Two AdamW steps of the head-dim-256 flagship at batch 8 x 1024:
    each loss finite, every gradient leaf finite and non-zero."""
    import torch
    from dpu_operator_tpu_torch.workloads.model import make_example_batch
    from dpu_operator_tpu_torch.workloads.perf import FLAGSHIP_BATCH
    from dpu_operator_tpu_torch.workloads.train import (make_train_step,
                                                        param_leaves)
    step, init_state, place = make_train_step(cfg, device="cuda")
    params, opt = init_state(1)
    batch = place(make_example_batch(cfg, batch=FLAGSHIP_BATCH))
    losses = []
    for _ in range(2):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    require(all(np.isfinite(losses)), f"head dim 256 train: loss {losses}")
    leaves = param_leaves(params)
    for i, t in enumerate(leaves):
        require(t.grad is not None and bool(torch.isfinite(t.grad).all())
                and float(t.grad.abs().max()) > 0, f"head dim 256 train: "
                f"gradient leaf {i} missing, non-finite or all zero")
    log(f"[wide] train, batch {FLAGSHIP_BATCH}x{cfg.max_seq}: two steps, "
        f"losses {losses[0]:.4f}, {losses[1]:.4f}; all {len(leaves)} "
        "gradient leaves finite and non-zero")
    del params, opt


#: the tiny fp32 model's KV8 logits, card against CPU: each side quantizes
#: K and V it computed in its own summation order, so an element within
#: fp32 noise of an int8 rounding midpoint lands one int8 step (1/127 of its
#: row's largest) apart, which moves a logit by about 1e-3 (1.34e-3 on the
#: H100 at this config and seed); the streams themselves must be equal
KV8_PARITY_TOL = 1e-2


def _kv8_chunk_parity(p_cpu, p_gpu, cfg, label: str) -> None:
    """A KV8 chunked prefill of *cfg* (fp32: two chunks of 16 rows, the
    fp32 KV8 kernel on the card) with 8 greedy decode steps after it (the
    KV8 cluster kernel), on the card and on the CPU from the same weights:
    the tokens equal, the logits within :data:`KV8_PARITY_TOL`."""
    import torch
    from dpu_operator_tpu_torch.ops import launch_counts
    from dpu_operator_tpu_torch.workloads.decode import (
        decode_step, init_kv_cache, prefill_chunk)
    ids = np.random.default_rng(12).integers(0, cfg.vocab, 30)
    got = {}
    before = launch_counts()
    for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
        cache = init_kv_cache(cfg, 2, device=dev, kv_int8=True)
        for off in (0, 16):
            chunk = np.zeros(16, np.int64)
            n = min(16, len(ids) - off)
            chunk[:n] = ids[off:off + n]
            cache, lc = prefill_chunk(p, cfg, cache, 1,
                                      torch.from_numpy(chunk), off, n)
        logits, toks = [lc.cpu()], []
        for i in range(8):
            toks.append(int(logits[-1].argmax()))
            last = torch.tensor([0, toks[-1]], device=dev)
            pos = torch.tensor([0, len(ids) + i], dtype=torch.int32,
                               device=dev)
            step, _ = decode_step(p, cfg, cache, last, pos)
            logits.append(step[1].cpu())
        got[dev] = (toks, logits)
    chunks = launch_counts()["attention_kv8_tf32"] \
        - before["attention_kv8_tf32"]
    err = max(float((a - b).abs().max())
              for a, b in zip(got["cpu"][1], got["cuda"][1]))
    log(f"[parity] {label} KV8 chunked prefill (2 chunks of 16, "
        f"{chunks} launches of the fp32 KV8 kernel) and 8 decode steps card "
        f"vs CPU: tokens equal {got['cpu'][0] == got['cuda'][0]}, logits max "
        f"|diff| {err:.3g} (tol {KV8_PARITY_TOL})")
    require(chunks == 2 * cfg.n_layers, f"{label} KV8 chunked prefill: "
            f"{chunks} launches of the fp32 KV8 kernel")
    require(got["cpu"][0] == got["cuda"][0], f"{label} KV8: greedy tokens "
            f"card {got['cuda'][0]} vs CPU {got['cpu'][0]}")
    require(err <= KV8_PARITY_TOL, f"{label} KV8 chunked prefill: logits "
            f"card vs CPU differ by {err}")


def _wide_tiny_parity() -> None:
    """A tiny fp32 config at head dim 256 (d_model 512 over 2 heads) on the
    card against the CPU, as phase 4 holds the default config: greedy
    streams, logits and a serve (:func:`_parity`), one train step
    (:func:`_train_parity`), and a KV8 chunked prefill
    (:func:`_kv8_chunk_parity`)."""
    import torch
    from dpu_operator_tpu_torch.workloads.model import TransformerConfig
    cfg = TransformerConfig(vocab=512, d_model=512, n_heads=2, n_layers=2,
                            d_ff=1024, max_seq=128, dtype=torch.float32)
    label = f"tiny fp32 at head dim {cfg.d_head}"
    p_cpu, p_gpu = _parity(cfg, 11, label)
    _train_parity(cfg, p_cpu)
    _kv8_chunk_parity(p_cpu, p_gpu, cfg, label)


def phase_wide(cfg) -> dict:
    """The flagship at head dim 256 (:func:`wide_config`: bf16, random
    weights from a seed) on the card: :func:`_wide_serve`,
    :func:`_wide_quant`, :func:`_wide_train`, then
    :func:`_wide_tiny_parity`; the launch counters are set to 0 before the
    phase and read after it, and every route of :data:`WIDE_KERNELS` must
    have launched. Returns the launches."""
    import torch
    from dpu_operator_tpu_torch.ops import launch_counts, reset_launch_counts
    from dpu_operator_tpu_torch.workloads.model import init_params, param_bytes
    t0 = time.monotonic()
    reset_launch_counts()
    params = init_params(0, cfg, device="cuda")
    log(f"[wide] flagship at {cfg.n_heads} heads of {cfg.d_head}: "
        f"{param_bytes(params) / 2 / 1e6:.1f}M parameters, d_model "
        f"{cfg.d_model}, {cfg.n_layers} layers, bf16")
    _wide_serve(params, cfg)
    _wide_quant(params, cfg)
    del params
    torch.cuda.empty_cache()
    _wide_train(cfg)
    torch.cuda.empty_cache()
    _wide_tiny_parity()
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"[wide] launches of the phase ({time.monotonic() - t0:.1f} s): "
        f"{counts}")
    for name in WIDE_KERNELS:
        require(counts[name] > 0, f"head dim 256: {name} never launched")
    return counts


# -- phase 12 -----------------------------------------------------------------
#: phase 12's expert count: what ``__graft_entry__.py`` gives at a model
#: axis of 4 (``2 * model_axis``)
MOE_EXPERTS = 8
#: phase 12 (a): the tiny fp32 MoE config of tests/test_decode.py:71-84,
#: whose capacity factor 8 covers every chunk and prompt
MOE_TINY = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                max_seq=32, moe_experts=4, moe_capacity_factor=8.0)
#: phase 12 (a): the tiny MoE's fp32 forward logits and aux, card against
#: CPU (summation order only: the same tolerance as phase 4's logits)
MOE_TINY_TOL = 1e-3
#: phase 12 (b): a capacity factor that covers every chunk of 256, every
#: prompt of generate's whole prefill and every decode step
MOE_COVER = 8.0
#: phase 12's main path must launch each of these: the tiny fp32 MoE's
#: forward, the bf16 serving and training kernels and the KV8 decode kernel
MOE_KERNELS = (("attention_fwd_tf32",) + SERVE_KERNELS + TRAIN_KERNELS
               + ("attention_kv8_rows",))


def _moe_tiny_parity() -> None:
    """Phase 12 (a): the tiny fp32 MoE on the card against the CPU from
    the same weights: 2 x 20 greedy tokens equal, forward logits and the
    aux loss within :data:`MOE_TINY_TOL`; then 4 requests served on 2
    slots with chunks of 8 on the card, every stream equal to
    ``generate``."""
    import torch
    from dpu_operator_tpu_torch.workloads.decode import generate
    from dpu_operator_tpu_torch.workloads.model import (
        TransformerConfig, forward, init_params)
    from dpu_operator_tpu_torch.workloads.train import map_params
    cfg = TransformerConfig(dtype=torch.float32, **MOE_TINY)
    p_cpu = init_params(3, cfg, device="cpu")
    p_gpu = map_params(lambda t: t.cuda(), p_cpu)
    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8)))
    s_cpu = generate(p_cpu, cfg, prompt, 20, device="cpu")
    s_gpu = generate(p_gpu, cfg, prompt, 20, device="cuda").cpu()
    require(torch.equal(s_cpu, s_gpu), f"tiny MoE: greedy streams differ "
            f"card vs CPU:\n{s_cpu}\n{s_gpu}")
    l_cpu, a_cpu = forward(p_cpu, prompt, cfg, return_aux=True)
    l_gpu, a_gpu = forward(p_gpu, prompt, cfg, return_aux=True)
    err = float((l_cpu - l_gpu.cpu()).abs().max())
    aux_err = abs(float(a_cpu) - float(a_gpu))
    log(f"[moe] tiny fp32 MoE ({cfg.moe_experts} experts, capacity factor "
        f"{cfg.moe_capacity_factor}): 2x20 greedy tokens equal card vs CPU; "
        f"forward logits max |diff| {err:.3g}, aux {float(a_gpu):.6f} "
        f"(|diff| {aux_err:.3g}) (tol {MOE_TINY_TOL})")
    require(err <= MOE_TINY_TOL and aux_err <= MOE_TINY_TOL,
            f"tiny MoE: logits / aux card vs CPU differ by {err} / {aux_err}")
    reqs = _requests(rng, 4, cfg.vocab, (3, 12), (4, 10))
    sched, _ = _serve(p_gpu, cfg, reqs, slots=2, chunk=8, device="cuda")
    _require_fault_free("tiny MoE serve", sched)
    require(len(sched.completed) == len(reqs), "tiny MoE serve incomplete")
    require(sched.pool.outstanding() == 0, "tiny MoE serve leaked KV blocks")
    for r in reqs:
        want = generate(p_gpu, cfg, torch.tensor([r.prompt]), r.output_len,
                        device="cuda")[0].tolist()
        require(r.tokens == want, f"tiny MoE serve {r.rid}: stream "
                f"{r.tokens} != generate {want}")
    log(f"[moe] tiny MoE served on the card: {len(reqs)} requests on 2 "
        "slots, chunk 8, every stream equals generate")


def _moe_serve(params, cfg, wbytes: int, dense: dict) -> dict:
    """Phase 12 (b) and (c): phase 5's 16 requests (8 slots, chunks of
    256) on the MoE flagship, at :data:`MOE_COVER` (each stream equal to
    ``generate``'s, or off at a bf16 near-tie within the teacher-forced
    margin, phase 5's rule: the batched GEMMs run at other row counts than
    generate's) and twice at the config's capacity factor (every request
    complete, no block leaked, the two runs' streams equal under ``==``);
    then the decode iteration of 8 held slots profiled beside the dense
    flagship's. Returns the runs' numbers."""
    import torch
    from dpu_operator_tpu_torch.workloads.decode import generate
    from dpu_operator_tpu_torch.workloads.serve import (Request,
                                                        TorchSlotExecutor)
    reqs = _requests(np.random.default_rng(2026), 16, cfg.vocab, (128, 512),
                     (32, 64))
    generate(params, cfg, torch.tensor([reqs[0].prompt[:64]]), 4,
             device="cuda")
    torch.cuda.synchronize()

    def fresh():
        return [Request(rid=r.rid, prompt_len=r.prompt_len,
                        output_len=r.output_len, prompt=r.prompt)
                for r in reqs]

    cover = dataclasses.replace(cfg, moe_capacity_factor=MOE_COVER)
    runs, served = {}, {}
    for label, c in (("cover", cover), ("default", cfg),
                     ("default again", cfg)):
        served[label] = fresh()
        runs[label] = _serve_run(params, c, f"moe {label}", served[label],
                                 wbytes)
    equal, worst = 0, 0.0
    for r in served["cover"]:
        want = generate(params, cover, torch.tensor([r.prompt]),
                        r.output_len, device="cuda")[0].tolist()
        if r.tokens == want:
            equal += 1
            continue
        margin = _margin(params, cover, r)
        worst = max(worst, margin)
        require(margin <= SERVE_LOGIT_TOL, f"moe cover {r.rid}: the stream "
                f"leaves generate and a served token is {margin:.4f} below "
                "the best logit")
    log(f"[moe] capacity factor {MOE_COVER}: {equal} of {len(reqs)} streams "
        f"equal generate token for token; the rest leave it at a bf16 "
        f"near-tie (worst teacher-forced margin {worst:.4f}, tol "
        f"{SERVE_LOGIT_TOL})")
    again = {r.rid: r.tokens for r in served["default again"]}
    diff = [r.rid for r in served["default"] if r.tokens != again[r.rid]]
    require(not diff, f"moe at capacity factor {cfg.moe_capacity_factor}: "
            f"streams of {diff} differ between two runs")
    log(f"[moe] capacity factor {cfg.moe_capacity_factor}: every request "
        "complete, no block leaked, and the two runs' streams equal under "
        "==")
    ex = TorchSlotExecutor(params, cfg, slots=8, chunk_tokens=256,
                           device="cuda")
    active = _held_slots(ex, cfg, np.random.default_rng(99))
    prof = profile_calls("MoE decode iteration (8 slots)",
                         lambda: ex.step(active), 10)
    d_prof = dense["decode_iteration"]

    def ms(x):
        return "not measured" if x is None else f"{x:.3f} ms"

    log(f"[moe] serve tokens/s at capacity factor {MOE_COVER} / "
        f"{cfg.moe_capacity_factor} / again: "
        + " / ".join(f"{run['tokens_per_s']:.1f}" for run in runs.values())
        + f" (dense flagship, phase 5 plain: "
        f"{dense['tokens_per_s']:.1f}); decode iteration of 8 slots: wall "
        f"{prof['wall_ms']:.3f} ms, device busy {ms(prof['busy_ms'])} "
        f"(dense: wall {d_prof['wall_ms']:.3f} ms, device busy "
        f"{ms(d_prof['busy_ms'])})")
    return {"runs": runs, "decode_iteration": prof,
            "cover_streams_equal_generate": equal}


def _moe_quant(params, cfg) -> None:
    """Phase 12 (d): the W8A8 tree of the MoE flagship (every ``moe``
    subtree left as it is): prefill logits correlated above 0.99 with
    bf16 (phase 8's gate), and a W8A8 + KV8 ``decode_step`` loop whose
    every step is finite and whose stream equals ``generate(kv_int8=
    True)``."""
    import torch
    from dpu_operator_tpu_torch.workloads.decode import (
        decode_step, generate, prefill, quantize_decode_params)
    qparams = quantize_decode_params(params)
    for i, (ql, lp) in enumerate(zip(qparams["layers"], params["layers"])):
        if "moe" in lp:
            require(ql["moe"] is lp["moe"] and "w1" not in ql,
                    f"moe quant: layer {i}'s experts were quantized")
    rng = np.random.default_rng(88)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64))).cuda()
    _, lb = prefill(params, cfg, prompt)
    _, lq = prefill(qparams, cfg, prompt)
    corr = float(np.corrcoef(lb.float().cpu().numpy().ravel(),
                             lq.float().cpu().numpy().ravel())[0, 1])
    require(corr > 0.99, f"moe W8A8 prefill logits correlate {corr} with "
            "bf16")
    steps = 32
    want = generate(qparams, cfg, prompt, steps, device="cuda", kv_int8=True)
    cache, logits = prefill(qparams, cfg, prompt, kv_int8=True)
    pos = torch.full((2,), prompt.shape[1], dtype=torch.int32, device="cuda")
    out = []
    for i in range(steps):
        require(bool(torch.isfinite(logits).all()),
                f"moe W8A8 + KV8: non-finite logits at step {i}")
        tok = logits.argmax(-1)
        out.append(tok)
        logits, cache = decode_step(qparams, cfg, cache, tok, pos + i)
    require(torch.equal(torch.stack(out, 1), want), "moe: a W8A8 + KV8 "
            "decode_step loop differs from generate(kv_int8=True)")
    log(f"[moe] W8A8 tree (experts and routers unquantized): prefill logits "
        f"(2 x 64 tokens) correlate {corr:.6f} with bf16 (gate > 0.99); a "
        f"W8A8 + KV8 decode_step loop of {steps} steps over 2 rows, every "
        "step finite, equals generate(kv_int8=True)")


def _moe_train(cfg, dense: dict) -> dict:
    """Phase 12 (e): ``measure_train`` of the MoE flagship at batch
    :data:`FLAGSHIP_BATCH` x 1024 (phase 7's), a warm-up and two timed AdamW steps,
    loss finite and falling; MFU counts active parameters
    (``train_step_flops``). Then one step on a fresh state: every gradient
    leaf finite and non-zero, the routers included; an expert that no
    token reached (an all-zero slice of a stacked ``w1`` / ``w2``
    gradient) is reported by name. Last, one profiled step."""
    import torch
    from dpu_operator_tpu_torch.workloads.model import make_example_batch
    from dpu_operator_tpu_torch.workloads.perf import (FLAGSHIP_BATCH,
                                                       active_param_count,
                                                       measure_train,
                                                       param_count)
    from dpu_operator_tpu_torch.workloads.train import (make_train_step,
                                                        named_leaves)
    batch = FLAGSHIP_BATCH
    perf = measure_train(cfg, batch=batch, steps=2, device="cuda")
    losses = perf.losses
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"moe train: losses {losses}")
    log(f"[moe] train batch {batch}x{cfg.max_seq}: step {perf.step_ms:.2f} "
        f"ms, {perf.tokens_per_s:.0f} tokens/s, MFU {perf.mfu:.4f} of "
        f"{perf.peak_tflops:.0f} TFLOP/s counting "
        f"{active_param_count(cfg) / 1e6:.1f}M active of "
        f"{param_count(cfg) / 1e6:.1f}M parameters, peak memory "
        f"{perf.peak_memory_bytes / 1e9:.2f} GB; losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f" (dense flagship, phase 7: step {dense['step_ms']:.2f} ms, MFU "
        f"{dense['mfu']:.4f}, peak memory {dense['peak_memory_gb']:.2f} GB)")
    step, init_state, place = make_train_step(cfg, device="cuda")
    params, opt = init_state(1)
    data = place(make_example_batch(cfg, batch=batch))
    step(params, opt, data)
    idle = []
    for name, t in named_leaves(params):
        require(t.grad is not None and bool(torch.isfinite(t.grad).all()),
                f"moe train: gradient leaf {name} missing or non-finite")
        require(float(t.grad.abs().max()) > 0,
                f"moe train: gradient leaf {name} is all zero")
        if ".moe.w" in name:
            per_expert = t.grad.flatten(1).abs().amax(1)
            idle += [f"{name}[{e}]" for e in
                     (per_expert == 0).nonzero().flatten().tolist()]
    leaves = named_leaves(params)
    log(f"[moe] train: all {len(leaves)} gradient leaves finite and "
        f"non-zero, the {sum('.moe.wg' in n for n, _ in leaves)} routers "
        f"included; experts no token reached: {idle or 'none'}")
    prof = profile_calls(f"MoE train step (batch {batch}x{cfg.max_seq})",
                         lambda: step(params, opt, data), 2, warmup=1)
    del params, opt
    return {"batch": batch, "step_ms": perf.step_ms,
            "tokens_per_s": perf.tokens_per_s, "mfu": perf.mfu,
            "peak_memory_gb": perf.peak_memory_bytes / 1e9,
            "losses": losses, "idle_experts": idle, "profiled_step": prof}


def phase_moe(cfg, dense: dict) -> dict:
    """Phase 12: the flagship with :data:`MOE_EXPERTS` experts (every
    second layer's FFN a top-1 mixture: layers 1, 3, ..., 11; about 1.18B
    parameters, 391.7M of them active a token; bf16, random weights from
    seed 0): (a) :func:`_moe_tiny_parity`, (b, c) :func:`_moe_serve`, (d)
    :func:`_moe_quant`, (e) :func:`_moe_train`. The launch counters are
    set to 0 before (a) and read after (e); every kernel of
    :data:`MOE_KERNELS` must have launched. *dense* holds the dense
    flagship's numbers of this run, printed beside. Returns the phase's
    numbers and launches."""
    import torch
    from dpu_operator_tpu_torch.ops import launch_counts, reset_launch_counts
    from dpu_operator_tpu_torch.workloads.model import (init_params,
                                                        param_bytes)
    from dpu_operator_tpu_torch.workloads.perf import (active_param_count,
                                                       param_count)
    moe = dataclasses.replace(cfg, moe_experts=MOE_EXPERTS)
    t0 = time.monotonic()
    reset_launch_counts()
    _moe_tiny_parity()
    params = init_params(0, moe, device="cuda")
    wbytes = param_bytes(params)
    layers = [i for i in range(moe.n_layers) if moe.is_moe_layer(i)]
    log(f"[moe] flagship with {MOE_EXPERTS} experts at layers {layers}, "
        f"capacity factor {moe.moe_capacity_factor}: "
        f"{param_count(moe) / 1e6:.1f}M parameters "
        f"({active_param_count(moe) / 1e6:.1f}M active a token), "
        f"{wbytes / 1e9:.2f} GB in bf16")
    require(wbytes == 2 * param_count(moe), "moe: the tree's bytes are not "
            "2 a parameter")
    serve = _moe_serve(params, moe, wbytes, dense)
    _moe_quant(params, moe)
    del params
    torch.cuda.empty_cache()
    train = _moe_train(moe, dense)
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"[moe] launches of the phase ({time.monotonic() - t0:.1f} s): "
        f"{counts}")
    for name in MOE_KERNELS:
        require(counts[name] > 0, f"phase 12: {name} never launched")
    out = {"params": param_count(moe), "active": active_param_count(moe),
           "serve": {k: {n: v for n, v in run.items() if n != "launches"}
                     for k, run in serve["runs"].items()},
           "decode_iteration": serve["decode_iteration"],
           "cover_streams_equal_generate":
               serve["cover_streams_equal_generate"],
           "train": train, "seconds": time.monotonic() - t0}
    log("[moe] " + json.dumps(out))
    out["launches"] = counts
    return out


# -- phase 13 -----------------------------------------------------------------
#: phase 13's collective payload (MB of fp32), the reference's default
COLLECTIVE_MBYTES = 64.0


def _one_rank_collectives(mesh) -> dict:
    """Phase 13 (a): the four collectives of ``workloads/collectives.py``
    on a :data:`COLLECTIVE_MBYTES` fp32 payload over the one-rank mesh's
    "model" axis, each output equal to its input under ``torch.equal``;
    then the three ``measure_*`` functions at that payload."""
    import torch
    from dpu_operator_tpu_torch.workloads import collectives as col
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn(int(COLLECTIVE_MBYTES * 1e6 / 4), device="cuda",
                    generator=gen)
    for name, make, arg in (
            ("psum_allreduce", col.psum_allreduce, x),
            ("ring_allreduce", col.ring_allreduce, x),
            ("all_to_all_exchange", col.all_to_all_exchange,
             x.view(1, -1)),
            ("ppermute_hop", col.ppermute_hop, x)):
        out = make(mesh, "model")(arg)
        torch.cuda.synchronize()
        require(torch.equal(out, arg), f"phase 13: {name} on one rank "
                "changed its input")
    meas = {"all_to_all": col.measure_all_to_all_gbps(
                mesh, "model", mbytes=COLLECTIVE_MBYTES),
            "ppermute_hop": col.measure_ppermute_gbps(
                mesh, "model", mbytes=COLLECTIVE_MBYTES),
            "allreduce": col.measure_allreduce_gbps(
                mesh, "model", mbytes=COLLECTIVE_MBYTES)}
    for m in meas.values():
        require(m["axis_size"] == 1 and m["sec_per_iter"] > 0
                and np.isfinite(m["algbw_gbps"]),
                f"phase 13: measurement {m}")
    log("[sharded] collectives on ONE rank (no link crossed; the times are "
        "the local copies): " + "; ".join(
            f"{k} {m['bytes'] / 1e6:.1f} MB {m['sec_per_iter'] * 1e3:.4f} ms "
            f"algbw {m['algbw_gbps']:.1f} GB/s" for k, m in meas.items()))
    return meas


def _sharded_tiny_parity(mesh) -> None:
    """Phase 13 (b): the fp32 2-layer model of tests/test_torch_spmd.py, 3
    AdamW steps sharded on the one-rank mesh against 3 one-device steps
    from the same weights and batch: losses within 1e-4 relative, the
    gathered parameters within 3 x lr (the CPU tests' bounds)."""
    import torch
    from dpu_operator_tpu_torch.workloads.model import (
        TransformerConfig, gather_params, init_params, make_example_batch)
    from dpu_operator_tpu_torch.workloads.train import (make_train_step,
                                                        param_leaves)
    cfg = TransformerConfig(n_layers=2, max_seq=32, dtype=torch.float32)
    weights = init_params(0, cfg, device="cuda")
    batch = make_example_batch(cfg, batch=4, seq=32)
    runs = {}
    for label, m in (("sharded", mesh), ("one device", None)):
        step, init_state, place = make_train_step(cfg, m, device="cuda")
        params, opt = init_state(params=weights)
        data = place(batch)
        losses = [float(step(params, opt, data)[2]) for _ in range(3)]
        if m is not None:
            params = gather_params(params, cfg, m)
        runs[label] = (losses, param_leaves(params))
    (got, got_p), (want, want_p) = runs["sharded"], runs["one device"]
    for a, b in zip(got, want):
        require(abs(a - b) <= 1e-4 * abs(b),
                f"phase 13: tiny sharded losses {got} vs one device {want}")
    err = max(float((a.detach() - b.detach()).abs().max())
              for a, b in zip(got_p, want_p))
    require(err <= 3 * cfg.learning_rate,
            f"phase 13: tiny sharded parameters {err} from one device's")
    log(f"[sharded] tiny fp32 on the one-rank mesh: losses {got} vs one "
        f"device {want}; parameters within {err:.3g} (bound "
        f"{3 * cfg.learning_rate})")


def _sharded_profile(cfg, mesh) -> dict:
    """Phase 13 (d): one profiled sharded step of the flagship on a fresh
    state (:func:`profile_calls`), and the device time of its NCCL
    kernels and of its copies, summed by kernel name."""
    from dpu_operator_tpu_torch.workloads.model import make_example_batch
    from dpu_operator_tpu_torch.workloads.perf import FLAGSHIP_BATCH
    from dpu_operator_tpu_torch.workloads.train import make_train_step
    step, init_state, place = make_train_step(cfg, mesh, device="cuda")
    params, opt = init_state(1)
    data = place(make_example_batch(cfg, batch=FLAGSHIP_BATCH))
    prof = profile_calls(
        f"sharded train step, one rank (batch {FLAGSHIP_BATCH}x"
        f"{cfg.max_seq})", lambda: step(params, opt, data), 2, warmup=1)
    by_kernel = device_times(lambda: step(params, opt, data), 2)
    prof["nccl_ms"] = sum(ms for k, ms in by_kernel.items()
                          if "nccl" in k.lower())
    prof["copy_ms"] = sum(ms for k, ms in by_kernel.items()
                          if "copy" in k.lower())
    log(f"[sharded] a sharded step's device time by kind: NCCL kernels "
        f"{prof['nccl_ms']:.3f} ms, copy kernels {prof['copy_ms']:.3f} ms, "
        f"of {sum(by_kernel.values()):.3f} ms busy")
    return prof


def phase_sharded(cfg, dense: dict, smi: str) -> dict:
    """Phase 13: the dp/tp/sp-sharded train step on a one-rank mesh, as a
    lone pod runs it. No operator env, so ``initialize_from_operator_env``
    does nothing; ``make_mesh`` forms a one-rank NCCL group; (a)
    :func:`_one_rank_collectives`, (b) :func:`_sharded_tiny_parity`, (c)
    ``measure_train(cfg, mesh)`` of the flagship (bf16, batch 8 x 1024,
    ``sequence_parallel`` on, 1 warm-up and 5 timed steps from phase 7's
    seed and batch): the loss falls, the first 3 losses lie within 1e-2
    of phase 7's (*dense*), and the three training kernels launch 12 times
    a step and RMSNorm 25 times; (d) :func:`_sharded_profile`. The launch
    counters are set to 0 before (b) and read after (c). The group is destroyed at the end. Returns the
    phase's numbers and launches."""
    import torch
    import torch.distributed as dist
    from dpu_operator_tpu_torch.ops import launch_counts, reset_launch_counts
    from dpu_operator_tpu_torch.workloads.bootstrap import \
        initialize_from_operator_env
    from dpu_operator_tpu_torch.workloads.mesh import make_mesh, mesh_shape
    from dpu_operator_tpu_torch.workloads.perf import (FLAGSHIP_BATCH,
                                                       measure_train)
    t0 = time.monotonic()
    require(initialize_from_operator_env({}) is None,
            "phase 13: a lone pod's empty env initialized a group")
    require(not dist.is_initialized(), "phase 13: a process group exists")
    mesh = make_mesh(("data", "model"), device_type="cuda")
    try:
        require(dist.get_backend() == "nccl" and dist.get_world_size() == 1
                and mesh_shape(mesh) == {"data": 1, "model": 1},
                f"phase 13: mesh {mesh_shape(mesh)} over "
                f"{dist.get_backend()}")
        meas = _one_rank_collectives(mesh)
        reset_launch_counts()
        _sharded_tiny_parity(mesh)
        tiny_counts = launch_counts()
        reset_launch_counts()
        steps = 5
        perf = measure_train(cfg, mesh, batch=FLAGSHIP_BATCH, steps=steps,
                             device="cuda")
        torch.cuda.synchronize()
        counts = launch_counts()
        prof = _sharded_profile(cfg, mesh)
    finally:
        dist.destroy_process_group()
    losses = perf.losses
    require(cfg.sequence_parallel, "phase 13: the flagship runs sp")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"phase 13: losses {losses}")
    near = [abs(a - b) for a, b in zip(losses[:3], dense["losses"][:3])]
    require(max(near) <= 1e-2, f"phase 13: first losses {losses[:3]} vs "
            f"phase 7's {dense['losses'][:3]}")
    for name in TRAIN_KERNELS:
        require(counts[name] == cfg.n_layers * (steps + 1),
                f"phase 13: {name} launched {counts[name]} times, wanted "
                f"{cfg.n_layers} a step")
    require(counts["fused_rmsnorm"] == (2 * cfg.n_layers + 1) * (steps + 1),
            f"phase 13: fused_rmsnorm launched {counts['fused_rmsnorm']} "
            "times")
    ratio = perf.step_ms / dense["step_ms"]
    log(f"[sharded] flagship bf16 {FLAGSHIP_BATCH}x{cfg.max_seq}, sp on, "
        f"one-rank mesh: step {perf.step_ms:.2f} ms against phase 7's "
        f"one-device {dense['step_ms']:.2f} ms (ratio {ratio:.4f}), "
        f"{perf.tokens_per_s:.0f} tokens/s, MFU {perf.mfu:.4f}, peak memory "
        f"{perf.peak_memory_bytes / 1e9:.2f} GB; losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f" (phase 7: {', '.join(f'{x:.4f}' for x in dense['losses'])}); "
        f"{smi}")
    out = {"step_ms": perf.step_ms, "one_device_step_ms": dense["step_ms"],
           "overhead_ratio": ratio, "tokens_per_s": perf.tokens_per_s,
           "mfu": perf.mfu, "peak_memory_gb": perf.peak_memory_bytes / 1e9,
           "losses": losses, "first_loss_gap": max(near),
           "collectives": meas, "profiled_step": prof,
           "seconds": time.monotonic() - t0}
    log("[sharded] " + json.dumps(out))
    log(f"[sharded] launches of the phase ({out['seconds']:.1f} s): flagship "
        f"{counts}; tiny {tiny_counts}")
    out["launches"] = {k: counts[k] + tiny_counts[k] for k in counts}
    return out


def main(argv: list) -> int:
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
    if argv[:1] == ["--time"]:
        timer = {"train": time_train, "kv8-chunk": time_kv8_chunk}[argv[1]]
        timer(*(int(x) if x.isdigit() else x for x in argv[2:]))
        return 0
    cfg = flagship_config()
    cases = phase_kernels(cfg)
    parity_counts = phase_cpu_parity()
    t0 = time.monotonic()
    params = init_params(0, cfg, device="cuda")
    torch.cuda.synchronize()
    wbytes = param_bytes(params)
    log(f"[serve] flagship bf16: {wbytes / 2 / 1e6:.1f}M parameters, "
        f"{wbytes / 1e6:.1f} MB, made on the card in "
        f"{time.monotonic() - t0:.1f} s")
    serve = phase_serve(cfg, params)
    chaos = phase_chaos(params, cfg, serve["plain"])
    wire = phase_wire(params, cfg, serve, dev["smi"])
    # the serve, chaos and wire runs' launches
    counts = {k: serve["launches"][k] + chaos["launches"][k]
              + wire["launches"][k] for k in serve["launches"]}
    window = profile_window(params, cfg)
    del params
    torch.cuda.empty_cache()
    train = phase_train(cfg)
    train_counts = train["launches"]
    torch.cuda.empty_cache()
    quant_counts = phase_quant(cfg)["launches"]
    torch.cuda.empty_cache()
    measure_counts = phase_measure(cfg)["launches"]
    torch.cuda.empty_cache()
    wide_counts = phase_wide(wide_config(cfg))
    torch.cuda.empty_cache()
    moe_counts = phase_moe(cfg, {
        "tokens_per_s": serve["runs"]["plain"]["tokens_per_s"],
        "decode_iteration": window["decode iteration (8 slots)"],
        "step_ms": train["step_ms"], "mfu": train["mfu"],
        "peak_memory_gb": train["peak_memory_gb"]})["launches"]
    torch.cuda.empty_cache()
    sharded_counts = phase_sharded(cfg, train, dev["smi"])["launches"]
    # each kernel's launches on the main paths (phase 4's fp32 models, the
    # four serve runs, the two chaos runs, the wire run, the train run, the
    # quantized phase, the measurement phase, the MoE phase and the sharded
    # phase), each read from zero; a head-dim-256 case's from phase 10, the
    # path of that head dim
    counts = {k: counts[k] + parity_counts[k] + train_counts[k]
              + quant_counts[k] + measure_counts[k] + moe_counts[k]
              + sharded_counts[k] for k in counts}
    kernels = [{
        "name": c["name"], "route": "cuda", "source": c["source"],
        "replaces": c["replaces"],
        "launches": (wide_counts if c["head_dim"] == 256
                     else counts)[c["kernel"]],
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
    sys.exit(main(sys.argv[1:]))
