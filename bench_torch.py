#!/usr/bin/env python3
"""Compute bench of the PyTorch/CUDA port (``dpu_operator_tpu_torch``): the
counterpart of ``bench.py``'s compute half, on an NVIDIA GPU.

    python3 bench_torch.py                  # the card, flagship sizes
    python3 bench_torch.py --device cpu     # small sizes, for tests
    python3 bench_torch.py --out PATH       # the JSON line also to PATH

Sections, each run on its own so one failure costs only itself:

- ``serve``: ``calibrate_cost_model`` fits the port's iterations of the
  flagship on the card (8 slots, a 32-token prompt). Then, under
  ``modelled``, the open-loop serving record on the virtual clock over
  that model (``bench_serving`` at loads 0.5 / 0.8 / 1.1 with
  ``chunked_config``), the whole-prompt baseline at 0.8, prefix sharing
  on and off, speculation on and off, and the continuous-vs-static ratio
  of the default cost model: every time there is the model's, not the
  card's. Under ``wall``, ``wall_open_loop``: arrivals at 0.8 of the
  modelled capacity served by ``TorchSlotExecutor`` on the card, with
  their wall time and wall tokens/s; its record must equal the
  ``SimExecutor``'s. A calibration that fails fails the section.
- ``train``: ``measure_train`` of the flagship at ``FLAGSHIP_BATCH``.
- ``flash``: ``measure_flash_attention`` at 4 x 2048 x 8 x 128 bf16, causal.
- ``decode``, ``decode_int8``, ``decode_b8_kv8``: ``measure_decode`` at
  B1 bf16, B1 W8A8 and B8 W8A8 + KV8, held to ``max_sane_frac``.

A fraction outside (0, cap] (MFU, the flash share of peak, the decode
roofline share over 1.15) fails its section: cap 1 on the card, 10 on the
CPU, whose rates are smoke constants. The script prints one JSON line
naming the device and, on the card, nvidia-smi's ``name, power.limit``
(a card whose line nvidia-smi does not give is an error); it records
each failed section under ``errors`` and then exits 1. Nothing
runs on the CPU unless ``--device cpu`` asks for it, and asking for the
card without one raises. It writes no ``BENCH_r*.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback
from typing import Optional

import torch

from dpu_operator_tpu_torch import resolve_device
from dpu_operator_tpu_torch.workloads import serve as serve_mod
from dpu_operator_tpu_torch.workloads.model import (TransformerConfig,
                                                    flagship_config,
                                                    init_params)
from dpu_operator_tpu_torch.workloads.perf import (
    FLAGSHIP_BATCH, measure_decode, measure_flash_attention, measure_train,
    nvidia_smi_line)

#: the record's name: this bench's lines are never folded into bench.py's
RECORD = "bench_torch"


def _checked(value: Optional[float], cap: float, name: str) -> None:
    if value is None or not 0.0 < value <= cap:
        raise ValueError(f"degenerate {name}={value}: outside (0, {cap}]")


class ComputeBench:
    """The sections at the sizes of *device*: the flagship on the card;
    ``bench.py``'s CPU shapes on the CPU (a 2-layer, d_model 64 model,
    flash at 1 x 256 x 2 x 64, short horizons). The serve section
    calibrates and serves the model the others measure."""

    def __init__(self, device: str = "cuda") -> None:
        self.dev = resolve_device(device)
        if self.dev.type == "cuda":
            self.cfg, self.batch, self.steps = (flagship_config(),
                                                FLAGSHIP_BATCH, 30)
            self.horizon_s, self.wall_horizon_s = 60.0, 20.0
            self.flash_kw = dict(b=4, s=2048, h=8, d=128, iters=400,
                                 best_of=8)
            self.decode_kw = dict(batch=1, steps=128, iters=4, best_of=2)
            self.cap = 1.0
        elif self.dev.type == "cpu":
            # max_seq 256 (bench.py's 128), which the longest arrival
            # (128 prompt + 128 output tokens) of the wall run needs
            self.cfg = TransformerConfig(vocab=512, d_model=64, n_heads=8,
                                         n_layers=2, d_ff=256, max_seq=256,
                                         attention="flash")
            self.batch, self.steps = 2, 6
            self.horizon_s, self.wall_horizon_s = 6.0, 1.0
            # bench.py's CPU shapes; chains long enough (20 calls, 32
            # steps) that a loaded CPU's jitter cannot collapse the slope
            self.flash_kw = dict(b=1, s=256, h=2, d=64, iters=20, best_of=1)
            self.decode_kw = dict(batch=1, steps=32, iters=2, best_of=1)
            self.cap = 10.0
        else:
            raise ValueError(f"bench_torch: unsupported device {self.dev}")

    def serve(self) -> dict:
        cm = serve_mod.calibrate_cost_model(self.cfg, device=self.dev)
        config = serve_mod.chunked_config(cm)
        h = self.horizon_s
        out = serve_mod.bench_serving(seed=0, loads=(0.5, 0.8, 1.1),
                                      cost_model=cm, config=config,
                                      horizon_s=h)
        out["cost_model_calibrated"] = True
        out["cost_model"]["spec_verify_per_token_ms"] = round(
            cm.spec_verify_per_token_s * 1e3, 6)
        atomic = serve_mod.bench_serving(seed=0, loads=(0.8,),
                                         cost_model=cm, horizon_s=h)
        out["atomic_prefill_baseline"] = {
            "slots": atomic["slots"],
            "ttft_p99_s_at_0.8": atomic["loads"]["0.8"]["ttft_p99_s"],
            "tokens_per_s_at_0.8": atomic["loads"]["0.8"]["tokens_per_s"],
        }
        out["prefix_sharing_bench"] = serve_mod.bench_prefix_sharing(
            seed=0, cost_model=cm, config=config, horizon_s=h * 2 / 3)
        out["spec_decode"] = serve_mod.bench_spec_decoding(
            seed=0, cost_model=cm, horizon_s=h * 2 / 3)
        # the ratio depends on the decode / prefill balance: the default
        # model's ratio beside the calibrated one
        ref = serve_mod.bench_serving(seed=0, loads=(), horizon_s=h)
        out["continuous_speedup_reference"] = \
            ref["continuous_vs_static"]["speedup"]
        out["wall"] = serve_mod.wall_open_loop(
            init_params(0, self.cfg, device=self.dev), self.cfg, cm, config,
            self.wall_horizon_s)
        return out

    def train(self):
        perf = measure_train(self.cfg, batch=self.batch, steps=self.steps,
                             device=self.dev)
        _checked(perf.mfu, self.cap, "mfu")
        return perf

    def flash(self):
        perf = measure_flash_attention(device=self.dev, **self.flash_kw)
        _checked(perf.frac_of_peak, self.cap, "flash_frac_of_peak")
        return perf

    def decode(self, quantized: bool = False, kv_int8: bool = False,
               batch: Optional[int] = None) -> dict:
        """One ``measure_decode`` row; a batched row runs 3/4 of the
        chain (``bench.py``'s rule: each step costs more)."""
        kw = dict(self.decode_kw)
        if batch is not None:
            kw["batch"] = batch
            kw["steps"] = max(kw["steps"] * 3 // 4, 8)
        return measure_decode(self.cfg, quantized=quantized,
                              kv_int8=kv_int8, device=self.dev,
                              max_sane_frac=self.cap * 1.15, **kw)

    def sections(self) -> list:
        return [
            ("serve", self.serve),
            ("train", self.train),
            ("flash", self.flash),
            ("decode", self.decode),
            ("decode_int8", lambda: self.decode(quantized=True)),
            ("decode_b8_kv8", lambda: self.decode(quantized=True,
                                                  kv_int8=True, batch=8)),
        ]


def run_sections(sections: list) -> tuple:
    """Run (name, thunk) pairs; a section that raises is recorded in
    *errors*, with its traceback on stderr, and the rest still run.
    Returns (results, errors)."""
    results, errors = {}, {}
    for name, thunk in sections:
        try:
            results[name] = thunk()
        except Exception as e:  # noqa: BLE001 — record it and go on
            errors[name] = f"{type(e).__name__}: {e}"
            print(f"section {name} failed:", file=sys.stderr)
            traceback.print_exc()
    return results, errors


def _decode_keys(rec: dict, suffix: str) -> dict:
    return {
        f"decode_tok_s{suffix}": round(rec["tokens_per_s"], 1),
        f"decode_ms_per_tok{suffix}": round(rec["ms_per_token"], 4),
        f"decode_hbm_frac{suffix}": round(rec["hbm_frac"], 4),
        f"decode_roofline_frac{suffix}": round(rec["roofline_frac"], 4),
        f"decode_bound{suffix}": rec["bound"],
    }


def _serve_payload(srv: dict) -> dict:
    """The serve record, compressed as ``bench.py`` compresses it, in two
    parts: ``modelled``, the virtual-clock records over the calibrated
    model (per load the latency, occupancy and leak keys, the batching
    ratio, the sharing and speculation evidence), and ``wall``, the same
    kind of arrivals served on the device, on the wall clock."""
    loads = {key: {k: row[k] for k in (
        "offered_rps", "completed", "rejected", "preemptions",
        "tokens_per_s", "ttft_p50_s", "ttft_p99_s", "itl_p50_s",
        "itl_p99_s", "kv_occupancy_mean", "kv_occupancy_max",
        "kv_blocks_leaked", "kv_blocks_shared_peak", "prefill_chunks",
        "prefill_tokens_discarded")}
        for key, row in srv["loads"].items()}
    ps, sd, wall = (srv["prefix_sharing_bench"], srv["spec_decode"],
                    srv["wall"])
    rec = wall["record"]
    return {
        **{k: srv[k] for k in (
            "seed", "slots", "kv_blocks", "kv_block_size",
            "prefill_chunk_tokens", "prefix_sharing", "cost_model",
            "cost_model_calibrated")},
        "modelled": {
            **{k: srv[k] for k in (
                "peak_tokens_per_s_modeled", "atomic_prefill_baseline",
                "continuous_speedup_reference")},
            "loads": loads,
            "continuous_speedup": srv["continuous_vs_static"]["speedup"],
            "prefix_sharing_bench": {
                **{k: ps[k] for k in ("offered_load", "kv_blocks_shared",
                                      "occupancy_max_with",
                                      "occupancy_max_without",
                                      "occupancy_cut")},
                "cow_copies": ps["with_sharing"]["kv_cow_copies"],
                "prefix_block_hits":
                    ps["with_sharing"]["kv_prefix_block_hits"],
                "kv_blocks_leaked":
                    (ps["with_sharing"]["kv_blocks_leaked"]
                     + ps["without_sharing"]["kv_blocks_leaked"]),
            },
            "spec_decode": {k: sd[k] for k in (
                "offered_load", "spec_k", "acceptance_rate",
                "mean_accepted_k", "itl_p50_s_spec", "itl_p50_s_baseline",
                "itl_p50_speedup", "tokens_per_s_speedup",
                "kv_blocks_leaked")},
        },
        "wall": {
            "offered_load": serve_mod.WALL_LOAD,
            "offered_rps": round(wall["offered_rps"], 3),
            "chunk_width": wall["chunk_width"],
            **{k: rec[k] for k in ("requests", "completed", "tokens",
                                   "kv_blocks_leaked")},
            "wall_s": round(wall["wall_s"], 3),
            "tokens_per_s": round(wall["wall_tokens_per_s"], 1),
            "modelled_tokens_per_s": rec["tokens_per_s"],
            "record_equals_sim": True,
        },
    }


def build_payload(results: dict, errors: dict, device: str,
                  smi: Optional[str]) -> dict:
    """One JSON-able dict of whatever sections landed. The headline is MFU
    when the train section landed."""
    payload: dict = {"record": RECORD, "device": device, "nvidia_smi": smi,
                     "metric": "mfu", "value": None,
                     "unit": "fraction_of_peak_bf16"}
    train = results.get("train")
    if train is not None:
        payload.update({
            "value": round(train.mfu, 4),
            "peak_tflops_bf16": train.peak_tflops,
            "train_step_ms": round(train.step_ms, 3),
            "tokens_per_s": round(train.tokens_per_s, 1),
            "model_tflops": round(train.model_tflops, 2),
            "params": train.params,
            "train_peak_memory_bytes": train.peak_memory_bytes,
        })
    flash = results.get("flash")
    if flash is not None:
        payload.update({
            "flash_call_ms": round(flash.call_ms, 4),
            "flash_tflops_causal": round(flash.tflops_causal, 1),
            "flash_frac_of_peak": round(flash.frac_of_peak, 4),
        })
    for name, suffix in (("decode", "_b1"), ("decode_int8", "_b1_int8"),
                         ("decode_b8_kv8", "_b8_int8kv8")):
        if name in results:
            payload.update(_decode_keys(results[name], suffix))
    if "serve" in results:
        payload["serve"] = _serve_payload(results["serve"])
    if errors:
        payload["errors"] = errors
    return payload


def main(argv: Optional[list] = None) -> int:
    """Run every section on ``--device`` and print the record's one line;
    returns 1 when a section failed, else 0."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None,
                    help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    bench = ComputeBench(args.device)
    results, errors = run_sections(bench.sections())
    if bench.dev.type == "cuda":
        device, smi = torch.cuda.get_device_name(bench.dev), nvidia_smi_line()
        if smi is None:
            errors["nvidia_smi"] = ("nvidia-smi gave no name, power.limit "
                                    "line for the card")
    else:
        device, smi = "cpu", None
    line = json.dumps(build_payload(results, errors, device, smi))
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
