"""Tiny configurations and mixes of the benchmark's shapes, for the CPU."""

import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

MODEL = {"vocab": 256, "d_model": 64, "n_heads": 4, "n_layers": 2,
         "d_ff": 128, "max_seq": 64, "dtype": "bfloat16",
         "attention": "flash", "moe_experts": 0, "moe_every": 2,
         "moe_capacity_factor": 1.25, "moe_aux_weight": 0.01}


def config(**model) -> dict:
    return {"block": "gpt2", "model": dict(MODEL, **model)}


def serve_mix(name: str, **arrivals) -> dict:
    """A benchmark mix cut to the tiny model: 8 slots, chunks of 32,
    prompts and outputs that fit 64 positions, set-up's mix within 10 s."""
    mix = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    mix.update(slots=8, prefill_budget=32, chunk_tokens=32,
               setup_traffic_s=0.5, setup_traffic_max_s=10.0,
               check_requests=4,
               prompt={"median": 20, "sigma": 0.7, "min": 4, "max": 48},
               output={"median": 6, "sigma": 0.6, "min": 2, "max": 16})
    if arrivals:
        mix["arrivals"] = dict(mix["arrivals"], **arrivals)
    return mix
