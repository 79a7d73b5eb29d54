"""One run of one cell: ``run.py --workload <name> --seed <n> --seconds
<s> --trace <0|1>``.

The run loads the manifest and the cell's files, refuses to run without
the CUDA cards the cell asks for, builds or reuses the port's kernels in
the checkout, makes its weights on the card from the seed, warms up the
cell's shapes, measures for ``--seconds``, checks its outputs against the
plain reference and prints, as the last line of its standard output, one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
per-layer metrics), ``device``, with ``--trace 1`` a ``breakdown``, and
last ``compared``, each number of the comparison beside its limit, which
also close its standard error. What else it learns (the card's name and
power limit, launch counts, the readings) goes on earlier lines.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import Optional

import torch

from . import arith, manifest, serve_cell

#: top-level module names that the process must not hold once the window
#: has closed: JAX and the JAX package (the port's own name, which starts
#: with the JAX package's, is another name)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "dpu_operator_tpu")


def forbidden_loaded(modules: Optional[dict] = None) -> list:
    """The forbidden top-level names among *modules* (``sys.modules``),
    each compared whole: the part before the first dot."""
    names = {name.split(".", 1)[0] for name in
             (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN_MODULES))


def power_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "nvidia-smi printed nothing"


def layer_metrics(mf: dict, cell: str, layer_run: dict,
                  device_name: str) -> dict:
    """The cell's per-layer metrics that their readers find something to
    read for."""
    layer_run = dict(layer_run, peak=arith.peaks(device_name))
    out = {}
    for metric in manifest.per_layer_of(mf, cell):
        value = manifest.metric_reader(metric["name"])(layer_run)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def execute(cell_name: str, seed: int, seconds: float, trace: bool,
            device: torch.device, t_start: float,
            root: Path = manifest.ROOT) -> dict:
    """Run one cell of the checkout at *root* on *device* and return the
    result's parts (the caller checks for the cards and prints)."""
    bench = root / "benchmark"
    mf = manifest.load_manifest(root)
    cell = manifest.find_cell(mf, cell_name)
    config = manifest.load_config(mf, cell["config"], root)
    traffic = manifest.load_traffic(cell["traffic"], bench)
    limits = manifest.load_limits(cell_name, bench)
    out = serve_cell.run(config, traffic, seed, seconds, trace, device,
                         t_start, limits)
    out.update(manifest=mf, cell=cell, limits=limits)
    return out


def info(out: dict, device_name: str) -> dict:
    """What else the run learned, for the ``# info`` line: the card's name
    and power limit, launch counts, the reference's seconds, the numbers
    compared, the sample, the queue, the fill at the window's open and
    close with the seconds of mix set-up served (and whether it stopped at
    its ceiling), and the host's load."""
    from dpu_operator_tpu_torch.ops import launch_counts
    return {"card": power_line(), "device": device_name,
            "launches": launch_counts(), "reference_s": out["reference_s"],
            "numbers": out["numbers"],
            **{k: out[k] for k in ("sample", "queue", "fill", "host_load")
               if k in out}}


def result_line(out: dict, trace: bool, device_name: str,
                chips: int) -> dict:
    mf, cell, limits = out["manifest"], out["cell"]["name"], out["limits"]
    if trace:
        metrics = layer_metrics(mf, cell, out["layer_run"], device_name)
    else:
        e2e = dict(out["e2e"], setup_s=out["setup_s"])
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in manifest.end_to_end_of(mf, cell)
                   if m["name"] in e2e}
    device = {"platform": "gpu", "kind": device_name, "count": chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = out["trace"]["busy_s"]
        device["window_s"] = out["trace"]["window_s"]
        line["breakdown"] = out["trace"]["breakdown"]
    line["compared"] = {k: {"value": out["numbers"][k], "limit": v}
                        for k, v in limits.items()}
    return line


def main(argv: Optional[list] = None, t_start: float = 0.0) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    mf = manifest.load_manifest()
    chips = manifest.find_cell(mf, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() is {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    device_name = torch.cuda.get_device_name(device)
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                  device, t_start)
    loaded = forbidden_loaded()
    if loaded:
        print(f"benchmark: the process holds {', '.join(loaded)}; nothing "
              "the benchmark runs may load JAX or the JAX package",
              file=sys.stderr)
        return 3
    print("# info " + json.dumps(info(out, device_name)), flush=True)
    line = result_line(out, bool(args.trace), device_name, chips)
    for name, entry in line["compared"].items():
        print(f"compared {name} {entry['value']!r} limit {entry['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
