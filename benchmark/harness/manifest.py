"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``configs/<name>.json`` (as ``BENCHMARK.json`` gives
its ``file``), a traffic mix ``traffic/<name>.json``, a per-layer metric
the reader ``metrics/<name>.py``, a kernel family the pattern files under
``kernels/<family>/``, a cell's correctness limits ``limits/<cell>.json``.
A later change adds a configuration, a mix, a metric or a kernel pattern
by adding files; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable

#: the benchmark's folder and the checkout's root
BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(manifest: dict, name: str) -> dict:
    for cell in manifest["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    for cfg in manifest["configs"]:
        if cfg["name"] == name:
            return json.loads((root / cfg["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_traffic(name: str, bench: Path = BENCH) -> dict:
    return json.loads((bench / "traffic" / f"{name}.json").read_text())


def load_limits(cell: str, bench: Path = BENCH) -> dict:
    """``{number: limit}`` of the cell's comparison."""
    data = json.loads((bench / "limits" / f"{cell}.json").read_text())
    return {name: entry["limit"] for name, entry in data["numbers"].items()}


def reports(manifest: dict, metric: dict, cell: str) -> bool:
    """Whether *cell* reports *metric*: a metric with ``workloads`` names
    its cells; one without is reported by every cell that reports the
    end-to-end metric it moves (or, for an end-to-end metric, by all)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    for e2e in manifest["end_to_end"]:
        if e2e["name"] == moves:
            return reports(manifest, e2e, cell)
    return False


def end_to_end_of(manifest: dict, cell: str) -> list:
    return [m for m in manifest["end_to_end"] if reports(manifest, m, cell)]


def per_layer_of(manifest: dict, cell: str) -> list:
    return [m for m in manifest["per_layer"] if reports(manifest, m, cell)]


def metric_reader(name: str, bench: Path = BENCH) -> Callable:
    """``read(run) -> float | None`` of ``metrics/<name>.py``."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + re.sub(r"\W", "_", name), path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load the reader {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_patterns(family: str, bench: Path = BENCH) -> list:
    """The compiled name patterns of a kernel family: one regular
    expression a line in every ``kernels/<family>/*.txt`` (``#`` starts a
    comment)."""
    out = []
    for path in sorted((bench / "kernels" / family).glob("*.txt")):
        for line in path.read_text().splitlines():
            line = line.split("#", 1)[0].strip()
            if line:
                out.append(re.compile(line))
    return out


def in_family(name: str, patterns: list) -> bool:
    return any(p.search(name) for p in patterns)
