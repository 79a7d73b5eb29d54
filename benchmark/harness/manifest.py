"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``configs/<name>.json`` (as ``BENCHMARK.json`` gives
its ``file``), and the block it names (its ``"block"``) the module
``blocks/<block>.py``; a traffic mix is ``traffic/<name>.json``, a
per-layer metric the reader ``metrics/<name>.py``, a kernel family the
pattern files under ``kernels/<family>/``, a cell's correctness limits
``limits/<cell>.json``. A later change adds an architecture, a
configuration, a mix, a metric or a kernel pattern by adding files;
nothing here names one.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
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
    """The configuration file, with ``block_file``: the path of the block
    it names, beside it under ``blocks/`` (which has to exist)."""
    for cfg in manifest["configs"]:
        if cfg["name"] == name:
            config = json.loads((root / cfg["file"]).read_text())
            path = block_path(config, root / "benchmark")
            if not path.is_file():
                raise FileNotFoundError(
                    f"config {name!r} names the block "
                    f"{config.get('block')!r}, and {path} does not exist")
            return dict(config, block_file=str(path))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def block_path(config: dict, bench: Path = BENCH) -> Path:
    if "block" not in config:
        raise KeyError("a configuration names its block (\"block\")")
    return bench / "blocks" / f"{config['block']}.py"


@functools.lru_cache(maxsize=None)
def _load_block(path: str) -> ModuleType:
    return _load_module("bench_block_", Path(path))


def block_of(config: dict) -> ModuleType:
    """The module of the configuration's block: its ``block_file`` where
    :func:`load_config` set one, else ``blocks/<block>.py`` of this
    benchmark. Of the configuration's ``model`` dict *m*, a block gives
    ``program_config(m)`` (the port's configuration), ``vocab(m)`` and
    ``positions(m)`` (the ids the traffic draws, a slot's positions),
    ``leaves(m)`` (``(path, shape, fan_in)`` of the drawn leaves, in the
    flat buffer's order) and ``norms(m)`` (``(path, shape)`` of the norm
    scales), ``forward(params, tokens, m, mm, groups)`` (the plain float32
    reference's logits, every product through *mm*, MoE routing in the
    served *groups*), ``param_count(m)``, ``active_param_count(m)``,
    ``serve_flops(m, work)`` (of the window's work counts),
    ``decode_attention_least_s(m, rows, peak)`` (of one decode pass's
    live rows' positions) and ``expected_moe_fill(m, traffic, counts)``
    (None without experts)."""
    return _load_block(config.get("block_file")
                       or str(block_path(config)))


def _load_module(prefix: str, path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        prefix + re.sub(r"\W", "_", path.stem), path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    return _load_module("bench_metric_",
                        bench / "metrics" / f"{name}.py").read


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
