"""BENCHMARK.json against the contract's shape, and the files it names."""

import json
import re
import shutil
import time

import pytest
import torch

import bench_tiny
from harness import cli, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def mf():
    return manifest.load_manifest()


def test_names_units_and_keys(mf):
    assert set(mf) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    metrics = mf["end_to_end"] + mf["per_layer"]
    for entry in mf["configs"] + mf["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for key in ("configs", "workloads"):
        names = [e["name"] for e in mf[key]]
        assert len(names) == len(set(names))
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in mf["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in mf["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for c in mf["workloads"]:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(c["traffic"]) and c["chips"] in (1, 4)
        assert 1 <= len(c["why"]) <= 200
    assert 1 <= mf["run_seconds"] <= 51 and isinstance(mf["run_seconds"],
                                                       int)


def test_every_cell_reports_what_it_must(mf):
    setup = [m for m in mf["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    for c in mf["workloads"]:
        e2e = [m["name"] for m in manifest.end_to_end_of(mf, c["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.per_layer_of(mf, c["name"])
    e2e_cells = {m["name"]: {c["name"] for c in mf["workloads"]
                             if manifest.reports(mf, m, c["name"])}
                 for m in mf["end_to_end"]}
    for m in mf["per_layer"]:
        # each cell that reports a layer metric reports what it moves
        assert set(m["workloads"]) <= e2e_cells[m["moves"]], m["name"]


def test_named_files_exist(mf):
    for cfg in mf["configs"]:
        data = json.loads((manifest.ROOT / cfg["file"]).read_text())
        assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
        assert data["reduced"] == cfg["reduced"]
        assert any(c["config"] == cfg["name"] for c in mf["workloads"])
    for c in mf["workloads"]:
        manifest.load_traffic(c["traffic"])
        assert manifest.load_limits(c["name"])
    for m in mf["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]))
    assert manifest.kernel_patterns("decode_attention")


def test_readers_find_nothing_in_an_empty_run(mf):
    for m in mf["per_layer"]:
        assert manifest.metric_reader(m["name"])(
            {"model": {}, "traffic": {}, "peak": None}) is None


def test_a_mix_added_as_files_runs_without_an_edit(tmp_path):
    """A new cell needs new files and entries only: a throwaway mix, a
    tiny configuration and its limits beside a copy of the benchmark, run
    through the harness on the CPU."""
    root = tmp_path / "checkout"
    shutil.copytree(manifest.BENCH, root / "benchmark")
    mf = manifest.load_manifest()
    (root / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(
        dict(bench_tiny.config(), name="tiny", source="test",
             reduced=[])))
    mix = bench_tiny.serve_mix("serve-batch", kind="poisson", rate_rps=40.0)
    (root / "benchmark" / "traffic" / "throwaway.json").write_text(
        json.dumps(mix))
    (root / "benchmark" / "limits" / "tiny.throwaway.json").write_text(
        json.dumps({"numbers": {"logit_gap": {"limit": 0.05}}}))
    mf["configs"].append({"name": "tiny", "source": "test", "reduced": [],
                          "file": "benchmark/configs/tiny.json", "why": "t"})
    mf["workloads"].append({"name": "tiny.throwaway", "config": "tiny",
                            "traffic": "throwaway", "chips": 1, "why": "t"})
    for m in mf["end_to_end"]:
        if "gpt2-medium.serve-batch" in m.get("workloads", ()):
            m["workloads"].append("tiny.throwaway")
    (root / "BENCHMARK.json").write_text(json.dumps(mf))
    out = cli.execute("tiny.throwaway", 2 ** 31 + 3, 1.5, False,
                      torch.device("cpu"), time.monotonic(), root)
    line = cli.result_line(out, False, "cpu", 1)
    assert line["correct"] and line["attempted"] > 0
    assert set(line["metrics"]) == {"serve_tokens_per_s", "setup_s"}
    assert list(line)[-1] == "compared"
