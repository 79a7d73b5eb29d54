"""The comparison fails what it must: the control (the reference in
float8 in the program's place) and the faults a serving run can have,
each planted under the program with the rest of the run as it is."""

import time

import numpy as np
import pytest
import torch

import bench_tiny
from harness import control, manifest, serve_cell

SEED = 2 ** 31 + 1234
CPU = torch.device("cpu")
CELL = "gpt2-medium.serve-batch"


def _run():
    """A run whose sample is every finished request, so that a fault in
    any slot reaches the comparison."""
    mix = dict(bench_tiny.serve_mix("serve-batch"), check_requests=1000)
    return serve_cell.run(bench_tiny.config(dtype="float32"), mix, SEED, 2.0,
                          False, CPU, time.monotonic(),
                          manifest.load_limits(CELL))


def test_an_unbroken_run_is_correct():
    assert _run()["correct"]


def _altered(monkeypatch):
    """Every third decode iteration hands out a token one past the one it
    produced."""
    from dpu_operator_tpu_torch.workloads import serve
    step = serve.TorchSlotExecutor.step
    calls = [0]

    def broken(self, active):
        out = step(self, active)
        calls[0] += 1
        if calls[0] % 3 == 0:
            out = {s: (t + 1) % self.cfg.vocab for s, t in out.items()}
            for s, t in out.items():
                self.last[s] = t
        return out
    monkeypatch.setattr(serve.TorchSlotExecutor, "step", broken)


def _unchanged(monkeypatch):
    """The cache is never written: every step leaves its state as it
    was."""
    from dpu_operator_tpu_torch.workloads import decode
    monkeypatch.setattr(decode, "_write_rows", lambda *a: None)


def _half(monkeypatch):
    """Half of the decode batch is left out: the slots of its upper half
    are handed the token they had."""
    from dpu_operator_tpu_torch.workloads import serve
    step = serve.TorchSlotExecutor.step

    def broken(self, active):
        stale = {s: int(self.last[s]) for s, _ in active}
        out = step(self, active)
        half = self.slots // 2
        out = {s: (stale[s] if s >= half else t) for s, t in out.items()}
        for s, t in out.items():
            self.last[s] = t
        return out
    monkeypatch.setattr(serve.TorchSlotExecutor, "step", broken)


@pytest.mark.parametrize("fault", [_altered, _unchanged, _half])
def test_a_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = _run()
    assert not out["correct"], out["numbers"]


@pytest.mark.parametrize("model", [{}, {"moe_experts": 4}])
def test_the_control_reads_above_the_program(model):
    """At a small size the control's mean gap over a run's sample lies
    above the program's, over a few seeds."""
    config = bench_tiny.config(d_model=256, n_heads=2, d_ff=1024,
                               vocab=2048, max_seq=128, **model)
    mix = bench_tiny.serve_mix("serve-batch")
    program, ctl = [], []
    for seed in range(SEED, SEED + 4):
        out = serve_cell.run(config, mix, seed, 2.0, False, CPU,
                             time.monotonic(), manifest.load_limits(CELL))
        program.append(out["numbers"]["logit_gap_mean"])
        ctl.append(control.serve_control_numbers(
            config, mix, seed, out["sequences"], CPU)["logit_gap_mean"])
    assert np.mean(ctl) > np.mean(program)
