"""When a backlog's window opens: at the first decode pass that serves at
least ``open_fill_share`` of the slots, never before ``setup_traffic_s``
of the mix; at ``setup_traffic_max_s`` the run opens all the same and
says so in its ``# info`` line."""

import time

import pytest
import torch

import bench_tiny
from harness import cli, serve_cell

SEED = 2 ** 31 + 2718
CPU = torch.device("cpu")


def _run(monkeypatch, **mix):
    """A run of the tiny model on ``serve-batch``'s mix, and each step of
    its scheduler: (start, end, decode rows)."""
    from dpu_operator_tpu_torch.workloads import serve
    step = serve.Scheduler.step
    steps: list = []

    def recorded(self):
        seen, start = len(self.trace), serve_cell.clock()
        did = step(self)
        steps.append((start, serve_cell.clock(), sum(
            e[2] for e in self.trace[seen:] if e[0] == "decode")))
        return did
    monkeypatch.setattr(serve.Scheduler, "step", recorded)
    # outputs longer than a fill takes, so that a pass serves every slot
    traffic = dict(bench_tiny.serve_mix("serve-batch"),
                   prompt={"median": 12, "sigma": 0.5, "min": 4, "max": 40},
                   output={"median": 10, "sigma": 0.2, "min": 8, "max": 12},
                   **mix)
    t_start = time.monotonic()
    out = serve_cell.run(bench_tiny.config(dtype="float32"), traffic, SEED,
                         1.5, False, CPU, t_start, {"logit_gap": 1e-5})
    return out, traffic, steps, t_start + out["setup_s"]


@pytest.mark.parametrize("floor_s", [0.0, 0.3])
def test_the_window_opens_on_the_first_full_pass_past_the_floor(
        monkeypatch, floor_s):
    out, traffic, steps, t0 = _run(monkeypatch, setup_traffic_s=floor_s)
    need = 8                     # 95% of 8 slots, rounded up
    setup = [s for s in steps if s[1] <= t0]
    fill = out["fill"]
    assert fill["at_open"]["decode_rows"] >= need
    assert setup[-1][2] >= need
    assert traffic["setup_traffic_s"] <= fill["setup_traffic_s"] \
        < traffic["setup_traffic_max_s"]
    assert fill["at_ceiling"] is False
    # no earlier full pass ended once the floor had passed
    first = setup[0][0]
    assert all(end - first < traffic["setup_traffic_s"]
               for _, end, rows in setup[:-1] if rows >= need)


def test_a_batch_that_never_fills_opens_at_the_ceiling(monkeypatch):
    """A share no pass can serve (more rows than slots): set-up serves the
    mix to its ceiling, the window runs, and the run says so."""
    out, traffic, steps, _ = _run(monkeypatch, setup_traffic_s=0.1,
                                  setup_traffic_max_s=0.6,
                                  open_fill_share=1.01)
    fill = out["fill"]
    assert fill["at_ceiling"] is True
    assert fill["setup_traffic_s"] >= 0.6
    assert out["e2e"]["serve_tokens_per_s"] > 0
    line = cli.info(out, "cpu")
    assert line["fill"]["at_ceiling"] is True
    assert line["fill"]["setup_traffic_s"] == fill["setup_traffic_s"]
    assert line["fill"]["at_open"] == fill["at_open"]


def test_the_info_line_carries_the_fill_at_the_open(monkeypatch):
    out, _, _, _ = _run(monkeypatch, setup_traffic_s=0.2)
    line = cli.info(out, "cpu")
    assert set(line["fill"]) == {"at_open", "at_close", "setup_traffic_s",
                                 "at_ceiling"}
    assert line["fill"]["at_open"]["decode_rows"] >= 8
    assert line["fill"]["setup_traffic_s"] == pytest.approx(
        out["fill"]["setup_traffic_s"])


def test_a_poisson_mix_keeps_its_fixed_set_up(monkeypatch):
    out, traffic, _, _ = _run(monkeypatch, setup_traffic_s=0.3,
                              arrivals={"kind": "poisson", "rate_rps": 40.0})
    fill = out["fill"]
    assert 0.3 <= fill["setup_traffic_s"] < 1.0
    assert fill["at_ceiling"] is False
