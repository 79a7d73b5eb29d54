"""On the card, at each cell's own size: the program's number within its
limit and the control's past it (``python -m pytest benchmark/tests -m
chip`` on a machine with an H100; skipped without a card)."""

import time

import pytest

from harness import control, manifest, serve_cell

SEED = 2 ** 31 + 4242


@pytest.mark.chip
@pytest.mark.parametrize("cell", [c["name"] for c in
                                  manifest.load_manifest()["workloads"]])
def test_the_control_fails_where_the_program_passes(card, cell):
    mf = manifest.load_manifest()
    entry = manifest.find_cell(mf, cell)
    config = manifest.load_config(mf, entry["config"])
    traffic = manifest.load_traffic(entry["traffic"])
    limits = manifest.load_limits(cell)
    out = serve_cell.run(config, traffic, SEED, mf["run_seconds"], False,
                         card, time.monotonic(), limits)
    assert out["correct"], out["numbers"]
    numbers = control.serve_control_numbers(config, traffic, SEED,
                                            out["sequences"], card)
    assert any(numbers[k] > v for k, v in limits.items()), numbers
