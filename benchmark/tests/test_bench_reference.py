"""The plain reference against the port, on the CPU in float32 at tiny
sizes: where the arithmetic is the same, the two agree to rounding."""

import time

import pytest
import torch

import bench_tiny
from harness import reference, serve_cell
from harness.weights import make_weights

SEED = 2 ** 31 + 41
CPU = torch.device("cpu")
MODELS = {"dense": {}, "moe": {"moe_experts": 4}}


@pytest.mark.parametrize("kind", MODELS)
def test_forward_matches_the_port(kind):
    from dpu_operator_tpu_torch.workloads.model import forward
    from harness.program import program_config
    config = bench_tiny.config(dtype="float32", **MODELS[kind])
    weights = make_weights(config, SEED, CPU)
    tokens = torch.randint(0, 256, (3, 40), generator=torch.Generator()
                           .manual_seed(1))
    with torch.no_grad():
        port = forward(weights, tokens, program_config(config))
        ref = reference.forward(reference.fp32_tree(weights), tokens,
                                config)
    assert (port - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("kind", MODELS)
def test_serving_matches_the_reference_in_float32(kind):
    """The served tokens are the reference's best at every position: a
    MoE model's chunks route as the program routes them (a chunk padded to
    its width, decoded tokens one a row), with a capacity that drops."""
    config = bench_tiny.config(dtype="float32", moe_capacity_factor=0.5,
                               **MODELS[kind])
    out = serve_cell.run(config, bench_tiny.serve_mix("serve-batch"), SEED,
                         2.0, False, CPU, time.monotonic(),
                         {"logit_gap": 1e-5})
    assert out["sample"]["requests"] == 4
    assert out["correct"], out["numbers"]
