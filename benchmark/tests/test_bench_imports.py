"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the program."""

import json
import subprocess
import sys

from harness import cli, manifest

ROOT = manifest.ROOT


def _modules(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path[:0] = [%r, %r, %r]\n%s\n"
         "import json; print(json.dumps(sorted(sys.modules)))"
         % (str(manifest.BENCH), str(ROOT), str(manifest.BENCH / "tests"),
            code)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    return {name.split(".", 1)[0]
            for name in json.loads(out.stdout.splitlines()[-1])}


def test_the_harness_and_the_program_load_no_jax():
    tops = _modules(
        "import harness.cli, harness.control\n"
        "import dpu_operator_tpu_torch.workloads.serve")
    assert "dpu_operator_tpu_torch" in tops
    assert not tops & set(cli.FORBIDDEN_MODULES)


def test_the_reference_loads_nothing_of_the_program():
    """The reference, its comparison and the GPT-2 block's forward, run on
    a tiny model."""
    tops = _modules(
        "import torch, harness.compare, bench_tiny\n"
        "from harness import reference, weights\n"
        "config = bench_tiny.config(dtype='float32')\n"
        "w = weights.make_weights(config, 3, 'cpu')\n"
        "reference.sequence_logits(reference.fp32_tree(w), [1, 2, 3],\n"
        "                          config, 'cpu')")
    assert "dpu_operator_tpu_torch" not in tops
    assert not tops & set(cli.FORBIDDEN_MODULES)


def test_names_are_compared_whole():
    assert cli.forbidden_loaded({"dpu_operator_tpu_torch.ops": 0,
                                 "jaxtyping": 0, "numpy": 0}) == []
    assert cli.forbidden_loaded({"dpu_operator_tpu.workloads": 0,
                                 "jax.numpy": 0}) == ["dpu_operator_tpu",
                                                      "jax"]
