"""Continuous batching in the PyTorch/CUDA port, on the CPU, and the
guard that keeps the port apart from the JAX package.

More requests than slots go through ``Scheduler`` and
``TorchSlotExecutor``; every stream must equal the port's own ``generate``
on the same prompt and every KV block must come back. The block pool's
allocation order is held against the JAX package's ``KvBlockPool``.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from dpu_operator_tpu.workloads.kv_pool import KvBlockPool as JaxKvBlockPool
from dpu_operator_tpu_torch.workloads import decode, model
from dpu_operator_tpu_torch.workloads.kv_pool import KvBlockPool
from dpu_operator_tpu_torch.workloads.serve import (
    BATCH, DONE, FAILED, INTERACTIVE, REJECTED, Request, Scheduler,
    ServeConfig, TorchSlotExecutor)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "dpu_operator_tpu_torch"


@pytest.fixture(scope="module")
def tiny():
    cfg = model.TransformerConfig(vocab=256, d_model=64, n_heads=4,
                                  n_layers=2, d_ff=128, max_seq=64,
                                  dtype=torch.float32)
    return cfg, model.init_params(0, cfg, device="cpu")


def _requests(seed, n, cls_every=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = int(rng.integers(3, 30))
        cls = INTERACTIVE if cls_every and i % cls_every == 0 else BATCH
        out.append(Request(rid=f"r{i}", prompt_len=p,
                           output_len=int(rng.integers(1, 12)),
                           slo_class=cls,
                           prompt=tuple(int(t) for t in
                                        rng.integers(0, 256, p))))
    return out


def _run(cfg, params, reqs, slots, chunk, kv_blocks=64):
    ex = TorchSlotExecutor(params, cfg, slots=slots, chunk_tokens=chunk,
                           device="cpu")
    sched = Scheduler(ServeConfig(slots=slots, kv_blocks=kv_blocks,
                                  kv_block_size=8,
                                  prefill_chunk_tokens=chunk), ex)
    for r in reqs:
        sched.submit(r)
    sched.run()
    return sched


@pytest.mark.parametrize("chunk", [0, 8])
def test_more_requests_than_slots_stream_equal_generate(tiny, chunk):
    """Whole-prompt (chunk 0) and chunked prefill: every request
    completes with exactly output_len tokens equal to generate's, and the
    pool drains to zero."""
    cfg, params = tiny
    reqs = _requests(1, 7, cls_every=3)
    sched = _run(cfg, params, reqs, slots=3, chunk=chunk)
    assert len(sched.completed) == 7 and not sched.failed
    for r in reqs:
        assert r.state == DONE and len(r.tokens) == r.output_len
        want = decode.generate(params, cfg, torch.tensor([r.prompt]),
                               r.output_len, device="cpu")[0].tolist()
        assert r.tokens == want, r.rid
    assert sched.pool.outstanding() == 0
    if chunk:
        assert sched.prefill_chunks_total >= sum(
            -(-r.prompt_len // chunk) for r in reqs)


def test_kv_pressure_delays_admission_but_completes_all(tiny):
    """A pool that holds two sequences at a time: admission waits for
    blocks, not slots, and nothing leaks."""
    cfg, params = tiny
    reqs = _requests(2, 6)
    sched = _run(cfg, params, reqs, slots=4, chunk=8, kv_blocks=10)
    assert len(sched.completed) == 6
    assert max(sum(1 for e in sched.trace[:i] if e[0] == "admit")
               - sum(1 for e in sched.trace[:i] if e[0] == "complete")
               for i in range(len(sched.trace) + 1)) <= 3
    assert sched.pool.outstanding() == 0


def test_interactive_admitted_before_batch(tiny):
    cfg, params = tiny
    reqs = _requests(3, 5)
    reqs[4].slo_class = INTERACTIVE
    sched = _run(cfg, params, reqs, slots=1, chunk=0)
    admits = [e[2] for e in sched.trace if e[0] == "admit"]
    assert admits[0] == "r4" and admits[1:] == ["r0", "r1", "r2", "r3"]


def test_static_batching_admits_only_into_an_empty_batch(tiny):
    cfg, params = tiny
    reqs = _requests(6, 5)
    ex = TorchSlotExecutor(params, cfg, slots=2, device="cpu")
    sched = Scheduler(ServeConfig(slots=2, kv_blocks=64, kv_block_size=8,
                                  static=True), ex)
    for r in reqs:
        sched.submit(r)
    sched.run()
    live = 0
    for event in sched.trace:
        if event[0] == "admit":
            assert live == 0 or event[1] == admitted_at
            admitted_at = event[1]
            live += 1
        elif event[0] == "complete":
            live -= 1
    assert all(r.state == DONE for r in reqs)


def test_rejections_at_ingest(tiny):
    cfg, params = tiny
    ex = TorchSlotExecutor(params, cfg, slots=1, device="cpu")
    sched = Scheduler(ServeConfig(slots=1, kv_blocks=4, kv_block_size=8,
                                  queue_limit=1), ex)
    big = Request(rid="big", prompt_len=30, output_len=10,
                  prompt=(1,) * 30)
    ok = Request(rid="ok", prompt_len=3, output_len=2, prompt=(1, 2, 3))
    dup = Request(rid="ok", prompt_len=3, output_len=2, prompt=(1, 2, 3))
    over = Request(rid="over", prompt_len=3, output_len=2, prompt=(4, 5, 6))
    for r in (big, ok, dup, over):
        sched.submit(r)
    sched.run()
    assert [(r.rid, r.reject_reason) for r in sched.rejected] == [
        ("big", "kv_too_large"), ("ok", "duplicate_rid"),
        ("over", "queue_full")]
    assert all(r.state == REJECTED for r in (big, dup, over))
    assert ok.state == DONE and len(ok.tokens) == 2


def test_failing_request_fails_alone(tiny):
    cfg, params = tiny
    reqs = _requests(4, 3)
    bad = Request(rid="bad", prompt_len=4, output_len=3, prompt=None)
    sched = _run(cfg, params, [bad] + reqs, slots=2, chunk=8)
    assert bad.state == FAILED and sched.failed == [bad]
    assert all(r.state == DONE for r in reqs)
    assert sched.pool.outstanding() == 0


def test_chunked_scheduler_refuses_executor_without_chunk_width(tiny):
    cfg, params = tiny
    ex = TorchSlotExecutor(params, cfg, slots=1, device="cpu")
    with pytest.raises(ValueError, match="chunk width"):
        Scheduler(ServeConfig(slots=1, prefill_chunk_tokens=8), ex)
    assert ex.prefix_aware is False and ex.spec_width is None


def test_kv_pool_allocates_as_the_jax_pool_does():
    rng = np.random.default_rng(5)
    ours, theirs = KvBlockPool(32, 4), JaxKvBlockPool(32, 4)
    live = []
    for i in range(60):
        if live and rng.random() < 0.4:
            owner = live.pop(int(rng.integers(len(live))))
            assert ours.free(owner) == theirs.free(owner)
        else:
            owner, n = f"o{i}", int(rng.integers(0, 6))
            got, want = ours.alloc(owner, n), theirs.alloc(owner, n)
            assert got == want
            if got is not None:
                live.append(owner)
                ours.set_used_tokens(owner, 3 * n)
                theirs.set_used_tokens(owner, 3 * n)
        assert ours.outstanding() == theirs.outstanding()
        assert ours.free_blocks() == theirs.free_blocks()
    for owner in live:
        assert ours.blocks_of(owner) == theirs.blocks_of(owner)
        ours.free(owner)
    assert ours.outstanding() == 0
    with pytest.raises(KeyError):
        ours.set_used_tokens("gone", 1)


# -- isolation guard ----------------------------------------------------------

def _banned(name):
    return name == "jax" or name.startswith("jax.") \
        or name == "dpu_operator_tpu" \
        or name.startswith("dpu_operator_tpu.")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import dpu_operator_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import bench_torch\n"
        "print(sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith('jax.') or m == 'dpu_operator_tpu'"
        " or m.startswith('dpu_operator_tpu.')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    [*PORT.rglob("*.py"), REPO / "chip_smoke.py", REPO / "bench_torch.py"]))
def test_no_source_of_the_port_names_jax(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        assert not any(_banned(n) for n in names), (path, names)
