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

from dpu_operator_tpu.utils import metrics as jax_metrics
from dpu_operator_tpu.workloads.kv_pool import KvBlockPool as JaxKvBlockPool
from dpu_operator_tpu_torch.utils import metrics
from dpu_operator_tpu_torch.workloads import decode, model
from dpu_operator_tpu_torch.workloads.kv_pool import KvBlockPool, chain_keys
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


def _gauges(m):
    return (m.SERVE_KV_BLOCKS.value(state="free"),
            m.SERVE_KV_BLOCKS.value(state="used"),
            m.KV_SHARED_BLOCKS.value(), m.SERVE_KV_FRAGMENTATION.value())


def _assert_pools_equal(ours, theirs):
    assert ours.snapshot() == theirs.snapshot()
    assert ours.shared_blocks() == theirs.shared_blocks()
    assert ours.internal_fragmentation() == theirs.internal_fragmentation()
    assert ours.logical_blocks() == theirs.logical_blocks()
    assert _gauges(metrics) == _gauges(jax_metrics)


@pytest.mark.parametrize("sharing", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kv_pool_gauges_equal_the_jax_pool_after_every_operation(
        sharing, seed):
    """The same random operations on both pools, prompts drawn from a
    few common prefixes so that mappings, copies on write and
    unpublishing fire: after each, the snapshot, the gauge readers and
    the four gauges' values are the JAX pool's, floats exactly."""
    rng = np.random.default_rng(seed)
    bs = 4
    ours, theirs = KvBlockPool(40, bs, sharing), \
        JaxKvBlockPool(40, bs, sharing)
    stems = [[int(t) for t in rng.integers(0, 50, 13)] for _ in range(3)]
    live = {}

    def both(name, *args):
        got = getattr(ours, name)(*args)
        assert got == getattr(theirs, name)(*args), (name, args)
        _assert_pools_equal(ours, theirs)
        return got

    _assert_pools_equal(ours, theirs)
    for i in range(300):
        op = rng.random()
        owner = (list(live)[int(rng.integers(len(live)))] if live
                 else None)
        if owner is None or op < 0.2:
            stem = stems[int(rng.integers(len(stems)))]
            prompt = stem[:int(rng.integers(2, 14))] \
                + [int(t) for t in rng.integers(0, 50,
                                                int(rng.integers(0, 5)))]
            keys = chain_keys(prompt, bs)
            owner = f"o{i}"
            mapped = both("map_prefix", owner, keys)
            need = -(-(len(prompt) + int(rng.integers(1, 6))) // bs)
            if both("alloc", owner, max(0, need - mapped)) is None:
                both("free", owner)
                continue
            live[owner] = (keys, len(prompt))
            if mapped:
                both("set_used_tokens", owner,
                     min(mapped * bs, len(prompt) - 1))
        elif op < 0.3:
            keys, prompt_len = live[owner]
            both("set_used_tokens", owner, prompt_len)
            both("register_prefix", owner, keys, prompt_len)
        elif op < 0.5:
            cap = len(ours.blocks_of(owner)) * bs
            if cap:
                both("write_token", owner, int(rng.integers(cap)))
        elif op < 0.7:
            cap = len(ours.blocks_of(owner)) * bs
            both("set_used_tokens", owner, int(rng.integers(-2, cap + 4)))
        elif op < 0.78:
            both("alloc", owner, int(rng.integers(0, 3)))
        elif op < 0.88:
            cap = len(ours.blocks_of(owner)) * bs
            both("rollback_tokens", owner, int(rng.integers(0, cap + 2)))
        elif op < 0.98:
            both("free", owner)
            del live[owner]
        else:
            both("free", "never-seen")
        for o in live:
            assert ours.blocks_of(o) == theirs.blocks_of(o)
    assert ours.cow_copies or not sharing
    for owner in list(live):
        both("free", owner)
    assert ours.outstanding() == 0 and _gauges(metrics)[1:] == (0, 0, 0)


class _Unwalkable(dict):
    """A dict that refuses to be walked while armed."""

    armed = False

    def _refuse(self):
        if self.armed:
            raise AssertionError("a pool mutation walked a whole dict")

    def __iter__(self):
        self._refuse()
        return super().__iter__()

    def keys(self):
        self._refuse()
        return super().keys()

    def values(self):
        self._refuse()
        return super().values()

    def items(self):
        self._refuse()
        return super().items()


def test_kv_pool_gauges_are_current_after_each_token_without_a_walk(
        monkeypatch):
    """At the serving cells' shape (16,384 blocks of 16, 256 owners,
    prompts and outputs drawn as the cells' mix draws them, about 6,600
    blocks held), one token more for every owner: each call
    updates the gauges once, walking neither the owners nor the blocks,
    and they end equal to the JAX pool's."""
    rng = np.random.default_rng(25)
    ours, theirs = KvBlockPool(16384, 16), JaxKvBlockPool(16384, 16)
    used = {}
    for i in range(256):
        owner = f"r{i}"
        prompt = int(np.clip(rng.lognormal(np.log(192), 0.8), 32, 768))
        output = int(np.clip(rng.lognormal(np.log(128), 0.6), 32, 256))
        blocks = -(-(prompt + output) // 16)
        assert ours.alloc(owner, blocks) == theirs.alloc(owner, blocks)
        ours.set_used_tokens(owner, prompt)
        theirs.set_used_tokens(owner, prompt)
        used[owner] = prompt
    assert 6000 < ours.outstanding() < 7500
    assert not hasattr(KvBlockPool, "_written_slots_locked")
    calls = []
    original = ours._update_gauges_locked

    def counted():
        calls.append(1)
        original()

    monkeypatch.setattr(ours, "_update_gauges_locked", counted)
    for name in ("_owned", "_refs", "_cover", "_used_tokens"):
        monkeypatch.setattr(ours, name, _Unwalkable(getattr(ours, name)))
    monkeypatch.setattr(_Unwalkable, "armed", True)
    for owner, n in used.items():
        ours.set_used_tokens(owner, n + 1)
    monkeypatch.setattr(_Unwalkable, "armed", False)
    assert len(calls) == len(used)
    for owner, n in used.items():
        theirs.set_used_tokens(owner, n + 1)
    ours._update_gauges_locked()
    assert _gauges(metrics) == _gauges(jax_metrics)
    assert ours.snapshot() == theirs.snapshot()


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
