"""Multi-process runs of the port's sharded code on the CPU, for tests.

:func:`spawn` runs a function in *world* spawned processes that form one
gloo process group, the CPU stand-in for the ranks of a mesh, and returns
each rank's result. A spawned child imports the module that holds its
target, so the targets live here, in a module that imports torch and the
port only: a target in a test file would load JAX in every rank.

- The group forms over a ``FileStore`` in a directory the caller names
  (pytest's ``tmp_path``): no port is bound, so concurrent test workers
  cannot collide. The target's arguments go to the ranks through a file
  in that directory, not through the spawn's pipe: a large pickle on the
  pipe blocks the parent until each rank has read it, so the ranks would
  start one after the other.
- Each rank runs ``torch.set_num_threads(1)``; the group's timeout is
  :data:`GROUP_TIMEOUT_S`.
- The parent waits at most *deadline* seconds (:data:`DEADLINE_S`). A
  rank that raises sends its traceback back, and the parent raises
  :class:`SpmdError` with it at once; a deadline that passes raises
  ``TimeoutError``. Either way every child is killed and joined before
  :func:`spawn` returns or raises, so no process is left behind.

The targets below are the rank side of ``tests/test_torch_mesh.py``,
``tests/test_torch_spmd.py`` and ``tests/test_torch_long_context.py``:
each computes several results a spawn and returns them as numpy arrays
and plain values, which the tests hold against the JAX package in the
parent process.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import multiprocessing
import os
import pickle
import queue
import time
import traceback
import types
import uuid
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

#: the process group's timeout in each rank (s)
GROUP_TIMEOUT_S = 120.0
#: the parent's deadline for a whole spawn (s)
DEADLINE_S = 240.0
#: how long the parent waits for a rank that reported to exit (s)
_EXIT_S = 30.0


class SpmdError(RuntimeError):
    """A rank raised; the message holds its traceback."""


def _rank_main(target: Callable, rank: int, world: int, store: str,
               out: multiprocessing.Queue) -> None:
    torch.set_num_threads(1)
    try:
        with open(store + ".args", "rb") as f:
            args = pickle.load(f)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        payload = pickle.dumps(target(*args))
    except BaseException:  # reported to the parent, which kills the group
        out.put((rank, False, traceback.format_exc()))
        return
    dist.destroy_process_group()
    out.put((rank, True, payload))


def spawn(target: Callable, world: int, store_dir: str, args: tuple = (),
          deadline: float = DEADLINE_S) -> list:
    """``target(*args)`` in *world* ranks of a gloo group; returns the
    ranks' results, rank 0 first. *target* must be a module-level function
    of an importable module that does not import JAX."""
    ctx = multiprocessing.get_context("spawn")
    results: queue.Queue = ctx.Queue()
    store = os.path.join(store_dir, f"spmd-store-{uuid.uuid4().hex}")
    with open(store + ".args", "wb") as f:
        pickle.dump(args, f)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(target, rank, world, store, results))
             for rank in range(world)]
    for p in procs:
        p.start()
    got: dict = {}
    end = time.monotonic() + deadline
    clean = False
    try:
        while len(got) < world:
            left = end - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spmd: {world - len(got)} of {world} ranks did not "
                    f"finish within {deadline:.0f} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    raise SpmdError(f"spmd: rank {dead[0]} exited with code "
                                    f"{procs[dead[0]].exitcode} and no "
                                    "result") from None
                continue
            if not ok:
                raise SpmdError(f"spmd: rank {rank} raised:\n{payload}")
            got[rank] = pickle.loads(payload)
        clean = True
    finally:
        for p in procs:
            if clean:
                p.join(_EXIT_S)
            if p.is_alive():
                p.kill()
            p.join(_EXIT_S)
        results.close()
        results.join_thread()
    return [got[r] for r in range(world)]


# -- rank side: helpers -------------------------------------------------------

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _refusal(fn: Callable) -> tuple:
    """``(exception type name, message)`` of what *fn* raises, or ``(None,
    None)``."""
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None, None


def _coords(mesh: Any) -> tuple:
    return mesh.get_local_rank("data"), mesh.get_local_rank("model")


# -- rank side of tests/test_torch_mesh.py ------------------------------------

def mesh_checks(ring_x: np.ndarray, topo_shape: tuple,
                topo_chips: int) -> dict:
    """Mesh factoring and layout, ``mesh_for_topology`` (a topology string,
    a duck-typed topology of *topo_shape* / *topo_chips*, and a slice larger
    than the world), and the four collectives and three measurements on
    the local shards the JAX tests' global arrays give this rank."""
    from ..workloads import collectives as col
    from ..workloads.mesh import (make_mesh, mesh_for_topology, mesh_shape)
    out: dict = {"rank": dist.get_rank()}
    default = make_mesh(("data", "model"), device_type="cpu")
    out["default"] = mesh_shape(default)
    out["default_coords"] = _coords(default)
    out["v5e-8"] = mesh_shape(mesh_for_topology("v5e-8", device_type="cpu"))
    topo = types.SimpleNamespace(shape=topo_shape, num_chips=topo_chips)
    out["duck"] = mesh_shape(mesh_for_topology(topo, device_type="cpu"))
    out["v5e-256"] = mesh_shape(mesh_for_topology("v5e-256",
                                                  device_type="cpu"))
    out["bad_sizes"] = _refusal(lambda: make_mesh(
        ("data", "model"), axis_sizes=(3, 3), device_type="cpu"))

    mesh = make_mesh(("data", "model"), (2, 4), device_type="cpu")
    d, m = _coords(mesh)
    out["coords_2x4"] = (d, m)
    x = torch.arange(16, dtype=torch.float32)
    out["psum"] = _np(col.psum_allreduce(mesh, "model")(x[4 * m:4 * m + 4]))
    xr = torch.from_numpy(ring_x)[16 * m:16 * m + 16]
    ring_in = xr.clone()
    out["ring"] = _np(col.ring_allreduce(mesh, "model")(xr))
    out["ring_psum"] = _np(col.psum_allreduce(mesh, "model")(xr))
    out["ring_input_kept"] = bool(torch.equal(xr, ring_in))

    line = make_mesh(("data", "model"), (1, 8), device_type="cpu")
    me = line.get_local_rank("model")
    out["measure"] = {impl: col.measure_allreduce_gbps(
        line, "model", mbytes=1.0, iters=2, impl=impl)
        for impl in ("psum", "ring")}
    n, chunk = 8, 4
    g = torch.arange(n * n * chunk, dtype=torch.float32).reshape(n * n,
                                                                 chunk)
    out["a2a"] = _np(col.all_to_all_exchange(line, "model")(
        g[me * n:(me + 1) * n]))
    chunk = 3
    g = torch.arange(n * chunk, dtype=torch.float32)
    out["hop"] = _np(col.ppermute_hop(line, "model")(
        g[me * chunk:(me + 1) * chunk]))
    out["measure_more"] = [fn(line, "model", mbytes=0.5, iters=2) for fn in (
        col.measure_all_to_all_gbps, col.measure_ppermute_gbps)]
    return out


def raise_on_rank(bad: int) -> None:
    """Rank *bad* raises while the others wait in a collective that cannot
    complete: the harness must report the raise, not wait."""
    if dist.get_rank() == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    dist.all_reduce(torch.ones(1))


def sleep_for(seconds: float) -> None:
    """A rank that outlives the parent's deadline."""
    time.sleep(seconds)


# -- rank side of tests/test_torch_spmd.py ------------------------------------

def _cfg(**kw: Any) -> Any:
    from ..workloads.model import TransformerConfig
    return TransformerConfig(**kw)


def _batch(tokens: np.ndarray, targets: np.ndarray) -> dict:
    return {"tokens": torch.from_numpy(tokens.astype(np.int64)),
            "targets": torch.from_numpy(targets.astype(np.int64))}


def _leaves_np(params: dict) -> list:
    from ..workloads.train import param_leaves
    return [_np(t) for t in param_leaves(params)]


def train_parity(np_tree: dict, tokens: np.ndarray, targets: np.ndarray,
                 cases: list, steps: int, fwd_tree: dict,
                 fwd_tokens: np.ndarray) -> dict:
    """For each ``(axis_sizes, sequence_parallel)`` of *cases*: *steps*
    sharded AdamW steps of the fp32 2-layer model from the bridged JAX
    tree *np_tree* on the global batch, the losses, and the gathered
    parameters (rank 0 returns them whole; every rank the sum of each
    leaf, so the tests see that the replicas agree). Then the sharded
    forward of the 1-layer model *fwd_tree* on *fwd_tokens* with and
    without sp, each rank's logits beside its data index."""
    from ..workloads.mesh import make_mesh
    from ..workloads.model import forward, gather_params, params_from_numpy
    from ..workloads.train import make_train_step
    rank = dist.get_rank()
    out: dict = {"rank": rank, "train": {}, "forward": {}}
    for sizes, sp in cases:
        cfg = _cfg(n_layers=2, max_seq=32, dtype=torch.float32,
                   sequence_parallel=sp)
        mesh = make_mesh(("data", "model"), sizes, device_type="cpu")
        step, init_state, place = make_train_step(cfg, mesh, device="cpu")
        params, opt = init_state(params=params_from_numpy(
            np_tree, cfg, device="cpu"))
        batch = place(_batch(tokens, targets))
        losses = []
        for _ in range(steps):
            params, opt, loss = step(params, opt, batch)
            losses.append(float(loss))
        leaves = _leaves_np(gather_params(params, cfg, mesh))
        out["train"][(tuple(sizes), sp)] = {
            "losses": losses,
            "sums": [float(a.astype(np.float64).sum()) for a in leaves],
            "params": leaves if rank == 0 else None}
    for sp in (True, False):
        cfg = _cfg(n_layers=1, max_seq=16, dtype=torch.float32,
                   sequence_parallel=sp)
        mesh = make_mesh(("data", "model"), (2, 4), device_type="cpu")
        from ..workloads.model import batch_shard, shard_params
        params = shard_params(params_from_numpy(fwd_tree, cfg, device="cpu"),
                              cfg, mesh)
        toks = batch_shard(torch.from_numpy(fwd_tokens.astype(np.int64)),
                           mesh)
        with torch.no_grad():
            logits = forward(params, toks, cfg, mesh)
        out["forward"][sp] = (mesh.get_local_rank("data"), _np(logits))
    return out


def train_behaviour() -> dict:
    """The rest of the sharded step's checks on a (2, 4) mesh unless
    named: the bf16 default model's loss over 5 steps; remat against no
    remat (loss and reduced gradients); the parameter shards' shapes;
    MoE on an (8, 1) mesh against the one-device step; ``measure_train``
    on the mesh; and the refusals."""
    from ..workloads.mesh import make_mesh
    from ..workloads.model import make_example_batch, param_specs
    from ..workloads.perf import measure_train
    from ..workloads.train import make_train_step, param_leaves
    out: dict = {"rank": dist.get_rank()}
    mesh = make_mesh(("data", "model"), (2, 4), device_type="cpu")

    cfg = _cfg(n_layers=2, max_seq=32)
    step, init_state, place = make_train_step(cfg, mesh, device="cpu")
    params, opt = init_state(seed=0)
    batch = place(make_example_batch(cfg, batch=4, seq=32))
    out["bf16_losses"] = [float(step(params, opt, batch)[2])
                          for _ in range(5)]

    remat = {}
    for on in (False, True):
        c = _cfg(n_layers=2, max_seq=32, dtype=torch.float32, remat=on)
        step, init_state, place = make_train_step(c, mesh, device="cpu")
        params, opt = init_state(seed=0)
        _, _, loss = step(params, opt,
                          place(make_example_batch(c, batch=4, seq=32)))
        remat[on] = (float(loss), [p.grad.clone()
                                   for p in param_leaves(params)])
    out["remat_loss"] = (remat[False][0], remat[True][0])
    out["remat_grad_err"] = max(float((a - b).abs().max()) for a, b in zip(
        remat[False][1], remat[True][1]))

    cfg = _cfg(n_layers=1, max_seq=16)
    _, init_state, _ = make_train_step(cfg, mesh, device="cpu")
    params, _ = init_state(seed=0)
    out["wqkv_spec"] = param_specs(cfg)["layers"][0]["wqkv"]
    out["shapes"] = {n: tuple(params["layers"][0][n].shape)
                     for n in ("wqkv", "wo", "w1", "w2")}
    out["shapes"]["embed"] = tuple(params["embed"].shape)

    out["moe"] = _moe_against_one_device()

    tiny = _cfg(n_layers=1, max_seq=16, dtype=torch.float32)
    perf = measure_train(tiny, mesh, batch=4, steps=1, device="cpu")
    out["perf"] = dataclasses.asdict(perf)

    moe = _cfg(moe_experts=4, max_seq=16, dtype=torch.float32)
    out["refusals"] = {
        "moe_tp": _refusal(lambda: make_train_step(moe, mesh, "cpu")),
        "ring": _refusal(lambda: make_train_step(
            _cfg(attention="ring", moe_experts=4), mesh, "cpu")),
        "heads": _refusal(lambda: make_train_step(
            _cfg(n_heads=6, d_model=96), mesh, "cpu")),
        "seq": _refusal(lambda: _forward_at_seq(mesh, 30)),
        "batch": _refusal(lambda: make_train_step(
            tiny, mesh, "cpu")[2](make_example_batch(tiny, batch=3))),
        "device": _refusal(lambda: make_train_step(tiny, mesh, "meta")),
    }
    dcn = make_mesh(("dcn", "data", "model"), (2, 2, 2), device_type="cpu")
    out["refusals"]["dcn"] = _refusal(
        lambda: make_train_step(tiny, dcn, "cpu"))
    return out


def _forward_at_seq(mesh: Any, seq: int) -> None:
    from ..workloads.model import forward, init_params, shard_params
    cfg = _cfg(n_layers=1, max_seq=32, dtype=torch.float32)
    params = shard_params(init_params(0, cfg, device="cpu"), cfg, mesh)
    forward(params, torch.zeros((1, seq), dtype=torch.int64), cfg, mesh)


def _moe_against_one_device() -> dict:
    """One step of the fp32 MoE model on an (8, 1) mesh (batch 8, one row a
    rank) against the one-device step on the whole batch: the losses, and
    the largest gradient difference over every leaf, scaled by max(1,
    |one-device gradient|)."""
    from ..workloads.mesh import make_mesh
    from ..workloads.model import make_example_batch
    from ..workloads.train import make_train_step, param_leaves
    cfg = _cfg(n_layers=2, max_seq=16, dtype=torch.float32, moe_experts=4)
    mesh = make_mesh(("data", "model"), (8, 1), device_type="cpu")
    batch = make_example_batch(cfg, batch=8, seq=16)
    got = {}
    for m in (mesh, None):
        step, init_state, place = make_train_step(cfg, m, device="cpu")
        params, opt = init_state(seed=3)
        _, _, loss = step(params, opt, place(batch))
        got[m is None] = (float(loss), [p.grad for p in param_leaves(params)])
    err = max(float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
              for a, b in zip(got[False][1], got[True][1]))
    return {"loss": got[False][0], "one_device_loss": got[True][0],
            "grad_err": err}


# -- rank side of tests/test_torch_long_context.py ----------------------------

_DM = ("data", "model")


@functools.lru_cache(maxsize=None)
def _mesh(names: tuple, sizes: tuple) -> Any:
    """A cpu mesh, formed once a rank: forming one sets up a gloo group
    for every row of every axis."""
    from ..workloads.mesh import make_mesh
    return make_mesh(names, sizes, device_type="cpu")


def _seq_shard(a: np.ndarray, mesh: Any, dtype: torch.dtype) -> torch.Tensor:
    """This rank's S / n columns of a global (B, S, ...) array."""
    from ..workloads.model import seq_columns
    return seq_columns(torch.from_numpy(a), mesh).to(dtype).contiguous()


def _attention_case(make: Callable, mesh: Any, qkv: tuple, do: Any,
                    dtype: torch.dtype) -> dict:
    """The sequence-sharded attention *make(mesh)* on this rank's columns
    of the global *qkv*: its output and, given the global output gradient
    *do*, the gradients of the rank's q, k, v columns."""
    q, k, v = (_seq_shard(a, mesh, dtype).requires_grad_(do is not None)
               for a in qkv)
    out = make(mesh)(q, k, v)
    got = {"out": _np(out)}
    if do is not None:
        out.backward(_seq_shard(do, mesh, dtype))
        got.update(dq=_np(q.grad), dk=_np(k.grad), dv=_np(v.grad))
    return got


def _long_context_attention(ring_qkv: tuple, ring_do: np.ndarray,
                           bf16_qkv: tuple, ulysses_qkv: tuple,
                           ulysses_do: np.ndarray) -> dict:
    """Ring attention on this rank's columns: on a (1, 8) mesh causal with
    the gradients of *ring_do* and not causal, on (2, 4) at S 32 with the
    gradients, and in bf16 on (1, 8) (*bf16_qkv* holds bf16 values); then
    Ulysses attention on an 8-wide ("model",) mesh with the gradients of
    *ulysses_do*."""
    from functools import partial

    from ..workloads import collectives as col
    from ..workloads.ring_attention import ring_attention
    from ..workloads.ulysses import ulysses_attention
    f32 = torch.float32
    line, square = _mesh(_DM, (1, 8)), _mesh(_DM, (2, 4))
    out: dict = {"rank": dist.get_rank(), "coords_2x4": _coords(square)}
    out["ring_causal"] = _attention_case(ring_attention, line, ring_qkv,
                                         ring_do, f32)
    out["ring_full"] = _attention_case(
        partial(ring_attention, causal=False), line, ring_qkv, None, f32)
    half = tuple(a[:, :32] for a in ring_qkv)
    out["ring_2x4"] = _attention_case(ring_attention, square, half,
                                      ring_do[:, :32], f32)
    out["ring_bf16"] = _attention_case(ring_attention, line, bf16_qkv,
                                       None, torch.bfloat16)
    # the hop's backward: rank r's gradient is rank r+1's weight
    x = torch.zeros(3, requires_grad=True)
    me = line.get_local_rank("model")
    col.ppermute_hop(line, "model")(x).mul(float(me)).sum().backward()
    out["hop_grad"] = _np(x.grad)
    heads = _mesh(("model",), (8,))
    out["ulysses"] = _attention_case(ulysses_attention, heads, ulysses_qkv,
                                     ulysses_do, f32)
    return out


def _steps(cfg: Any, mesh: Any, tree: Any, seed: int, tokens: np.ndarray,
           targets: np.ndarray, steps: int, gather: bool) -> dict:
    """*steps* AdamW steps of *cfg* on *mesh* from the bridged JAX tree
    *tree* (or the port's ``init_params(seed)``): the losses, each leaf's
    sum on this rank, and on rank 0 the parameters gathered into the
    JAX layout when *gather*."""
    from ..workloads.model import gather_params, params_from_numpy
    from ..workloads.train import make_train_step
    step, init_state, place = make_train_step(cfg, mesh, device="cpu")
    params, opt = init_state(seed, None if tree is None else
                             params_from_numpy(tree, cfg, device="cpu"))
    batch = place(_batch(tokens, targets))
    losses = [float(step(params, opt, batch)[2]) for _ in range(steps)]
    leaves = _leaves_np(params)
    return {"losses": losses,
            "sums": [float(a.astype(np.float64).sum()) for a in leaves],
            "params": _leaves_np(gather_params(params, cfg, mesh))
            if gather and dist.get_rank() == 0 else None}


def _long_context_train(fwd_tree: dict, fwd_tokens: np.ndarray,
                       ring_tree: dict, ring_batch: tuple,
                       ulysses_tree: dict, ulysses_batch: tuple,
                       steps: int) -> dict:
    """The sequence modes in the sharded forward and train step: the
    1-layer fp32 model *fwd_tree* forward on a (1, 8) mesh in ring and
    Ulysses mode (the rank's columns of the logits); *steps* fp32 steps of
    the ring model on (2, 4) and of the Ulysses model on (1, 8) from the
    bridged trees; 5 steps of the bf16 ring model from the port's
    ``init_params(0)``; ``measure_train`` in ring mode; and the
    refusals."""
    from ..workloads.model import forward, params_from_numpy
    from ..workloads.perf import measure_train
    from ..workloads.train import make_train_step
    f32 = torch.float32
    line, square = _mesh(_DM, (1, 8)), _mesh(_DM, (2, 4))
    out: dict = {"rank": dist.get_rank(), "coords_2x4": _coords(square),
                 "forward": {}}
    for mode in ("ring", "ulysses"):
        cfg = _cfg(n_layers=1, max_seq=32, dtype=f32, attention=mode)
        params = params_from_numpy(fwd_tree, cfg, device="cpu")
        with torch.no_grad():
            out["forward"][mode] = _np(forward(
                params, torch.from_numpy(fwd_tokens.astype(np.int64)), cfg,
                line))

    ring = _cfg(n_layers=2, max_seq=64, dtype=f32, attention="ring")
    out["ring_train"] = _steps(ring, square, ring_tree, 0, *ring_batch,
                               steps, True)
    ulysses = _cfg(vocab=64, d_model=64, n_heads=8, n_layers=2, d_ff=128,
                   max_seq=64, dtype=f32, attention="ulysses")
    out["ulysses_train"] = _steps(ulysses, line, ulysses_tree, 0,
                                  *ulysses_batch, steps, True)
    bf16 = _cfg(n_layers=2, max_seq=64, attention="ring")
    out["ring_bf16"] = _steps(bf16, square, None, 0, *ring_batch, 5,
                              False)["losses"]

    tiny = _cfg(n_layers=1, max_seq=16, dtype=f32, attention="ring")
    out["perf"] = dataclasses.asdict(measure_train(tiny, square, batch=4,
                                                   steps=1, device="cpu"))

    def at_seq(mode: str, seq: int) -> None:
        from ..workloads.model import init_params
        cfg = _cfg(n_layers=1, max_seq=32, dtype=f32, attention=mode)
        forward(init_params(0, cfg, device="cpu"),
                torch.zeros((1, seq), dtype=torch.int64), cfg, square)

    out["refusals"] = {
        "ring_seq": _refusal(lambda: at_seq("ring", 30)),
        "ulysses_seq": _refusal(lambda: at_seq("ulysses", 30)),
        "ulysses_heads": _refusal(lambda: make_train_step(
            _cfg(n_heads=6, d_model=96, attention="ulysses"), line, "cpu")),
        "moe_ring": _refusal(lambda: make_train_step(
            _cfg(moe_experts=4, attention="ring"), square, "cpu")),
        "moe_ulysses": _refusal(lambda: make_train_step(
            _cfg(moe_experts=4, attention="ulysses"), line, "cpu")),
    }
    return out


def long_context(attention_args: tuple, train_args: tuple) -> dict:
    """The whole rank side of ``tests/test_torch_long_context.py`` in one
    spawn: :func:`_long_context_attention` and :func:`_long_context_train`
    on their arguments."""
    return {"attention": _long_context_attention(*attention_args),
            "train": _long_context_train(*train_args)}
