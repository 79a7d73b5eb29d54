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
  :func:`spawn` returns or raises, so no process is left behind. A rank
  destroys its group on the way out, also when its target raised.
- ``backend="nccl"`` forms the group over the cards, rank r on card r
  (``graft_entry.dryrun_multichip`` on a machine of several cards).

The targets below are the rank side of ``tests/test_torch_mesh.py``,
``tests/test_torch_spmd.py``, ``tests/test_torch_long_context.py``,
``tests/test_torch_expert_parallel.py`` and ``tests/test_torch_pipeline.py``:
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
               out: multiprocessing.Queue, backend: str) -> None:
    torch.set_num_threads(1)
    try:
        with open(store + ".args", "rb") as f:
            args = pickle.load(f)
        if backend == "nccl":  # one card a rank
            torch.cuda.set_device(rank)
        dist.init_process_group(
            backend, store=dist.FileStore(store, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        payload = pickle.dumps(target(*args))
    except BaseException:  # reported to the parent, which kills the group
        out.put((rank, False, traceback.format_exc()))
        # in the pipe before the group ends, so the parent reads this
        # traceback before any rank that the end fails
        out.close()
        out.join_thread()
        return
    finally:  # the group ends here, also when the target raised
        if dist.is_initialized():
            dist.destroy_process_group()
    out.put((rank, True, payload))


def spawn(target: Callable, world: int, store_dir: str, args: tuple = (),
          deadline: float = DEADLINE_S, backend: str = "gloo") -> list:
    """``target(*args)`` in *world* ranks of a *backend* group ("gloo",
    or "nccl" with rank r on card r); returns the ranks' results, rank 0
    first. *target* must be a module-level function of an importable
    module that does not import JAX."""
    ctx = multiprocessing.get_context("spawn")
    results: queue.Queue = ctx.Queue()
    store = os.path.join(store_dir, f"spmd-store-{uuid.uuid4().hex}")
    with open(store + ".args", "wb") as f:
        pickle.dump(args, f)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(target, rank, world, store, results,
                               backend))
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
    """A copy: an fp32 CPU tensor's ``numpy()`` shares its memory."""
    return t.detach().float().cpu().numpy().copy()


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


def _first_loss(cfg: Any, mesh: Any, case: tuple) -> tuple:
    """``(refusal, loss)``: one sharded step of *cfg* on *mesh* from the
    bridged tree and global batch of *case* (``(tree, tokens,
    targets)``); the refusal is ``(None, None)`` when the step runs, and
    the loss is then the step's (the global batch's loss at the tree)."""
    from ..workloads.model import params_from_numpy
    from ..workloads.train import make_train_step
    got: list = []

    def run() -> None:
        tree, tokens, targets = case
        step, init_state, place = make_train_step(cfg, mesh, "cpu")
        params, opt = init_state(params=params_from_numpy(tree, cfg, "cpu"))
        got.append(float(step(params, opt, place(_batch(tokens,
                                                         targets)))[2]))

    return _refusal(run), (got[0] if got else None)


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


def train_behaviour(runs: dict) -> dict:
    """The rest of the sharded step's checks on a (2, 4) mesh unless
    named: the bf16 default model's loss over 5 steps; remat against no
    remat (loss and reduced gradients); the parameter shards' shapes;
    MoE on an (8, 1) mesh against the one-device step; ``measure_train``
    on the mesh; and the refusals. The modes that once were refused run
    one step each from the bridged trees and batches of *runs* (keys
    ``moe_tp``: MoE on (2, 4); ``ring``: MoE with ring attention on (2,
    4); ``dcn``: a ("dcn", "data", "model") mesh of (2, 2, 2)): their
    refusal reads ``(None, None)`` and ``runs`` holds the loss."""
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
    ring = _cfg(attention="ring", moe_experts=4, max_seq=16,
                dtype=torch.float32)
    dcn = make_mesh(("dcn", "data", "model"), (2, 2, 2), device_type="cpu")
    out["refusals"], out["runs"] = {}, {}
    for case, c, m in (("moe_tp", moe, mesh), ("ring", ring, mesh),
                       ("dcn", tiny, dcn)):
        out["refusals"][case], out["runs"][case] = _first_loss(
            c, m, runs[case])
    out["refusals"].update({
        "heads": _refusal(lambda: make_train_step(
            _cfg(n_heads=6, d_model=96), mesh, "cpu")),
        "seq": _refusal(lambda: _forward_at_seq(mesh, 30)),
        "batch": _refusal(lambda: make_train_step(
            tiny, mesh, "cpu")[2](make_example_batch(tiny, batch=3))),
        "device": _refusal(lambda: make_train_step(tiny, mesh, "meta")),
    })
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
    # gather_params is a collective: every rank calls it
    whole = _leaves_np(gather_params(params, cfg, mesh)) if gather else None
    return {"losses": losses,
            "sums": [float(a.astype(np.float64).sum()) for a in leaves],
            "params": whole if dist.get_rank() == 0 else None}


def _long_context_train(fwd_tree: dict, fwd_tokens: np.ndarray,
                       ring_tree: dict, ring_batch: tuple,
                       ulysses_tree: dict, ulysses_batch: tuple,
                       steps: int, moe_runs: dict) -> dict:
    """The sequence modes in the sharded forward and train step: the
    1-layer fp32 model *fwd_tree* forward on a (1, 8) mesh in ring and
    Ulysses mode (the rank's columns of the logits); *steps* fp32 steps of
    the ring model on (2, 4) and of the Ulysses model on (1, 8) from the
    bridged trees; 5 steps of the bf16 ring model from the port's
    ``init_params(0)``; ``measure_train`` in ring mode; and the
    refusals. MoE in a sequence mode, once refused, runs one step from
    the bridged tree and batch of *moe_runs* (``moe_ring`` on (2, 4),
    ``moe_ulysses`` on (1, 8)): its refusal reads ``(None, None)`` and
    ``moe_runs`` holds the loss."""
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
    }
    out["moe_runs"] = {}
    for mode, m in (("ring", square), ("ulysses", line)):
        cfg = _cfg(moe_experts=4, attention=mode, n_layers=2, max_seq=32,
                   dtype=f32)
        out["refusals"][f"moe_{mode}"], out["moe_runs"][f"moe_{mode}"] = \
            _first_loss(cfg, m, moe_runs[f"moe_{mode}"])
    return out


def long_context(attention_args: tuple, train_args: tuple) -> dict:
    """The whole rank side of ``tests/test_torch_long_context.py`` in one
    spawn: :func:`_long_context_attention` and :func:`_long_context_train`
    on their arguments."""
    return {"attention": _long_context_attention(*attention_args),
            "train": _long_context_train(*train_args)}


# -- rank side of tests/test_torch_expert_parallel.py -------------------------

def _moe_grads(params: dict) -> list:
    """The reduced gradients of every MoE router (``moe.wg``) after a
    step."""
    return [_np(lp["moe"]["wg"].grad) for lp in params["layers"]
            if "moe" in lp]


def _ep_steps(cfg: Any, mesh: Any, case: tuple, steps: int) -> dict:
    """:func:`_steps` from the bridged tree and batch of *case*, with the
    routers' reduced gradients after the first step."""
    from ..workloads.model import gather_params, params_from_numpy
    from ..workloads.train import make_train_step
    tree, tokens, targets = case
    step, init_state, place = make_train_step(cfg, mesh, device="cpu")
    params, opt = init_state(params=params_from_numpy(tree, cfg, "cpu"))
    batch = place(_batch(tokens, targets))
    losses = [float(step(params, opt, batch)[2])]
    wg = _moe_grads(params)
    losses += [float(step(params, opt, batch)[2]) for _ in range(steps - 1)]
    leaves = _leaves_np(params)
    whole = _leaves_np(gather_params(params, cfg, mesh))  # a collective
    return {"losses": losses, "wg_grad": wg,
            "sums": [float(a.astype(np.float64).sum()) for a in leaves],
            "params": whole if dist.get_rank() == 0 else None}


def expert_parallel(ep: tuple, seq: tuple, steps: int) -> dict:
    """Expert parallelism and MoE in the sequence modes, in one spawn.

    *ep* is ``(config fields, case)``: *steps* fp32 steps of that MoE
    model on a (2, 4) mesh with sp on and off from the case's bridged
    tree and batch, then 5 bf16 steps from ``init_params(0)``, and the
    refusal of experts that do not split over "model". *seq* is
    ``(config fields, case)`` of a MoE model with a capacity factor under
    1: *steps* steps with ring attention on (2, 4) and (1, 8) and with
    Ulysses on (1, 8)."""
    from ..workloads.model import make_example_batch
    from ..workloads.train import make_train_step
    f32 = torch.float32
    square, line = _mesh(_DM, (2, 4)), _mesh(_DM, (1, 8))
    out: dict = {"rank": dist.get_rank(), "coords_2x4": _coords(square)}
    fields, case = ep
    out["ep"] = {sp: _ep_steps(_cfg(**fields, dtype=f32,
                                    sequence_parallel=sp), square, case,
                               steps) for sp in (True, False)}
    bf16 = _cfg(**fields)
    step, init_state, place = make_train_step(bf16, square, device="cpu")
    params, opt = init_state(seed=0)
    batch = place(make_example_batch(bf16, batch=4))
    out["ep_bf16"] = [float(step(params, opt, batch)[2]) for _ in range(5)]
    out["refusal"] = _refusal(lambda: make_train_step(
        _cfg(**{**fields, "moe_experts": 6}), square, "cpu"))
    fields, case = seq
    out["seq"] = {}
    for mode, sizes, m in (("ring", (2, 4), square), ("ring", (1, 8), line),
                           ("ulysses", (1, 8), line)):
        out["seq"][(mode, sizes)] = _ep_steps(
            _cfg(**fields, dtype=f32, attention=mode), m, case, steps)
    return out


# -- rank side of tests/test_torch_pipeline.py --------------------------------

def _pipeline(fields: dict, tree: dict, tokens: np.ndarray,
              targets: np.ndarray, steps: int) -> dict:
    """The pipeline on a (4, 2) ("pipe", "data") mesh with 4 microbatches:
    the forward of the bridged fp32 tree on *tokens* (this rank's rows and
    its data index) with the hops it made; *steps* fp32 train steps
    (losses, each leaf's sum on this rank, the gathered tree on rank 0);
    the same steps of the config with ``moe_experts=4`` (the dense stage
    stack, as the reference builds it); 6 bf16 steps from
    ``init_pipeline_params(0)``."""
    from ..workloads import pipeline as pp
    from ..workloads.model import gather_tree, make_example_batch
    f32 = torch.float32
    mesh = _mesh(("pipe", "data"), (4, 2))
    cfg = _cfg(**fields, dtype=f32)
    out: dict = {"coords": (mesh.get_local_rank("pipe"),
                            mesh.get_local_rank("data"))}
    step, init_state, place = pp.make_pipeline_train_step(cfg, mesh, 4,
                                                          "cpu")
    params, opt = init_state(params=pp.pipeline_params_from_numpy(
        tree, cfg, "cpu"))
    batch = place(_batch(tokens, targets))
    fwd = step.forward
    with torch.no_grad():
        out["forward"] = _np(fwd(params, batch["tokens"]))
    out["forward_hops"] = fwd.hops
    out["losses"] = [float(step(params, opt, batch)[2])
                     for _ in range(steps)]
    out["sums"] = [float(a.astype(np.float64).sum())
                   for a in _leaves_np(params)]
    whole = gather_tree(params, pp.pipeline_param_specs(), mesh)
    out["params"] = _leaves_np(whole) if dist.get_rank() == 0 else None
    moe = _cfg(**fields, dtype=f32, moe_experts=4)
    step, init_state, place = pp.make_pipeline_train_step(moe, mesh, 4,
                                                          "cpu")
    params, opt = init_state(params=pp.pipeline_params_from_numpy(
        tree, moe, "cpu"))
    batch = place(_batch(tokens, targets))
    out["moe_losses"] = [float(step(params, opt, batch)[2])
                         for _ in range(steps)]
    bf16 = _cfg(**fields)
    step, init_state, place = pp.make_pipeline_train_step(bf16, mesh, 4,
                                                          "cpu")
    params, opt = init_state(seed=0)
    batch = place(make_example_batch(bf16, batch=8, seq=16))
    out["bf16"] = [float(step(params, opt, batch)[2]) for _ in range(6)]
    return out


def _multislice(blocks: np.ndarray, fields: dict, case: tuple,
                steps: int) -> dict:
    """``make_multislice_mesh(2)``, the two all-reduces on this rank's
    block of *blocks* (block ``dcn * model + m``: JAX's
    ``P(("dcn", "model"))``); ``make_multislice_mesh(2, ranks=range(4))``
    (2, 1, 2), its two all-reduces on ranks 0-3, and the refusal of 3
    ranks; and *steps* fp32 sharded steps on the
    (2, 2, 2) mesh from *case*'s bridged tree and batch (with the placed
    batch's rows)."""
    from ..workloads import multislice as ms
    from ..workloads.model import _batch_axes, param_specs
    from ..workloads.train import named_leaves
    mesh = ms.make_multislice_mesh(2, device_type="cpu")
    from ..workloads.mesh import mesh_shape
    out: dict = {"shape": mesh_shape(mesh)}
    c, m = mesh.get_local_rank("dcn"), mesh.get_local_rank("model")
    x = torch.from_numpy(blocks[c * 2 + m])
    kept = x.clone()
    out["hier"] = _np(ms.hierarchical_allreduce(mesh)(x))
    out["flat"] = _np(ms.flat_allreduce(mesh)(x))
    out["input_kept"] = bool(torch.equal(x, kept))
    out["block"] = c * 2 + m
    part = ms.make_multislice_mesh(2, device_type="cpu", ranks=range(4))
    out["part_shape"] = mesh_shape(part)
    out["part_placed"] = part.get_coordinate() is not None
    if out["part_placed"]:
        c, m = part.get_local_rank("dcn"), part.get_local_rank("model")
        x = torch.from_numpy(blocks[c * 2 + m])
        out["part_hier"] = _np(ms.hierarchical_allreduce(part)(x))
        out["part_flat"] = _np(ms.flat_allreduce(part)(x))
    out["part_uneven"] = _refusal(lambda: ms.make_multislice_mesh(
        2, device_type="cpu", ranks=range(3)))
    cfg = _cfg(**fields, dtype=torch.float32)
    out["batch_axes"] = _batch_axes(mesh)
    out["dcn_in_specs"] = any("dcn" in s for _, s in
                              named_leaves(param_specs(cfg)))
    from ..workloads.model import batch_shard
    out["rows"] = _np(batch_shard(torch.arange(8), mesh))
    out["train"] = _steps(cfg, mesh, case[0], 0, case[1], case[2], steps,
                          True)
    return out


def _restores(store: str, fields: dict, pp_fields: dict,
              dcn_fields: dict) -> dict:
    """The re-sharding restores in *store*: (a) 3 fp32 steps on (2, 4),
    saved, restored onto (4, 2), one more step against the unbroken run's
    fourth (and, on rank 0, onto one device with no mesh), and a narrower
    model's refused restores with and without the mesh; (b) a pipeline
    train state on (4, 2) ("pipe", "data") saved and restored, its
    ``wqkv`` shards; (c) one step on (2, 2, 2) ("dcn", "data", "model"),
    saved, restored onto a (2, 2) mesh of ranks 0-3, the first leaf and a
    step there."""
    import os
    from ..workloads import pipeline as pp
    from ..workloads.checkpoint import TrainCheckpointer
    from ..workloads.model import make_example_batch
    from ..workloads.train import make_train_step, param_leaves
    f32 = torch.float32
    rank = dist.get_rank()
    out: dict = {}
    cfg = _cfg(**fields, dtype=f32)
    batch = make_example_batch(cfg, batch=4, seq=16)
    a, b = _mesh(_DM, (2, 4)), _mesh(_DM, (4, 2))
    ckpt = TrainCheckpointer(os.path.join(store, "ckpt"))
    step, init_state, place = make_train_step(cfg, a, "cpu")
    params, opt = init_state(seed=0)
    data = place(batch)
    for _ in range(3):
        step(params, opt, data)
    ckpt.save(3, params, opt, mesh=a, cfg=cfg)
    out["unbroken"] = float(step(params, opt, data)[2])
    step_b, init_b, place_b = make_train_step(cfg, b, "cpu")
    pb, ob = init_b(seed=1)
    pb, ob, n = ckpt.restore(pb, ob, mesh=b, cfg=cfg)
    out["restored_step"] = n
    out["wqkv_shape"] = tuple(pb["layers"][0]["wqkv"].shape)
    out["resumed"] = float(step_b(pb, ob, place_b(batch))[2])
    if rank == 0:
        step1, init1, place1 = make_train_step(cfg, None, "cpu")
        p1, o1 = init1(seed=2)
        ckpt.restore(p1, o1, cfg=cfg)
        out["one_device"] = float(step1(p1, o1, place1(batch))[2])
    # a narrower model restored onto (2, 4): refused before the cut, with
    # the text a restore without a mesh gives, nothing written
    narrow = _cfg(**{**fields, "d_model": 32}, dtype=f32)
    for where, m in (("mesh", a), ("none", None)):
        _, init_n, _ = make_train_step(narrow, m, "cpu")
        pn, on = init_n(seed=3)
        before = [t.detach().clone() for t in param_leaves(pn)]
        out[f"narrow_{where}"] = _refusal(
            lambda: ckpt.restore(pn, on, mesh=m, cfg=narrow))
        out[f"narrow_{where}_kept"] = not on.state and all(
            torch.equal(x, y) for x, y in zip(param_leaves(pn), before))

    pcfg = _cfg(**pp_fields, dtype=f32)
    pmesh = _mesh(("pipe", "data"), (4, 2))
    _, pinit, _ = pp.make_pipeline_train_step(pcfg, pmesh, 4, "cpu")
    pparams, popt = pinit(seed=0)
    pckpt = TrainCheckpointer(os.path.join(store, "pp-ckpt"))
    pckpt.save(1, pparams, popt, mesh=pmesh)
    p2, o2 = pinit(seed=5)
    p2, _, _ = pckpt.restore(p2, o2, mesh=pmesh)
    out["pipeline_wqkv_equal"] = bool(torch.equal(
        pparams["stages"]["wqkv"], p2["stages"]["wqkv"]))

    dcfg = _cfg(**dcn_fields, dtype=f32)
    big = _mesh(("dcn", "data", "model"), (2, 2, 2))
    step, init_state, place = make_train_step(dcfg, big, "cpu")
    params, opt = init_state(seed=0)
    step(params, opt, place(make_example_batch(dcfg, batch=8, seq=16)))
    mckpt = TrainCheckpointer(os.path.join(store, "ms"))
    mckpt.save(1, params, opt, mesh=big, cfg=dcfg)
    out["dcn_first_leaf"] = _np(param_leaves(params)[0])
    from ..workloads.mesh import make_mesh
    small = make_mesh(_DM, (2, 2), device_type="cpu", ranks=range(4))
    if rank < 4:
        sstep, sinit, splace = make_train_step(dcfg, small, "cpu")
        sp, so = sinit(seed=9)
        sp, so, _ = mckpt.restore(sp, so, mesh=small, cfg=dcfg)
        out["small_first_leaf"] = _np(param_leaves(sp)[0])
        out["small_loss"] = float(sstep(sp, so, splace(
            make_example_batch(dcfg, batch=4, seq=16)))[2])
    dist.barrier()
    return out


def pipeline_and_slices(store: str, pipe: tuple, slices: tuple,
                        restores: tuple) -> dict:
    """The whole rank side of ``tests/test_torch_pipeline.py`` in one
    spawn: :func:`_pipeline`, :func:`_multislice` and :func:`_restores` on
    their arguments (*store* is the spawn's directory)."""
    return {"rank": dist.get_rank(), "pipeline": _pipeline(*pipe),
            "multislice": _multislice(*slices),
            "restores": _restores(store, *restores)}
