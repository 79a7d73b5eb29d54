"""Collective workloads: the traffic the wired slice must sustain.

Port of ``dpu_operator_tpu/workloads/collectives.py``. Each function takes
a mesh (``workloads/mesh.py``) and an axis name and returns a callable on
the rank's local shard, as the JAX function under ``shard_map`` sees it,
over the axis's process group (``mesh.get_group(axis)``). Every callable
leaves its input as it was and returns a new tensor, as the jitted JAX
functions do.

- :func:`psum_allreduce`: ``torch.distributed.all_reduce``, the
  production path.
- :func:`ring_allreduce`: reduce-scatter then all-gather around the ring,
  2(n-1) single-hop steps of ``batch_isend_irecv`` to rank (r+1) % n of
  the axis: each hop crosses one link of the dimension the axis is laid
  on, so measuring it is measuring the wiring. The chunk schedule is the
  reference's.
- :func:`all_to_all_exchange` and :func:`ppermute_hop`: the MoE dispatch
  collective and the unit hop of ring attention and pipelines.

The ``measure_*`` functions keep the reference's payload sizing, chained
timing (each call's output is the next call's input) and algbw / busbw
formulas; they time on the host clock, after ``torch.cuda.synchronize``
on the card. On a one-rank axis no link is crossed: the ring and the hop
return a copy of their input, and the times measure the local copies.
"""

from __future__ import annotations

import time
from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import axis_size, mesh_device


def _group(mesh: DeviceMesh, axis: str) -> tuple:
    """``(group, this rank's index on the axis, the axis's global
    ranks)``."""
    group = mesh.get_group(axis)
    return group, mesh.get_local_rank(axis), \
        dist.get_process_group_ranks(group)


def psum_allreduce(mesh: DeviceMesh,
                   axis: str = "model") -> Callable[..., torch.Tensor]:
    """x -> allreduce(x) over *axis* via the native collective."""
    group = mesh.get_group(axis)

    def _ar(x: torch.Tensor) -> torch.Tensor:
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    return _ar


def _hop(send: torch.Tensor, recv: torch.Tensor, group: dist.ProcessGroup,
         to: int, frm: int) -> None:
    """Send *send* to global rank *to* while receiving *recv* from *frm*."""
    ops = [dist.P2POp(dist.isend, send, to, group),
           dist.P2POp(dist.irecv, recv, frm, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()


def ring_allreduce(mesh: DeviceMesh,
                   axis: str = "model") -> Callable[..., torch.Tensor]:
    """Allreduce built from 2*(n-1) single-hop steps.

    Reduce-scatter then all-gather around the ring — the bandwidth-optimal
    schedule on a torus dimension, moving 2*(n-1)/n of the data per link.
    The local shard's size must be a multiple of n.
    """
    group, me, ranks = _group(mesh, axis)
    n = len(ranks)
    to, frm = ranks[(me + 1) % n], ranks[(me - 1) % n]

    def _ar(x: torch.Tensor) -> torch.Tensor:
        if n == 1:
            return x.clone()
        if x.numel() % n:
            raise ValueError(f"ring_allreduce: {x.numel()} elements do not "
                             f"split into {n} chunks")
        chunks = x.reshape(n, -1).clone()
        moved = torch.empty_like(chunks[0])
        # reduce-scatter: at step i rank r sends chunk (r-i)%n one hop
        # forward; the receiver accumulates it. After n-1 steps rank r
        # holds the fully-reduced chunk (r+1)%n.
        for i in range(n - 1):
            _hop(chunks[(me - i) % n], moved, group, to, frm)
            chunks[(me - 1 - i) % n] += moved
        # all-gather: rotate completed chunks around the ring
        for i in range(n - 1):
            _hop(chunks[(me + 1 - i) % n], chunks[(me - i) % n], group,
                 to, frm)
        return chunks.reshape(x.shape)

    return _ar


def all_to_all_exchange(mesh: DeviceMesh,
                        axis: str = "model") -> Callable[..., torch.Tensor]:
    """All-to-all over *axis*: device i's j-th chunk lands on device j as
    chunk i. The local shard is (n, chunk): one outgoing chunk per peer."""
    group = mesh.get_group(axis)

    def _a2a(x: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    return _a2a


def ppermute_hop(mesh: DeviceMesh,
                 axis: str = "model") -> Callable[..., torch.Tensor]:
    """One neighbor rotation over *axis*: rank r's shard goes to rank
    (r+1) % n. The unit hop of both the ring attention KV rotation and the
    pipeline stage handoff; its rate is the single-link bandwidth."""
    group, me, ranks = _group(mesh, axis)
    n = len(ranks)

    def _rot(x: torch.Tensor) -> torch.Tensor:
        if n == 1:
            return x.clone()
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        _hop(x.contiguous(), out, group, ranks[(me + 1) % n],
             ranks[(me - 1) % n])
        return out

    return _rot


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def _time_collective(fn: Callable[..., torch.Tensor], x: torch.Tensor,
                     iters: int) -> float:
    _sync(fn(x))  # warm: the first call sets up the communicator
    t0 = time.perf_counter()
    out = x
    for _ in range(iters):
        out = fn(out)
    _sync(out)
    return (time.perf_counter() - t0) / iters


def _ones(mesh: DeviceMesh, shape: tuple) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.float32, device=mesh_device(mesh))


def measure_all_to_all_gbps(mesh: DeviceMesh, axis: str = "model",
                            mbytes: float = 64.0, iters: int = 10) -> dict:
    """All-to-all bandwidth: each device sends (n-1)/n of its shard.
    ``bytes`` is the global payload (every rank's shard), as in the
    reference."""
    n = axis_size(mesh, axis)
    per_shard = max(n, int(mbytes * 1e6 / 4 / n) // n * n)
    x = _ones(mesh, (n, per_shard // n))
    dt = _time_collective(all_to_all_exchange(mesh, axis), x, iters)
    payload = n * x.numel() * 4
    algbw = payload / dt / 1e9
    return {"impl": "all_to_all", "axis_size": n, "bytes": payload,
            "sec_per_iter": dt, "algbw_gbps": algbw,
            "busbw_gbps": algbw * (n - 1) / n if n > 1 else algbw}


def measure_ppermute_gbps(mesh: DeviceMesh, axis: str = "model",
                          mbytes: float = 64.0, iters: int = 10) -> dict:
    """Single-hop neighbor-rotation bandwidth (ring/pipeline unit hop):
    every byte crosses exactly one link, so algbw IS the link rate."""
    n = axis_size(mesh, axis)
    per_shard = max(1, int(mbytes * 1e6 / 4 / n))
    x = _ones(mesh, (per_shard,))
    dt = _time_collective(ppermute_hop(mesh, axis), x, iters)
    payload = n * per_shard * 4
    algbw = payload / dt / 1e9
    return {"impl": "ppermute_hop", "axis_size": n, "bytes": payload,
            "sec_per_iter": dt, "algbw_gbps": algbw, "busbw_gbps": algbw}


def measure_allreduce_gbps(mesh: DeviceMesh, axis: str = "model",
                           mbytes: float = 64.0, iters: int = 10,
                           impl: str = "psum") -> dict:
    """Time allreduce and report algorithmic bandwidth.

    algbw = payload / time; busbw = algbw * 2*(n-1)/n — the per-link
    rate. Chained timing: the data dependency defeats overlap between
    calls; values grow as n^iters, which fp32 holds for realistic counts.
    """
    n = axis_size(mesh, axis)
    per_shard = int(mbytes * 1e6 / 4 / n)
    per_shard = max(n, per_shard - per_shard % n)  # ring needs n | size
    x = _ones(mesh, (per_shard,))
    fn = (ring_allreduce if impl == "ring" else psum_allreduce)(mesh, axis)
    dt = _time_collective(fn, x, iters)
    payload = n * per_shard * 4
    algbw = payload / dt / 1e9
    busbw = algbw * 2 * (n - 1) / n if n > 1 else algbw
    return {"impl": impl, "axis_size": n, "bytes": payload,
            "sec_per_iter": dt, "algbw_gbps": algbw, "busbw_gbps": busbw}
