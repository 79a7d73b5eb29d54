"""Multi-slice collectives: a fast axis inside a slice, "dcn" across
slices.

Port of ``dpu_operator_tpu/workloads/multislice.py``
(``make_multislice_mesh``, ``hierarchical_allreduce``, ``flat_allreduce``,
``dcn_bytes_per_host``) over the port's ``DeviceMesh`` (``mesh.py``).
Slices are joined over the datacenter network, an order of magnitude
slower a host than the links inside a slice, so cross-slice traffic is
kept small: the hierarchical all-reduce reduce-scatters inside the slice,
all-reduces the 1 / n shard across slices, and all-gathers inside the
slice, moving 1 / n of the payload across slices instead of all of it.

As ``collectives.py``'s functions, each returns a callable on the rank's
local shard (what the reference's function sees under ``shard_map``),
which leaves its input as it was and returns a new tensor. The rank
order is slice-major: on a ("dcn", "data", "model") mesh the ranks of
one slice are consecutive.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import _world, axes_group, axis_size, make_mesh
from .model import _gather, _scatter


def make_multislice_mesh(n_slices: int,
                         axis_names: Sequence[str] = ("dcn", "data",
                                                      "model"),
                         device_type: str = "cuda",
                         ranks: Optional[Sequence[int]] = None
                         ) -> DeviceMesh:
    """A mesh over every rank of the default process group, or over
    *ranks* of it (JAX ``make_multislice_mesh(devices=...)``), whose
    leading axis spans slices and whose trailing axes stay inside one
    slice: the ranks of a slice are factored as the reference factors its
    devices (near-equal extents, the last axis taking the rest). As
    ``mesh.make_mesh(ranks=)``, every rank of the group calls it, and a
    rank outside *ranks* gets the mesh without a place on it
    (``mesh.get_coordinate()`` is None). Ranks that do not split into
    *n_slices* raise ``ValueError``."""
    n = _world(device_type) if ranks is None else len(ranks)
    if n % n_slices:
        raise ValueError(
            f"{n} devices do not split into {n_slices} slices")
    rem = n // n_slices
    shape = [n_slices]
    inner = len(axis_names) - 1
    for i in range(inner - 1):
        f = 1
        target = round(rem ** (1 / (inner - i)))
        for cand in range(target, 0, -1):
            if rem % cand == 0:
                f = cand
                break
        shape.append(f)
        rem //= f
    shape.append(rem)
    return make_mesh(axis_names, tuple(shape), device_type=device_type,
                     ranks=ranks)


def hierarchical_allreduce(mesh: DeviceMesh, ici_axis: str = "model",
                           dcn_axis: str = "dcn"
                           ) -> Callable[..., torch.Tensor]:
    """x -> the sum of x over *ici_axis* and *dcn_axis* by the schedule
    that keeps the cross-slice leg small: reduce-scatter over *ici_axis*,
    all-reduce the shard over *dcn_axis*, all-gather over *ici_axis*. The
    cross-slice bytes a host drop by the size of *ici_axis* against
    :func:`flat_allreduce`. The shard's first dim must split over
    *ici_axis*."""
    ici, n_ici = mesh.get_group(ici_axis), axis_size(mesh, ici_axis)
    dcn = mesh.get_group(dcn_axis)

    def _ar(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % n_ici:
            raise ValueError(f"hierarchical_allreduce: dim 0 of "
                             f"{tuple(x.shape)} does not split over "
                             f"{n_ici} ranks")
        shard = _scatter(x, ici, n_ici, 0)        # inside the slice
        dist.all_reduce(shard, group=dcn)          # across slices, 1 / n
        return _gather(shard, ici, n_ici, 0)       # inside the slice

    return _ar


def flat_allreduce(mesh: DeviceMesh, ici_axis: str = "model",
                   dcn_axis: str = "dcn") -> Callable[..., torch.Tensor]:
    """The comparison point: one all-reduce over the group of both axes
    (``mesh.axes_group``), whose whole payload crosses slices."""
    group = axes_group(mesh, (dcn_axis, ici_axis))[0]

    def _ar(x: torch.Tensor) -> torch.Tensor:
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    return _ar


def dcn_bytes_per_host(payload_bytes: int, n_ici: int, n_slices: int,
                       hierarchical: bool = True) -> float:
    """Model of the cross-slice traffic a host of the two schedules (the
    reference's formula: a ring over the slices moves 2 (n - 1) / n of the
    payload, and the hierarchical schedule 1 / n_ici of that)."""
    if n_slices <= 1:
        return 0.0
    ring_factor = 2 * (n_slices - 1) / n_slices
    full = payload_bytes * ring_factor
    return full / n_ici if hierarchical else full
