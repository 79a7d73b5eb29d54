"""Device meshes laid out like the programmed slice topology.

Port of ``dpu_operator_tpu/workloads/mesh.py`` (``_balanced_factor``,
``make_mesh``, ``mesh_for_topology``) over a
``torch.distributed.device_mesh.DeviceMesh``. A JAX mesh is an array of
devices; here it is an array of the ranks of the default process group,
laid out row-major as ``np.array(devices).reshape(axis_sizes)`` lays out
JAX's devices: on a ("data", "model") mesh rank r sits at (r // model,
r % model), so the ranks of one "model" group are consecutive.

The port keeps its own copy of the slice shapes of
``dpu_operator_tpu/ici/topology.py`` (``parse_topology``, ``_factor_2d``,
``_factor_3d``, ``slice_shape``, ``PORTS_PER_CHIP``): the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import math
import re
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import resolve_device

_TOPOLOGY_RE = re.compile(r"^(v[2-6][ep]?)-(\d+)$")

#: ICI links per chip by generation (4: a 2D torus, 6: a 3D torus)
PORTS_PER_CHIP = {"v2": 4, "v3": 4, "v4": 6, "v5e": 4, "v5p": 6, "v6e": 4}


def parse_topology(topology: str) -> tuple:
    """``"v5e-16"`` -> ``("v5e", 16)``; anything else raises."""
    m = _TOPOLOGY_RE.match(topology)
    if not m:
        raise ValueError(f"invalid topology {topology!r}")
    return m.group(1), int(m.group(2))


def _factor_2d(n: int) -> tuple:
    """Most-square 2D factorization (2x2, 2x4, 4x4, 4x8, ...)."""
    best = (1, n)
    for a in range(1, int(math.isqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best


def _factor_3d(n: int) -> tuple:
    """Most-cubic 3D factorization for 3D tori."""
    best = (1, 1, n)
    best_score = n * 3
    for a in range(1, int(round(n ** (1 / 3))) + 2):
        if n % a:
            continue
        for b in range(a, int(math.isqrt(n // a)) + 1):
            if (n // a) % b:
                continue
            c = n // a // b
            score = a + b + c
            if score < best_score:
                best_score = score
                best = (a, b, c)
    return best


def slice_shape(topology: str) -> tuple:
    """Grid shape for a slice, e.g. v5e-16 -> (4, 4); v5p-32 -> (2, 4, 4)."""
    gen, chips = parse_topology(topology)
    if PORTS_PER_CHIP[gen] == 4:
        return _factor_2d(chips)
    return _factor_3d(chips)


def _balanced_factor(n: int, k: int) -> tuple:
    """Factor n into k near-equal factors, largest last (so the fastest-
    varying mesh axis — typically model — gets the bigger extent)."""
    dims = [1] * k
    rem = n
    for i in range(k - 1):
        target = round(rem ** (1 / (k - i)))
        f = 1
        for cand in range(target, 0, -1):
            if rem % cand == 0:
                f = cand
                break
        dims[i] = f
        rem //= f
    dims[k - 1] = rem
    return tuple(sorted(dims))


def _world(device_type: str) -> int:
    """The default process group's size; without one, a one-rank group
    formed here over an in-process store (NCCL on "cuda", gloo on
    "cpu")."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {device_type!r}")
    resolve_device(device_type)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    return dist.get_world_size()


def _mesh(device_type: str, shape: tuple, axis_names: Sequence[str]
          ) -> DeviceMesh:
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def make_mesh(axis_names: Sequence[str] = ("data", "model"),
              axis_sizes: Optional[Sequence[int]] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh over the ranks of the default process group.

    Without explicit *axis_sizes* the world is factored into near-equal
    axis extents with "model" (the last axis) largest, since
    tensor-parallel collectives are the most latency-sensitive and belong
    on the shortest hops. Sizes that do not cover the world raise
    ``ValueError``.

    Without a process group this forms a one-rank group (NCCL on "cuda",
    gloo on "cpu") over an in-process store: how a lone pod runs the
    sharded step, the counterpart of JAX's single-process mesh. The
    caller ends it with ``torch.distributed.destroy_process_group()``.
    Asking for "cuda" without a card raises.
    """
    n = _world(device_type)
    if axis_sizes is None:
        axis_sizes = _balanced_factor(n, len(axis_names))
    if math.prod(axis_sizes) != n:
        raise ValueError(
            f"axis sizes {tuple(axis_sizes)} do not cover {n} devices")
    return _mesh(device_type, tuple(axis_sizes), axis_names)


def mesh_for_topology(topology: object,
                      axis_names: Sequence[str] = ("data", "model"),
                      device_type: str = "cuda") -> DeviceMesh:
    """Mesh whose axis extents follow the physical slice shape.

    *topology* is a topology string (``"v5e-16"``) or any object with
    ``.shape`` and ``.num_chips`` (the JAX package's ``SliceTopology``).
    For a v5e-16 (4x4) with axes (data, model) this yields a 4x4 mesh
    whose "model" axis walks the x torus dimension. Extra physical dims
    are folded into the first (data) axis, matching how dp tolerates
    longer hop counts. A world smaller than the slice falls back to
    :func:`make_mesh`'s balanced mesh.
    """
    if isinstance(topology, str):
        shape = slice_shape(topology)
        chips = math.prod(shape)
    else:
        shape, chips = tuple(topology.shape), topology.num_chips
    n = _world(device_type)
    if n != chips:
        return make_mesh(axis_names, device_type=device_type)
    k = len(axis_names)
    if len(shape) >= k:
        folded = (math.prod(shape[: len(shape) - k + 1]),) + \
            tuple(shape[len(shape) - k + 1:])
    else:
        folded = (1,) * (k - len(shape)) + tuple(shape)
    return _mesh(device_type, folded, axis_names)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The extent of *axis* (JAX ``mesh.shape[axis]``)."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def mesh_shape(mesh: DeviceMesh) -> dict:
    """``{axis: extent}`` (JAX ``dict(mesh.shape)``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shards live on: its current card for a
    "cuda" mesh, the CPU for a "cpu" one."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
