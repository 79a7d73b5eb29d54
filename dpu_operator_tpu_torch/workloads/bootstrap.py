"""Multi-host runtime bootstrap from operator-provided environment.

Port of ``dpu_operator_tpu/workloads/bootstrap.py``. Two parties
contribute, each the facts it owns:

- the OPERATOR's device plugin exports this host's slice position on
  every chip Allocate: TPU_WORKER_ID, TPU_HOSTS_PER_SLICE,
  TPU_SLICE_TOPOLOGY;
- the JOB that spans hosts (one pod per host) sets TPU_WORKER_COUNT and
  TPU_COORDINATOR_ADDRESS (a headless service for its pod 0) in the pod
  spec.

A workload entrypoint calls :func:`initialize_from_operator_env` before it
builds a mesh: with both halves present the process group forms across the
job's hosts; a lone pod (no job env) stays single-host, and
``workloads/mesh.py`` forms its one-rank group. The operator never exports
a process COUNT, because a slice-wide count would tell a 1-pod allocation
to wait for peers that do not exist.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Mapping, Optional

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)


def distributed_env(environ: Optional[Mapping[str, str]] = None) \
        -> Optional[dict]:
    """``torch.distributed.init_process_group`` kwargs from the merged
    operator+job env, or None for a single-host workload (initialize must
    NOT be called then: a one-process "cluster" would wait on a
    coordinator). The keys map from the JAX ``jax.distributed.initialize``
    kwargs: ``coordinator_address`` -> ``init_method``
    (``"tcp://<address>"``), ``num_processes`` -> ``world_size``,
    ``process_id`` -> ``rank``. TPU_WORKER_COUNT comes from the JOB spec;
    the operator-exported TPU_WORKER_ID supplies the rank."""
    environ = os.environ if environ is None else environ
    count = int(environ.get("TPU_WORKER_COUNT", "1") or 1)
    if count <= 1:
        return None
    coordinator = environ.get("TPU_COORDINATOR_ADDRESS", "")
    if not coordinator:
        raise RuntimeError(
            "TPU_WORKER_COUNT > 1 but TPU_COORDINATOR_ADDRESS unset — "
            "both are JOB-owned facts: set them in the job's pod "
            "template (the operator exports only TPU_WORKER_ID, "
            "TPU_HOSTS_PER_SLICE and TPU_SLICE_TOPOLOGY on Allocate)")
    return {
        "init_method": f"tcp://{coordinator}",
        "world_size": count,
        "rank": int(environ.get("TPU_WORKER_ID", "0") or 0),
    }


def initialize_from_operator_env(
        environ: Optional[Mapping[str, str]] = None,
        initialize: Optional[Callable[..., object]] = None,
        backend: Optional[str] = None) -> Optional[dict]:
    """Bring up the multi-host process group when the env says so; returns
    the kwargs used, *backend* among them (None = single-host, nothing to
    do). *initialize* is injectable for tests and defaults to
    ``torch.distributed.init_process_group``. *backend* defaults to NCCL
    when CUDA is present, else gloo; a failed initialize raises, and no
    other backend is tried."""
    kwargs = distributed_env(environ)
    if kwargs is None:
        log.info("single-host allocation; skipping distributed init")
        return None
    if initialize is None:
        initialize = dist.init_process_group
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {"backend": backend, **kwargs}
    log.info("initializing multi-host runtime: rank %d/%d via %s (%s)",
             kwargs["rank"], kwargs["world_size"], kwargs["init_method"],
             backend)
    initialize(**kwargs)
    return kwargs
