"""The port's mesh, collectives and bootstrap against the JAX package.

Twins of ``tests/test_workloads.py`` (mesh factoring, ``mesh_for_topology``,
the collectives and their measurements) and ``tests/test_bootstrap.py``.
The JAX tests run on 8 virtual CPU devices in one process; the port's
ranks are processes, so the twins run in 8 spawned ranks of a gloo group
(``dpu_operator_tpu_torch.testing.spmd``), one spawn for the whole file,
and compare each rank's local shard with the JAX function's global result
here. The harness's own failure paths (a rank that raises, a deadline that
passes) take two small spawns more.
"""

import multiprocessing
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dpu_operator_tpu.ici import SliceTopology
from dpu_operator_tpu.ici import topology as jax_topology
from dpu_operator_tpu.workloads import bootstrap as jax_bootstrap
from dpu_operator_tpu.workloads import make_mesh as jax_make_mesh
from dpu_operator_tpu.workloads import mesh as jax_mesh
from dpu_operator_tpu.workloads import ring_allreduce as jax_ring_allreduce
from dpu_operator_tpu_torch.testing import spmd
from dpu_operator_tpu_torch.workloads import collectives, mesh
from dpu_operator_tpu_torch.workloads.bootstrap import (
    distributed_env, initialize_from_operator_env)

WORLD = 8


# -- in process: factoring and slice shapes ---------------------------------

@pytest.mark.parametrize("k", [2, 3])
def test_balanced_factor_equals_jax(k):
    for n in range(1, 65):
        assert mesh._balanced_factor(n, k) == jax_mesh._balanced_factor(n, k)


@pytest.mark.parametrize("gen", sorted(jax_topology.PORTS_PER_CHIP))
def test_slice_shape_equals_jax(gen):
    assert mesh.PORTS_PER_CHIP == jax_topology.PORTS_PER_CHIP
    for chips in (4, 8, 16, 32, 64, 128, 256):
        name = f"{gen}-{chips}"
        assert mesh.slice_shape(name) == jax_topology.slice_shape(name)
        assert mesh.parse_topology(name) == jax_topology.parse_topology(name)


def test_parse_topology_refuses_what_jax_refuses():
    for bad in ("v5e", "v7-8", "tpu-16", "v5e-x"):
        with pytest.raises(ValueError, match="invalid topology"):
            mesh.parse_topology(bad)
        with pytest.raises(ValueError, match="invalid topology"):
            jax_topology.parse_topology(bad)


def test_make_mesh_asks_for_cuda_by_default():
    """Every entry point defaults to the card and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        mesh.mesh_for_topology("v5e-8")
    assert not dist.is_initialized()


def test_one_rank_mesh_without_a_process_group():
    """A lone pod: without a process group ``make_mesh`` forms a one-rank
    group (gloo on the CPU; NCCL on the card, ``chip_smoke.py`` phase 13).
    On one rank every collective returns its input, and the measurements
    cross no link."""
    assert not dist.is_initialized()
    try:
        m = mesh.make_mesh(("data", "model"), device_type="cpu")
        assert dist.get_world_size() == 1
        assert mesh.mesh_shape(m) == {"data": 1, "model": 1}
        x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
        for make in (collectives.psum_allreduce, collectives.ring_allreduce,
                     collectives.ppermute_hop):
            assert torch.equal(make(m, "model")(x), x)
        blocks = x.reshape(1, -1)
        assert torch.equal(
            collectives.all_to_all_exchange(m, "model")(blocks), blocks)
        for fn in (collectives.measure_all_to_all_gbps,
                   collectives.measure_ppermute_gbps,
                   collectives.measure_allreduce_gbps):
            r = fn(m, "model", mbytes=0.25, iters=2)
            assert r["axis_size"] == 1 and r["sec_per_iter"] > 0
            assert r["busbw_gbps"] == r["algbw_gbps"] > 0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# -- in process: bootstrap (twins of tests/test_bootstrap.py) ----------------

def test_distributed_env_single_host_is_none():
    assert distributed_env({}) is None
    assert distributed_env({"TPU_WORKER_COUNT": "1"}) is None
    assert jax_bootstrap.distributed_env({}) is None


def test_distributed_env_multi_host():
    env = {"TPU_WORKER_COUNT": "4", "TPU_WORKER_ID": "2",
           "TPU_COORDINATOR_ADDRESS": "10.0.0.1:8476"}
    assert distributed_env(env) == {
        "init_method": "tcp://10.0.0.1:8476", "world_size": 4, "rank": 2}
    # the same facts as the JAX kwargs, under torch's names
    j = jax_bootstrap.distributed_env(env)
    assert (j["coordinator_address"], j["num_processes"], j["process_id"]) \
        == ("10.0.0.1:8476", 4, 2)


def test_distributed_env_missing_coordinator_is_loud():
    with pytest.raises(RuntimeError, match="TPU_COORDINATOR_ADDRESS"):
        distributed_env({"TPU_WORKER_COUNT": "2"})


def test_initialize_called_with_env_args():
    calls = []
    env = {"TPU_WORKER_COUNT": "2", "TPU_WORKER_ID": "1",
           "TPU_COORDINATOR_ADDRESS": "coord:8476"}
    out = initialize_from_operator_env(
        env, initialize=lambda **kw: calls.append(kw), backend="gloo")
    assert calls == [out] == [{"backend": "gloo",
                               "init_method": "tcp://coord:8476",
                               "world_size": 2, "rank": 1}]
    # single-host never calls initialize (it would wait on a coordinator
    # that does not exist)
    assert initialize_from_operator_env(
        {}, initialize=lambda **kw: calls.append(kw)) is None
    assert len(calls) == 1


def test_initialize_backend_follows_the_card_and_never_switches():
    """NCCL with a card, gloo without; a failing initialize raises and no
    other backend is tried."""
    env = {"TPU_WORKER_COUNT": "2", "TPU_COORDINATOR_ADDRESS": "c:1"}
    calls = []

    def failing(**kw):
        calls.append(kw["backend"])
        raise RuntimeError("no peer")

    with pytest.raises(RuntimeError, match="no peer"):
        initialize_from_operator_env(env, initialize=failing)
    assert calls == ["nccl" if torch.cuda.is_available() else "gloo"]


# -- gloo at world 8 (twins of tests/test_workloads.py) ---------------------

RING_X = np.random.default_rng(0).standard_normal(64).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    topo = SliceTopology("v5p-8")
    return spmd.spawn(spmd.mesh_checks, WORLD,
                      str(tmp_path_factory.mktemp("mesh")),
                      args=(RING_X, tuple(topo.shape), topo.num_chips))


def test_make_mesh_factors_devices(ranks):
    """The balanced (2, 4) mesh, laid out row-major: rank r at (r // 4,
    r % 4), as ``np.array(devices).reshape`` lays out JAX's devices."""
    jm = jax_make_mesh(("data", "model"))
    for r in ranks:
        assert r["default"] == dict(jm.shape) == {"data": 2, "model": 4}
        assert r["default_coords"] == divmod(r["rank"], 4)
        assert r["bad_sizes"] == ("ValueError",
                                  "axis sizes (3, 3) do not cover 8 devices")


def test_mesh_for_topology_matches_slice_shape(ranks):
    assert all(r["v5e-8"] == {"data": 2, "model": 4} for r in ranks)


def test_mesh_for_topology_folds_3d_into_2_axes(ranks):
    """A topology object (the JAX package's ``SliceTopology("v5p-8")``,
    (2, 2, 2), passed by its shape and chip count)."""
    assert all(r["duck"] == {"data": 4, "model": 2} for r in ranks)


def test_mesh_for_topology_degrades_when_fewer_devices(ranks):
    for r in ranks:
        assert r["v5e-256"]["data"] * r["v5e-256"]["model"] == WORLD


def test_psum_allreduce_sums_across_axis(ranks):
    expected = np.arange(16, dtype=np.float32).reshape(4, 4).sum(0)
    for r in ranks:
        np.testing.assert_allclose(r["psum"], expected)


def test_ring_allreduce_matches_psum_and_jax(ranks):
    """The same global x from ``np.random.default_rng(0)`` through the
    port's ring on each rank's shard and through JAX's ring_allreduce
    on the (2, 4) mesh."""
    jm = jax_make_mesh(("data", "model"), axis_sizes=(2, 4))
    want = np.asarray(jax_ring_allreduce(jm, "model")(jnp.asarray(RING_X)))
    for r in ranks:
        _, m = r["coords_2x4"]
        np.testing.assert_allclose(r["ring"], r["ring_psum"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r["ring"], want[16 * m:16 * (m + 1)],
                                   rtol=1e-5, atol=1e-6)
        assert r["ring_input_kept"]


@pytest.mark.parametrize("impl", ["psum", "ring"])
def test_measure_allreduce_reports_bandwidth(ranks, impl):
    for r in ranks:
        m = r["measure"][impl]
        assert m["impl"] == impl and m["axis_size"] == 8
        assert m["algbw_gbps"] > 0 and m["sec_per_iter"] > 0
        # n = 8: busbw = 7/4 algbw
        assert m["busbw_gbps"] == pytest.approx(m["algbw_gbps"] * 7 / 4)
        assert m["bytes"] == 8 * (int(1e6 / 4 / 8) // 8 * 8) * 4


def test_all_to_all_exchange_is_block_transpose(ranks):
    n, chunk = 8, 4
    x = np.arange(n * n * chunk, dtype=np.float32).reshape(n * n, chunk)
    expect = x.reshape(n, n, chunk).transpose(1, 0, 2).reshape(n * n, chunk)
    got = np.concatenate([r["a2a"] for r in ranks])
    np.testing.assert_array_equal(got, expect)


def test_ppermute_hop_rotates_shards(ranks):
    n, chunk = 8, 3
    x = np.arange(n * chunk, dtype=np.float32)
    expect = np.roll(x.reshape(n, chunk), 1, axis=0).ravel()
    np.testing.assert_array_equal(
        np.concatenate([r["hop"] for r in ranks]), expect)


def test_collective_measurements_report_sane_numbers(ranks):
    for r in ranks:
        a2a, hop = r["measure_more"]
        for m in (a2a, hop):
            assert m["algbw_gbps"] > 0
            assert m["sec_per_iter"] > 0
            assert m["bytes"] > 0
        assert a2a["busbw_gbps"] == pytest.approx(a2a["algbw_gbps"] * 7 / 8)
        assert hop["busbw_gbps"] == hop["algbw_gbps"]


# -- the harness's failure paths ---------------------------------------------

def _live(before):
    return [p for p in multiprocessing.active_children() if p not in before]


def test_a_raising_rank_fails_the_spawn_at_once(tmp_path):
    """Rank 1 raises while rank 0 waits in an all-reduce that cannot
    complete: the spawn raises with rank 1's traceback well inside the
    group's timeout, and no child is left."""
    before = multiprocessing.active_children()
    t0 = time.monotonic()
    with pytest.raises(spmd.SpmdError, match="rank 1 fails on purpose"):
        spmd.spawn(spmd.raise_on_rank, 2, str(tmp_path), args=(1,))
    assert time.monotonic() - t0 < spmd.GROUP_TIMEOUT_S / 2
    assert _live(before) == []


def test_a_hanging_rank_fails_the_spawn_at_its_deadline(tmp_path):
    before = multiprocessing.active_children()
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish within 8 s"):
        spmd.spawn(spmd.sleep_for, 2, str(tmp_path), args=(600.0,),
                   deadline=8.0)
    assert time.monotonic() - t0 < 8.0 + 2 * 30.0
    assert _live(before) == []
