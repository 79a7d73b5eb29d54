"""The port's dp/tp/sp-sharded train step against the JAX package.

The JAX step (``make_train_step(cfg, mesh)``) runs here on the 8 virtual
CPU devices; the port's runs in 8 spawned ranks of a gloo group
(``dpu_operator_tpu_torch.testing.spmd``), two spawns for the file. Both
start from the same JAX ``init_params`` tree, bridged through numpy
(``params_from_numpy``, then ``shard_params``), and take the same batch.

Tolerances, as ``tests/test_torch_train.py``'s three-step AdamW test
states them: losses within 1e-4 relative; parameters (the port's gathered
back into the JAX layout by ``gather_params``) within 3 x lr, because
Adam's first step moves a weight by about +-lr, so a near-zero gradient
may differ in sign. The sharded forward is held to the unsharded forward
and to JAX's sharded forward within 2e-4 (test_workloads.py's bound).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax  # noqa: F401  (the JAX step's optimizer)
import pytest
import torch
import torch.distributed as dist

from dpu_operator_tpu.workloads import make_mesh as jax_make_mesh
from dpu_operator_tpu.workloads import model as jax_model
from dpu_operator_tpu_torch.testing import spmd
from dpu_operator_tpu_torch.workloads import model
from dpu_operator_tpu_torch.workloads.bootstrap import \
    initialize_from_operator_env
from dpu_operator_tpu_torch.workloads.mesh import make_mesh
from dpu_operator_tpu_torch.workloads.train import (make_train_step,
                                                    param_leaves)

WORLD = 8
STEPS = 3
#: (axis sizes, sequence_parallel) of the parity runs
CASES = [((2, 4), True), ((2, 4), False), ((1, 8), True)]
CFG = model.TransformerConfig(n_layers=2, max_seq=32, dtype=torch.float32)
JAX_CFG = jax_model.TransformerConfig(n_layers=2, max_seq=32,
                                      dtype=jnp.float32)
FWD_CFG = model.TransformerConfig(n_layers=1, max_seq=16,
                                  dtype=torch.float32)
JAX_FWD_CFG = jax_model.TransformerConfig(n_layers=1, max_seq=16,
                                          dtype=jnp.float32)
LR_TOL = 3 * CFG.learning_rate


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_leaves(tree):
    """JAX tree leaves in the port's ``param_leaves`` order."""
    out = [tree["embed"], tree["pos"], tree["out_norm"]]
    for lp in tree["layers"]:
        out += [lp[n] for n in ("ln1", "wqkv", "wo", "ln2", "w1", "w2")]
    return [np.asarray(a, np.float32) for a in out]


@pytest.fixture(scope="module")
def inputs():
    tree = _np_tree(jax_model.init_params(jax.random.key(0), JAX_CFG))
    batch = jax_model.make_example_batch(JAX_CFG, batch=4, seq=32)
    fwd_tree = _np_tree(jax_model.init_params(jax.random.key(1),
                                              JAX_FWD_CFG))
    fwd_tokens = np.asarray(jax_model.make_example_batch(
        JAX_FWD_CFG, batch=2, seq=16)["tokens"])
    return {"tree": tree, "tokens": np.asarray(batch["tokens"]),
            "targets": np.asarray(batch["targets"]),
            "fwd_tree": fwd_tree, "fwd_tokens": fwd_tokens}


@pytest.fixture(scope="module")
def parity(inputs, tmp_path_factory):
    return spmd.spawn(
        spmd.train_parity, WORLD, str(tmp_path_factory.mktemp("parity")),
        args=(inputs["tree"], inputs["tokens"], inputs["targets"], CASES,
              STEPS, inputs["fwd_tree"], inputs["fwd_tokens"]))


#: the refusal cases whose mode the port now runs (expert parallelism on
#: (2, 4), MoE with ring attention on (2, 4), a (2, 2, 2) multi-slice
#: mesh), with the JAX config of the one step ``train_behaviour`` takes
NOW_RUN = {
    "moe_tp": jax_model.TransformerConfig(moe_experts=4, max_seq=16,
                                          dtype=jnp.float32),
    "ring": jax_model.TransformerConfig(attention="ring", moe_experts=4,
                                        max_seq=16, dtype=jnp.float32),
    "dcn": jax_model.TransformerConfig(n_layers=1, max_seq=16,
                                       dtype=jnp.float32),
}


@pytest.fixture(scope="module")
def now_run():
    """Each NOW_RUN case's bridged tree and batch (4 x 16), and JAX's loss
    of that batch at that tree (the first step's loss)."""
    cases, losses = {}, {}
    for case, cfg in NOW_RUN.items():
        tree = _np_tree(jax_model.init_params(jax.random.key(0), cfg))
        batch = jax_model.make_example_batch(cfg, batch=4, seq=16)
        cases[case] = (tree, np.asarray(batch["tokens"]),
                       np.asarray(batch["targets"]))
        losses[case] = float(jax.jit(jax_model.loss_fn, static_argnums=2)(
            tree, batch, cfg))
    return cases, losses


@pytest.fixture(scope="module")
def behaviour(now_run, tmp_path_factory):
    return spmd.spawn(spmd.train_behaviour, WORLD,
                      str(tmp_path_factory.mktemp("behaviour")),
                      args=(now_run[0],))


def _jax_run(sizes, sp):
    """JAX ``make_train_step(cfg, mesh)``: STEPS steps from
    ``init_params(key(0))``; the losses and the parameters."""
    cfg = dataclasses.replace(JAX_CFG, sequence_parallel=sp)
    mesh = jax_make_mesh(("data", "model"), axis_sizes=sizes)
    step, init_state, place = jax_model.make_train_step(cfg, mesh)
    params, opt = init_state(jax.random.key(0))
    batch = place(jax_model.make_example_batch(cfg, batch=4, seq=32))
    losses = []
    for _ in range(STEPS):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    return losses, _jax_leaves(params)


def _one_device_run(inputs):
    """The port's one-device step on the same tree and batch."""
    step, init_state, _ = make_train_step(CFG, device="cpu")
    params, opt = init_state(params=model.params_from_numpy(
        inputs["tree"], CFG, device="cpu"))
    batch = {"tokens": torch.from_numpy(inputs["tokens"].astype(np.int64)),
             "targets": torch.from_numpy(inputs["targets"].astype(np.int64))}
    losses = []
    for _ in range(STEPS):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    return losses, [t.detach().numpy() for t in param_leaves(params)]


def _hold(losses, leaves, want_losses, want_leaves):
    for got, want in zip(losses, want_losses):
        assert abs(got - want) <= 1e-4 * abs(want), (losses, want_losses)
    assert len(leaves) == len(want_leaves) == 3 + 6 * CFG.n_layers
    for i, (got, want) in enumerate(zip(leaves, want_leaves)):
        assert got.shape == want.shape, i
        np.testing.assert_allclose(got, want, rtol=0, atol=LR_TOL,
                                   err_msg=f"leaf {i}")


# -- the sharded step against JAX's, and against the port's one-device step ---

@pytest.mark.parametrize("sizes,sp", CASES)
def test_sharded_step_matches_jax_sharded_step(parity, sizes, sp):
    run = parity[0]["train"][(sizes, sp)]
    _hold(run["losses"], run["params"], *_jax_run(sizes, sp))


@pytest.mark.parametrize("sizes,sp", CASES)
def test_sharded_step_matches_the_one_device_step(parity, inputs, sizes, sp):
    run = parity[0]["train"][(sizes, sp)]
    _hold(run["losses"], run["params"], *_one_device_run(inputs))


@pytest.mark.parametrize("sizes,sp", CASES)
def test_every_rank_holds_the_same_model(parity, sizes, sp):
    """Replicated leaves stay equal on every rank (the norm scales' and
    pos's gradients reduced over "model" under sp, every gradient averaged
    over "data"), and every rank reads the same global loss."""
    want = parity[0]["train"][(sizes, sp)]
    for r in parity[1:]:
        got = r["train"][(sizes, sp)]
        assert got["losses"] == want["losses"]
        assert got["sums"] == want["sums"], r["rank"]


@pytest.mark.parametrize("sp", [True, False])
def test_forward_agrees_with_and_without_mesh(parity, inputs, sp):
    """Twin of test_workloads.py:95: the (2, 4)-sharded forward's logits
    (each data rank's rows, over the whole vocabulary) against the
    unsharded forward and against JAX's sharded forward, fp32, within
    2e-4."""
    rows = {}
    for r in parity:
        d, logits = r["forward"][sp]
        if d in rows:  # every model rank of a data row has the same logits
            np.testing.assert_array_equal(rows[d], logits)
        rows[d] = logits
    got = np.concatenate([rows[d] for d in sorted(rows)])
    params = model.params_from_numpy(inputs["fwd_tree"], FWD_CFG,
                                     device="cpu")
    with torch.no_grad():
        single = model.forward(
            params, torch.from_numpy(inputs["fwd_tokens"].astype(np.int64)),
            FWD_CFG).numpy()
    np.testing.assert_allclose(got, single, atol=2e-4)
    cfg = dataclasses.replace(JAX_FWD_CFG, sequence_parallel=sp)
    mesh = jax_make_mesh(("data", "model"), axis_sizes=(2, 4))
    want = jax.jit(lambda p, t: jax_model.forward(p, t, cfg, mesh))(
        inputs["fwd_tree"], jnp.asarray(inputs["fwd_tokens"]))
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-4)


# -- twins of the rest of tests/test_workloads.py -----------------------------

def test_train_step_runs_and_loss_decreases(behaviour):
    """Twin of test_workloads.py:70: the bf16 default model, (2, 4)."""
    for r in behaviour:
        losses = r["bf16_losses"]
        assert np.isfinite(losses).all()
        assert losses[-1] < losses[0]
        assert losses == behaviour[0]["bf16_losses"]


def test_train_step_params_are_sharded(behaviour):
    """Twin of test_workloads.py:83: wqkv's spec is (None, "model") and a
    rank holds 3D / 4 of its columns, as a JAX device does."""
    cfg = model.TransformerConfig(n_layers=1, max_seq=16)
    d = cfg.d_model
    for r in behaviour:
        assert r["wqkv_spec"] == (None, "model")
        assert r["shapes"] == {"wqkv": (d, 3 * d // 4), "wo": (d // 4, d),
                               "w1": (d, cfg.d_ff // 4),
                               "w2": (cfg.d_ff // 4, d),
                               "embed": (cfg.vocab // 4, d)}


def test_remat_train_step_matches_no_remat(behaviour):
    """Twin of test_workloads.py:109: the sharded step with remat replays
    each layer's collectives in the backward; loss within 1e-5 and the
    reduced gradients within 1e-6."""
    for r in behaviour:
        plain, remat = r["remat_loss"]
        assert abs(plain - remat) < 1e-5
        assert r["remat_grad_err"] <= 1e-6


def test_moe_on_a_data_axis_matches_one_device(behaviour):
    """MoE runs on a "model" axis of 1: on an (8, 1) mesh the router's
    statistics are averaged over "data", so the loss (aux term included)
    and every gradient equal the one-device step's."""
    for r in behaviour:
        moe = r["moe"]
        assert abs(moe["loss"] - moe["one_device_loss"]) <= 1e-5
        assert moe["grad_err"] <= 1e-5


def test_measure_train_times_the_sharded_step(behaviour):
    perf = behaviour[0]["perf"]
    assert perf["world"] == WORLD and perf["device"] == "cpu"
    assert perf["step_ms"] > 0 and len(perf["losses"]) == 2
    assert perf["tokens_per_s"] == pytest.approx(4 * 16 / perf["step_ms"]
                                                 * 1e3)
    assert perf["mfu"] == pytest.approx(
        perf["model_tflops"] / (perf["peak_tflops"] * WORLD))


@pytest.mark.parametrize("case,kind,match", [
    ("moe_tp", "NotImplementedError", r"MoE on a 'model' axis of 4 .*7b"),
    ("ring", "NotImplementedError", r"not ported yet .*7b"),
    ("dcn", "NotImplementedError", r"'dcn' axis .*7c"),
    ("heads", "ValueError", "n_heads 6 does not split"),
    ("seq", "ValueError", "S 30 does not split"),
    ("batch", "ValueError", "batch 3 does not split"),
    ("device", "ValueError", "a cpu mesh for device meta"),
])
def test_what_the_sharded_step_refuses(behaviour, now_run, case, kind,
                                       match):
    """What the sharded step refuses: heads, S and the batch that do not
    split, and a mesh of another device type. The cases ``moe_tp``,
    ``ring`` and ``dcn`` (*kind* and *match* are the refusal the port
    gave until it ran these modes) now run: no refusal, and one step's
    loss equals JAX's loss at the same tree within 1e-4 relative."""
    import re
    if case in NOW_RUN:
        want = now_run[1][case]
        for r in behaviour:
            assert r["refusals"][case] == (None, None), r["refusals"][case]
            assert abs(r["runs"][case] - want) <= 1e-4 * abs(want), (
                case, r["runs"][case], want)
        return
    for r in behaviour:
        got_kind, msg = r["refusals"][case]
        assert got_kind == kind and re.search(match, msg), (got_kind, msg)


# -- one rank in this process: the CPU twin of chip_smoke.py phase 13 --------

def test_one_rank_sharded_step_equals_the_one_device_step(inputs):
    """A lone pod: no operator env, so no distributed init; ``make_mesh``
    forms a one-rank group. The sharded step on that (1, 1) mesh, sp on,
    goes through every collective of the SPMD region and matches the
    one-device step within the parity bounds."""
    assert initialize_from_operator_env({}) is None
    assert not dist.is_initialized()
    try:
        mesh = make_mesh(("data", "model"), device_type="cpu")
        step, init_state, place = make_train_step(CFG, mesh, device="cpu")
        params, opt = init_state(params=model.params_from_numpy(
            inputs["tree"], CFG, device="cpu"))
        batch = place({k: torch.from_numpy(inputs[k].astype(np.int64))
                       for k in ("tokens", "targets")})
        losses = [float(step(params, opt, batch)[2]) for _ in range(STEPS)]
        leaves = [t.detach().numpy() for t in param_leaves(
            model.gather_params(params, CFG, mesh))]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    _hold(losses, leaves, *_one_device_run(inputs))
