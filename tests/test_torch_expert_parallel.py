"""The port's expert parallelism and MoE in the sequence modes against the
JAX package.

Twins of ``tests/test_moe_pipeline.py``'s expert-parallel tests (:58,
:85), at their config in fp32. The JAX side runs here on the 8 virtual
CPU devices, each reference once, in a module fixture; the port's side
runs in 8 spawned ranks of a gloo group
(``dpu_operator_tpu_torch.testing.spmd.expert_parallel``), one spawn for
the file. Both sides take the same JAX ``init_params`` trees, bridged by
``params_from_numpy``, and the same batches.

- Expert parallelism on a (2, 4) ("data", "model") mesh, sequence
  parallelism on and off: each rank holds 2 of the 8 experts; the step
  against JAX ``make_train_step(cfg, mesh)``, and the routers' gradient
  after one step against a jitted ``jax.grad`` of JAX ``loss_fn``.
- MoE with ring attention on (2, 4) and (1, 8) and with Ulysses on
  (1, 8), at a capacity factor of 0.5 (a capacity of 8 against a mean
  load of 8 a row and expert, so tokens drop, and a token's place in its
  queue counts the row's tokens on the lower "model" ranks).

Tolerances, as ``tests/test_torch_spmd.py`` holds the sharded step:
losses within 1e-4 relative; parameters (gathered into the JAX layout)
within 3 x lr, because Adam's first step moves a weight by about +-lr, so
a near-zero gradient may differ in sign; the routers' gradient within
1e-4 of its largest element.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax  # noqa: F401  (the JAX step's optimizer)
import pytest
import torch
import torch.distributed as dist

from dpu_operator_tpu.workloads import model as jax_model
from dpu_operator_tpu.workloads.mesh import make_mesh as jax_make_mesh
from dpu_operator_tpu_torch.testing import spmd
from dpu_operator_tpu_torch.workloads import model
from dpu_operator_tpu_torch.workloads.mesh import make_mesh
from dpu_operator_tpu_torch.workloads.train import named_leaves

WORLD = 8
STEPS = 3
#: tests/test_moe_pipeline.py:58's model
EP_FIELDS = dict(n_layers=2, d_model=32, n_heads=4, d_ff=64, max_seq=32,
                 vocab=128, moe_experts=8)
#: tests/test_long_context.py:245's model with 8 experts, capacity 0.5
SEQ_FIELDS = dict(vocab=64, d_model=64, n_heads=8, n_layers=2, d_ff=128,
                  max_seq=64, moe_experts=8, moe_capacity_factor=0.5)
EP_CFG = jax_model.TransformerConfig(**EP_FIELDS, dtype=jnp.float32)
SEQ_CFG = jax_model.TransformerConfig(**SEQ_FIELDS, dtype=jnp.float32,
                                      flash_block_q=8, flash_block_k=8)
#: (attention, mesh axis sizes) of the sequence-mode runs
SEQ_CASES = [("ring", (2, 4)), ("ring", (1, 8)), ("ulysses", (1, 8))]
LR_TOL = 3 * EP_CFG.learning_rate
GRAD_TOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_leaves(tree):
    """JAX tree leaves in the port's ``param_leaves`` order."""
    out = [tree["embed"], tree["pos"], tree["out_norm"]]
    for lp in tree["layers"]:
        out += [lp[n] for n in ("ln1", "wqkv", "wo", "ln2")]
        out += ([lp["moe"][n] for n in ("wg", "w1", "w2")] if "moe" in lp
                else [lp["w1"], lp["w2"]])
    return [np.asarray(a, np.float32) for a in out]


def _case(cfg, batch):
    tree = _np_tree(jax_model.init_params(jax.random.key(0), cfg))
    b = jax_model.make_example_batch(cfg, batch=batch)
    return tree, np.asarray(b["tokens"]), np.asarray(b["targets"])


@pytest.fixture(scope="module")
def inputs():
    return {"ep": _case(EP_CFG, 4), "seq": _case(SEQ_CFG, 2)}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """The port's side: one spawn of 8 ranks for the whole file."""
    return spmd.spawn(
        spmd.expert_parallel, WORLD, str(tmp_path_factory.mktemp("ep")),
        args=((EP_FIELDS, inputs["ep"]), (SEQ_FIELDS, inputs["seq"]),
              STEPS))


def _jax_steps(cfg, sizes, case):
    """JAX ``make_train_step(cfg, mesh)``: STEPS steps from the case's
    tree and batch; the losses and the parameters."""
    mesh = jax_make_mesh(("data", "model"), axis_sizes=sizes)
    step, init_state, place = jax_model.make_train_step(cfg, mesh)
    params, opt = init_state(jax.random.key(0))
    _, tokens, targets = case
    data = place({"tokens": jnp.asarray(tokens),
                  "targets": jnp.asarray(targets)})
    losses = []
    for _ in range(STEPS):
        params, opt, loss = step(params, opt, data)
        losses.append(float(loss))
    return losses, _jax_leaves(params)


@pytest.fixture(scope="module")
def jax_runs(inputs):
    """The JAX references, once for the module: the ep steps sp on and
    off, the routers' gradient at the initial tree, and the sequence-mode
    steps."""
    tree, tokens, targets = inputs["ep"]
    grad = jax.jit(jax.grad(jax_model.loss_fn), static_argnums=2)(
        tree, {"tokens": jnp.asarray(tokens),
               "targets": jnp.asarray(targets)}, EP_CFG)
    return {
        "ep": {sp: _jax_steps(dataclasses.replace(EP_CFG,
                                                  sequence_parallel=sp),
                              (2, 4), inputs["ep"])
               for sp in (True, False)},
        "wg_grad": [np.asarray(lp["moe"]["wg"]) for lp in grad["layers"]
                    if "moe" in lp],
        "seq": {(mode, sizes): _jax_steps(
            dataclasses.replace(SEQ_CFG, attention=mode), sizes,
            inputs["seq"]) for mode, sizes in SEQ_CASES},
    }


def _hold(run, want_losses, want_leaves):
    for got, want in zip(run["losses"], want_losses):
        assert abs(got - want) <= 1e-4 * abs(want), (run["losses"],
                                                     want_losses)
    assert len(run["params"]) == len(want_leaves)
    for i, (got, want) in enumerate(zip(run["params"], want_leaves)):
        assert got.shape == want.shape, i
        np.testing.assert_allclose(got, want, rtol=0, atol=LR_TOL,
                                   err_msg=f"leaf {i}")


def _replicated(cfg):
    """Which of ``param_leaves`` are replicated over the mesh."""
    return ["model" not in s for _, s in named_leaves(model.param_specs(cfg))]


# -- expert parallelism -------------------------------------------------------

def test_ep_specs_are_jax_specs():
    """Twin of test_moe_pipeline.py:58's spec checks: a MoE layer's expert
    weights split over "model" on the expert dim, the dense layer keeps
    tp, and every spec is JAX's."""
    from jax.sharding import PartitionSpec as P
    cfg = model.TransformerConfig(**EP_FIELDS)
    specs = model.param_specs(cfg)
    assert specs["layers"][1]["moe"]["w1"] == ("model", None, None)
    assert "w1" not in specs["layers"][1]
    assert specs["layers"][0]["w1"] == (None, "model")
    want = jax_model.param_specs(EP_CFG)
    assert specs["layers"][1]["moe"] == {
        k: tuple(v) for k, v in want["layers"][1]["moe"].items()}
    assert want["layers"][1]["moe"]["w2"] == P("model", None, None)


@pytest.mark.parametrize("sp", [True, False])
def test_ep_step_matches_jax(ranks, jax_runs, sp):
    """3 fp32 steps with 2 experts a rank on (2, 4) against JAX
    ``make_train_step(cfg, mesh)`` (losses 1e-4 relative, the gathered
    parameters 3 x lr)."""
    _hold(ranks[0]["ep"][sp], *jax_runs["ep"][sp])


@pytest.mark.parametrize("sp", [True, False])
def test_ep_router_gradient_matches_jax_grad(ranks, jax_runs, sp):
    """The routers' gradient after the first step (summed over "model",
    averaged over "data") against ``jax.grad`` of JAX ``loss_fn`` on the
    whole batch: the aux term counted once, the output term from every
    rank's own experts. Every rank holds the same gradient."""
    want = jax_runs["wg_grad"]
    assert len(want) == 1
    for r in ranks:
        got = r["ep"][sp]["wg_grad"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            err = float(np.abs(g - w).max() / np.abs(w).max())
            assert err <= GRAD_TOL, (r["rank"], err)


@pytest.mark.parametrize("sp", [True, False])
def test_ep_ranks_agree(ranks, sp):
    """Every rank reads the same global loss; the replicated leaves
    (norms, ``pos``, the routers) are equal on every rank, and each
    expert shard is equal on the ranks of its "model" index."""
    cfg = model.TransformerConfig(**EP_FIELDS)
    rep = _replicated(cfg)
    by_model = {}
    for r in ranks:
        run = r["ep"][sp]
        assert run["losses"] == ranks[0]["ep"][sp]["losses"]
        for i, (s, w) in enumerate(zip(run["sums"],
                                       ranks[0]["ep"][sp]["sums"])):
            if rep[i]:
                assert s == w, (r["rank"], i)
        m = r["coords_2x4"][1]
        by_model.setdefault(m, run["sums"])
        assert run["sums"] == by_model[m], r["rank"]


def test_ep_bf16_loss_decreases(ranks):
    """The bf16 gate of test_moe_pipeline.py:58: 5 steps on (2, 4) from
    the port's ``init_params(0)``, loss finite and falling, the same on
    every rank."""
    for r in ranks:
        losses = r["ep_bf16"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        assert losses == ranks[0]["ep_bf16"]


def test_ep_refuses_experts_that_do_not_split(ranks):
    """6 experts over a "model" axis of 4: JAX's sharding cannot split
    them either."""
    for r in ranks:
        assert r["refusal"] == (
            "ValueError",
            "moe_experts 6 does not split over a 'model' axis of 4")


# -- MoE in the sequence modes ------------------------------------------------

def test_moe_ring_mode_replicates_experts():
    """Twin of test_moe_pipeline.py:85: in ring mode the experts
    replicate (spec ``()``, JAX's ``P()``)."""
    cfg = model.TransformerConfig(n_layers=2, attention="ring",
                                  moe_experts=4)
    assert model.param_specs(cfg)["layers"][1]["moe"] == dict.fromkeys(
        ("wg", "w1", "w2"), ())
    jcfg = jax_model.TransformerConfig(n_layers=2, attention="ring",
                                       moe_experts=4)
    assert tuple(jax_model.param_specs(jcfg)["layers"][1]["moe"]["w1"]) \
        == ()


@pytest.mark.parametrize("mode,sizes", SEQ_CASES)
def test_moe_sequence_step_matches_jax(ranks, jax_runs, mode, sizes):
    """3 fp32 steps of MoE in a sequence mode against JAX
    ``make_train_step(cfg, mesh)`` on the same mesh, at a capacity that
    drops tokens."""
    _hold(ranks[0]["seq"][(mode, sizes)], *jax_runs["seq"][(mode, sizes)])


@pytest.mark.parametrize("mode,sizes", SEQ_CASES)
def test_moe_sequence_ranks_hold_the_same_model(ranks, mode, sizes):
    """Every leaf is replicated in a sequence mode, the experts too: every
    rank reads the same loss and holds the same parameters."""
    want = ranks[0]["seq"][(mode, sizes)]
    for r in ranks[1:]:
        got = r["seq"][(mode, sizes)]
        assert got["losses"] == want["losses"]
        assert got["sums"] == want["sums"], r["rank"]


# -- one rank in this process: no spawn ---------------------------------------

@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo mesh in this process, ended after the module."""
    assert not dist.is_initialized()
    mesh = make_mesh(("data", "model"), device_type="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("mode", ["ring", "ulysses", "standard"])
def test_one_rank_moe_forward_equals_the_one_device_forward(one_rank,
                                                            inputs, mode):
    """MoE through a region on the one-rank mesh (the column routing of a
    sequence mode, or the expert-parallel hook) gives the one-device
    forward's logits and aux loss, and JAX's."""
    tree, tokens, _ = inputs["seq"]
    cfg = model.TransformerConfig(**SEQ_FIELDS, dtype=torch.float32,
                                  attention=mode)
    params = model.params_from_numpy(tree, cfg, device="cpu")
    toks = torch.from_numpy(tokens.astype(np.int64))
    with torch.no_grad():
        got, got_aux = model.forward(params, toks, cfg, one_rank,
                                     return_aux=True)
        want, want_aux = model.forward(params, toks, cfg, return_aux=True)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got_aux, want_aux, atol=1e-6, rtol=1e-6)
    jax_logits, jax_aux = jax.jit(
        lambda p, t: jax_model.forward(p, t, SEQ_CFG, return_aux=True))(
            tree, jnp.asarray(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_logits),
                               atol=1e-4, rtol=1e-4)
    assert abs(float(got_aux) - float(jax_aux)) <= 1e-5
