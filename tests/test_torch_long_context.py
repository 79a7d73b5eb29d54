"""The port's long context (ring and Ulysses attention, and the
sequence-sharded train step) against the JAX package.

Twins of ``tests/test_long_context.py``'s ring and Ulysses tests, at their
sizes and tolerances. The JAX side runs here on the 8 virtual CPU devices,
each reference once, in a module-scoped fixture; the port's side runs in
8 spawned ranks of a gloo group (``dpu_operator_tpu_torch.testing.spmd``),
one spawn for the file (the attention functions, then the forward and the
train steps). Both sides take the same numpy inputs and
the same JAX ``init_params`` trees, bridged by ``params_from_numpy``.

Tolerances: the attention functions as the JAX tests state them (fp32
2e-5, bf16 5e-2, Ulysses 2e-2), their gradients against the gradient of
JAX's ``full_attention`` within 1e-4; the ring forward within 3e-4; the
train steps as ``tests/test_torch_spmd.py`` holds the sharded step:
losses within 1e-4 relative, parameters within 3 x lr (Adam's first step
moves a weight by about +-lr, so a near-zero gradient may differ in sign).

The two JAX tests that measure the size of a lowered XLA program
(``test_ring_program_size_constant_in_axis``,
``test_ulysses_program_size_invariant``) have no twin: an eager PyTorch
step lowers no program.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax  # noqa: F401  (the JAX step's optimizer)
import pytest
import torch
import torch.distributed as dist

from dpu_operator_tpu.workloads import model as jax_model
from dpu_operator_tpu.workloads.mesh import make_mesh as jax_make_mesh
from dpu_operator_tpu.workloads.ring_attention import \
    full_attention as jax_full_attention
from dpu_operator_tpu.workloads.ring_attention import \
    ring_attention as jax_ring_attention
from dpu_operator_tpu.workloads.ulysses import \
    ulysses_attention as jax_ulysses_attention
from dpu_operator_tpu_torch.ops import flash_attention_vjp
from dpu_operator_tpu_torch.testing import spmd
from dpu_operator_tpu_torch.workloads import collectives, model
from dpu_operator_tpu_torch.workloads.mesh import make_mesh
from dpu_operator_tpu_torch.workloads.ring_attention import (
    full_attention, ring_attention)
from dpu_operator_tpu_torch.workloads.train import (make_train_step,
                                                    param_leaves)
from dpu_operator_tpu_torch.workloads.ulysses import ulysses_attention

WORLD = 8
STEPS = 3
GRAD_TOL = 1e-4
FWD_CFG = jax_model.TransformerConfig(n_layers=1, max_seq=32,
                                      dtype=jnp.float32)
#: test_long_context.py:175's model in fp32, and :245's
RING_CFG = jax_model.TransformerConfig(n_layers=2, max_seq=64,
                                       attention="ring", dtype=jnp.float32)
ULYSSES_CFG = jax_model.TransformerConfig(
    vocab=64, d_model=64, n_heads=8, n_layers=2, d_ff=128, max_seq=64,
    attention="ulysses", flash_block_q=8, flash_block_k=8,
    dtype=jnp.float32)
#: (JAX config, mesh axis sizes, global batch) of the train parity runs
TRAIN = {"ring": (RING_CFG, (2, 4), 4), "ulysses": (ULYSSES_CFG, (1, 8), 2)}
#: the refusal cases whose mode the port now runs (MoE with ring attention
#: on (2, 4), with Ulysses on (1, 8)): the JAX config of the one step
#: ``spmd._long_context_train`` takes, batch 2
MOE_RUNS = {f"moe_{mode}": jax_model.TransformerConfig(
    moe_experts=4, attention=mode, n_layers=2, max_seq=32, dtype=jnp.float32)
    for mode in ("ring", "ulysses")}
LR_TOL = 3 * RING_CFG.learning_rate


def _qkv(rng, shape, bf16=False):
    """Three standard normal draws of *shape* (test_long_context.py's
    inputs' distribution), fp32, or bf16 values held in fp32."""
    qkv = tuple(rng.standard_normal(shape, np.float32) for _ in range(3))
    if bf16:
        qkv = tuple(torch.from_numpy(a).bfloat16().float().numpy()
                    for a in qkv)
    return qkv


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch_np(cfg, batch):
    b = jax_model.make_example_batch(cfg, batch=batch, seq=cfg.max_seq)
    return np.asarray(b["tokens"]), np.asarray(b["targets"])


def _torch_cfg(cfg, **kw):
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(model.TransformerConfig)
              if f.name != "dtype"}
    fields.update(dtype=torch.float32, **kw)
    return model.TransformerConfig(**fields)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(19)
    return {
        "ring_qkv": _qkv(rng, (2, 64, 4, 16)),
        "ring_do": rng.standard_normal((2, 64, 4, 16), np.float32),
        "bf16_qkv": _qkv(rng, (2, 64, 4, 16), bf16=True),
        "ulysses_qkv": _qkv(rng, (2, 256, 8, 32)),
        "ulysses_do": rng.standard_normal((2, 256, 8, 32), np.float32),
        "fwd_tree": _np_tree(jax_model.init_params(jax.random.key(5),
                                                   FWD_CFG)),
        "fwd_tokens": _batch_np(FWD_CFG, 2)[0],
        "trees": {mode: _np_tree(jax_model.init_params(jax.random.key(0),
                                                       cfg))
                  for mode, (cfg, _, _) in TRAIN.items()},
        "batches": {mode: _batch_np(cfg, batch)
                    for mode, (cfg, _, batch) in TRAIN.items()},
        "moe_runs": {case: (_np_tree(jax_model.init_params(
            jax.random.key(0), cfg)), *_batch_np(cfg, 2))
            for case, cfg in MOE_RUNS.items()},
    }


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """The port's side: one spawn of 8 ranks for the whole file."""
    return spmd.spawn(
        spmd.long_context, WORLD, str(tmp_path_factory.mktemp("ranks")),
        args=((inputs["ring_qkv"], inputs["ring_do"], inputs["bf16_qkv"],
               inputs["ulysses_qkv"], inputs["ulysses_do"]),
              (inputs["fwd_tree"], inputs["fwd_tokens"],
               inputs["trees"]["ring"], inputs["batches"]["ring"],
               inputs["trees"]["ulysses"], inputs["batches"]["ulysses"],
               STEPS, inputs["moe_runs"])))


@pytest.fixture(scope="module")
def attention_runs(ranks):
    return [r["attention"] for r in ranks]


@pytest.fixture(scope="module")
def train_runs(ranks):
    return [r["train"] for r in ranks]


@jax.jit
def _full_attention_vjp(q, k, v, do):
    return jax.vjp(jax_full_attention, q, k, v)[1](do)


def _jax_vjp(qkv, do):
    """The gradients of JAX's causal ``full_attention`` for the output
    gradient *do*."""
    return [np.asarray(g) for g in _full_attention_vjp(*qkv, do)]


@pytest.fixture(scope="module")
def jax_attention(inputs):
    """JAX ring attention on the tests' meshes, JAX Ulysses attention,
    JAX ``full_attention`` and its gradients, once for the module."""
    line = jax_make_mesh(("data", "model"), axis_sizes=(1, 8))
    square = jax_make_mesh(("data", "model"), axis_sizes=(2, 4))
    heads = jax_make_mesh(("model",), axis_sizes=(8,))
    q, k, v = (jnp.asarray(a) for a in inputs["ring_qkv"])
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in inputs["bf16_qkv"])
    uq, uk, uv = (jnp.asarray(a) for a in inputs["ulysses_qkv"])
    half = tuple(a[:, :32] for a in inputs["ring_qkv"])
    out = {
        "ring_causal": jax_ring_attention(line, "model")(q, k, v),
        "ring_full": jax_ring_attention(line, "model", causal=False)(q, k,
                                                                     v),
        "ring_2x4": jax_ring_attention(square, "model")(
            *(jnp.asarray(a) for a in half)),
        "ring_bf16": jax_ring_attention(line, "model")(qb, kb, vb),
        "full_causal": jax_full_attention(q, k, v),
        "full_full": jax_full_attention(q, k, v, causal=False),
        "full_2x4": jax_full_attention(*(jnp.asarray(a) for a in half)),
        "full_bf16": jax_full_attention(qb, kb, vb),
        "ulysses": jax_ulysses_attention(heads, "model", block_q=64,
                                         block_k=64)(uq, uk, uv),
        "full_ulysses": jax_full_attention(uq, uk, uv),
    }
    out = {name: np.asarray(a, np.float32) for name, a in out.items()}
    out["grads"] = {
        "ring_causal": _jax_vjp(inputs["ring_qkv"], inputs["ring_do"]),
        "ring_2x4": _jax_vjp(half, inputs["ring_do"][:, :32]),
        "ulysses": _jax_vjp(inputs["ulysses_qkv"], inputs["ulysses_do"]),
    }
    return out


def _jax_train(mode, inputs):
    """JAX ``make_train_step(cfg, mesh)``: STEPS steps from
    ``init_params(key(0))`` on the mode's batch; the losses and the
    parameters in the port's ``param_leaves`` order."""
    cfg, sizes, batch = TRAIN[mode]
    mesh = jax_make_mesh(("data", "model"), axis_sizes=sizes)
    step, init_state, place = jax_model.make_train_step(cfg, mesh)
    params, opt = init_state(jax.random.key(0))
    tokens, targets = inputs["batches"][mode]
    data = place({"tokens": jnp.asarray(tokens),
                  "targets": jnp.asarray(targets)})
    losses = []
    for _ in range(STEPS):
        params, opt, loss = step(params, opt, data)
        losses.append(float(loss))
    leaves = [params["embed"], params["pos"], params["out_norm"]]
    for lp in params["layers"]:
        leaves += [lp[n] for n in ("ln1", "wqkv", "wo", "ln2", "w1", "w2")]
    replicated = all(a.sharding.is_fully_replicated for a in leaves)
    return losses, [np.asarray(a, np.float32) for a in leaves], replicated


@pytest.fixture(scope="module")
def jax_train(inputs):
    """The JAX ring and Ulysses train steps, and JAX's forward of the
    1-layer model on a (1, 8) mesh in each sequence mode, once for the
    module."""
    line = jax_make_mesh(("data", "model"), axis_sizes=(1, 8))
    tokens = jnp.asarray(inputs["fwd_tokens"])
    forward = {}
    for mode in ("ring", "ulysses"):
        cfg = dataclasses.replace(FWD_CFG, attention=mode)
        forward[mode] = np.asarray(jax.jit(
            lambda p, t, c=cfg: jax_model.forward(p, t, c, line))(
                inputs["fwd_tree"], tokens))
    return {"forward": forward,
            "train": {mode: _jax_train(mode, inputs) for mode in TRAIN}}


def _along_model(runs, path, sizes):
    """The global array from the ranks' S / n columns at *path* (a key or
    a tuple of keys) on a mesh of *sizes*: rank d * model + m holds column
    block m, and every "data" row of ranks must hold the same columns."""
    path = path if isinstance(path, tuple) else (path,)

    def at(run):
        for key in path:
            run = run[key]
        return run

    model_n = sizes[-1]
    rows = [[at(r) for r in runs[d:d + model_n]]
            for d in range(0, len(runs), model_n)]
    for row in rows[1:]:
        for got, want in zip(row, rows[0]):
            np.testing.assert_array_equal(got, want)
    return np.concatenate(rows[0], axis=1)


# -- the attention functions --------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_full(attention_runs, jax_attention, causal):
    """Twin of test_long_context.py:24: (1, 8), 2e-5, against JAX's
    ``full_attention`` and JAX's ring."""
    case = "causal" if causal else "full"
    got = _along_model(attention_runs, (f"ring_{case}", "out"), (1, 8))
    for want in (jax_attention[f"full_{case}"],
                 jax_attention[f"ring_{case}"]):
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_ring_attention_4way_axis(attention_runs, jax_attention):
    """Twin of test_long_context.py:33: (2, 4) at S 32; both "data" rows
    compute the same columns."""
    got = _along_model(attention_runs, ("ring_2x4", "out"), (2, 4))
    for want in (jax_attention["full_2x4"], jax_attention["ring_2x4"]):
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_ring_attention_bf16(attention_runs, jax_attention):
    """Twin of test_long_context.py:124: bf16 inputs, 5e-2."""
    got = _along_model(attention_runs, ("ring_bf16", "out"), (1, 8))
    for want in (jax_attention["full_bf16"], jax_attention["ring_bf16"]):
        np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("case,sizes", [("ring_causal", (1, 8)),
                                        ("ring_2x4", (2, 4)),
                                        ("ulysses", (8,))])
def test_sequence_attention_gradients(attention_runs, jax_attention, case,
                                      sizes):
    """The backward through the hops (``RingHop``) and the all-to-alls
    (``AllToAll``): each rank's dq, dk, dv columns against the gradient of
    JAX's ``full_attention`` for the same output gradient."""
    for name, want in zip(("dq", "dk", "dv"), jax_attention["grads"][case]):
        got = _along_model(attention_runs, (case, name), sizes)
        np.testing.assert_allclose(got, want, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"{case} {name}")


def test_ring_hop_backward_goes_the_other_way(attention_runs):
    """Rank r's hop sends to r + 1 and rank r + 1 weighs what it received
    by r + 1, so the gradient at rank r is r + 1 (mod 8)."""
    for r in attention_runs:
        np.testing.assert_array_equal(
            r["hop_grad"], np.full(3, (r["rank"] + 1) % WORLD, np.float32))


def test_ulysses_matches_full_attention(attention_runs, jax_attention):
    """Twin of test_long_context.py:225: an 8-wide "model" mesh, B 2, S
    256, H 8, D 32, against JAX's Ulysses attention and ``full_attention``
    within 2e-2."""
    got = _along_model(attention_runs, ("ulysses", "out"), (8,))
    for want in (jax_attention["ulysses"], jax_attention["full_ulysses"]):
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


# -- the forward and the train step -------------------------------------------

@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_sequence_mode_matches_standard_forward(train_runs, jax_train,
                                                inputs, mode):
    """Twin of test_long_context.py:193: the 1-layer fp32 model's forward
    on (1, 8) in the sequence mode (each rank's columns of the logits)
    against the port's one-device forward and JAX's forward in that mode,
    within 3e-4."""
    got = _along_model([r["forward"] for r in train_runs], mode, (1, 8))
    cfg = _torch_cfg(FWD_CFG)
    params = model.params_from_numpy(inputs["fwd_tree"], cfg, device="cpu")
    with torch.no_grad():
        single = model.forward(params, torch.from_numpy(
            inputs["fwd_tokens"].astype(np.int64)), cfg).numpy()
    for want in (single, jax_train["forward"][mode]):
        np.testing.assert_allclose(got, want, atol=3e-4, rtol=3e-4)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_sequence_train_step_matches_jax(train_runs, jax_train, mode):
    """Twins of test_long_context.py:175 (ring, (2, 4)) and :245 (Ulysses,
    (1, 8), its config): STEPS fp32 AdamW steps from the same tree and
    batch as JAX's ``make_train_step(cfg, mesh)``; losses within 1e-4
    relative, the parameters within 3 x lr. JAX's parameters stay
    replicated."""
    want_losses, want_leaves, replicated = jax_train["train"][mode]
    assert replicated
    run = train_runs[0][f"{mode}_train"]
    for got, want in zip(run["losses"], want_losses):
        assert abs(got - want) <= 1e-4 * abs(want), (run["losses"],
                                                     want_losses)
    assert len(run["params"]) == len(want_leaves) == 3 + 6 * 2
    for i, (got, want) in enumerate(zip(run["params"], want_leaves)):
        assert got.shape == want.shape, i
        np.testing.assert_allclose(got, want, rtol=0, atol=LR_TOL,
                                   err_msg=f"leaf {i}")


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_every_rank_holds_the_same_model(train_runs, mode):
    """The replication check of test_long_context.py:262: after the steps
    every rank holds the same parameters (each gradient summed over
    "model" and averaged over "data") and read the same global loss."""
    want = train_runs[0][f"{mode}_train"]
    for r in train_runs[1:]:
        got = r[f"{mode}_train"]
        assert got["losses"] == want["losses"]
        assert got["sums"] == want["sums"], r["rank"]


def test_ring_mode_train_step_loss_decreases(train_runs):
    """Twin of test_long_context.py:175: the bf16 ring model on (2, 4),
    5 steps, loss falling, the same on every rank."""
    for r in train_runs:
        losses = r["ring_bf16"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        assert losses == train_runs[0]["ring_bf16"]


def test_measure_train_runs_a_sequence_mode(train_runs):
    perf = train_runs[0]["perf"]
    assert perf["world"] == WORLD and perf["device"] == "cpu"
    assert perf["step_ms"] > 0 and len(perf["losses"]) == 2
    assert np.isfinite(perf["losses"]).all()
    assert perf["tokens_per_s"] == pytest.approx(4 * 16 / perf["step_ms"]
                                                 * 1e3)


@pytest.mark.parametrize("case,kind,match", [
    ("ring_seq", "ValueError", r"ring attention: S 30 does not split"),
    ("ulysses_seq", "ValueError", r"ulysses attention: S 30 does not split"),
    ("ulysses_heads", "ValueError", r"n_heads 6 does not split over a "
                                    r"'model' axis of 8"),
    ("moe_ring", "NotImplementedError", r"MoE with attention='ring' .*7b-ii"),
    ("moe_ulysses", "NotImplementedError",
     r"MoE with attention='ulysses' .*7b-ii"),
])
def test_what_the_sequence_modes_refuse(train_runs, inputs, case, kind,
                                        match):
    """What the sequence modes refuse: S or heads that do not split. The
    cases ``moe_ring`` and ``moe_ulysses`` (*kind* and *match* are the
    refusal the port gave until it ran MoE in a sequence mode) now run:
    no refusal, and one step's loss equals JAX's loss at the same tree
    within 1e-4 relative."""
    if case in MOE_RUNS:
        tree, tokens, targets = inputs["moe_runs"][case]
        want = float(jax.jit(jax_model.loss_fn, static_argnums=2)(
            tree, {"tokens": jnp.asarray(tokens),
                   "targets": jnp.asarray(targets)}, MOE_RUNS[case]))
        for r in train_runs:
            assert r["refusals"][case] == (None, None), r["refusals"][case]
            got = r["moe_runs"][case]
            assert abs(got - want) <= 1e-4 * abs(want), (case, got, want)
        return
    for r in train_runs:
        got_kind, msg = r["refusals"][case]
        assert got_kind == kind and re.search(match, msg), (got_kind, msg)


# -- one rank in this process: no spawn ---------------------------------------

@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo mesh in this process, ended after the module."""
    assert not dist.is_initialized()
    mesh = make_mesh(("data", "model"), device_type="cpu")
    yield mesh
    dist.destroy_process_group()


def _torch_qkv(inputs, requires_grad=False):
    return tuple(torch.tensor(a).requires_grad_(requires_grad)
                 for a in inputs["ring_qkv"])


def test_one_rank_ring_equals_full_attention(one_rank, inputs):
    q, k, v = _torch_qkv(inputs)
    for causal in (True, False):
        got = ring_attention(one_rank, causal=causal)(q, k, v)
        torch.testing.assert_close(got, full_attention(q, k, v, causal),
                                   atol=2e-5, rtol=2e-5)


def test_one_rank_ulysses_is_flash_attention(one_rank, inputs):
    q, k, v = _torch_qkv(inputs)
    assert torch.equal(ulysses_attention(one_rank)(q, k, v),
                       flash_attention_vjp(q, k, v))


def test_all_to_all_gradient_on_one_rank(one_rank, inputs):
    """``AllToAll`` on one rank is the identity (the collective copies):
    its value and its gradient equal those of the computation without
    it."""
    x = torch.tensor(inputs["ring_qkv"][0]).requires_grad_(True)
    w = torch.from_numpy(inputs["ring_do"])
    for split, concat in ((2, 1), (1, 2), (0, 0)):
        y = collectives.all_to_all(one_rank, "model", split, concat)(x)
        assert torch.equal(y, x)
        (g,) = torch.autograd.grad((y * y * w).sum(), x)
        torch.testing.assert_close(g, 2 * x.detach() * w, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_one_rank_sequence_step_equals_the_one_device_step(one_rank, inputs,
                                                          mode):
    """The CPU twin of chip_smoke.py phase 14 (c): the sequence-mode step
    on the (1, 1) mesh goes through its region, its loss reduction and
    its gradient sums, and matches the one-device step of the same model
    within the parity bounds."""
    cfg = _torch_cfg(TRAIN[mode][0], attention=mode)
    tokens, targets = inputs["batches"][mode]
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int64)),
             "targets": torch.from_numpy(targets.astype(np.int64))}
    runs = []
    for mesh in (one_rank, None):
        step, init_state, place = make_train_step(cfg, mesh, device="cpu")
        params, opt = init_state(params=model.params_from_numpy(
            inputs["trees"][mode], cfg, device="cpu"))
        data = place(batch)
        losses = [float(step(params, opt, data)[2]) for _ in range(STEPS)]
        runs.append((losses, [t.detach() for t in param_leaves(params)]))
    (got, got_p), (want, want_p) = runs
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-4 * abs(b), (got, want)
    for a, b in zip(got_p, want_p):
        torch.testing.assert_close(a, b, rtol=0, atol=LR_TOL)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_moe_in_a_sequence_mode_raises(one_rank, mode):
    """MoE in a sequence mode, refused until it was ported, now runs with
    and without a mesh: ``init_params``, ``check_mesh`` and
    ``make_train_step`` take the config, and the forward through the
    one-rank mesh (the column routing) gives JAX's logits and aux loss on
    the same tree."""
    jcfg = jax_model.TransformerConfig(moe_experts=4, attention=mode,
                                       max_seq=32, dtype=jnp.float32)
    cfg = _torch_cfg(jcfg)
    model.init_params(0, cfg, device="cpu")
    model.check_mesh(cfg, one_rank)
    make_train_step(cfg, one_rank, device="cpu")
    tree = _np_tree(jax_model.init_params(jax.random.key(3), jcfg))
    tokens, _ = _batch_np(jcfg, 2)
    with torch.no_grad():
        got, aux = model.forward(
            model.params_from_numpy(tree, cfg, device="cpu"),
            torch.from_numpy(tokens.astype(np.int64)), cfg, one_rank,
            return_aux=True)
    want, want_aux = jax.jit(lambda p, t: jax_model.forward(
        p, t, jcfg, return_aux=True))(tree, jnp.asarray(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    assert abs(float(aux) - float(want_aux)) <= 1e-5


def test_a_sequence_mode_without_a_mesh_is_the_one_device_forward(inputs):
    """As the JAX ``forward`` falls through without a mesh: the same
    logits as the standard mode, bit for bit."""
    tokens = torch.from_numpy(inputs["fwd_tokens"].astype(np.int64))
    got = {}
    for mode in ("standard", "ring", "ulysses"):
        cfg = _torch_cfg(FWD_CFG, attention=mode)
        params = model.params_from_numpy(inputs["fwd_tree"], cfg,
                                         device="cpu")
        with torch.no_grad():
            got[mode] = model.forward(params, tokens, cfg)
    assert torch.equal(got["ring"], got["standard"])
    assert torch.equal(got["ulysses"], got["standard"])
