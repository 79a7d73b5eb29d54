"""The port's pipeline, multi-slice and re-sharding restore against the
JAX package.

Twins of ``tests/test_moe_pipeline.py``'s pipeline tests (:96-:146),
``tests/test_long_context.py``'s multi-slice tests (:134-:149),
``tests/test_multislice_e2e.py:240`` and ``tests/test_checkpoint.py``'s
restores (:51, :103, :128). The JAX side runs here on the 8 virtual CPU
devices, each reference once, in a module fixture; the port's side runs
in 8 spawned ranks of a gloo group
(``dpu_operator_tpu_torch.testing.spmd.pipeline_and_slices``), one spawn
for the file. Both sides take the same JAX trees (``init_params``,
``init_pipeline_params``), bridged through numpy, and the same batches.

Tolerances: the pipelined forward within 2e-4 (the JAX gate's bound);
train steps as ``tests/test_torch_spmd.py`` holds the sharded step
(losses within 1e-4 relative, parameters within 3 x lr); a resumed step's
loss within 1e-5 of the unbroken run's (test_checkpoint.py:51's bound).

test_moe_pipeline.py:146 reads the lowered XLA program for
collective-permutes, which an eager PyTorch step does not have. Its twin
counts the hops the schedule makes instead: one a tick, M + P - 1 a
forward, each a ``RingHop`` to the next stage.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax  # noqa: F401  (the JAX step's optimizer)
import pytest
import torch

from dpu_operator_tpu.workloads import model as jax_model
from dpu_operator_tpu.workloads import pipeline as jax_pipeline
from dpu_operator_tpu.workloads.mesh import make_mesh as jax_make_mesh
from dpu_operator_tpu.workloads.multislice import (
    dcn_bytes_per_host as jax_dcn_bytes_per_host)
from dpu_operator_tpu.workloads.multislice import (
    hierarchical_allreduce as jax_hierarchical_allreduce)
from dpu_operator_tpu_torch.testing import spmd
from dpu_operator_tpu_torch.workloads import model, pipeline
from dpu_operator_tpu_torch.workloads.multislice import dcn_bytes_per_host

WORLD = 8
STEPS = 3
N_MICRO = 4
#: test_moe_pipeline.py:96's pipeline model (4 stages of 1 layer)
PP_FIELDS = dict(n_layers=4, d_model=32, n_heads=4, d_ff=64, max_seq=16,
                 vocab=64)
#: test_multislice_e2e.py:240's model
DCN_FIELDS = dict(vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                  max_seq=16)
#: test_checkpoint.py's model
CKPT_FIELDS = dict(n_layers=1, d_model=64, n_heads=4, d_ff=128,
                   max_seq=16, vocab=64)
PP_CFG = jax_model.TransformerConfig(**PP_FIELDS, dtype=jnp.float32)
DCN_CFG = jax_model.TransformerConfig(**DCN_FIELDS, dtype=jnp.float32)
LR_TOL = 3 * PP_CFG.learning_rate


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_pipeline_leaves(tree):
    """A JAX pipeline tree's leaves in the port's ``param_leaves`` order."""
    return [np.asarray(a, np.float32) for a in (
        tree["embed"], tree["pos"], tree["out_norm"],
        *(tree["stages"][n] for n in ("ln1", "wqkv", "wo", "ln2", "w1",
                                      "w2")))]


def _jax_leaves(tree):
    out = [tree["embed"], tree["pos"], tree["out_norm"]]
    for lp in tree["layers"]:
        out += [lp[n] for n in ("ln1", "wqkv", "wo", "ln2", "w1", "w2")]
    return [np.asarray(a, np.float32) for a in out]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(20)
    tokens = rng.integers(0, PP_CFG.vocab, (8, 16)).astype(np.int32)
    targets = rng.integers(0, PP_CFG.vocab, (8, 16)).astype(np.int32)
    dcn_batch = jax_model.make_example_batch(DCN_CFG, batch=8, seq=16)
    return {
        "pp_tree": _np_tree(jax_pipeline.init_pipeline_params(
            jax.random.key(0), PP_CFG, n_stages=4)),
        "tokens": tokens, "targets": targets,
        "blocks": rng.standard_normal((4, 64)).astype(np.float32),
        "dcn_case": (_np_tree(jax_model.init_params(jax.random.key(0),
                                                    DCN_CFG)),
                     np.asarray(dcn_batch["tokens"]),
                     np.asarray(dcn_batch["targets"])),
    }


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """The port's side: one spawn of 8 ranks for the whole file."""
    store = str(tmp_path_factory.mktemp("pp"))
    return spmd.spawn(
        spmd.pipeline_and_slices, WORLD, store,
        args=(store, (PP_FIELDS, inputs["pp_tree"], inputs["tokens"],
                      inputs["targets"], STEPS),
              (inputs["blocks"], DCN_FIELDS, inputs["dcn_case"], STEPS),
              (CKPT_FIELDS, PP_FIELDS, CKPT_FIELDS)))


@pytest.fixture(scope="module")
def jax_runs(inputs):
    """The JAX references, once for the module: the pipelined forward and
    STEPS pipelined train steps on (4, 2) ("pipe", "data"); the
    hierarchical all-reduce and STEPS sharded steps on (2, 2, 2) ("dcn",
    "data", "model")."""
    pmesh = jax_make_mesh(("pipe", "data"), axis_sizes=(4, 2))
    fwd = jax_pipeline.make_pipeline_forward(PP_CFG, pmesh, n_micro=N_MICRO)
    tokens = jnp.asarray(inputs["tokens"])
    with jax.sharding.use_mesh(pmesh) if hasattr(
            jax.sharding, "use_mesh") else pmesh:
        logits = np.asarray(jax.jit(fwd)(inputs["pp_tree"], tokens))
    step, init_state, place = jax_pipeline.make_pipeline_train_step(
        PP_CFG, pmesh, n_micro=N_MICRO)
    params, opt = init_state(jax.random.key(0))
    data = place({"tokens": tokens,
                  "targets": jnp.asarray(inputs["targets"])})
    losses = []
    for _ in range(STEPS):
        params, opt, loss = step(params, opt, data)
        losses.append(float(loss))
    pp = (losses, _jax_pipeline_leaves(params))

    dmesh = jax_make_mesh(("dcn", "data", "model"), axis_sizes=(2, 2, 2))
    hier = np.asarray(jax_hierarchical_allreduce(dmesh)(
        jnp.asarray(inputs["blocks"].reshape(-1))))
    step, init_state, place = jax_model.make_train_step(DCN_CFG, dmesh)
    params, opt = init_state(jax.random.key(0))
    _, tokens, targets = inputs["dcn_case"]
    data = place({"tokens": jnp.asarray(tokens),
                  "targets": jnp.asarray(targets)})
    losses = []
    for _ in range(STEPS):
        params, opt, loss = step(params, opt, data)
        losses.append(float(loss))
    return {"pp_logits": logits, "pp": pp, "hier": hier.reshape(4, 64),
            "dcn": (losses, _jax_leaves(params))}


def _hold(losses, leaves, want_losses, want_leaves):
    for got, want in zip(losses, want_losses):
        assert abs(got - want) <= 1e-4 * abs(want), (losses, want_losses)
    assert len(leaves) == len(want_leaves)
    for i, (got, want) in enumerate(zip(leaves, want_leaves)):
        assert got.shape == want.shape, i
        np.testing.assert_allclose(got, want, rtol=0, atol=LR_TOL,
                                   err_msg=f"leaf {i}")


def _pp_cfg(**kw):
    return model.TransformerConfig(**{**PP_FIELDS, "dtype": torch.float32,
                                      **kw})


# -- the pipeline -------------------------------------------------------------

def _pipelined_logits(ranks):
    """The global logits from the ranks' rows: data rank d holds row
    m * 2 + d of each microbatch m, and every stage the same logits."""
    got = np.zeros((8, 16, PP_FIELDS["vocab"]), np.float32)
    seen = {}
    for r in ranks:
        p, d = r["pipeline"]["coords"]
        logits = r["pipeline"]["forward"]
        if d in seen:
            np.testing.assert_array_equal(seen[d], logits)
        seen[d] = logits
        for m in range(N_MICRO):
            got[m * 2 + d] = logits[m]
    assert sorted(seen) == [0, 1]
    return got


def test_pipeline_forward_matches_sequential(ranks, inputs):
    """Twin of test_moe_pipeline.py:96: 4 stages x 4 microbatches over
    the hops equal the same stacked layers run one after another
    (``sequential_forward``), within 2e-4."""
    cfg = _pp_cfg()
    params = pipeline.pipeline_params_from_numpy(inputs["pp_tree"], cfg,
                                                 device="cpu")
    with torch.no_grad():
        want = pipeline.sequential_forward(
            cfg, params, torch.from_numpy(inputs["tokens"].astype(np.int64)))
    np.testing.assert_allclose(_pipelined_logits(ranks), want.numpy(),
                               atol=2e-4, rtol=2e-4)


def test_pipeline_forward_matches_jax(ranks, jax_runs):
    """The pipelined forward against JAX ``make_pipeline_forward`` on the
    same mesh and weights (its stages' einsum attention against the
    port's flash attention: the same function), within 2e-4."""
    np.testing.assert_allclose(_pipelined_logits(ranks),
                               jax_runs["pp_logits"], atol=2e-4, rtol=2e-4)


def test_pipeline_train_step_matches_jax(ranks, jax_runs):
    """3 fp32 steps of ``make_pipeline_train_step`` against JAX's on
    (4, 2): losses 1e-4 relative, the gathered stage-stacked tree within
    3 x lr."""
    run = ranks[0]["pipeline"]
    _hold(run["losses"], run["params"], *jax_runs["pp"])


def test_pipeline_replicated_leaves_agree_on_every_rank(ranks):
    """``embed``, ``pos`` and ``out_norm`` (the replicated leaves, summed
    over "pipe" and averaged over "data") are equal on every rank, each
    stage's leaves equal on its data ranks, and every rank reads the same
    loss."""
    want = ranks[0]["pipeline"]
    by_stage = {}
    for r in ranks:
        run = r["pipeline"]
        assert run["losses"] == want["losses"]
        assert run["sums"][:3] == want["sums"][:3], r["rank"]
        p = run["coords"][0]
        by_stage.setdefault(p, run["sums"][3:])
        assert run["sums"][3:] == by_stage[p], r["rank"]
    assert len(by_stage) == 4


def test_pipeline_train_step_loss_decreases(ranks):
    """Twin of test_moe_pipeline.py:122: bf16, 6 steps on (4, 2)."""
    for r in ranks:
        losses = r["pipeline"]["bf16"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        assert losses == ranks[0]["pipeline"]["bf16"]


def test_pipeline_moe_config_trains_the_dense_stack(ranks):
    """A config with ``moe_experts=4`` builds and trains the dense stage
    stack, as the reference's ``init_pipeline_params`` and ``_layer_fwd``
    (which never read ``moe_experts``): from the same bridged tree its 3
    fp32 steps on (4, 2) give the dense config's losses on every rank."""
    for r in ranks:
        run = r["pipeline"]
        assert run["moe_losses"] == run["losses"], r["rank"]


def test_pipeline_moe_config_sequential_forward_matches_jax():
    """JAX ``init_pipeline_params`` of a config with ``moe_experts=4`` over
    2 stages, through ``pipeline_params_from_numpy``: the port's
    ``sequential_forward`` equals JAX's within 2e-4, and the dense
    config's on the same tree exactly."""
    jcfg = jax_model.TransformerConfig(**PP_FIELDS, dtype=jnp.float32,
                                       moe_experts=4)
    tree = _np_tree(jax_pipeline.init_pipeline_params(jax.random.key(3),
                                                      jcfg, 2))
    tokens = np.random.default_rng(21).integers(
        0, PP_FIELDS["vocab"], (4, 16)).astype(np.int32)
    want = np.asarray(jax_pipeline.sequential_forward(
        jcfg, tree, jnp.asarray(tokens)))
    toks = torch.from_numpy(tokens.astype(np.int64))
    got = {}
    for experts in (4, 0):
        cfg = _pp_cfg(moe_experts=experts)
        params = pipeline.pipeline_params_from_numpy(tree, cfg,
                                                     device="cpu")
        with torch.no_grad():
            got[experts] = pipeline.sequential_forward(cfg, params, toks)
    np.testing.assert_allclose(got[4].numpy(), want, atol=2e-4, rtol=2e-4)
    assert torch.equal(got[4], got[0])


def test_pipeline_rejects_uneven_layer_split():
    """Twin of test_moe_pipeline.py:138."""
    with pytest.raises(ValueError, match="stages"):
        pipeline.init_pipeline_params(0, _pp_cfg(n_layers=5), n_stages=4,
                                      device="cpu")


def test_pipeline_makes_one_hop_a_tick(ranks):
    """In place of test_moe_pipeline.py:146 (a lowered XLA program's
    collective-permutes): every rank's forward makes one hop to the next
    stage a tick, M + P - 1 = 7 for 4 microbatches over 4 stages, and no
    gather of the activations."""
    for r in ranks:
        assert r["pipeline"]["forward_hops"] == N_MICRO + 4 - 1


def test_pipeline_specs_split_stages_over_pipe():
    """The reference's ``pipeline_param_specs``: the stacked leaves on
    "pipe", the rest replicated."""
    specs = pipeline.pipeline_param_specs()
    want = jax_pipeline.pipeline_param_specs()
    assert {k: tuple(v) for k, v in want["stages"].items()} == \
        specs["stages"]
    assert all(specs[k] == () == tuple(want[k])
               for k in ("embed", "pos", "out_norm"))


# -- multi-slice --------------------------------------------------------------

def test_multislice_mesh_shape(ranks):
    """Twin of test_long_context.py:134: ``make_multislice_mesh(2)`` over 8
    ranks is (2, 2, 2)."""
    for r in ranks:
        assert r["multislice"]["shape"] == {"dcn": 2, "data": 2,
                                            "model": 2}


def test_hierarchical_allreduce_matches_flat(ranks, inputs, jax_runs):
    """Twin of test_long_context.py:140: on (2, 2, 2) the hierarchical
    all-reduce equals the flat one, the plain sum over the "dcn" and
    "model" ranks, and JAX's, and leaves its input as it was."""
    total = inputs["blocks"].sum(0)
    for r in ranks:
        ms = r["multislice"]
        np.testing.assert_allclose(ms["hier"], ms["flat"], rtol=1e-5)
        np.testing.assert_allclose(ms["hier"], total, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ms["hier"],
                                   jax_runs["hier"][ms["block"]],
                                   rtol=1e-5, atol=1e-6)
        assert ms["input_kept"]


def test_multislice_mesh_over_part_of_the_world(ranks, inputs):
    """``make_multislice_mesh(2, ranks=range(4))`` over 8 ranks (JAX
    ``make_multislice_mesh(devices=...)``, test_multislice_e2e.py:206) is
    (2, 1, 2) on every rank; on ranks 0-3 its hierarchical all-reduce
    equals the flat one and the plain sum over those 4 ranks, ranks 4-7
    have no place on it, and 3 ranks do not split into 2 slices."""
    total = inputs["blocks"].sum(0)
    for r in ranks:
        ms = r["multislice"]
        assert ms["part_shape"] == {"dcn": 2, "data": 1, "model": 2}
        assert ms["part_placed"] == (r["rank"] < 4), r["rank"]
        assert ms["part_uneven"] == (
            "ValueError", "3 devices do not split into 2 slices")
        if r["rank"] < 4:
            np.testing.assert_allclose(ms["part_hier"], ms["part_flat"],
                                       rtol=1e-5)
            np.testing.assert_allclose(ms["part_hier"], total, rtol=1e-5,
                                       atol=1e-6)


def test_dcn_traffic_model():
    """Twin of test_long_context.py:149, and the JAX function's values."""
    flat = dcn_bytes_per_host(1 << 20, n_ici=4, n_slices=2,
                              hierarchical=False)
    hier = dcn_bytes_per_host(1 << 20, n_ici=4, n_slices=2)
    assert hier == flat / 4
    assert dcn_bytes_per_host(1 << 20, 4, 1) == 0.0
    for args in ((1 << 20, 4, 2), (3000, 2, 4), (1 << 20, 4, 1)):
        for h in (True, False):
            assert dcn_bytes_per_host(*args, hierarchical=h) == \
                jax_dcn_bytes_per_host(*args, hierarchical=h)


def test_multislice_train_step_shards_batch_over_dcn(ranks, jax_runs):
    """Twin of test_multislice_e2e.py:240: the batch splits over ("dcn",
    "data"), slice-major (rank (c, d, m) holds rows 2 (2c + d) and
    2 (2c + d) + 1 of 8), no parameter splits over "dcn", and 3 fp32 steps
    equal JAX ``make_train_step`` on the same mesh."""
    for r in ranks:
        ms = r["multislice"]
        assert ms["batch_axes"] == ("dcn", "data")
        assert not ms["dcn_in_specs"]
        c, d = divmod(r["rank"] // 2, 2)
        np.testing.assert_array_equal(ms["rows"],
                                      [2 * (2 * c + d), 2 * (2 * c + d) + 1])
        assert ms["train"]["losses"] == ranks[0]["multislice"]["train"][
            "losses"]
    run = ranks[0]["multislice"]["train"]
    _hold(run["losses"], run["params"], *jax_runs["dcn"])


# -- the re-sharding restore --------------------------------------------------

def test_restore_onto_different_mesh_factoring(ranks):
    """Twin of test_checkpoint.py:51/:64: saved on (2, 4) after 3 steps,
    restored onto (4, 2) (``wqkv`` re-sharded: 3D / 2 columns a rank), the
    next step's loss equals the unbroken run's; restored onto one device
    with no mesh, the same."""
    for r in ranks:
        rs = r["restores"]
        assert rs["restored_step"] == 3
        assert rs["wqkv_shape"] == (64, 3 * 64 // 2)
        assert abs(rs["resumed"] - rs["unbroken"]) < 1e-5, rs
    one = ranks[0]["restores"]
    assert abs(one["one_device"] - one["unbroken"]) < 1e-5, one


def test_restore_of_a_narrower_model_onto_a_mesh_is_refused(ranks):
    """The (2, 4) state restored into a model of d_model 32 raises the same
    ValueError with the (2, 4) mesh as without one, naming the global
    shapes and not the rank's shards (``embed`` splits its vocabulary
    over "model"), and leaves the caller's shards and optimizer as they
    were."""
    want = ("ValueError", "checkpoint step 3: leaf embed is (64, 64) "
            "torch.float32, the model's (64, 32) torch.float32")
    for r in ranks:
        rs = r["restores"]
        assert rs["narrow_mesh"] == want, r["rank"]
        assert rs["narrow_none"] == want, r["rank"]
        assert rs["narrow_mesh_kept"] and rs["narrow_none_kept"], r["rank"]


def test_checkpoint_pipeline_params_roundtrip(ranks):
    """Twin of test_checkpoint.py:103: a stage-stacked train state saved
    on (4, 2) ("pipe", "data") restores into a fresh state, every rank's
    ``wqkv`` stage equal."""
    assert all(r["restores"]["pipeline_wqkv_equal"] for r in ranks)


def test_multislice_checkpoint_resumes_on_single_slice(ranks):
    """Twin of test_checkpoint.py:128: a state saved on (2, 2, 2) ("dcn",
    "data", "model") restores onto a (2, 2) mesh of ranks 0-3 (the
    surviving slice): the first leaf carries over exactly (parameters
    replicate over "dcn"), and training continues there."""
    small = [r for r in ranks if r["rank"] < 4]
    assert len(small) == 4
    for r in small:
        rs = r["restores"]
        np.testing.assert_array_equal(rs["small_first_leaf"],
                                      rs["dcn_first_leaf"])
        assert np.isfinite(rs["small_loss"]) and rs["small_loss"] > 0
