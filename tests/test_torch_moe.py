"""MoE of the PyTorch/CUDA port against the JAX package, on the CPU.

The same expert weights (the JAX ``init_params`` / ``init_moe_params``
trees, bridged through numpy) and the same numpy inputs go through both
packages. The port's ``moe_ffn`` gathers the kept tokens into the expert
batch and scatters them back where the JAX function multiplies one-hot
matrices: each output has one nonzero term either way, so in fp32 the two
agree to float noise (1e-5 scaled) and the routing, the drops and the aux
loss are the same; in bf16 the expert products round in different places
and a tolerance of a few bf16 steps holds. Then the model: forward with
its aux, the loss and its gradients, decode, verify and a padded chunk
routed per batch row, greedy streams, the quantized tree, the scheduler
over a tiny MoE ``TorchSlotExecutor``, checkpoints and the parameter
accounting. The twins of tests/test_moe_pipeline.py (:20, :34, :52),
tests/test_decode.py:71, tests/test_perf_accounting.py (:67, :81) and
tests/test_checkpoint.py:76 are named in their docstrings.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpu_operator_tpu.workloads import decode as jdecode
from dpu_operator_tpu.workloads import model as jmodel
from dpu_operator_tpu.workloads import moe as jmoe
from dpu_operator_tpu.workloads import perf as jperf
from dpu_operator_tpu.workloads import serve as jserve
from dpu_operator_tpu_torch.workloads import decode as tdecode
from dpu_operator_tpu_torch.workloads import model as tmodel
from dpu_operator_tpu_torch.workloads import moe as tmoe
from dpu_operator_tpu_torch.workloads import perf as tperf
from dpu_operator_tpu_torch.workloads import serve as tserve
from dpu_operator_tpu_torch.workloads.checkpoint import TrainCheckpointer
from dpu_operator_tpu_torch.workloads.train import (make_train_step,
                                                    named_leaves,
                                                    param_leaves)

#: the JAX decode test's MoE config (tests/test_decode.py:77): capacity
#: factor 8 covers every chunk and prompt, so nothing is dropped
COVER = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=32, moe_experts=4, moe_capacity_factor=8.0)
#: a config at the default capacity factor 1.25, where tokens drop
DROPS = dict(vocab=96, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=48, moe_experts=4)

#: fp32: the gather and the one-hot einsum differ only in float noise
F32_TOL = 1e-5
#: bf16: a few rounding steps (2^-8 relative) of the expert products
BF16_TOL = 3e-2


def _bridge(shape, dtype="float32", seed=3):
    jcfg = jmodel.TransformerConfig(dtype=jnp.dtype(dtype), **shape)
    tcfg = tmodel.TransformerConfig(dtype=getattr(torch, dtype), **shape)
    jparams = jmodel.init_params(jax.random.key(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, tcfg, tmodel.params_from_numpy(tree, tcfg,
                                                         device="cpu")


@pytest.fixture(scope="module")
def cover():
    return _bridge(COVER)


@pytest.fixture(scope="module")
def drops():
    return _bridge(DROPS)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _moe_pair(seed, d, f, e, dtype):
    jp = jmoe.init_moe_params(jax.random.key(seed), d, f, e,
                              dtype=jnp.dtype(dtype))
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(
        getattr(torch, dtype)) for k, v in jp.items()}
    return jp, tp


def _scaled(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))


# -- moe.py: the twins of tests/test_moe_pipeline.py --------------------------

def test_single_expert_moe_equals_dense_ffn():
    """test_moe_pipeline.py:20: one expert takes every token with gate
    1.0, so the MoE FFN is the dense FFN of its weights and aux is 1."""
    gen = torch.Generator().manual_seed(0)
    d, f = 16, 32
    params = tmoe.init_moe_params(gen, d, f, 1, torch.float32,
                                  torch.device("cpu"))
    x = torch.from_numpy(_x(1, (2, 8, d)))
    out, aux = tmoe.moe_ffn(params, x, capacity_factor=1.0)
    dense = torch.nn.functional.gelu(x @ params["w1"][0],
                                     approximate="tanh") @ params["w2"][0]
    torch.testing.assert_close(out, dense, atol=1e-5, rtol=1e-5)
    assert float(aux) == pytest.approx(1.0)


def test_moe_capacity_drops_overflow_tokens():
    """test_moe_pipeline.py:34: tokens past an expert's capacity give a
    zero row; the survivors are min(routed, capacity) per expert, and the
    outputs equal the JAX function's on the same weights."""
    d, f = 8, 16
    jp, tp = _moe_pair(0, d, f, 2, "float32")
    x = _x(1, (1, 64, d))
    out, _ = tmoe.moe_ffn(tp, torch.from_numpy(x), capacity_factor=0.25)
    cap = tmoe.moe_capacity(64, 2, 0.25)
    idx = np.argmax(x.reshape(64, d) @ np.asarray(jp["wg"]), axis=-1)
    expected = int(np.minimum(np.bincount(idx, minlength=2), cap).sum())
    assert int((out[0] != 0).any(-1).sum()) == expected
    assert expected < 64
    want, _ = jmoe.moe_ffn(jp, jnp.asarray(x), capacity_factor=0.25)
    assert _scaled(out.numpy(), want) <= F32_TOL


@pytest.mark.parametrize("n,e,cf", [(64, 2, 0.25), (1000, 8, 1.25),
                                    (4, 4, 1.0), (1, 8, 1.25), (5, 8, 1.25),
                                    (256, 8, 1.25), (1024, 8, 1.25),
                                    (40, 4, 1.25), (7, 3, 8.0)])
def test_moe_capacity_is_the_jax_multiple_of_8(n, e, cf):
    """test_moe_pipeline.py:52: the capacity is a multiple of 8, at least
    8, and the JAX formula's."""
    cap = tmoe.moe_capacity(n, e, cf)
    assert cap == jmoe.moe_capacity(n, e, cf)
    assert cap % 8 == 0 and cap >= 8


# -- moe_ffn against the JAX function -----------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("cf", [8.0, 1.25, 0.5])
def test_moe_ffn_output_and_aux_match_jax(dtype, tol, cf):
    """Output and aux of both functions on the same weights and input,
    three rows of 64 tokens over 4 experts: capacity covering, the default
    1.25 and 0.5 (capacity 8 for 16 tokens an expert), where rows drop
    tokens. fp32 within float noise;
    bf16 within a few rounding steps. The router is fp32 on both sides,
    so the kept tokens are the same set."""
    d, f, e = 16, 32, 4
    jp, tp = _moe_pair(5, d, f, e, dtype)
    x = _x(6, (3, 64, d))
    xj = jnp.asarray(x, jnp.dtype(dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want, aux_j = jmoe.moe_ffn(jp, xj, capacity_factor=cf)
    got, aux = tmoe.moe_ffn(tp, xt, capacity_factor=cf)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    assert _scaled(got.float().numpy(), np.asarray(want, np.float32)) <= tol
    assert abs(float(aux) - float(aux_j)) <= 1e-6
    zero_j = ~np.asarray(want, np.float32).any(-1)
    zero_t = ~got.float().numpy().any(-1)
    np.testing.assert_array_equal(zero_t, zero_j)
    if cf == 0.5:
        assert zero_t.any()   # the small capacity really dropped tokens


def test_moe_ffn_ties_go_to_the_lowest_expert():
    """A router whose columns are equal gives every token the same
    probability for each expert: argmax picks expert 0, as jnp.argmax."""
    d, f, e = 8, 16, 4
    jp, tp = _moe_pair(7, d, f, e, "float32")
    wg = np.repeat(np.asarray(jp["wg"])[:, :1], e, axis=1)
    jp = dict(jp, wg=jnp.asarray(wg))
    tp = dict(tp, wg=torch.from_numpy(wg))
    x = _x(8, (2, 8, d))
    got, _ = tmoe.moe_ffn(tp, torch.from_numpy(x), capacity_factor=8.0)
    want, _ = jmoe.moe_ffn(jp, jnp.asarray(x), capacity_factor=8.0)
    assert _scaled(got.numpy(), want) <= F32_TOL
    dense = torch.nn.functional.gelu(torch.from_numpy(x) @ tp["w1"][0],
                                     approximate="tanh") @ tp["w2"][0]
    torch.testing.assert_close(got, dense / e, atol=1e-5, rtol=1e-5)


def test_moe_ffn_grads_match_jax():
    """Gradients of wg, w1, w2 and x through a loss of the output and the
    aux, at a capacity that drops tokens, against jax.grad."""
    d, f, e = 8, 16, 4
    jp, tp = _moe_pair(9, d, f, e, "float32")
    x = _x(10, (2, 16, d))
    cot = _x(11, (2, 16, d))

    def jloss(p, xx):
        out, aux = jmoe.moe_ffn(p, xx, capacity_factor=1.0)
        return jnp.sum(out * cot) + 0.5 * aux

    gp, gx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.moe_ffn(tp, xt, capacity_factor=1.0)
    ((out * torch.from_numpy(cot)).sum() + 0.5 * aux).backward()
    for name in ("wg", "w1", "w2"):
        assert _scaled(tp[name].grad.numpy(), gp[name]) <= 1e-5, name
    assert _scaled(xt.grad.numpy(), gx) <= 1e-5


# -- the model ----------------------------------------------------------------

def test_moe_layers_and_tree_match_jax(cover):
    jcfg, jparams, tcfg, tparams = cover
    assert [tcfg.is_moe_layer(i) for i in range(4)] \
        == [jcfg.is_moe_layer(i) for i in range(4)] \
        == [False, True, False, True]
    for jl, tl in zip(jparams["layers"], tparams["layers"]):
        assert set(tl) == set(jl)
    assert set(tparams["layers"][1]["moe"]) == {"wg", "w1", "w2"}
    own = tmodel.init_params(0, tcfg, device="cpu")
    for i, (jl, tl) in enumerate(zip(jparams["layers"], own["layers"])):
        shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jl)
        assert {k: (tuple(v.shape) if not isinstance(v, dict) else
                    {n: tuple(t.shape) for n, t in v.items()})
                for k, v in tl.items()} == shapes, i


@pytest.mark.parametrize("remat", [False, True])
def test_forward_with_aux_and_loss_match_jax(drops, remat):
    """forward(return_aux=True) and loss_fn against JAX at the default
    capacity factor (tokens drop in the 32-token rows), with and without
    remat (torch.utils.checkpoint), fp32."""
    jcfg, jparams, tcfg, tparams = drops
    tcfg = dataclasses.replace(tcfg, remat=remat)
    tokens = _tokens(12, (3, 32), DROPS["vocab"])
    want, aux_j = jmodel.forward(jparams, jnp.asarray(tokens), jcfg,
                                 return_aux=True)
    got, aux = tmodel.forward(tparams, torch.from_numpy(tokens), tcfg,
                              return_aux=True)
    assert aux.dtype == torch.float32 and aux.ndim == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    assert abs(float(aux) - float(aux_j)) <= 1e-6
    batch = jmodel.make_example_batch(jcfg, batch=3, seq=32)
    loss_j = jmodel.loss_fn(jparams, batch, jcfg)
    loss = tmodel.loss_fn(tparams, tmodel.make_example_batch(tcfg, 3, 32),
                          tcfg)
    assert abs(float(loss) - float(loss_j)) <= 1e-5 * abs(float(loss_j))


def test_dense_forward_aux_is_zero():
    cfg = dataclasses.replace(tmodel.TransformerConfig(dtype=torch.float32),
                              n_layers=2, max_seq=16)
    params = tmodel.init_params(0, cfg, device="cpu")
    logits, aux = tmodel.forward(params, torch.zeros((1, 8), dtype=torch.long),
                                 cfg, return_aux=True)
    assert float(aux) == 0.0 and logits.shape == (1, 8, cfg.vocab)


def _jax_moe_leaves(tree):
    out = [tree["embed"], tree["pos"], tree["out_norm"]]
    for lp in tree["layers"]:
        out.extend(lp[n] for n in ("ln1", "wqkv", "wo", "ln2"))
        out.extend(lp["moe"][n] for n in ("wg", "w1", "w2")) if "moe" in lp \
            else out.extend(lp[n] for n in ("w1", "w2"))
    return [np.asarray(a, np.float32) for a in out]


@pytest.mark.parametrize("remat", [False, True])
def test_loss_gradients_match_jax_grad(drops, remat):
    """Every gradient leaf of loss_fn (the routers and experts included)
    against jax.value_and_grad, within 1e-4 of max(1, |JAX|), fp32."""
    jcfg, jparams, tcfg, tparams = drops
    tcfg = dataclasses.replace(tcfg, remat=remat)
    jbatch = jmodel.make_example_batch(jcfg, batch=2, seq=32)
    loss_j, grads_j = jax.value_and_grad(jmodel.loss_fn)(jparams, jbatch,
                                                        jcfg)
    _, init_state, place = make_train_step(tcfg, device="cpu")
    params, _ = init_state(params=tparams)
    loss = tmodel.loss_fn(params, place(tmodel.make_example_batch(tcfg, 2,
                                                                  32)), tcfg)
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    names = [n for n, _ in named_leaves(params)]
    assert "layers.1.moe.wg" in names and "layers.1.w1" not in names
    for name, p, g in zip(names, param_leaves(params),
                          _jax_moe_leaves(grads_j)):
        assert p.grad is not None, name
        assert _scaled(p.grad.numpy(), g) <= 1e-4, name


def test_moe_train_step_loss_decreases():
    """test_moe_pipeline.py's train step without the mesh: a bf16 MoE
    model memorising one batch, three AdamW steps, every gradient leaf
    finite and non-zero (the router included)."""
    cfg = tmodel.TransformerConfig(n_layers=2, d_model=32, n_heads=4,
                                   d_ff=64, max_seq=32, vocab=128,
                                   moe_experts=8)
    step, init_state, place = make_train_step(cfg, device="cpu")
    params, opt = init_state(seed=0)
    batch = place(tmodel.make_example_batch(cfg, 4))
    losses = []
    for _ in range(3):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    for name, p in named_leaves(params):
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert p.grad.abs().max() > 0, name


# -- decode, verify and chunks, routed per row --------------------------------

def _reference_generate(params, cfg, prompt, steps):
    """Greedy tokens by full forwards over the growing sequence: the
    training function, no cache."""
    seq = torch.as_tensor(prompt).long()
    for _ in range(steps):
        logits = tmodel.forward(params, seq, cfg)
        seq = torch.cat([seq, logits[:, -1].argmax(-1, keepdim=True)], 1)
    return seq[:, prompt.shape[1]:]


def test_moe_decode_matches_forward_when_capacity_covers(cover):
    """tests/test_decode.py:71: at a covering capacity the forward drops
    nothing, so generate equals greedy full forwards exactly, and equals
    the JAX generate's stream on the same weights."""
    jcfg, jparams, tcfg, tparams = cover
    prompt = _tokens(4, (2, 4), COVER["vocab"])
    got = tdecode.generate(tparams, tcfg, torch.from_numpy(prompt), 6,
                           device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), _reference_generate(tparams, tcfg, prompt, 6).numpy())
    want = jdecode.generate(jparams, jcfg, jnp.asarray(prompt), steps=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_streams_equal_jax_at_the_default_capacity(drops):
    """At capacity factor 1.25 the prompt's prefill drops tokens; decode
    routes each slot's one token (capacity 8) and drops none. Both
    packages do the same, so the fp32 streams are equal."""
    jcfg, jparams, tcfg, tparams = drops
    prompt = _tokens(13, (3, 20), DROPS["vocab"])
    want = jdecode.generate(jparams, jcfg, jnp.asarray(prompt), steps=12)
    got = tdecode.generate(tparams, tcfg, torch.from_numpy(prompt), 12,
                           device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_and_verify_route_each_row_on_its_own(drops):
    """decode_step over 8 slots and verify_step over 8 rows of 5 tokens at
    per-row positions against the JAX functions: each row routes alone (a
    verify row's 5 tokens have capacity 8 and drop nothing; the 40 tokens
    of the batch flattened into one group would get capacity 16 over 4
    experts and drop some). The logits agree in fp32, and a row's logits
    do not depend on the other rows."""
    jcfg, jparams, tcfg, tparams = drops
    prompt = _tokens(14, (8, 12), DROPS["vocab"])
    jcache, _ = jdecode.prefill(jparams, jcfg, jnp.asarray(prompt))
    tcache, _ = tdecode.prefill(tparams, tcfg, torch.from_numpy(prompt))
    pos = np.asarray([12, 3, 7, 12, 0, 9, 11, 5], np.int32)
    tok1 = _tokens(15, (8,), DROPS["vocab"])
    jl, jcache = jdecode.decode_step(jparams, jcfg, jcache,
                                     jnp.asarray(tok1), jnp.asarray(pos))
    tl, tcache = tdecode.decode_step(tparams, tcfg, tcache,
                                     torch.from_numpy(tok1).long(),
                                     torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    rows = _tokens(16, (8, 5), DROPS["vocab"])
    jv, _ = jdecode.verify_step(jparams, jcfg, jcache, jnp.asarray(rows),
                                jnp.asarray(pos + 1))
    before = [{k: t.clone() for k, t in layer.items()} for layer in tcache]
    tv, _ = tdecode.verify_step(tparams, tcfg, tcache,
                                torch.from_numpy(rows).long(),
                                torch.from_numpy(pos + 1))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4,
                               rtol=1e-4)
    # row 2 alone, on its own copy of the cache, gives the same logits
    alone = [{k: t[2:3].clone() for k, t in layer.items()}
             for layer in before]
    one, _ = tdecode.verify_step(tparams, tcfg, alone,
                                 torch.from_numpy(rows[2:3]).long(),
                                 torch.from_numpy(pos[2:3] + 1))
    torch.testing.assert_close(one[0], tv[2], atol=1e-5, rtol=1e-5)


def test_padded_chunk_routes_over_its_width_as_jax(drops):
    """A chunk of width 16 holding 5 real tokens routes over all 16 rows
    (capacity from 16, the padding after the real tokens), as the JAX
    prefill_chunk does: the last valid row's logits and the written K/V
    agree with JAX's in fp32."""
    jcfg, jparams, tcfg, tparams = drops
    jcache = jdecode.init_kv_cache(jcfg, 3)
    tcache = tdecode.init_kv_cache(tcfg, 3, device="cpu")
    ids = _tokens(17, (21,), DROPS["vocab"])
    for offset, n in ((0, 16), (16, 5)):
        chunk = np.zeros(16, np.int32)
        chunk[:n] = ids[offset:offset + n]
        jcache, jl = jdecode.prefill_chunk(
            jparams, jcfg, jcache, jnp.int32(1), jnp.asarray(chunk),
            jnp.int32(offset), jnp.int32(n))
        tcache, tl = tdecode.prefill_chunk(
            tparams, tcfg, tcache, 1, torch.from_numpy(chunk).long(),
            offset, n)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
    for jlay, tlay in zip(jcache, tcache):
        for key in ("k", "v"):
            np.testing.assert_allclose(tlay[key][1, :21].numpy(),
                                       np.asarray(jlay[key])[1, :21],
                                       atol=1e-5, rtol=1e-5)


def test_chunked_prefill_equals_whole_prefill_when_capacity_covers(cover):
    """At the covering capacity a chunked prefill's last logits equal the
    whole prefill's (the port's invariant test at the JAX test's factor
    8.0)."""
    _, _, tcfg, tparams = cover
    ids = _tokens(18, (13,), COVER["vocab"])
    _, whole = tdecode.prefill(tparams, tcfg,
                               torch.from_numpy(ids[None]).long())
    cache = tdecode.init_kv_cache(tcfg, 2, device="cpu")
    for offset in (0, 8):
        chunk = np.zeros(8, np.int64)
        n = min(8, len(ids) - offset)
        chunk[:n] = ids[offset:offset + n]
        cache, last = tdecode.prefill_chunk(tparams, tcfg, cache, 0,
                                            torch.from_numpy(chunk),
                                            offset, n)
    torch.testing.assert_close(last, whole[0], atol=1e-5, rtol=1e-5)


# -- the quantized tree -------------------------------------------------------

def test_quantized_tree_keeps_the_experts_and_serves(drops):
    """quantize_decode_params leaves every moe subtree as it is (JAX
    decode.py:66-67) and quantizes the rest as the JAX tree; a W8A8 + KV8
    MoE stream equals the JAX one in fp32."""
    jcfg, jparams, tcfg, tparams = drops
    jq = jdecode.quantize_decode_params(jparams)
    tq = tdecode.quantize_decode_params(tparams)
    for jl, tl, raw in zip(jq["layers"], tq["layers"], tparams["layers"]):
        assert set(tl) == set(jl)
        if "moe" in tl:
            assert tl["moe"] is raw["moe"]
            assert "w1" not in tl
        for name in ("wqkv", "wo"):
            np.testing.assert_array_equal(tl[name]["q"].numpy(),
                                          np.asarray(jl[name]["q"]))
    prompt = _tokens(19, (2, 10), DROPS["vocab"])
    want = jdecode.generate(jq, jcfg, jnp.asarray(prompt), steps=8,
                            kv_int8=True)
    got = tdecode.generate(tq, tcfg, torch.from_numpy(prompt), 8,
                           device="cpu", kv_int8=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the scheduler over a tiny MoE executor -----------------------------------

def _serve_requests(seed, n, vocab):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = int(rng.integers(3, 20))
        out.append((f"m{i}", tuple(int(t) for t in rng.integers(0, vocab, p)),
                    int(rng.integers(2, 9))))
    return out


@pytest.mark.parametrize("chunk", [0, 8])
def test_scheduler_over_a_moe_executor_matches_jax(cover, chunk):
    """Both packages' Scheduler over their slot executors on the same MoE
    weights at the covering capacity: equal traces, equal streams, equal
    to the port's generate, every block returned."""
    jcfg, jparams, tcfg, tparams = cover
    reqs = _serve_requests(20, 5, COVER["vocab"])
    traces, streams = {}, {}
    for side, (srv, ex) in {
            "jax": (jserve, jserve.JaxSlotExecutor(jparams, jcfg, slots=2,
                                                   chunk_tokens=chunk)),
            "port": (tserve, tserve.TorchSlotExecutor(
                tparams, tcfg, slots=2, chunk_tokens=chunk,
                device="cpu"))}.items():
        sched = srv.Scheduler(srv.ServeConfig(slots=2, kv_blocks=16,
                                              kv_block_size=8,
                                              prefill_chunk_tokens=chunk), ex)
        for rid, prompt, n in reqs:
            sched.submit(srv.Request(rid=rid, prompt_len=len(prompt),
                                     output_len=n, prompt=prompt))
        sched.run()
        assert len(sched.completed) == len(reqs), side
        assert sched.pool.outstanding() == 0, side
        traces[side] = list(sched.trace)
        streams[side] = {r.rid: list(r.tokens) for r in sched.completed}
    assert traces["port"] == traces["jax"]
    assert streams["port"] == streams["jax"]
    for rid, prompt, n in reqs:
        want = tdecode.generate(tparams, tcfg, torch.tensor([prompt]), n,
                                device="cpu")[0].tolist()
        assert streams["port"][rid] == want, rid


# -- accounting and checkpoints -----------------------------------------------

def test_param_count_moe_closed_form():
    """tests/test_perf_accounting.py:67: MoE layers swap the dense FFN for
    a router and E expert FFNs, every moe_every-th layer."""
    cfg = tmodel.TransformerConfig(vocab=100, d_model=8, n_heads=2,
                                   n_layers=4, d_ff=32, max_seq=16,
                                   moe_experts=4)
    attn = 16 + 8 * 24 + 64
    dense_ffn = 8 * 32 + 32 * 8
    moe_ffn = 8 * 4 + 4 * dense_ffn
    expect = (100 * 8 + 16 * 8 + 8
              + 2 * (attn + dense_ffn) + 2 * (attn + moe_ffn))
    assert tperf.param_count(cfg) == expect
    assert tperf.active_param_count(cfg) == expect - 2 * 3 * dense_ffn


def test_param_count_moe_matches_actual_params():
    """tests/test_perf_accounting.py:81: the count equals the tree's
    elements, and param_bytes counts the moe subtree."""
    cfg = tmodel.TransformerConfig(vocab=64, d_model=8, n_heads=2,
                                   n_layers=2, d_ff=16, max_seq=16,
                                   moe_experts=4, dtype=torch.float32)
    params = tmodel.init_params(0, cfg, device="cpu")
    actual = sum(t.numel() for t in param_leaves(params))
    assert tperf.param_count(cfg) == actual
    assert tmodel.param_bytes(params) == 4 * actual


@pytest.mark.parametrize("shape", [
    dict(vocab=100, d_model=8, n_heads=2, n_layers=4, d_ff=32, max_seq=16,
         moe_experts=4),
    dict(vocab=32768, d_model=1536, n_heads=12, n_layers=12, d_ff=6144,
         max_seq=1024, moe_experts=8),
    dict(vocab=256, d_model=64, n_heads=4, n_layers=3, d_ff=128,
         max_seq=64, moe_experts=0)])
def test_counts_and_flops_equal_jax(shape):
    """param_count, active_param_count and train_step_flops equal the JAX
    package's (the 8-expert flagship: about 1.18B parameters, 391.7M of
    them active)."""
    jcfg = jmodel.TransformerConfig(**shape)
    tcfg = tmodel.TransformerConfig(**shape)
    assert tperf.param_count(tcfg) == jperf.param_count(jcfg)
    assert tperf.active_param_count(tcfg) == jperf.active_param_count(jcfg)
    assert tperf.train_step_flops(tcfg, 8, 1024) \
        == jperf.train_step_flops(jcfg, 8, 1024)
    if shape["moe_experts"] == 8:
        assert 1.18e9 < tperf.param_count(tcfg) < 1.19e9
        assert tperf.active_param_count(tcfg) == tperf.param_count(
            dataclasses.replace(tcfg, moe_experts=0)) + 6 * 1536 * 8


def test_checkpoint_moe_params_roundtrip(tmp_path):
    """tests/test_checkpoint.py:76: a MoE tree and its AdamW state save
    and restore like a dense one."""
    cfg = tmodel.TransformerConfig(n_layers=2, d_model=32, n_heads=4,
                                   d_ff=64, max_seq=32, vocab=64,
                                   moe_experts=8, dtype=torch.float32)
    step, init_state, place = make_train_step(cfg, device="cpu")
    params, opt = init_state(seed=0)
    params, opt, _ = step(params, opt, place(tmodel.make_example_batch(cfg,
                                                                       2)))
    ckpt = TrainCheckpointer(str(tmp_path / "moe-ckpt"))
    ckpt.save(3, params, opt)
    p2, o2 = init_state(seed=1)
    assert not torch.equal(p2["layers"][1]["moe"]["w1"],
                           params["layers"][1]["moe"]["w1"])
    p2, o2, step_n = ckpt.restore(p2, o2)
    assert step_n == 3
    for (name, a), (_, b) in zip(named_leaves(params), named_leaves(p2)):
        assert torch.equal(a, b), name
    assert len(o2.state_dict()["state"]) == len(param_leaves(params))
    ckpt.close()
