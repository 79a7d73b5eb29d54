"""Head dim 256 in the PyTorch/CUDA port against the JAX package.

Every CUDA attention route runs head dims 1-256 (D 129-255 zero-padded to
256). On the CPU the port takes its plain versions; these tests hold them
against the JAX package at head dim 256 on the same numpy inputs and
bridged weights: a tiny model of d_model 512 over 2 heads (the JAX
``init_params`` tree through numpy), its fp32 greedy stream and KV8 stream
against JAX ``generate``, and one training step (loss and every gradient
leaf, the Pallas kernels in interpret mode) within the limits of
``tests/test_torch_train.py``. The kernels themselves run on the card in
``tests/test_torch_tc.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpu_operator_tpu.ops.flash_attention import \
    flash_attention_vjp as jax_flash_vjp
from dpu_operator_tpu.workloads import decode as jdecode
from dpu_operator_tpu.workloads import model as jmodel
from dpu_operator_tpu_torch.ops import flash_attention_vjp
from dpu_operator_tpu_torch.workloads import decode as tdecode
from dpu_operator_tpu_torch.workloads import model as tmodel
from dpu_operator_tpu_torch.workloads.train import (make_train_step,
                                                    param_leaves)

#: a tiny model at head dim 256: d_model 512 over 2 heads
SHAPE = dict(vocab=256, d_model=512, n_heads=2, n_layers=2, d_ff=1024,
             max_seq=64)
#: tests/test_torch_train.py's limits for one train step against JAX:
#: loss absolute, each gradient leaf relative to max(1, |JAX|)
LOSS_TOL = GRAD_TOL = 1e-4


def _configs(attention="standard"):
    return (jmodel.TransformerConfig(dtype=jnp.float32, attention=attention,
                                     **SHAPE),
            tmodel.TransformerConfig(dtype=torch.float32,
                                     attention=attention, **SHAPE))


@pytest.fixture(scope="module")
def bridged():
    """(jcfg, JAX params, tcfg, the same weights in the port)."""
    jcfg, tcfg = _configs()
    assert tcfg.d_head == 256
    jparams = jmodel.init_params(jax.random.key(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, tcfg, tmodel.params_from_numpy(tree, tcfg,
                                                         device="cpu")


def _prompt(seed, shape):
    return np.random.default_rng(seed).integers(0, SHAPE["vocab"], shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32", "kv8"])
def test_greedy_stream_at_head_dim_256_equals_jax(bridged, kv_int8):
    """The fp32 greedy stream, and the stream over the int8 KV cache
    (KV8), of both packages from the same weights and prompt: equal."""
    jcfg, jparams, tcfg, tparams = bridged
    prompt = _prompt(1, (2, 8))
    want = np.asarray(jdecode.generate(jparams, jcfg, jnp.asarray(prompt),
                                       12, kv_int8=kv_int8))
    got = tdecode.generate(tparams, tcfg, torch.from_numpy(prompt), 12,
                           device="cpu", kv_int8=kv_int8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_forward_logits_at_head_dim_256_match_jax(bridged):
    jcfg, jparams, tcfg, tparams = bridged
    tokens = _prompt(2, (2, 16))
    want = np.asarray(jmodel.forward(jparams, jnp.asarray(tokens), jcfg))
    got = tmodel.forward(tparams, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))


def test_train_step_at_head_dim_256_matches_jax():
    """One step's loss and every gradient leaf (the flash VJP: the Pallas
    forward with the lse, dQ and dK/dV in interpret mode on the JAX side)
    within tests/test_torch_train.py's limits."""
    jcfg, tcfg = _configs("flash")
    tree = jmodel.init_params(jax.random.key(3), jcfg)
    np_tree = jax.tree_util.tree_map(np.asarray, tree)
    jbatch = jmodel.make_example_batch(jcfg, batch=2, seq=32)
    loss_j, grads_j = jax.value_and_grad(jmodel.loss_fn)(tree, jbatch, jcfg)
    _, init_state, place = make_train_step(tcfg, device="cpu")
    params, _ = init_state(params=tmodel.params_from_numpy(np_tree, tcfg,
                                                           device="cpu"))
    loss = tmodel.loss_fn(params, place(tmodel.make_example_batch(
        tcfg, batch=2, seq=32)), tcfg)
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= LOSS_TOL
    want = [grads_j["embed"], grads_j["pos"], grads_j["out_norm"]]
    for lp in grads_j["layers"]:
        want.extend(lp[n] for n in ("ln1", "wqkv", "wo", "ln2", "w1", "w2"))
    leaves = param_leaves(params)
    assert len(leaves) == len(want)
    for i, (p, w) in enumerate(zip(leaves, want)):
        err = _scaled_err(p.grad.numpy(), np.asarray(w, np.float32))
        assert err <= GRAD_TOL, f"leaf {i}: {err}"


@pytest.mark.parametrize("d", [160, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_vjp_at_wide_head_dims_matches_jax(d, causal):
    """The plain forward and backward (what the card pads D 160 to 256 and
    launches) against JAX ``flash_attention_vjp`` in interpret mode: loss
    sum(sin(o)) as tests/test_torch_train.py, fp32 within its 5e-5."""
    rng = np.random.default_rng(13)
    q, k, v = (rng.standard_normal((2, 32, 2, d)).astype(np.float32)
               for _ in range(3))

    def loss_j(q, k, v):
        return jnp.sum(jnp.sin(jax_flash_vjp(q, k, v, causal, 16, 16)))

    want = jax.grad(loss_j, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    torch.sin(flash_attention_vjp(*ts, causal=causal)).sum().backward()
    for t, w, name in zip(ts, want, "qkv"):
        err = _scaled_err(t.grad.numpy(), np.asarray(w))
        assert err <= 5e-5, f"d{name}: {err}"
