"""The training path of the PyTorch/CUDA port against the JAX package.

On the CPU every wrapper takes its plain PyTorch version. These tests hold
the forward-with-logsumexp, the dQ / dK-dV backward and the whole training
step (loss, every gradient leaf, AdamW) against the JAX package on the same
numpy inputs and bridged weights, the Pallas kernels running in interpret
mode as ``tests/test_ops.py`` runs them. The CUDA kernels themselves run in
the ``cuda`` tests, which skip without a card (``chip_smoke.py`` runs them
on one).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from dpu_operator_tpu.ops.flash_attention import _fwd_with_lse
from dpu_operator_tpu.ops.flash_attention import \
    flash_attention_vjp as jax_flash_vjp
from dpu_operator_tpu.workloads import model as jax_model
from dpu_operator_tpu_torch.ops import (
    FlashAttentionFn, attention_bwd_dkv, attention_bwd_dkv_plain,
    attention_bwd_dq, attention_bwd_dq_plain, attention_delta,
    attention_fwd_lse, attention_fwd_plain, flash_attention_vjp,
    fused_rmsnorm, fused_rmsnorm_plain, launch_counts)
from dpu_operator_tpu_torch.workloads import model
from dpu_operator_tpu_torch.workloads.checkpoint import TrainCheckpointer
from dpu_operator_tpu_torch.workloads.mesh import make_mesh
from dpu_operator_tpu_torch.workloads.perf import (CPU_PEAK_FLOPS,
                                                   measure_train,
                                                   param_count, peak_tflops,
                                                   train_step_flops)
from dpu_operator_tpu_torch.workloads.train import (make_train_step,
                                                    map_params, named_leaves,
                                                    param_leaves)

#: bf16 keeps 8 significant bits: one rounding step is 2^-8 relative
BF16_STEP = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode; "
                    "chip_smoke.py runs them on the card)")
    return torch.device("cuda")


def _qkv(seed, shape, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# -- (a) forward with logsumexp ----------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_fwd_lse_matches_jax_fwd_with_lse(dtype, causal):
    b, s, h, d = 2, 64, 2, 16
    q, k, v = _qkv(10, (b, s, h, d))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def bh(a):  # (B, S, H, D) -> (B*H, S, D), as _vjp_fwd reshapes
        return jnp.asarray(a, jdt).transpose(0, 2, 1, 3).reshape(b * h, s, d)

    out_j, lse_j = _fwd_with_lse(bh(q), bh(k), bh(v), causal, 16, 16,
                                        1.0 / np.sqrt(d), True)
    out, lse = attention_fwd_lse(_t(q, tdt), _t(k, tdt), _t(v, tdt), causal)
    assert out.dtype == tdt and lse.dtype == torch.float32
    assert lse.shape == (b, h, s)
    out_j = np.asarray(out_j, np.float32).reshape(b, h, s, d)
    out_t = out.float().numpy().transpose(0, 2, 1, 3)
    lse_j = np.asarray(lse_j).reshape(b, h, s)
    if dtype == "float32":
        np.testing.assert_allclose(out_t, out_j, atol=2e-6, rtol=1e-5)
        np.testing.assert_allclose(lse.numpy(), lse_j, atol=2e-6, rtol=1e-6)
    else:
        # P rounds to bf16 against another running max (JAX walks blocks
        # of 16, the port of 64); the lse is fp32 arithmetic either way
        assert _scaled_err(out_t, out_j) <= 2e-2
        np.testing.assert_allclose(lse.numpy(), lse_j, atol=1e-5, rtol=1e-6)


# -- (b) the custom VJP against JAX ------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 5e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_vjp_grads_match_jax(dtype, tol, causal):
    """Loss sum(sin(o)) as tests/test_ops.py; fp32 within 5e-5, bf16
    within 2e-2 of max(1, |JAX|)."""
    q, k, v = _qkv(11, (2, 64, 2, 16))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def loss_j(q, k, v):
        o = jax_flash_vjp(q, k, v, causal, 16, 16)
        return jnp.sum(jnp.sin(o.astype(jnp.float32)))

    want = jax.grad(loss_j, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    ts = [_t(a, tdt).requires_grad_() for a in (q, k, v)]
    o = flash_attention_vjp(*ts, causal=causal)
    assert o.grad_fn is not None
    torch.sin(o.float()).sum().backward()
    for t, w, name in zip(ts, want, "qkv"):
        assert t.grad.dtype == tdt
        err = _scaled_err(t.grad.float().numpy(), np.asarray(w, np.float32))
        assert err <= tol, f"d{name}: {err}"


# -- (c) the plain backward at a ragged S JAX cannot take --------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [50, 130])
def test_plain_backward_matches_autograd_at_ragged_s(causal, s):
    """dq / dk / dv of the plain block walks equal autograd through the
    plain forward within fp32 noise (4e-6 of max(1, |ref|))."""
    q, k, v, do = (_t(a) for a in _qkv(12, (2, s, 3, 32), n=4))
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_fwd_plain(*ts, causal=causal), ts,
                               do)
    out, lse = attention_fwd_lse(q, k, v, causal)
    delta = attention_delta(do, out)
    dq = attention_bwd_dq_plain(q, k, v, do, lse, delta, causal)
    dk, dv = attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal)
    for got, w, name in zip((dq, dk, dv), want, "qkv"):
        err = _scaled_err(got.numpy(), w.numpy())
        assert err <= 4e-6, f"d{name}: {err}"


def test_backward_wrappers_take_the_plain_version_on_cpu():
    q, k, v, do = (_t(a) for a in _qkv(13, (1, 40, 2, 32), n=4))
    out, lse = attention_fwd_lse(q, k, v)
    delta = attention_delta(do, out)
    before = launch_counts()
    assert torch.equal(attention_bwd_dq(q, k, v, do, lse, delta),
                       attention_bwd_dq_plain(q, k, v, do, lse, delta))
    for a, b in zip(attention_bwd_dkv(q, k, v, do, lse, delta),
                    attention_bwd_dkv_plain(q, k, v, do, lse, delta)):
        assert torch.equal(a, b)
    assert launch_counts() == before


def test_training_wrappers_refuse_other_devices_and_bad_shapes():
    q = torch.empty((1, 4, 2, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attention_fwd_lse(q, q, q)
    lse = torch.empty((1, 2, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attention_bwd_dq(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match="unsupported device"):
        attention_bwd_dkv(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match="one"):
        attention_fwd_lse(torch.zeros(1, 4, 2, 32), torch.zeros(1, 5, 2, 32),
                          torch.zeros(1, 5, 2, 32))


def test_flash_attention_vjp_without_grad_is_the_primal():
    q, k, v = (_t(a) for a in _qkv(14, (1, 20, 2, 16)))
    out = flash_attention_vjp(q, k, v)
    assert out.grad_fn is None
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    recorded = FlashAttentionFn.apply(*ts, True)
    assert torch.equal(out, recorded.detach())


# -- (d) RMSNorm's gradient ---------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-6),
                                       (torch.bfloat16, BF16_STEP)])
def test_rmsnorm_fn_gradient_matches_autograd_of_plain(dtype, tol):
    """RmsNormFn's closed-form backward against autograd through the plain
    fp32 formula (fp32 noise; bf16: one rounding step of each result)."""
    rng = np.random.default_rng(15)
    x = _t(rng.standard_normal((3, 7, 64)) * 2.0, dtype)
    scale = _t(1.0 + 0.1 * rng.standard_normal(64), dtype)
    dy = _t(rng.standard_normal((3, 7, 64)), dtype)
    a = [x.clone().requires_grad_(), scale.clone().requires_grad_()]
    b = [x.clone().requires_grad_(), scale.clone().requires_grad_()]
    y = fused_rmsnorm(*a)
    assert y.grad_fn is not None and "RmsNormFn" in type(y.grad_fn).__name__
    y.backward(dy)
    fused_rmsnorm_plain(*b).backward(dy)
    assert torch.equal(y, fused_rmsnorm_plain(x, scale))
    for got, want in zip(a, b):
        assert got.grad.dtype == dtype
        err = _scaled_err(got.grad.float().numpy(), want.grad.float().numpy())
        assert err <= tol, err


# -- (e) the training step against JAX ---------------------------------------

JAX_TINY = jax_model.TransformerConfig(
    vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq=32,
    dtype=jnp.float32, attention="flash")
TINY = model.TransformerConfig(vocab=64, d_model=64, n_heads=4, n_layers=2,
                               d_ff=128, max_seq=32, dtype=torch.float32,
                               attention="flash")


@pytest.fixture(scope="module")
def bridged():
    """The JAX tree of the tiny fp32 config, its numpy leaves, and the
    example batch of both frameworks (the same tokens)."""
    tree = jax_model.init_params(jax.random.key(3), JAX_TINY)
    np_tree = jax.tree_util.tree_map(np.asarray, tree)
    return tree, np_tree, jax_model.make_example_batch(JAX_TINY, batch=4)


#: JAX loss and gradient of the tiny config, compiled once for the module
_jax_value_and_grad = jax.jit(jax.value_and_grad(jax_model.loss_fn),
                              static_argnums=2)


def _jax_leaves(tree):
    out = [tree["embed"], tree["pos"], tree["out_norm"]]
    for lp in tree["layers"]:
        out.extend(lp[n] for n in ("ln1", "wqkv", "wo", "ln2", "w1", "w2"))
    return [np.asarray(a, np.float32) for a in out]


def test_make_example_batch_equals_jax():
    ours = model.make_example_batch(TINY, batch=3, seq=16)
    theirs = jax_model.make_example_batch(JAX_TINY, batch=3, seq=16)
    for key in ("tokens", "targets"):
        assert np.array_equal(ours[key].numpy(), np.asarray(theirs[key]))


def test_loss_and_every_gradient_leaf_match_jax(bridged):
    """loss_fn and all 15 gradient leaves within 1e-4 of max(1, |JAX|)."""
    tree, np_tree, jbatch = bridged
    loss_j, grads_j = _jax_value_and_grad(tree, jbatch, JAX_TINY)
    step, init_state, place = make_train_step(TINY, device="cpu")
    params, _ = init_state(params=model.params_from_numpy(np_tree, TINY,
                                                          device="cpu"))
    loss = model.loss_fn(params, place(model.make_example_batch(TINY, 4)),
                         TINY)
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= 1e-4
    leaves = param_leaves(params)
    assert len(leaves) == 3 + 6 * TINY.n_layers
    for i, (p, g) in enumerate(zip(leaves, _jax_leaves(grads_j))):
        assert p.grad is not None, f"leaf {i} got no gradient"
        err = _scaled_err(p.grad.numpy(), g)
        assert err <= 1e-4, f"leaf {i}: {err}"


def test_three_adamw_steps_match_optax(bridged):
    """Three steps of the port's AdamW against optax.adamw on the JAX side:
    losses within 1e-4 relative, parameters within 3 x lr (Adam's first
    step moves a weight by about +-lr, so a near-zero gradient may differ
    in sign)."""
    tree, np_tree, jbatch = bridged
    tx = optax.adamw(JAX_TINY.learning_rate)
    opt_j = tx.init(tree)
    step, init_state, place = make_train_step(TINY, device="cpu")
    params, opt = init_state(params=model.params_from_numpy(np_tree, TINY,
                                                            device="cpu"))
    batch = place(model.make_example_batch(TINY, 4))
    for _ in range(3):
        loss_j, g = _jax_value_and_grad(tree, jbatch, JAX_TINY)
        updates, opt_j = tx.update(g, opt_j, tree)
        tree = optax.apply_updates(tree, updates)
        params, opt, loss = step(params, opt, batch)
        assert abs(float(loss) - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    for p, w in zip(param_leaves(params), _jax_leaves(tree)):
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=3 * TINY.learning_rate)
    state = opt.state[param_leaves(params)[0]]
    assert state["exp_avg"].dtype == TINY.dtype
    assert opt.param_groups[0]["weight_decay"] == 1e-4


def test_every_layer_weight_gets_a_gradient():
    """The fault a kernel without autograd leaves: only the tied embedding
    would get a gradient. Every leaf must get a finite, non-zero one."""
    cfg = dataclasses.replace(TINY, dtype=torch.bfloat16)
    step, init_state, place = make_train_step(cfg, device="cpu")
    params, opt = init_state(seed=0)
    step(params, opt, place(model.make_example_batch(cfg, 2)))
    for i, p in enumerate(param_leaves(params)):
        assert p.grad is not None, f"leaf {i}"
        assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 0, i


# -- (f) loss falls, (g) remat --------------------------------------------------

def test_train_step_loss_decreases():
    """Memorising one batch must improve (test_workloads.py's check, bf16
    default config)."""
    cfg = model.TransformerConfig(n_layers=2, max_seq=32, attention="flash")
    step, init_state, place = make_train_step(cfg, device="cpu")
    params, opt = init_state(seed=0)
    batch = place(model.make_example_batch(cfg, batch=4, seq=32))
    losses = []
    for _ in range(5):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0]


def test_remat_train_step_matches_no_remat():
    """torch.utils.checkpoint layers: the same loss and gradients (fp32,
    identical arithmetic recomputed)."""
    results = {}
    for remat in (False, True):
        cfg = dataclasses.replace(TINY, remat=remat)
        step, init_state, place = make_train_step(cfg, device="cpu")
        params, opt = init_state(seed=1)
        loss = model.loss_fn(params, place(model.make_example_batch(cfg, 4)),
                             cfg)
        loss.backward()
        results[remat] = (loss.item(),
                          [p.grad.clone() for p in param_leaves(params)])
    assert abs(results[True][0] - results[False][0]) < 1e-5
    for a, b in zip(results[True][1], results[False][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


# -- (h) checkpointing -----------------------------------------------------------

def _trained(seed=0, steps=2, cfg=TINY, mesh=None):
    step, init_state, place = make_train_step(cfg, mesh, device="cpu")
    params, opt = init_state(seed=seed)
    batch = place(model.make_example_batch(cfg, 4))
    for _ in range(steps):
        params, opt, _ = step(params, opt, batch)
    return step, init_state, batch, params, opt


def test_checkpoint_save_restore_resumes_the_same_run(tmp_path):
    step, init_state, batch, params, opt = _trained()
    ckpt = TrainCheckpointer(str(tmp_path / "ckpt"))
    ckpt.save(2, params, opt)
    assert ckpt.latest_step() == 2
    p0, o0 = init_state(seed=5)     # other weights, fresh optimizer
    p, o, step_no = ckpt.restore(p0, o0)
    assert step_no == 2 and p is p0
    for a, b in zip(param_leaves(p), param_leaves(params)):
        assert torch.equal(a, b)
    _, _, loss_a = step(p, o, batch)
    _, _, loss_b = step(params, opt, batch)
    assert float(loss_a) == float(loss_b)
    ckpt.close()


@pytest.fixture(params=["no mesh", "one-rank mesh"])
def restore_mesh(request):
    """None, or a one-rank gloo ("data", "model") mesh in this process
    whose group the finalizer ends, so no group outlives the test."""
    if request.param == "no mesh":
        return None
    assert not dist.is_initialized()
    request.addfinalizer(dist.destroy_process_group)
    return make_mesh(("data", "model"), device_type="cpu")


#: (the saved config's changes to TINY, the restoring one's, the whole
#: ValueError text)
_MISMATCHES = {
    "3 layers into 2": ({"n_layers": 3}, {}, "checkpoint step 5 holds 21 "
                        "parameter leaves, the model 15"),
    "2 layers into 3": ({}, {"n_layers": 3}, "checkpoint step 5 holds 15 "
                        "parameter leaves, the model 21"),
    "another width": ({}, {"d_model": 32}, "checkpoint step 5: leaf embed "
                      "is (64, 64) torch.float32, the model's (64, 32) "
                      "torch.float32"),
    "bf16": ({}, {"dtype": torch.bfloat16}, "checkpoint step 5: leaf "
             "embed is (64, 64) torch.float32, the model's (64, 64) "
             "torch.bfloat16"),
    "dense into MoE": ({}, {"moe_experts": 2}, "checkpoint step 5 holds 15 "
                       "parameter leaves, the model 16"),
    "MoE into dense": ({"moe_experts": 2}, {}, "checkpoint step 5 holds 16 "
                       "parameter leaves, the model 15"),
}


@pytest.mark.parametrize("case", list(_MISMATCHES))
def test_checkpoint_restore_of_a_mismatch_changes_nothing(tmp_path,
                                                          restore_mesh,
                                                          case):
    """A 2-layer fp32 checkpoint restored into another model (more or
    fewer layers, another width, bf16, MoE layers or none) raises
    ValueError, as the reference's restore does, and leaves every
    parameter leaf and the optimizer as they were: nothing is copied
    before the whole checkpoint is checked. Saved and restored with a
    one-rank mesh, the text is the same: the tree's structure is checked
    before the saved state is cut by the caller's specs."""
    saved, other, want = _MISMATCHES[case]
    saved_cfg = dataclasses.replace(TINY, **saved)
    _, _, _, params, opt = _trained(steps=1, cfg=saved_cfg,
                                    mesh=restore_mesh)
    ckpt = TrainCheckpointer(str(tmp_path / "ckpt"))
    ckpt.save(5, params, opt, mesh=restore_mesh, cfg=saved_cfg)
    cfg = dataclasses.replace(TINY, **other)
    _, init_state, _ = make_train_step(cfg, restore_mesh, device="cpu")
    p0, o0 = init_state(seed=7)
    before = [t.detach().clone() for t in param_leaves(p0)]
    opt_before = o0.state_dict()
    with pytest.raises(ValueError) as raised:
        ckpt.restore(p0, o0, mesh=restore_mesh, cfg=cfg)
    assert str(raised.value) == want
    for (name, _), got, want_leaf in zip(
            named_leaves(p0), param_leaves(p0), before):
        assert torch.equal(got, want_leaf), name
    assert o0.state_dict() == opt_before and not o0.state


def test_checkpoint_restore_empty_dir_raises(tmp_path):
    ckpt = TrainCheckpointer(str(tmp_path / "empty"))
    _, init_state, _ = make_train_step(TINY, device="cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.restore(*init_state(seed=0))


def test_checkpoint_keep_prunes_the_oldest(tmp_path):
    _, _, _, params, opt = _trained(steps=1)
    ckpt = TrainCheckpointer(str(tmp_path / "ckpt"), keep=2)
    for s in (1, 2, 3, 4):
        ckpt.save(s, params, opt)
    assert ckpt.steps() == [3, 4] and ckpt.latest_step() == 4
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_3.pt", "step_4.pt"]


# -- accounting --------------------------------------------------------------------

def test_flop_accounting_matches_jax_perf():
    from dpu_operator_tpu.workloads import perf as jax_perf
    jcfg = jax_perf.flagship_config()
    cfg = model.flagship_config()
    assert param_count(cfg) == jax_perf.param_count(jcfg)
    assert train_step_flops(cfg, 8, 1024) == jax_perf.train_step_flops(
        jcfg, 8, 1024)


def test_peak_tflops_matches_the_exact_device_name():
    assert peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    # the PCIe and NVL parts have lower peaks: no SXM rate for them
    assert peak_tflops("NVIDIA H100 PCIe") is None
    assert peak_tflops("NVIDIA H100 NVL") is None


def test_map_params_keeps_the_tree_and_its_leaf_order():
    params = model.init_params(0, TINY, device="cpu")
    doubled = map_params(lambda t: 2 * t, params)
    assert [n for n in doubled] == ["embed", "pos", "out_norm", "layers"]
    pairs = list(zip(param_leaves(doubled), param_leaves(params)))
    assert len(pairs) == 3 + 6 * TINY.n_layers
    for got, p in pairs:
        assert torch.equal(got, 2 * p)


def test_measure_train_refuses_the_cpu():
    """No CPU time passes for the card's: on the CPU (the port bench's
    small sizes) the steps run on the host clock and the record says
    "cpu", holds no peak memory and takes the stated smoke peak, not a
    card's; every device but CUDA and the CPU is refused."""
    perf = measure_train(TINY, batch=2, steps=1, device="cpu")
    assert perf.device == "cpu" and perf.peak_memory_bytes is None
    assert perf.peak_tflops == CPU_PEAK_FLOPS / 1e12
    assert perf.step_ms > 0 and len(perf.losses) == 2
    with pytest.raises(ValueError, match="unsupported device"):
        measure_train(TINY, batch=2, steps=1, device="meta")


# -- (i) the CUDA kernels ------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s,d", [(1024, 128), (1000, 128), (77, 64),
                                 (33, 32), (1, 128), (64, 16), (50, 48)])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_training_kernels_match_plain(cuda, dtype, tol, s, d, causal):
    g = torch.Generator(device=cuda).manual_seed(6)
    h = 3
    qkv = torch.randn((2, s, 3 * h * d), generator=g, device=cuda).to(dtype)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, -1))
    do = torch.randn((2, s, h, d), generator=g, device=cuda).to(dtype)
    counts = launch_counts()
    out, lse = attention_fwd_lse(q, k, v, causal)
    out_p, lse_p = attention_fwd_plain(q, k, v, None, causal,
                                       return_lse=True)
    delta = attention_delta(do, out)
    got = [out, lse, attention_bwd_dq(q, k, v, do, lse, delta, causal),
           *attention_bwd_dkv(q, k, v, do, lse, delta, causal)]
    want = [out_p, lse_p,
            attention_bwd_dq_plain(q, k, v, do, lse, delta, causal),
            *attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal)]
    after = launch_counts()
    # bf16 takes the tensor-core forward, dQ and dK/dV (D 32 and 16 padded
    # to 64); fp32 the 3xTF32 forward, dQ and dK/dV
    names = (("attention_fwd_lse_tc", "attention_bwd_dq_tc",
              "attention_bwd_dkv_tc") if dtype == torch.bfloat16 else
             ("attention_fwd_lse_tf32", "attention_bwd_dq_tf32",
              "attention_bwd_dkv_tf32"))
    for name in names:
        assert after[name] == counts[name] + 1
    for a, b in zip(got, want):
        err = _scaled_err(a.float().cpu().numpy(), b.float().cpu().numpy())
        assert err <= tol


def test_cuda_train_step_matches_cpu(cuda):
    """One fp32 step of a tiny config (head dim 32, as the kernels take)
    on the card against the CPU: loss and every gradient leaf within 1e-4
    of max(1, |CPU|)."""
    cfg = dataclasses.replace(TINY, d_model=128)
    cpu_params = model.init_params(2, cfg, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        step, init_state, place = make_train_step(cfg, device=dev)
        params, opt = init_state(params=cpu_params)
        _, _, loss = step(params, opt,
                          place(model.make_example_batch(cfg, 4)))
        out[dev] = (float(loss), [p.grad.cpu() for p in
                                  param_leaves(params)])
    assert abs(out["cpu"][0] - out["cuda"][0]) <= 1e-4
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert _scaled_err(a.numpy(), b.numpy()) <= 1e-4
