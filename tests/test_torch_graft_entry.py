"""The port's graft twin (``dpu_operator_tpu_torch/graft_entry.py``)
against ``__graft_entry__.py``.

``entry()``: the twin of ``tests/test_graft_entry.py:56`` (the logits of
the entry's forward are (4, 64, vocab)), its config field for field
against the reference's, and the port's forward on the reference's own
parameters (``params_from_numpy`` of its ``init_params`` tree) against
the reference's logits. ``dryrun_multichip``: 8 gloo ranks in one spawn,
each mode's first loss finite and positive (the reference asserts the
losses positive); the one-rank body in this process, the CPU twin of
``chip_smoke.py`` phase 16's NCCL run at world 1; and the refusals.

Tolerances, each logit in units of its own size plus the logits' RMS:
in bf16 (the entry's dtype) :data:`BF16_TOL`. JAX's attention is a plain
einsum with a bf16 softmax output, the port's the flash attention's plain
version, which rounds once; each bf16 forward lies up to 3.5e-2 from the
fp32 forward of the same weights on these tokens, and the two 3.7e-2
from each other. The bound is the one ``chip_smoke.py`` holds this
config's bf16 logits to between the card and the CPU. In fp32 on the
same weights :data:`F32_TOL`.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import __graft_entry__ as jax_graft
from dpu_operator_tpu.workloads import model as jax_model
from dpu_operator_tpu_torch import graft_entry
from dpu_operator_tpu_torch.workloads import model

#: bf16 logits, port against JAX (``chip_smoke.DEFAULT_BF16_LOGIT_TOL``)
BF16_TOL = 5e-2
#: fp32 logits, port against JAX: summation order only
F32_TOL = 1e-4
#: the modes of the reference's dry run at 8 devices
MODES = ("standard", "ring", "ulysses", "ep", "multislice", "pipeline")


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rms = float(np.sqrt(np.mean(want ** 2)))
    return float(np.max(np.abs(got - want) / (np.abs(want) + rms)))


@pytest.fixture(scope="module")
def jax_entry():
    """The reference's entry: its parameters as numpy leaves, its tokens,
    its logits on them and on seeded random tokens."""
    fn, (params, tokens) = jax_graft.entry()
    run = jax.jit(fn)
    rand = np.random.default_rng(21).integers(0, 256, (4, 64)).astype(
        np.int32)
    return {"tree": jax.tree_util.tree_map(np.asarray, params),
            "tokens": np.asarray(tokens),
            "logits": np.asarray(run(params, tokens)),
            "rand": rand,
            "rand_logits": np.asarray(run(params, jnp.asarray(rand)))}


def test_entry_returns_forward_and_args():
    """Twin of test_graft_entry.py:56: ``entry(device="cpu")`` gives a
    forward and its inputs, tokens of zeros (4, 64), and the logits are
    (4, 64, vocab) fp32 and finite."""
    fn, (params, tokens) = graft_entry.entry(device="cpu")
    assert tokens.shape == (4, 64) and tokens.dtype == torch.int64
    assert not tokens.any()
    with torch.no_grad():
        out = fn(params, tokens)
    assert out.shape == (4, 64, 256) and out.dtype == torch.float32
    assert torch.isfinite(out).all()


def test_entry_config_is_the_references():
    """The entry's model is ``TransformerConfig(n_layers=2, max_seq=64)``
    with the reference's defaults: vocab 256, d_model 128, 8 heads of
    16, d_ff 512, bf16."""
    cfg = model.TransformerConfig(n_layers=2, max_seq=64)
    want = jax_model.TransformerConfig(n_layers=2, max_seq=64)
    for name in ("vocab", "d_model", "n_heads", "n_layers", "d_ff",
                 "max_seq", "d_head"):
        assert getattr(cfg, name) == getattr(want, name), name
    assert str(cfg.dtype).split(".")[-1] == jnp.dtype(want.dtype).name
    _, (params, _) = graft_entry.entry(device="cpu")
    assert params["embed"].shape == (256, 128)
    assert params["embed"].dtype == torch.bfloat16
    assert len(params["layers"]) == 2


@pytest.mark.parametrize("tokens", ["entry", "random"])
def test_entry_forward_matches_jax(jax_entry, tokens):
    """The port's entry forward on the reference's parameters
    (``params_from_numpy``) against the reference's logits, on the
    entry's zero tokens and on seeded random ones, within
    :data:`BF16_TOL` scaled."""
    fn, _ = graft_entry.entry(device="cpu")
    cfg = model.TransformerConfig(n_layers=2, max_seq=64)
    params = model.params_from_numpy(jax_entry["tree"], cfg, device="cpu")
    toks, want = ((jax_entry["tokens"], jax_entry["logits"])
                  if tokens == "entry"
                  else (jax_entry["rand"], jax_entry["rand_logits"]))
    with torch.no_grad():
        got = fn(params, torch.from_numpy(toks.astype(np.int64)))
    assert got.shape == want.shape
    err = _scaled_err(got.numpy(), want)
    assert err <= BF16_TOL, err


def test_entry_forward_in_fp32_matches_jax(jax_entry):
    """The entry's model in fp32 on the reference's parameters (upcast):
    the port's forward against JAX ``forward`` within :data:`F32_TOL`."""
    cfg = model.TransformerConfig(n_layers=2, max_seq=64,
                                  dtype=torch.float32)
    jcfg = jax_model.TransformerConfig(n_layers=2, max_seq=64,
                                       dtype=jnp.float32)
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32),
                                  jax_entry["tree"])
    want = np.asarray(jax.jit(lambda p, t: jax_model.forward(p, t, jcfg))(
        tree, jnp.asarray(jax_entry["rand"])))
    params = model.params_from_numpy(tree, cfg, device="cpu")
    with torch.no_grad():
        got = model.forward(params, torch.from_numpy(
            jax_entry["rand"].astype(np.int64)), cfg)
    err = _scaled_err(got.numpy(), want)
    assert err <= F32_TOL, err


def test_entry_asks_for_the_card_by_default():
    """Every entry point defaults to the card and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        graft_entry.entry()


def test_dryrun_on_the_card_raises_without_one():
    """``dryrun_multichip(2, device="cuda")`` raises without a card, before
    any rank starts; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        graft_entry.dryrun_multichip(2, device="cuda")
    assert not dist.is_initialized()


def test_dryrun_refuses_no_ranks():
    with pytest.raises(ValueError, match="over 0 ranks"):
        graft_entry.dryrun_multichip(0, device="cpu")


def test_dryrun_multichip_over_8_gloo_ranks():
    """``dryrun_multichip(8, device="cpu")``: 8 gloo ranks in one spawn,
    the full train step once in each mode of the reference's dry run at 8
    devices (dp/tp/sp on (2, 4), ring, Ulysses, ep with 8 experts,
    multi-slice on (2, 2, 2), the pipeline over 4 stages x 2 data ranks),
    every first loss finite and positive. The spawn's deadline is
    ``spmd.DEADLINE_S`` (about 8 s on a quiet 8-core host)."""
    losses = graft_entry.dryrun_multichip(8, device="cpu")
    assert tuple(losses) == MODES
    for mode, loss in losses.items():
        assert math.isfinite(loss) and loss > 0, (mode, loss)


def test_dryrun_body_on_one_rank_in_process():
    """The dry run's body on a one-rank gloo group formed in this process
    (as ``dryrun_multichip(1, device="cuda")`` forms an NCCL one): the
    modes of one rank (no multi-slice, no pipeline below 2 stages), each
    first loss finite and positive; the group ends after."""
    assert not dist.is_initialized()
    try:
        losses = graft_entry._dryrun_body("cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert tuple(losses) == ("standard", "ring", "ulysses", "ep")
    for mode, loss in losses.items():
        assert math.isfinite(loss) and loss > 0, (mode, loss)
