"""Model and KV-cache decode of the PyTorch/CUDA port against the JAX
package, and the port's own exact invariants.

The same weights (the JAX ``init_params`` tree, bridged through numpy) and
the same numpy prompts go through both packages on the CPU. In fp32 logits
agree to float noise and greedy streams are equal; in bf16 the packages
round in different places (``_rmsnorm`` rounds rsqrt to bf16, the port's
fused RMSNorm does not) and only a tolerance holds. Inside the port,
decode, verify and chunked prefill share one body and the exact invariants
of tests/test_decode.py hold bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpu_operator_tpu.workloads import decode as jdecode
from dpu_operator_tpu.workloads import model as jmodel
from dpu_operator_tpu_torch.workloads import decode as tdecode
from dpu_operator_tpu_torch.workloads import model as tmodel
from dpu_operator_tpu_torch.workloads import serve as tserve

SHAPE = dict(vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq=64)


def _configs(dtype):
    return (jmodel.TransformerConfig(dtype=jnp.dtype(dtype), **SHAPE),
            tmodel.TransformerConfig(dtype=getattr(torch, dtype), **SHAPE))


def _bridge(dtype):
    jcfg, tcfg = _configs(dtype)
    jparams = jmodel.init_params(jax.random.key(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, tcfg, tmodel.params_from_numpy(tree, tcfg,
                                                         device="cpu")


@pytest.fixture(scope="module")
def f32():
    return _bridge("float32")


@pytest.fixture(scope="module")
def bf16():
    return _bridge("bfloat16")


def _prompt(seed, shape):
    return np.random.default_rng(seed).integers(0, SHAPE["vocab"], shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("attention", ["standard", "flash"])
def test_forward_matches_jax_fp32(f32, attention):
    jcfg, jparams, tcfg, tparams = f32
    import dataclasses
    jcfg = dataclasses.replace(jcfg, attention=attention)
    tcfg = dataclasses.replace(tcfg, attention=attention)
    tokens = _prompt(0, (2, 16))
    want = np.asarray(jmodel.forward(jparams, jnp.asarray(tokens), jcfg))
    got = tmodel.forward(tparams, torch.from_numpy(tokens), tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_greedy_generate_equals_jax_fp32(f32):
    jcfg, jparams, tcfg, tparams = f32
    prompt = _prompt(1, (2, 8))
    want = np.asarray(jdecode.generate(jparams, jcfg, jnp.asarray(prompt),
                                       steps=12))
    got = tdecode.generate(tparams, tcfg, torch.from_numpy(prompt), 12,
                           device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_prefill_logits_within_tolerance_of_jax(bf16):
    """bf16 logits near 1 round in steps of 2^-7; the two packages round
    the norms and the attention probabilities in different places, so the
    last-position logits agree to a few such steps."""
    jcfg, jparams, tcfg, tparams = bf16
    prompt = _prompt(2, (2, 12))
    _, want = jdecode.prefill(jparams, jcfg, jnp.asarray(prompt))
    _, got = tdecode.prefill(tparams, tcfg, torch.from_numpy(prompt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=0.05, rtol=0)


def test_verify_step_matches_jax_and_drops_rows_past_max_seq(f32):
    """Rows at or past max_seq are not written (JAX: mode="drop"), the
    other rows land at pos + i, and the logits agree with JAX's."""
    jcfg, jparams, tcfg, tparams = f32
    prompt = _prompt(3, (2, 10))
    jcache, _ = jdecode.prefill(jparams, jcfg, jnp.asarray(prompt))
    tcache, _ = tdecode.prefill(tparams, tcfg, torch.from_numpy(prompt))
    before = [{k: t.clone() for k, t in layer.items()} for layer in tcache]
    tokens = _prompt(4, (2, 4))
    pos = np.asarray([62, 10], np.int32)             # rows 64, 65 dropped
    jlog, jcache = jdecode.verify_step(jparams, jcfg, jcache,
                                       jnp.asarray(tokens), jnp.asarray(pos))
    tlog, tcache = tdecode.verify_step(tparams, tcfg, tcache,
                                       torch.from_numpy(tokens),
                                       torch.from_numpy(pos))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=1e-4)
    for jl, tl, bl in zip(jcache, tcache, before):
        for key in ("k", "v"):
            np.testing.assert_allclose(tl[key].numpy(), np.asarray(jl[key]),
                                       atol=1e-5, rtol=1e-5)
            changed = (tl[key] != bl[key]).flatten(2).any(-1)
            assert changed[0].nonzero().flatten().tolist() == [62, 63]
            assert changed[1].nonzero().flatten().tolist() == [10, 11, 12,
                                                               13]


def _step_generate(params, cfg, prompt, steps):
    """generate() driven one decode_step at a time with vector positions
    (the serve path)."""
    cache, logits = tdecode.prefill(params, cfg, prompt)
    pos = torch.full((prompt.shape[0],), prompt.shape[1], dtype=torch.int32)
    out = []
    for i in range(steps):
        tok = logits.argmax(-1)
        out.append(tok)
        logits, cache = tdecode.decode_step(params, cfg, cache, tok, pos + i)
    return torch.stack(out, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_token_identical_to_generate(f32, bf16, dtype):
    _, _, cfg, params = f32 if dtype == "float32" else bf16
    prompt = torch.from_numpy(_prompt(5, (3, 6)))
    want = tdecode.generate(params, cfg, prompt, 12, device="cpu")
    assert torch.equal(_step_generate(params, cfg, prompt, 12), want)


def test_decode_step_scalar_and_vector_pos_identical(f32):
    _, _, cfg, params = f32
    prompt = torch.from_numpy(_prompt(6, (2, 7)))
    cache, logits = tdecode.prefill(params, cfg, prompt)
    tok = logits.argmax(-1)
    cache2 = [{k: t.clone() for k, t in layer.items()} for layer in cache]
    a_logits, a_cache = tdecode.decode_step(params, cfg, cache, tok, 7)
    b_logits, b_cache = tdecode.decode_step(
        params, cfg, cache2, tok, torch.full((2,), 7, dtype=torch.int32))
    assert torch.equal(a_logits, b_logits)
    for la, lb in zip(a_cache, b_cache):
        assert torch.equal(la["k"], lb["k"]) and torch.equal(la["v"],
                                                             lb["v"])


def _chunked_prefill(params, cfg, cache, slot, prompt, chunk):
    logits, off = None, 0
    while off < len(prompt):
        n = min(chunk, len(prompt) - off)
        padded = torch.zeros(chunk, dtype=torch.long)
        padded[:n] = torch.as_tensor(prompt[off:off + n])
        cache, logits = tdecode.prefill_chunk(params, cfg, cache, slot,
                                              padded, off, n)
        off += n
    return cache, logits


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_chunk_cache_and_token_identical_to_prefill(f32, bf16,
                                                            dtype):
    """Chunked prefill writes the prefill's cache rows and its final logits
    pick the same token, for chunk widths that divide the prompt, straddle
    it and cover it. In bf16 the rows are bit-identical; in fp32 the CPU
    matrix product rounds rows differently for different row counts, so
    there they agree to float noise (as in tests/test_decode.py)."""
    _, _, cfg, params = f32 if dtype == "float32" else bf16
    prompt = _prompt(7, (13,))
    ref_cache, ref_logits = tdecode.prefill(
        params, cfg, torch.from_numpy(prompt[None]))
    for chunk in (4, 5, 13, 16):
        cache, logits = _chunked_prefill(
            params, cfg, tdecode.init_kv_cache(cfg, 3, device="cpu"), 1,
            prompt, chunk)
        for lr, lc in zip(ref_cache, cache):
            for key in ("k", "v"):
                want, got = lr[key][0, :13], lc[key][1, :13]
                if dtype == "bfloat16":
                    assert torch.equal(got, want), (chunk, key)
                else:
                    torch.testing.assert_close(got, want, atol=2e-6,
                                               rtol=2e-5)
        if dtype == "bfloat16":
            assert torch.equal(logits, ref_logits[0]), chunk
        assert int(logits.argmax()) == int(ref_logits[0].argmax()), chunk


def test_prefill_chunk_generation_identical_to_generate(f32):
    _, _, cfg, params = f32
    prompt = _prompt(8, (11,))
    want = tdecode.generate(params, cfg, torch.from_numpy(prompt[None]), 8,
                            device="cpu")[0].tolist()
    for chunk in (3, 6, 11):
        cache, logits = _chunked_prefill(
            params, cfg, tdecode.init_kv_cache(cfg, 2, device="cpu"), 0,
            prompt, chunk)
        toks = [int(logits.argmax())]
        pos = torch.tensor([11, 0], dtype=torch.int32)
        last = torch.tensor([toks[0], 0])
        for _ in range(7):
            step_logits, cache = tdecode.decode_step(params, cfg, cache,
                                                     last, pos)
            toks.append(int(step_logits[0].argmax()))
            last[0] = toks[-1]
            pos[0] += 1
        assert toks == want, chunk


def test_verify_width_one_identical_to_decode_step(f32):
    _, _, cfg, params = f32
    prompt = torch.from_numpy(_prompt(9, (2, 9)))
    cache, logits = tdecode.prefill(params, cfg, prompt)
    cache2 = [{k: t.clone() for k, t in layer.items()} for layer in cache]
    tok = logits.argmax(-1)
    pos = torch.tensor([9, 9], dtype=torch.int32)
    d_logits, d_cache = tdecode.decode_step(params, cfg, cache, tok, pos)
    v_logits, v_cache = tdecode.verify_step(params, cfg, cache2,
                                            tok[:, None], pos)
    assert torch.equal(v_logits[:, 0], d_logits)
    for la, lb in zip(d_cache, v_cache):
        assert torch.equal(la["k"], lb["k"]) and torch.equal(la["v"],
                                                             lb["v"])


def test_sampling_properties(f32):
    """torch's random bits are not JAX's: check properties, not bits."""
    _, _, cfg, params = f32
    prompt = torch.from_numpy(_prompt(10, (2, 5)))
    greedy = tdecode.generate(params, cfg, prompt, 6, device="cpu")
    top1 = tdecode.generate(params, cfg, prompt, 6, temperature=0.7,
                            top_k=1, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    assert torch.equal(top1, greedy)
    runs = [tdecode.generate(params, cfg, prompt, 6, temperature=1.5,
                             top_k=20,
                             generator=torch.Generator().manual_seed(s),
                             device="cpu") for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1])
    assert all(((r >= 0) & (r < cfg.vocab)).all() for r in runs)
    with pytest.raises(ValueError, match="generator"):
        tdecode.generate(params, cfg, prompt, 2, temperature=1.0,
                         device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        tdecode.generate(params, cfg, prompt, 60, device="cpu")


def test_default_device_is_cuda_and_raises_without_it(f32, monkeypatch):
    _, _, cfg, params = f32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: tmodel.init_params(0, cfg),
             lambda: tmodel.params_from_numpy({}, cfg),
             lambda: tdecode.init_kv_cache(cfg, 1),
             lambda: tdecode.generate(params, cfg, torch.zeros((1, 2),
                                                               dtype=torch.long), 1),
             lambda: tserve.TorchSlotExecutor(params, cfg, slots=1)]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("change,match", [
    # MoE in a sequence mode: *match* is the refusal these cases gave
    # until the mode was ported; they now run (the test's docstring)
    (dict(attention="ring", moe_experts=4),
     r"not ported yet \(ROADMAP queue 1, item 7"),
    (dict(attention="ulysses", moe_experts=4),
     r"not ported yet \(ROADMAP queue 1, item 7"),
])
def test_unported_modes_raise(change, match):
    """MoE in a sequence mode, refused until it was ported (*match* is
    that refusal's text), now runs: ``init_params`` takes the config, and
    without a mesh the forward of a bridged JAX tree gives JAX's logits
    and aux loss (fp32)."""
    import dataclasses
    jcfg, tcfg = (dataclasses.replace(c, **change)
                  for c in _configs("float32"))
    tmodel.init_params(0, tcfg, device="cpu")
    tree = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.key(0), jcfg))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 16))
    with torch.no_grad():
        got, aux = tmodel.forward(
            tmodel.params_from_numpy(tree, tcfg, device="cpu"),
            torch.from_numpy(tokens), tcfg, return_aux=True)
    want, want_aux = jmodel.forward(tree, jnp.asarray(tokens, jnp.int32),
                                    jcfg, return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    assert abs(float(aux) - float(want_aux)) <= 1e-5
