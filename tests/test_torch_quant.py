"""The quantized serving path of the PyTorch/CUDA port against the JAX
package: int8 weights (W8A8) and the int8 KV cache (KV8).

The same weights (the JAX ``init_params`` tree, bridged through numpy) and
the same numpy prompts go through both packages on the CPU. Quantization is
elementwise fp32 arithmetic and rounding, so the port's int8 tree equals
the JAX one exactly; the int8 products are exact int32 sums. In fp32 the
logits agree to float noise and the greedy streams are equal; in bf16 the
packages round in different places and a correlation or an agreement
share holds. Inside the port the JAX package's exact invariants hold bit
for bit over a KV8 cache: decode steps equal ``generate``, verify at width
1 equals decode, and speculative verify emits ``generate``'s stream. The
KV8 kernels run only on a card: tests/test_torch_tc.py (which imports no
JAX) holds them against their plain version there, as ``chip_smoke.py``
does.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpu_operator_tpu.workloads import decode as jdecode
from dpu_operator_tpu.workloads import model as jmodel
from dpu_operator_tpu.workloads import serve as jserve
from dpu_operator_tpu_torch.ops import (attention_fwd_kv8,
                                        attention_kv8_plain, launch_counts)
from dpu_operator_tpu_torch.workloads import decode as tdecode
from dpu_operator_tpu_torch.workloads import model as tmodel
from dpu_operator_tpu_torch.workloads import perf as tperf
from dpu_operator_tpu_torch.workloads import serve as tserve
from dpu_operator_tpu_torch.workloads import spec as tspec

#: the config of tests/test_torch_decode.py
SHAPE = dict(vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq=64)
#: fp32 logits, port against JAX: the int8 products are exact, so only the
#: fp32 rescale, the norms and the attention's summation order differ
#: (largest reading 2.4e-7 at these weights)
F32_TOL = 1e-4
#: bf16 quantized logits against the reference: at least this correlated
#: (tests/test_decode.py's gate for W8A8 against the bf16 path)
MIN_CORR = 0.99
#: the KV8 plain version against a dense dequantized softmax in fp32
#: (summation order only)
KV8_PLAIN_TOL = 1e-5


def _configs(dtype):
    return (jmodel.TransformerConfig(dtype=jnp.dtype(dtype), **SHAPE),
            tmodel.TransformerConfig(dtype=getattr(torch, dtype), **SHAPE))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bridge(dtype):
    """(jcfg, JAX params, JAX int8 tree, tcfg, port params, the JAX int8
    tree bridged into the port)."""
    jcfg, tcfg = _configs(dtype)
    jparams = jmodel.init_params(jax.random.key(0), jcfg)
    jq = jdecode.quantize_decode_params(jparams)
    return (jcfg, jparams, jq, tcfg,
            tmodel.params_from_numpy(_np_tree(jparams), tcfg, device="cpu"),
            tmodel.params_from_numpy(_np_tree(jq), tcfg, device="cpu"))


@pytest.fixture(scope="module")
def f32():
    return _bridge("float32")


@pytest.fixture(scope="module")
def bf16():
    return _bridge("bfloat16")


def _prompt(seed, shape):
    return np.random.default_rng(seed).integers(0, SHAPE["vocab"], shape,
                                                dtype=np.int32)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                          f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{path}/{i}")]
    return [(path, tree)]


# -- W8A8: the tree -------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_tree_equals_jax(f32, bf16, dtype):
    """The port's quantize_decode_params on the bridged weights equals the
    bridged JAX int8 tree leaf for leaf: int8 values and fp32 scales
    exactly, norms and pos untouched (tests/test_decode.py's
    test_quantized_weights_are_int8, held to the JAX tree)."""
    jcfg, _, _, cfg, params, bridged = f32 if dtype == "float32" else bf16
    mine = tdecode.quantize_decode_params(params)
    got, want = _leaves(mine), _leaves(bridged)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    assert mine["embed"]["q"].dtype == torch.int8
    assert mine["embed"]["scale"].shape == (cfg.vocab, 1)
    lp = mine["layers"][0]
    assert lp["wqkv"]["scale"].shape == (1, 3 * cfg.d_model)
    assert lp["wqkv"]["scale"].dtype == torch.float32
    assert lp["ln1"].dtype == cfg.dtype and mine["pos"].dtype == cfg.dtype


def test_int8_projections_are_stored_column_major(f32):
    """Both ways to the int8 tree (quantizing, bridging) store each
    projection's q column-major, the right-operand layout of the int8
    product on the card; the embedding stays row-major (its rows are
    gathered)."""
    _, _, _, _, params, bridged = f32
    for tree in (tdecode.quantize_decode_params(params), bridged):
        for lp in tree["layers"]:
            for name in tmodel.PROJECTIONS:
                q = lp[name]["q"]
                assert q.stride() == (1, q.shape[0]), name
        assert tree["embed"]["q"].is_contiguous()


def test_act_quant_rounds_half_to_even_as_jnp_round():
    """Exact .5 ties (amax 127, so the scale is 1.0) round to the even
    integer, as ``jnp.round`` does; ``floor(x + 0.5)`` would not."""
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -126.5]],
                 np.float32)
    q, s = tdecode._act_quant(torch.from_numpy(x))
    jq, js = jdecode._act_quant(jnp.asarray(x))
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, -2, 4, -126]]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_int8_product_is_exact_for_any_leading_shape():
    rng = np.random.default_rng(3)
    xq = torch.from_numpy(rng.integers(-127, 128, (2, 3, 24), np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (24, 16), np.int8))
    want = (xq.int().reshape(6, 24) @ wq.int()).reshape(2, 3, 16)
    assert torch.equal(tdecode._int8_mm(xq, wq), want)
    assert torch.equal(tdecode._int8_mm(xq, wq.t().contiguous().t()), want)


def test_param_bytes_counts_each_leaf_at_its_width(f32):
    _, _, _, cfg, params, bridged = f32
    d, f, v, s = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.max_seq
    proj = d * 3 * d + d * d + d * f + f * d          # int8 elements
    scales = 3 * d + d + f + d                        # fp32 (1, N) scales
    want = (v * d + 4 * v + 4 * (s * d + d)
            + cfg.n_layers * (proj + 4 * scales + 4 * 2 * d))
    assert tmodel.param_bytes(bridged) == want
    assert tmodel.param_bytes(params) == 4 * tperf.param_count(cfg)


# -- W8A8: against the JAX package ---------------------------------------------

def test_w8a8_prefill_logits_match_jax_fp32(f32):
    jcfg, _, jq, cfg, _, qparams = f32
    prompt = _prompt(2, (2, 12))
    _, want = jdecode.prefill(jq, jcfg, jnp.asarray(prompt))
    _, got = tdecode.prefill(qparams, cfg, torch.from_numpy(prompt))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)


def test_w8a8_prefill_logits_bf16_correlate_with_jax_and_bf16(bf16):
    """bf16: the port's W8A8 logits against JAX's W8A8 logits, and against
    the port's own bf16 path (the gate of tests/test_decode.py's
    test_quantized_decode_matches_bf16_closely)."""
    jcfg, _, jq, cfg, params, qparams = bf16
    prompt = _prompt(2, (2, 8))
    _, jl = jdecode.prefill(jq, jcfg, jnp.asarray(prompt))
    _, ql = tdecode.prefill(qparams, cfg, torch.from_numpy(prompt))
    _, bl = tdecode.prefill(params, cfg, torch.from_numpy(prompt))
    q = ql.numpy().ravel()
    assert np.corrcoef(q, np.asarray(jl, np.float32).ravel())[0, 1] > MIN_CORR
    assert np.corrcoef(q, bl.numpy().ravel())[0, 1] > MIN_CORR


MODES = {"w8a8": (True, False), "kv8": (False, True),
         "w8a8+kv8": (True, True)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_greedy_streams_equal_jax_fp32(f32, mode):
    """The quantized generate of both packages from the same weights:
    equal greedy streams in fp32 (the twins of tests/test_decode.py's
    W8A8, KV8 and composed generate tests, held to JAX's streams)."""
    jcfg, jparams, jq, cfg, params, qparams = f32
    quantized, kv_int8 = MODES[mode]
    prompt = _prompt(1, (2, 8))
    want = np.asarray(jdecode.generate(jq if quantized else jparams, jcfg,
                                       jnp.asarray(prompt), 12,
                                       kv_int8=kv_int8))
    got = tdecode.generate(qparams if quantized else params, cfg,
                           torch.from_numpy(prompt), 12, device="cpu",
                           kv_int8=kv_int8)
    np.testing.assert_array_equal(got.numpy(), want)


#: tests/test_decode.py's quantized-stream tests: their config (bf16),
#: their weights (``init_params`` at key 0) and prompt (key 1), their stream
#: lengths and the least share of tokens each quantized stream must share
#: with the bf16 path's (a greedy path diverges after a miss)
AGREE_SHAPE = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                   max_seq=64)
AGREE = {"w8a8": (12, 0.5), "kv8": (16, 0.8), "w8a8+kv8": (12, 0.5)}


@pytest.fixture(scope="module")
def agree_model():
    jcfg = jmodel.TransformerConfig(**AGREE_SHAPE)
    cfg = tmodel.TransformerConfig(**AGREE_SHAPE)
    jparams = jmodel.init_params(jax.random.key(0), jcfg)
    prompt = np.array(jax.random.randint(jax.random.key(1), (2, 8), 0,
                                         cfg.vocab))
    return (cfg, tmodel.params_from_numpy(_np_tree(jparams), cfg,
                                          device="cpu"),
            tmodel.params_from_numpy(
                _np_tree(jdecode.quantize_decode_params(jparams)), cfg,
                device="cpu"), torch.from_numpy(prompt))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_greedy_streams_bf16_track_the_bf16_path(agree_model, mode):
    """The twins of tests/test_decode.py's
    test_quantized_decode_matches_bf16_closely (W8A8),
    test_kv_int8_decode_matches_bf16_cache_closely (KV8) and
    test_kv_int8_composes_with_w8a8 on their own weights and prompt,
    inside the port: the quantized bf16 stream shares at least the JAX
    test's share of tokens with the port's bf16 stream."""
    cfg, params, qparams, prompt = agree_model
    quantized, kv_int8 = MODES[mode]
    steps, least = AGREE[mode]
    want = tdecode.generate(params, cfg, prompt, steps, device="cpu")
    got = tdecode.generate(qparams if quantized else params, cfg, prompt,
                           steps, device="cpu", kv_int8=kv_int8)
    assert float((got == want).float().mean()) > least


# -- KV8: the cache -------------------------------------------------------------

def test_kv8_cache_shapes_and_prefill_rows(f32):
    """init_kv_cache(kv_int8=True) and the rows prefill stores (the twin
    of tests/test_decode.py's test_kv_int8_cache_shapes_and_dtypes), held
    to JAX's cache: equal scales to fp32 noise, int8 values within one
    step (a value at a rounding tie may land either side)."""
    jcfg, jparams, _, cfg, params, _ = f32
    cache = tdecode.init_kv_cache(cfg, 2, device="cpu", kv_int8=True)
    shape = (2, cfg.max_seq, cfg.n_heads, cfg.d_head)
    assert sorted(cache[0]) == ["k_q", "k_s", "v_q", "v_s"]
    assert cache[0]["k_q"].dtype == torch.int8 and cache[0]["k_q"].shape \
        == shape
    assert cache[0]["k_s"].dtype == torch.float32 and cache[0]["k_s"].shape \
        == (*shape[:3], 1)
    prompt = _prompt(4, (2, 5))
    qcache, _ = tdecode.prefill(params, cfg, torch.from_numpy(prompt),
                                kv_int8=True)
    jcache, _ = jdecode.prefill(jparams, jcfg, jnp.asarray(prompt),
                                kv_int8=True)
    for tl, jl in zip(qcache, jcache):
        assert int(tl["k_q"][:, :5].abs().max()) > 0
        assert float(tl["k_s"][:, :5].min()) > 0
        assert int(tl["k_q"][:, 5:].abs().max()) == 0
        for name in ("k_s", "v_s"):
            np.testing.assert_allclose(tl[name].numpy(), np.asarray(jl[name]),
                                       rtol=1e-5, atol=0)
        for name in ("k_q", "v_q"):
            diff = tl[name].int().numpy() - np.asarray(jl[name], np.int32)
            assert np.abs(diff).max() <= 1, name


def _step_generate(params, cfg, prompt, steps, kv_int8):
    """generate() driven one decode_step at a time with vector positions
    (the serve path)."""
    cache, logits = tdecode.prefill(params, cfg, prompt, kv_int8=kv_int8)
    pos = torch.full((prompt.shape[0],), prompt.shape[1], dtype=torch.int32)
    out = []
    for i in range(steps):
        tok = logits.argmax(-1)
        out.append(tok)
        logits, cache = tdecode.decode_step(params, cfg, cache, tok, pos + i)
    return torch.stack(out, 1)


@pytest.mark.parametrize("weights", ["bf16/fp32", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv8_decode_steps_identical_to_generate(f32, bf16, dtype, weights):
    """The twin of tests/test_decode.py's
    test_decode_step_token_identical_with_kv_int8, bit for bit."""
    _, _, _, cfg, params, qparams = f32 if dtype == "float32" else bf16
    p = qparams if weights == "int8" else params
    prompt = torch.from_numpy(_prompt(5, (2, 5)))
    want = tdecode.generate(p, cfg, prompt, 10, device="cpu", kv_int8=True)
    assert torch.equal(_step_generate(p, cfg, prompt, 10, True), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv8_verify_width_one_identical_to_decode(f32, bf16, dtype):
    _, _, _, cfg, _, qparams = f32 if dtype == "float32" else bf16
    prompt = torch.from_numpy(_prompt(6, (2, 7)))
    cache, logits = tdecode.prefill(qparams, cfg, prompt, kv_int8=True)
    twin = [{k: t.clone() for k, t in layer.items()} for layer in cache]
    tok = logits.argmax(-1)
    pos = torch.tensor([7, 7], dtype=torch.int32)
    dec, cache = tdecode.decode_step(qparams, cfg, cache, tok, pos)
    ver, twin = tdecode.verify_step(qparams, cfg, twin, tok[:, None], pos)
    assert torch.equal(ver[:, 0], dec)
    for a, b in zip(cache, twin):
        assert all(torch.equal(a[k], b[k]) for k in a)


#: bf16 logits, port against JAX, teacher-forced over a KV8 cache: the
#: bf16 tolerance of tests/test_torch_decode.py (logits near 1 round in
#: steps of 2^-7, and the packages round the norms and the KV8 scores in
#: different places: the port keeps q . k_q in fp32, JAX rounds it to bf16;
#: largest reading 0.0234 with bf16 weights, 0.0418 with W8A8)
BF16_ATOL = 0.05


@pytest.mark.parametrize("step", ["decode", "verify"])
@pytest.mark.parametrize("weights", ["bf16", "int8"])
def test_kv8_bf16_teacher_forced_logits_within_tolerance_of_jax(bf16,
                                                                 weights,
                                                                 step):
    """One stream, fed the same tokens, through both packages' KV8
    prefill and then their decode_step (one token at a time) or
    verify_step (5 tokens a row, twice), with bf16 or W8A8 weights: the
    logits of every position agree within BF16_ATOL."""
    jcfg, jparams, jq, cfg, params, qparams = bf16
    p, jp = (qparams, jq) if weights == "int8" else (params, jparams)
    prompt = _prompt(14, (2, 8))
    stream = _prompt(15, (2, 10))
    cache, logits = tdecode.prefill(p, cfg, torch.from_numpy(prompt),
                                    kv_int8=True)
    jcache, jlogits = jdecode.prefill(jp, jcfg, jnp.asarray(prompt),
                                      kv_int8=True)
    pairs = [(logits, jlogits)]
    width = 1 if step == "decode" else 5
    for i in range(0, stream.shape[1], width):
        pos = np.full(2, prompt.shape[1] + i, np.int32)
        tok = stream[:, i:i + width]
        if step == "decode":
            logits, cache = tdecode.decode_step(
                p, cfg, cache, torch.from_numpy(tok[:, 0]),
                torch.from_numpy(pos))
            jlogits, jcache = jdecode.decode_step(
                jp, jcfg, jcache, jnp.asarray(tok[:, 0]), jnp.asarray(pos))
        else:
            logits, cache = tdecode.verify_step(
                p, cfg, cache, torch.from_numpy(tok), torch.from_numpy(pos))
            jlogits, jcache = jdecode.verify_step(
                jp, jcfg, jcache, jnp.asarray(tok), jnp.asarray(pos))
        pairs.append((logits, jlogits))
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   atol=BF16_ATOL, rtol=0)


def _chunked_prefill_into(params, cfg, cache, slot, prompt, chunk):
    logits = None
    for off in range(0, len(prompt), chunk):
        piece = prompt[off:off + chunk]
        padded = np.zeros(chunk, np.int64)
        padded[:len(piece)] = piece
        cache, logits = tdecode.prefill_chunk(
            params, cfg, cache, slot, torch.from_numpy(padded), off,
            len(piece))
    return cache, logits


@pytest.mark.parametrize("weights", ["fp32", "int8"])
def test_kv8_prefill_chunk_continuation_decodes(f32, weights):
    """The twin of tests/test_decode.py's
    test_prefill_chunk_supports_kv_int8_cache: a KV8 chunked prefill into
    slot 1 writes int8 rows there only and its continuation decodes to
    finite logits; in fp32 the chunk's token and the next step's logits
    are JAX's (its prefill_chunk over the same KV8 cache)."""
    jcfg, jparams, jq, cfg, params, qparams = f32
    p, jp = (qparams, jq) if weights == "int8" else (params, jparams)
    prompt = _prompt(32, (9,))
    cache, logits = _chunked_prefill_into(
        p, cfg, tdecode.init_kv_cache(cfg, 2, device="cpu", kv_int8=True),
        1, prompt, 4)
    assert cache[0]["k_q"].dtype == torch.int8
    assert int(cache[0]["k_q"][0].abs().max()) == 0
    assert float(cache[0]["k_s"][1, :len(prompt)].min()) > 0
    jcache = jdecode.init_kv_cache(jcfg, 2, kv_int8=True)
    for off in range(0, len(prompt), 4):
        piece = np.zeros(4, np.int32)
        n = len(prompt[off:off + 4])
        piece[:n] = prompt[off:off + 4]
        jcache, jlogits = jdecode.prefill_chunk(jp, jcfg, jcache, 1,
                                                jnp.asarray(piece), off, n)
    tok = int(logits.argmax())
    assert tok == int(jnp.argmax(jlogits))
    last = np.zeros(2, np.int64)
    last[1] = tok
    pos = np.array([0, len(prompt)], np.int32)
    step, _ = tdecode.decode_step(p, cfg, cache, torch.from_numpy(last),
                                  torch.from_numpy(pos))
    jstep, _ = jdecode.decode_step(jp, jcfg, jcache,
                                   jnp.asarray(last, jnp.int32),
                                   jnp.asarray(pos))
    assert bool(torch.isfinite(step).all())
    np.testing.assert_allclose(step[1].numpy(), np.asarray(jstep)[1],
                               atol=F32_TOL, rtol=F32_TOL)


def _spec_generate(params, cfg, prompt, out_len, k, ref, corrupt, kv_int8):
    """The port's verify_step driven with an oracle drafter (drafts copied
    from *ref*, the last one corrupted when *corrupt*) and the exact greedy
    rule at the fixed width k + 1, as tests/test_spec.py drives JAX's."""
    cache, logits = tdecode.prefill(params, cfg, torch.tensor([prompt]),
                                    kv_int8=kv_int8)
    toks = [int(logits[0].argmax())]
    pos = len(prompt)
    while len(toks) < out_len:
        kk = min(k, out_len - len(toks) - 1)
        drafts = list(ref[len(toks):len(toks) + kk])
        if corrupt and drafts:
            drafts[-1] = (drafts[-1] + 1) % cfg.vocab
        row = [toks[-1]] + drafts + [toks[-1]] * (k - len(drafts))
        logits, cache = tdecode.verify_step(
            params, cfg, cache, torch.tensor([row]),
            torch.tensor([pos], dtype=torch.int32))
        arg = logits.argmax(-1)[0].tolist()
        _, emitted = tspec.greedy_accept(drafts, arg[:len(drafts) + 1])
        toks.extend(emitted)
        pos += len(emitted)
    return toks[:out_len]


@pytest.mark.parametrize("mode", ["int8", "kv8", "int8+kv8"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_verify_streams_identical_to_generate(f32, mode, k):
    """The twin of tests/test_spec.py's
    test_verify_step_streams_identical_to_generate in its int8 and kv8
    modes: speculation through the port's verify_step, with rejections
    forced every iteration, emits exactly the port's generate stream,
    which is JAX's in fp32."""
    jcfg, jparams, jq, cfg, params, qparams = f32
    kv_int8 = "kv8" in mode
    p, jp = (qparams, jq) if "int8" in mode else (params, jparams)
    prompt = [3, 7, 11, 5, 2]
    out_len = 12
    ref = tdecode.generate(p, cfg, torch.tensor([prompt]), out_len,
                           device="cpu", kv_int8=kv_int8)[0].tolist()
    jref = jdecode.generate(jp, jcfg, jnp.asarray([prompt], jnp.int32),
                            out_len, kv_int8=kv_int8)
    assert ref == [int(t) for t in np.asarray(jref)[0]]
    for corrupt in (True, False):
        assert _spec_generate(p, cfg, prompt, out_len, k, ref, corrupt,
                              kv_int8) == ref


# -- KV8 attention: the plain version --------------------------------------------

def _kv8_inputs(seed, b, sq, skv, h, d, dtype=torch.float32):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32))

    (kq, ks), (vq, vs) = (tdecode._kv_quant(t(b, skv, h, d))
                          for _ in range(2))
    return t(b, sq, h, d).to(dtype), kq, ks, vq, vs


def _dense_kv8(q, kq, ks, vq, vs, pos):
    """Dequantize K and V and take a dense masked softmax: the reference
    of the plain version, in fp32 (its P is not rounded: fp32 inputs)."""
    b, sq, h, d = q.shape
    skv = kq.shape[1]
    k, v = kq.float() * ks, vq.float() * vs
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / math.sqrt(d)
    rows = pos.long()[:, None] + torch.arange(sq)
    ok = torch.arange(skv)[None, None, :] <= rows[:, :, None]
    p = torch.softmax(s.masked_fill(~ok[:, None], float("-inf")), -1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("sq,skv,pos0", [
    (1, 64, [0, 33]),        # decode
    (5, 64, [10, 61]),       # verify: rows 64, 65 of batch 1 past max_seq
    (16, 40, [0, 24]),       # a chunk at two offsets
    (3, 64, [62, 70]),       # every row of batch 1 past max_seq
])
def test_kv8_plain_matches_dense_dequantized_softmax(sq, skv, pos0):
    """A row past the cache's end attends every key (its causal mask
    admits them all), as the reference's does."""
    q, kq, ks, vq, vs = _kv8_inputs(7, 2, sq, skv, 3, 16)
    pos = torch.tensor(pos0, dtype=torch.int32)
    got = attention_kv8_plain(q, kq, ks, vq, vs, pos)
    np.testing.assert_allclose(got.numpy(),
                               _dense_kv8(q, kq, ks, vq, vs, pos).numpy(),
                               atol=KV8_PLAIN_TOL, rtol=KV8_PLAIN_TOL)


def test_kv8_plain_rows_do_not_depend_on_the_batch():
    """A row's result is its own: one slot alone equals its row of the
    batch, and a chunk's rows equal the same rows of a wider chunk, bit
    for bit (what the invariants of decode, verify and chunked prefill
    rest on)."""
    q, kq, ks, vq, vs = _kv8_inputs(8, 3, 8, 64, 2, 32, torch.bfloat16)
    pos = torch.tensor([5, 40, 63], dtype=torch.int32)
    full = attention_kv8_plain(q, kq, ks, vq, vs, pos)
    one = attention_kv8_plain(q[1:2], kq[1:2], ks[1:2], vq[1:2], vs[1:2],
                              pos[1:2])
    assert torch.equal(one, full[1:2])
    tail = attention_kv8_plain(q[:, 3:], kq, ks, vq, vs, pos + 3)
    assert torch.equal(tail, full[:, 3:])


def test_kv8_wrapper_takes_the_plain_path_on_the_cpu():
    q, kq, ks, vq, vs = _kv8_inputs(9, 2, 4, 48, 2, 32)
    pos = torch.tensor([3, 20], dtype=torch.int32)
    before = launch_counts()
    assert torch.equal(attention_fwd_kv8(q, kq, ks, vq, vs, pos),
                       attention_kv8_plain(q, kq, ks, vq, vs, pos))
    assert launch_counts() == before
    assert {"attention_kv8_rows", "attention_kv8_tc",
            "attention_kv8_tiled"} <= set(before)


def test_kv8_wrapper_refuses_bad_shapes_and_devices():
    q, kq, ks, vq, vs = _kv8_inputs(10, 1, 2, 16, 2, 32)
    with pytest.raises(ValueError, match="shapes"):
        attention_fwd_kv8(q, kq, ks[:, :, :1], vq, vs)
    meta = [torch.empty(t.shape, dtype=t.dtype, device="meta")
            for t in (q, kq, ks, vq, vs)]
    with pytest.raises(ValueError, match="unsupported device"):
        attention_fwd_kv8(*meta)


# -- measure_decode ---------------------------------------------------------------

def test_measure_decode_kv8_byte_model():
    """The twin of tests/test_decode.py's test_measure_decode_kv_int8_byte_model
    (on the CPU, at the stated CPU rate): KV8 charges 1 + 4 / d_head bytes
    an element, so the HBM time shrinks by exactly the KV-width delta over
    the keys the slope's steps admit (the mean of prompt + i + 1 over the
    long chain's steps beyond the short one's), not the whole cache."""
    cfg = tmodel.TransformerConfig(vocab=64, d_model=32, n_heads=2,
                                   n_layers=1, d_ff=64, max_seq=32)
    r16 = tperf.measure_decode(cfg, batch=1, steps=8, iters=1, best_of=1,
                               device="cpu")
    r8 = tperf.measure_decode(cfg, batch=1, steps=8, iters=1, best_of=1,
                              kv_int8=True, device="cpu")
    n_short, steps = 4, 8
    keys = np.mean([tperf.DECODE_PROMPT_LEN + i + 1
                    for i in range(n_short - 1, steps - 1)])
    assert keys < cfg.max_seq
    kv16 = 2.0 * cfg.n_layers * keys * cfg.d_model * 2.0
    kv8 = 2.0 * cfg.n_layers * keys * cfg.d_model * (1.0 + 4.0 / cfg.d_head)
    delta_ms = (kv16 - kv8) / tperf.CPU_DECODE_HBM_BYTES_PER_S * 1e3
    got = r16["hbm_ms_per_token"] - r8["hbm_ms_per_token"]
    assert got == pytest.approx(delta_ms, rel=1e-6)
    for r in (r16, r8):
        assert r["roofline_ms_per_token"] >= r["hbm_ms_per_token"]
        assert r["device"] == "cpu" and r["ms_per_token"] > 0


def test_measure_decode_charges_the_int8_tree_and_keeps_the_jax_keys():
    cfg = tmodel.TransformerConfig(vocab=64, d_model=32, n_heads=2,
                                   n_layers=1, d_ff=64, max_seq=32)
    plain = tperf.measure_decode(cfg, batch=2, steps=8, iters=1, best_of=1,
                                 device="cpu")
    q = tperf.measure_decode(cfg, batch=2, steps=8, iters=1, best_of=1,
                             quantized=True, device="cpu")
    wb = tmodel.param_bytes(tmodel.init_params(0, cfg, device="cpu"))
    qb = tmodel.param_bytes(tdecode.quantize_decode_params(
        tmodel.init_params(0, cfg, device="cpu")))
    assert qb < wb
    delta_ms = (wb - qb) / tperf.CPU_DECODE_HBM_BYTES_PER_S * 1e3
    assert plain["hbm_ms_per_token"] - q["hbm_ms_per_token"] \
        == pytest.approx(delta_ms, rel=1e-6)
    assert set(plain) == {"batch", "steps", "ms_per_token", "tokens_per_s",
                          "roofline_ms_per_token", "hbm_ms_per_token",
                          "compute_ms_per_token", "bound", "hbm_frac",
                          "roofline_frac", "device"}


# -- serving W8A8 through the scheduler -------------------------------------------

def _requests(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = int(rng.integers(3, 20))
        out.append((f"r{i}", tuple(int(t) for t in rng.integers(0, 256, p)),
                    int(rng.integers(2, 10))))
    return out


@pytest.mark.parametrize("chunk", [0, 8])
def test_w8a8_serve_streams_equal_jax_slot_executor(f32, chunk):
    """The same int8 tree served by both packages' Scheduler over their
    slot executors (the JAX one takes the quantized tree as it is): equal
    streams in fp32, every block returned."""
    jcfg, _, jq, cfg, _, qparams = f32
    reqs = _requests(11, 4)
    streams = {}
    for side, (srv, ex) in {
            "jax": (jserve, jserve.JaxSlotExecutor(jq, jcfg, slots=2,
                                                   chunk_tokens=chunk)),
            "port": (tserve, tserve.TorchSlotExecutor(
                qparams, cfg, slots=2, chunk_tokens=chunk,
                device="cpu"))}.items():
        sched = srv.Scheduler(srv.ServeConfig(slots=2, kv_blocks=32,
                                              kv_block_size=8,
                                              prefill_chunk_tokens=chunk), ex)
        for rid, prompt, n in reqs:
            sched.submit(srv.Request(rid=rid, prompt_len=len(prompt),
                                     output_len=n, prompt=prompt))
        sched.run()
        assert len(sched.completed) == len(reqs), side
        assert sched.pool.outstanding() == 0, side
        streams[side] = {r.rid: list(r.tokens) for r in sched.completed}
    assert streams["port"] == streams["jax"]


def test_executor_takes_the_int8_tree_and_checks_its_device(f32):
    _, _, _, cfg, _, qparams = f32
    ex = tserve.TorchSlotExecutor(qparams, cfg, slots=1, device="cpu")
    assert ex.params is qparams
    assert tdecode.params_device(qparams) == torch.device("cpu")
    with pytest.raises(ValueError, match="params live on cpu"):
        tserve.TorchSlotExecutor(qparams, cfg, slots=1, device="meta")
