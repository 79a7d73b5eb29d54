"""Kernels of the PyTorch/CUDA port against the JAX package's kernels.

On the CPU each wrapper takes its plain PyTorch version; these tests hold
that version against the JAX function (the Pallas kernel in interpret
mode) on the same numpy inputs, and check the properties the CUDA kernels
are built around. The CUDA kernels themselves run in the ``cuda`` tests,
which skip without a card (``chip_smoke.py`` runs them on one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpu_operator_tpu.ops.flash_attention import flash_attention as jax_flash
from dpu_operator_tpu.ops.rmsnorm import fused_rmsnorm as jax_rmsnorm
from dpu_operator_tpu_torch.ops import (attention_fwd, attention_fwd_plain,
                                        flash_attention, fused_rmsnorm,
                                        fused_rmsnorm_plain, launch_counts)

#: bf16 keeps 8 significant bits: one rounding step is 2^-8 relative
BF16_STEP = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode; "
                    "chip_smoke.py runs them on the card)")
    return torch.device("cuda")


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_jax_fused_rmsnorm(dtype):
    rng = _rng(0)
    x = rng.standard_normal((4, 32, 64)).astype(np.float32) * 3.0
    scale = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(jax_rmsnorm(jnp.asarray(x, jdt),
                                  jnp.asarray(scale, jdt)), np.float32)
    got = fused_rmsnorm(torch.from_numpy(x).to(tdt),
                        torch.from_numpy(scale).to(tdt))
    assert got.dtype == tdt and got.shape == x.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    else:
        # both round one fp32 result to bf16: at most one step apart
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=BF16_STEP, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_plain_matches_jax_flash_attention(causal):
    rng = _rng(1)
    q, k, v = (rng.standard_normal((2, 48, 2, 16)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                block_q=16, block_k=16))
    got = flash_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                          causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("d", [8, 48])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_plain_matches_jax_flash_attention_at_other_head_dims(
        d, causal):
    """The same parity at bench.py's head dim (8) and at one between the
    kernels' compiled head dims (48): the card zero-pads both (to 32 and
    64) and scales by 1 / sqrt(D), the function this holds to JAX's."""
    rng = _rng(7)
    q, k, v = (rng.standard_normal((2, 48, 2, d)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                block_q=16, block_k=16))
    got = flash_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                          causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=1e-5)


def _dense_reference(q, k, v, pos0, causal):
    """float64 softmax attention with row i of batch b at pos0[b] + i."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(d)
    if causal:
        rows = pos0[:, None] + np.arange(sq)[None]
        ok = np.arange(skv)[None, None, :] <= rows[:, :, None]
        s = np.where(ok[:, None], s, -np.inf)
    s = np.exp(s - s.max(-1, keepdims=True))
    p = s / s.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v.astype(np.float64))


@pytest.mark.parametrize("sq,skv,pos0", [
    (1, 64, [0, 63]),          # decode: one query, the whole cache row
    (5, 70, [3, 60]),          # verify / chunk, ragged key count
    (13, 130, [0, 117]),       # several key blocks
])
def test_attention_at_offset_matches_dense_masked_softmax(sq, skv, pos0):
    rng = _rng(2)
    q = rng.standard_normal((2, sq, 3, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, skv, 3, 32)).astype(np.float32)
            for _ in range(2))
    pos = np.asarray(pos0, np.int32)
    got = attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(),
                               _dense_reference(q, k, v, pos, True),
                               atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_rows_do_not_depend_on_neighbours_or_cache_length(dtype):
    """The design property chunked prefill rests on: rows [a, b) computed
    alone at offset a, against a longer cache row whose extra keys hold
    garbage, equal the same rows of the whole-prompt computation bit for
    bit."""
    g = torch.Generator().manual_seed(3)
    p, max_seq = 37, 96
    q, k, v = (torch.randn((1, p, 2, 32), generator=g).to(dtype)
               for _ in range(3))
    whole = attention_fwd(q, k, v)
    ck, cv = (torch.randn((1, max_seq, 2, 32), generator=g).to(dtype)
              for _ in range(2))
    ck[:, :p], cv[:, :p] = k, v
    for a, b in ((0, 5), (5, 21), (21, 37), (36, 37)):
        part = attention_fwd(q[:, a:b], ck, cv,
                             torch.tensor([a], dtype=torch.int32))
        assert torch.equal(part, whole[:, a:b]), (a, b)


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    before = launch_counts()
    x = torch.randn(3, 16)
    assert torch.equal(fused_rmsnorm(x, torch.ones(16)),
                       fused_rmsnorm_plain(x, torch.ones(16)))
    q = torch.randn(1, 4, 2, 32)
    assert torch.equal(attention_fwd(q, q, q), attention_fwd_plain(q, q, q))
    assert launch_counts() == before


def test_wrappers_refuse_other_devices():
    x = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_rmsnorm(x, torch.empty(8, device="meta"))
    q = torch.empty((1, 2, 1, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attention_fwd(q, q, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_rmsnorm_kernel_matches_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(4)
    for rows, d in ((8, 1536), (300, 1536), (5, 100)):
        x = torch.randn((rows, d), generator=g, device=cuda).to(dtype)
        scale = torch.rand((d,), generator=g, device=cuda).to(dtype) + 0.5
        n = fused_rmsnorm.launches
        got = fused_rmsnorm(x, scale)
        assert fused_rmsnorm.launches == n + 1
        want = fused_rmsnorm_plain(x, scale)
        tol = 1e-5 if dtype == torch.float32 else BF16_STEP
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,d,pos0", [
    (1, 1024, 128, [0, 511, 1023]), (256, 1024, 128, [256, 0, 700]),
    (70, 70, 64, [0, 0, 0]), (3, 77, 32, [5, 60, 74])])
def test_cuda_attention_kernel_matches_plain(cuda, dtype, sq, skv, d, pos0):
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((3, sq, 4, d), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((3, skv, 4, d), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    pos = torch.tensor(pos0, dtype=torch.int32, device=cuda)
    n = attention_fwd.launches
    got = attention_fwd(q, k, v, pos)
    assert attention_fwd.launches == n + 1
    want = attention_fwd_plain(q, k, v, pos)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
