"""The tensor-core attention kernels of the PyTorch/CUDA port.

bf16 at head dim 64 or 128 takes the ``wgmma`` forward (with and without
the logsumexp) and dK/dV kernels; fp32, head dim 32 and the one-row decode
shape keep the CUDA-core kernels. On the CPU these tests hold the routing
functions and the tile-height rule, and the property the forward kernel is
built around (a row's result does not depend on its tile) on the plain
version at the kernel's shapes. The ``cuda`` tests hold the kernels against
their plain versions on the card and skip without one.

This file imports no JAX, so on a machine with the card and without JAX it
runs alone: ``python3 -m pytest --noconftest tests/test_torch_tc.py``.
"""

import importlib

import pytest
import torch

from dpu_operator_tpu_torch.ops import (attention_bwd_dkv,
                                        attention_bwd_dkv_plain,
                                        attention_delta, attention_fwd,
                                        attention_fwd_lse,
                                        attention_fwd_plain, launch_counts,
                                        reset_launch_counts)

#: the module (the package's ``flash_attention`` name is the function)
fa = importlib.import_module("dpu_operator_tpu_torch.ops.flash_attention")

BF16, F32 = torch.bfloat16, torch.float32
#: kernel vs plain in bf16: the largest of |kernel - plain| / (|plain| +
#: rms(plain)) (chip_smoke.py's score and limit; the two round P, dS and
#: the output at the same places and differ in summation order)
TOL_BF16 = 1.5e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode; "
                    "chip_smoke.py runs them on the card)")
    return torch.device("cuda")


# -- routing, on the CPU -------------------------------------------------------

@pytest.mark.parametrize("dtype,d,sq,with_lse,route", [
    (BF16, 128, 512, False, "tc"),      # whole-prompt prefill
    (BF16, 128, 256, False, "tc"),      # a prefill chunk
    (BF16, 64, 300, False, "tc"),
    (BF16, 128, 1024, True, "tc"),      # the training forward
    (BF16, 64, 1000, True, "tc"),
    (BF16, 128, 1, True, "tc"),         # with the lse, one row is tiled
    (BF16, 128, 1, False, "decode"),
    (F32, 128, 1, False, "decode"),
    (F32, 128, 1024, True, "simt"),     # wgmma has no fp32 operand
    (F32, 64, 512, False, "simt"),
    (BF16, 32, 512, False, "simt"),     # D 32: the CUDA-core kernel
    (BF16, 32, 77, True, "simt"),
])
def test_attention_route(dtype, d, sq, with_lse, route):
    assert fa._attn_route(dtype, d, sq, with_lse) == route


@pytest.mark.parametrize("dtype,d,route", [
    (BF16, 128, "tc"), (BF16, 64, "tc"), (BF16, 32, "simt"),
    (F32, 128, "simt"), (F32, 64, "simt")])
def test_dkv_route(dtype, d, route):
    assert fa._dkv_route(dtype, d) == route


@pytest.mark.parametrize("b,n,h,sms,rows", [
    (1, 512, 12, 132, 64),     # prefill: 48 blocks at 128 rows, 96 at 64
    (1, 256, 12, 132, 64),     # a 256-row chunk: 24 and 48
    (8, 1024, 12, 132, 128),   # the train step: 768 at 128
    (1, 1024, 12, 132, 64),    # one sequence (dK/dV: 96 key blocks at 128)
    (2, 1024, 12, 132, 128),   # 192 at 128
    (1, 1408, 12, 132, 128),   # exactly 132 blocks fill the card
    (1, 1280, 12, 132, 64),    # 120 do not
    (1, 512, 12, 48, 128),     # a card with fewer SMs
])
def test_tile_rows(b, n, h, sms, rows):
    assert fa._tile_rows(b, n, h, sms) == rows


def test_launch_counts_name_every_route_and_reset():
    counts = launch_counts()
    for name in ("attention_fwd_tiled", "attention_fwd_decode",
                 "attention_fwd_tc", "attention_fwd_lse",
                 "attention_fwd_lse_tc", "attention_bwd_dq",
                 "attention_bwd_dkv", "attention_bwd_dkv_tc"):
        assert name in counts
    fa.attention_fwd.tc_launches += 1
    try:
        assert launch_counts()["attention_fwd_tc"] == \
            counts["attention_fwd_tc"] + 1
    finally:
        reset_launch_counts()
    assert set(launch_counts().values()) == {0}


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("offset,width", [(0, 64), (64, 100), (256, 64),
                                          (300, 33)])
def test_plain_chunk_equals_whole_at_tc_head_dims(d, offset, width):
    """The forward's design property at the tensor-core head dims, on the
    plain version: rows [offset, offset + width) computed alone against a
    longer cache row equal the whole prompt's rows bit for bit in bf16."""
    g = torch.Generator().manual_seed(11)
    p, max_seq = 400, 512
    q, k, v = (torch.randn((1, p, 1, d), generator=g).to(BF16)
               for _ in range(3))
    whole = attention_fwd(q, k, v)
    ck, cv = (torch.randn((1, max_seq, 1, d), generator=g).to(BF16)
              for _ in range(2))
    ck[:, :p], cv[:, :p] = k, v
    part = attention_fwd(q[:, offset:offset + width], ck, cv,
                         torch.tensor([offset], dtype=torch.int32))
    assert torch.equal(part, whole[:, offset:offset + width])


# -- the kernels, on the card ----------------------------------------------------

def _scaled_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    g, r = got.float(), ref.float()
    rms = max(float(r.square().mean().sqrt()), 1e-30)
    return float(((g - r).abs() / (r.abs() + rms)).max())


@pytest.fixture(params=[64, 128], ids=["tile64", "tile128"])
def tile(request, monkeypatch):
    """Both tile heights at small shapes: the SM count the rule sees is
    set so that the grid decides for one or two warpgroups a block."""
    rows = request.param
    monkeypatch.setattr(fa, "_sms", lambda device: 1 if rows == 128
                        else 1 << 30)
    return rows


def _projection(dev, b, s, h, d, seed):
    """q, k, v as views of one (B, S, 3HD) bf16 projection, and dO."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((b, s, 3 * h * d), generator=g, device=dev).to(BF16)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, -1))
    do = torch.randn((b, s, h, d), generator=g, device=dev).to(BF16)
    return q, k, v, do


@pytest.mark.parametrize("s", [50, 130, 1000])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_tc_forward_matches_plain(cuda, tile, s, d, causal):
    q, k, v, _ = _projection(cuda, 2, s, 3, d, seed=21)
    before = launch_counts()
    out, lse = attention_fwd_lse(q, k, v, causal)
    out2 = attention_fwd(q, k, v, None, causal)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["attention_fwd_lse_tc"] == before["attention_fwd_lse_tc"] + 1
    assert after["attention_fwd_tc"] == before["attention_fwd_tc"] + 1
    assert after["attention_fwd_lse"] == before["attention_fwd_lse"]
    assert after["attention_fwd_tiled"] == before["attention_fwd_tiled"]
    out_p, lse_p = attention_fwd_plain(q, k, v, None, causal,
                                       return_lse=True)
    assert _scaled_err(out, out_p) <= TOL_BF16
    assert _scaled_err(lse, lse_p) <= TOL_BF16
    # the lse output changes nothing else: same kernel, same rows
    assert torch.equal(out, out2)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("offset", [0, 64, 256, 300])
def test_cuda_tc_forward_at_offset_over_a_slot_row(cuda, tile, d, offset):
    """A chunk of 130 rows at ``offset`` against one slot's row of a
    (slots, max_seq, H, D) cache (a strided view, no copy), as chunked
    prefill calls it, against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(22)
    h, max_seq = 3, 512
    ck, cv = (torch.randn((4, max_seq, h, d), generator=g,
                          device=cuda).to(BF16) for _ in range(2))
    q = torch.randn((1, 130, h, d), generator=g, device=cuda).to(BF16)
    pos = torch.tensor([offset], dtype=torch.int32, device=cuda)
    got = attention_fwd(q, ck[2:3], cv[2:3], pos)
    want = attention_fwd_plain(q, ck[2:3], cv[2:3], pos)
    assert _scaled_err(got, want) <= TOL_BF16


@pytest.mark.parametrize("d", [64, 128])
def test_cuda_tc_chunk_equals_whole_prefill(cuda, tile, d):
    """The forward's invariant on the card: chunks of a prompt computed
    against the cache row equal the whole prompt's rows bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(23)
    h, p, max_seq = 3, 512, 1024
    q, k, v = (torch.randn((1, p, h, d), generator=g, device=cuda).to(BF16)
               for _ in range(3))
    whole = attention_fwd(q, k, v)
    ck, cv = (torch.randn((2, max_seq, h, d), generator=g,
                          device=cuda).to(BF16) for _ in range(2))
    ck[1, :p], cv[1, :p] = k[0], v[0]
    for a, b in ((0, 256), (256, 512), (64, 130), (300, 512)):
        pos = torch.tensor([a], dtype=torch.int32, device=cuda)
        part = attention_fwd(q[:, a:b], ck[1:2], cv[1:2], pos)
        assert torch.equal(part, whole[:, a:b]), (a, b)


@pytest.mark.parametrize("s", [50, 130, 1000])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_tc_dkv_matches_plain(cuda, tile, s, d, causal):
    q, k, v, do = _projection(cuda, 2, s, 3, d, seed=24)
    out, lse = attention_fwd_lse(q, k, v, causal)
    delta = attention_delta(do, out)
    before = launch_counts()
    dk, dv = attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["attention_bwd_dkv_tc"] == before["attention_bwd_dkv_tc"] + 1
    assert after["attention_bwd_dkv"] == before["attention_bwd_dkv"]
    dk_p, dv_p = attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal)
    assert _scaled_err(dk, dk_p) <= TOL_BF16
    assert _scaled_err(dv, dv_p) <= TOL_BF16


@pytest.mark.parametrize("seed", [1, 1234])
def test_cuda_tc_dkv_matches_plain_at_the_train_shape(cuda, seed):
    """8 x 1024 x 12 x 128, where a P or dS rounded to bf16 on the other
    side of a rounding midpoint than the plain version (their fp32 dot
    products sum in different orders) shows as a dV / dK row one bf16 step
    off: the kernel re-decides such roundings from the sequential dot
    product, and holds the per-element limit."""
    q, k, v, do = _projection(cuda, 8, 1024, 12, 128, seed)
    out, lse = attention_fwd_lse(q, k, v)
    delta = attention_delta(do, out)
    dk, dv = attention_bwd_dkv(q, k, v, do, lse, delta)
    dk_p, dv_p = attention_bwd_dkv_plain(q, k, v, do, lse, delta)
    assert _scaled_err(dk, dk_p) <= TOL_BF16
    assert _scaled_err(dv, dv_p) <= TOL_BF16


def test_cuda_fp32_and_head_dim_32_keep_the_cuda_core_kernels(cuda):
    q, k, v, do = _projection(cuda, 1, 70, 2, 32, seed=25)
    before = launch_counts()
    out, lse = attention_fwd_lse(q, k, v)
    attention_bwd_dkv(q, k, v, do, lse, attention_delta(do, out))
    qf, kf, vf = (t.float() for t in (q, k, v))
    attention_fwd(qf.contiguous(), kf.contiguous(), vf.contiguous())
    after = launch_counts()
    assert after["attention_fwd_lse"] == before["attention_fwd_lse"] + 1
    assert after["attention_bwd_dkv"] == before["attention_bwd_dkv"] + 1
    assert after["attention_fwd_tiled"] == before["attention_fwd_tiled"] + 1
    for name in ("attention_fwd_tc", "attention_fwd_lse_tc",
                 "attention_bwd_dkv_tc"):
        assert after[name] == before[name]
