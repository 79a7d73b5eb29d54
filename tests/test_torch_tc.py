"""The tensor-core attention kernels of the PyTorch/CUDA port.

bf16 at head dim 64 or 128 takes the ``wgmma`` forward (with and without
the logsumexp), dQ and dK/dV kernels; fp32 and head dim 32 keep the
CUDA-core kernels, and the one-row decode shape takes the decode kernels,
split over keys. On the CPU these tests hold the routing functions, the
tile-height rule and the decode chunk rule, and the properties the forward
and decode kernels are built around (a row's result does not depend on its
tile, nor on the batch it is decoded in) on the plain versions at the
kernels' shapes. The ``cuda`` tests hold the kernels against their plain
versions on the card and skip without one.

This file imports no JAX, so on a machine with the card and without JAX it
runs alone: ``python3 -m pytest --noconftest tests/test_torch_tc.py``.
"""

import importlib

import pytest
import torch

from dpu_operator_tpu_torch.ops import (attention_bwd_dkv,
                                        attention_bwd_dkv_plain,
                                        attention_bwd_dq,
                                        attention_bwd_dq_plain,
                                        attention_decode_plain,
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
#: the same score in fp32, where the two differ in summation order alone
TOL_F32 = 1e-4
#: decode positions around the chunk edges (the chunk is 128 keys) and the
#: last key of a 1024-key cache row
POSITIONS = (0, 1, 127, 128, 129, 1023)


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


@pytest.mark.parametrize("dtype,d,route", [
    (BF16, 128, "tc"), (BF16, 64, "tc"), (BF16, 32, "simt"),
    (F32, 128, "simt"), (F32, 64, "simt")])
def test_dq_route(dtype, d, route):
    assert fa._dq_route(dtype, d) == route


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
                 "attention_bwd_dq_tc", "attention_bwd_dkv",
                 "attention_bwd_dkv_tc"):
        assert name in counts
    fa.attention_fwd.tc_launches += 1
    try:
        assert launch_counts()["attention_fwd_tc"] == \
            counts["attention_fwd_tc"] + 1
    finally:
        reset_launch_counts()
    assert set(launch_counts().values()) == {0}


def test_launch_counts_split_dq_by_route_and_reset():
    """dQ's tensor-core launches count as ``attention_bwd_dq_tc`` and only
    there; ``attention_bwd_dq`` is the CUDA-core route alone."""
    before = launch_counts()
    fa.attention_bwd_dq.launches += 3
    fa.attention_bwd_dq.tc_launches += 2
    try:
        after = launch_counts()
        assert after["attention_bwd_dq_tc"] == \
            before["attention_bwd_dq_tc"] + 2
        assert after["attention_bwd_dq"] == before["attention_bwd_dq"] + 1
    finally:
        reset_launch_counts()
    assert launch_counts()["attention_bwd_dq_tc"] == 0
    assert fa.attention_bwd_dq.launches == 0


@pytest.mark.parametrize("pos,chunks", [(0, 1), (1, 1), (127, 1), (128, 2),
                                        (129, 2), (1023, 8)])
def test_decode_chunk_rule(pos, chunks):
    """A row at position ``pos`` admits ``pos + 1`` keys: its chunk count,
    and which blocks of the grid (8 a row over 1024 keys) work or exit."""
    assert fa.DECODE_CHUNK == 128
    assert fa._decode_chunks(pos, 1024) == chunks
    assert fa._decode_chunks(1023, 1024) == 8          # the grid a row
    works = [c * fa.DECODE_CHUNK < pos + 1 for c in range(8)]
    assert works == [c < chunks for c in range(8)]
    # past the cache row, and without the causal mask: every key
    assert fa._decode_chunks(pos + 2048, 1024) == 8
    assert fa._decode_chunks(pos, 1024, causal=False) == 8
    # a 100-key cache row is one chunk wherever the row sits
    assert fa._decode_chunks(pos, 100) == 1


def _decode_inputs(dtype, d, slots=8, h=3, max_seq=1024, seed=31,
                   device="cpu"):
    """One query row a slot over a (slots, max_seq, H, D) cache, the slots
    at POSITIONS and then at random positions."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((slots, 1, h, d), generator=g, device=device).to(dtype)
    ck, cv = (torch.randn((slots, max_seq, h, d), generator=g,
                          device=device).to(dtype) for _ in range(2))
    pos = torch.randint(0, max_seq, (slots,), generator=g, device=device,
                        dtype=torch.int32)
    pos[:len(POSITIONS)] = torch.tensor(POSITIONS, dtype=torch.int32)
    return q, ck, cv, pos


@pytest.mark.parametrize("dtype,tol", [(BF16, TOL_BF16), (F32, TOL_F32)])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_plain_split_decode_matches_plain_forward(dtype, tol, d):
    """The decode kernels' split-and-combine, in plain PyTorch, against the
    forward's plain version (key blocks of 64, one running max) at every
    position of POSITIONS: the two round P against different maxima."""
    q, ck, cv, pos = _decode_inputs(dtype, d)
    got = attention_decode_plain(q, ck, cv, pos)
    want = attention_fwd_plain(q, ck, cv, pos)
    assert got.shape == want.shape and got.dtype == dtype
    assert _scaled_err(got, want) <= tol


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_plain_split_decode_row_does_not_depend_on_the_batch(dtype):
    """The decode kernels' invariant on the plain split: each slot's row
    decoded alone (1 slot) equals the same row in the 8-slot batch bit for
    bit, at every position of POSITIONS."""
    q, ck, cv, pos = _decode_inputs(dtype, 128)
    batch = attention_decode_plain(q, ck, cv, pos)
    for i in range(q.shape[0]):
        one = attention_decode_plain(q[i:i + 1], ck[i:i + 1], cv[i:i + 1],
                                     pos[i:i + 1])
        assert torch.equal(one, batch[i:i + 1]), i


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
    # dQ takes the tensor-core rule too
    qf, kf, vf, dof = (t.float().contiguous() for t in (q, k, v, do))
    out_f, lse_f = attention_fwd_lse(qf, kf, vf)
    mid = launch_counts()
    attention_bwd_dq(q, k, v, do, lse, attention_delta(do, out))
    attention_bwd_dq(qf, kf, vf, dof, lse_f, attention_delta(dof, out_f))
    end = launch_counts()
    assert end["attention_bwd_dq"] == mid["attention_bwd_dq"] + 2
    assert end["attention_bwd_dq_tc"] == mid["attention_bwd_dq_tc"]


@pytest.mark.parametrize("s", [50, 130, 1000])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_tc_dq_matches_plain(cuda, tile, s, d, causal):
    q, k, v, do = _projection(cuda, 2, s, 3, d, seed=26)
    out, lse = attention_fwd_lse(q, k, v, causal)
    delta = attention_delta(do, out)
    before = launch_counts()
    dq = attention_bwd_dq(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["attention_bwd_dq_tc"] == before["attention_bwd_dq_tc"] + 1
    assert after["attention_bwd_dq"] == before["attention_bwd_dq"]
    dq_p = attention_bwd_dq_plain(q, k, v, do, lse, delta, causal)
    assert _scaled_err(dq, dq_p) <= TOL_BF16
    # no atomics: the same inputs give the same dQ bit for bit
    assert torch.equal(dq, attention_bwd_dq(q, k, v, do, lse, delta, causal))


@pytest.mark.parametrize("seed", [1, 1234])
def test_cuda_tc_dq_matches_plain_at_the_train_shape(cuda, seed):
    """8 x 1024 x 12 x 128, the train step's shape: dS rounded to bf16 from
    dot products that the tensor cores sum in another order than the plain
    version's fp32 matmul, held to the per-element limit."""
    q, k, v, do = _projection(cuda, 8, 1024, 12, 128, seed)
    out, lse = attention_fwd_lse(q, k, v)
    delta = attention_delta(do, out)
    dq = attention_bwd_dq(q, k, v, do, lse, delta)
    dq_p = attention_bwd_dq_plain(q, k, v, do, lse, delta)
    assert _scaled_err(dq, dq_p) <= TOL_BF16


@pytest.mark.parametrize("dtype,tol", [(BF16, TOL_BF16), (F32, TOL_F32)])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_cuda_decode_matches_plain(cuda, dtype, tol, d):
    """The split decode kernels against the forward's plain version over a
    slotted cache, one slot at each position of POSITIONS, and against the
    plain split, which rounds P against the same chunk maxima."""
    q, ck, cv, pos = _decode_inputs(dtype, d, device=cuda)
    before = launch_counts()
    got = attention_fwd(q, ck, cv, pos)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["attention_fwd_decode"] == before["attention_fwd_decode"] + 1
    assert _scaled_err(got, attention_fwd_plain(q, ck, cv, pos)) <= tol
    assert _scaled_err(got, attention_decode_plain(q, ck, cv, pos)) <= tol


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_cuda_decode_row_does_not_depend_on_the_batch(cuda, dtype):
    """The decode kernels' invariant on the card: a slot's row launched
    alone (1 slot) equals the same row of the 8-slot launch bit for bit,
    and two launches on the same inputs give the same output."""
    q, ck, cv, pos = _decode_inputs(dtype, 128, device=cuda)
    batch = attention_fwd(q, ck, cv, pos)
    for i in range(q.shape[0]):
        one = attention_fwd(q[i:i + 1], ck[i:i + 1], cv[i:i + 1],
                            pos[i:i + 1])
        assert torch.equal(one, batch[i:i + 1]), i
    assert torch.equal(batch, attention_fwd(q, ck, cv, pos))
