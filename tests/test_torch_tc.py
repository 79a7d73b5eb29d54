"""The tensor-core attention kernels of the PyTorch/CUDA port.

bf16 takes the ``wgmma`` forward (with and without the logsumexp), dQ and
dK/dV kernels; fp32 takes the 3xTF32 forward and dK/dV kernels and the
CUDA-core dQ kernel; the one-row decode shape takes the decode kernels,
split over keys; attention over the int8 KV cache (KV8) takes the cluster
kernel for up to ``KV8_ROWS_MAX`` rows, the tensor cores for more rows in
bf16 at a padded head dim of 64 / 128 / 256, else the tiled KV8 kernel.
Every head dim from 1 to 256 runs, zero-padded to the route's next compiled
head dim. On the CPU these tests hold the routing functions, the padded head
dim, the tile-height rule and the decode chunk rule, the exactness of the
pad on the plain versions, a CPU emulation of the 3xTF32 products, and the
properties the forward and decode kernels are built around (a row's result
does not depend on its tile, nor on the batch it is decoded in) on the
plain versions at the kernels' shapes. The ``cuda`` tests hold the kernels
against their plain versions on the card and skip without one.

This file imports no JAX, so on a machine with the card and without JAX it
runs alone: ``python3 -m pytest --noconftest tests/test_torch_tc.py``.
"""

import importlib
import math

import pytest
import torch

from dpu_operator_tpu_torch.ops import (attention_bwd_dkv,
                                        attention_bwd_dkv_plain,
                                        attention_bwd_dq,
                                        attention_bwd_dq_plain,
                                        attention_decode_plain,
                                        attention_delta, attention_fwd,
                                        attention_fwd_lse,
                                        attention_fwd_kv8,
                                        attention_fwd_plain,
                                        attention_kv8_plain, launch_counts,
                                        reset_launch_counts)
from dpu_operator_tpu_torch.workloads import decode

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
    (BF16, 128, 5, False, "tc"),        # speculative verify, k = 4
    (BF16, 128, 2, False, "tc"),        # speculative verify, k = 1
    (F32, 128, 4, False, "tf32"),
    (BF16, 128, 1024, True, "tc"),      # the training forward
    (BF16, 64, 1000, True, "tc"),
    (BF16, 128, 1, True, "tc"),         # with the lse, one row is tiled
    (BF16, 128, 1, False, "decode"),
    (F32, 128, 1, False, "decode"),
    (F32, 128, 1024, True, "tf32"),     # fp32: 3xTF32 on the tensor cores
    (F32, 64, 512, False, "tf32"),
    (BF16, 32, 512, False, "tc"),       # D 32: padded to 64
    (BF16, 32, 77, True, "tc"),
    (BF16, 16, 512, False, "tc"),       # the default config's head dim
    (BF16, 16, 1, True, "tc"),
    (BF16, 16, 1, False, "decode"),
    (F32, 16, 64, True, "tf32"),
    (F32, 8, 48, False, "tf32"),        # bench.py's config
    (BF16, 256, 512, False, "tc"),      # head dim 256 (Gemma's)
    (BF16, 160, 1, False, "decode"),
    (F32, 256, 1024, True, "tf32"),
])
def test_attention_route(dtype, d, sq, with_lse, route):
    assert fa._attn_route(dtype, d, sq, with_lse) == route


#: KV8 widths: decode, verify at k 1, the widest cluster launch, one row
#: past it, and a prefill chunk
KV8_WIDTHS = (1, 2, fa.KV8_ROWS_MAX, fa.KV8_ROWS_MAX + 1, 256)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("d", [16, 32, 48, 64, 128, 160, 256])
@pytest.mark.parametrize("sq", KV8_WIDTHS)
def test_kv8_route(dtype, d, sq):
    """Up to KV8_ROWS_MAX rows take the cluster kernel in every type and
    head dim; more rows the tensor cores in bf16 at a padded head dim of 64
    / 128 / 256 (D 33-256) and the tiled CUDA-core KV8 kernel otherwise
    (fp32, or D up to 32, padded to 32)."""
    if sq <= 8:
        want = "rows"
    elif dtype == BF16 and d > 32:
        want = "tc"
    else:
        want = "simt"
    assert fa.KV8_ROWS_MAX == 8
    assert fa._kv8_route(dtype, d, sq) == want


@pytest.mark.parametrize("dtype,d,route", [
    (BF16, 128, "tc"), (BF16, 64, "tc"), (BF16, 32, "tc"),
    (BF16, 16, "tc"), (F32, 128, "tf32"), (F32, 64, "tf32"),
    (F32, 16, "tf32"), (BF16, 256, "tc"), (F32, 200, "tf32")])
def test_dkv_route(dtype, d, route):
    assert fa._dkv_route(dtype, d) == route


@pytest.mark.parametrize("dtype,d,route", [
    (BF16, 128, "tc"), (BF16, 64, "tc"), (BF16, 32, "tc"),
    (BF16, 16, "tc"), (F32, 128, "simt"), (F32, 64, "simt"),
    (F32, 16, "simt"), (BF16, 256, "tc"), (F32, 200, "simt")])
def test_dq_route(dtype, d, route):
    assert fa._dq_route(dtype, d) == route


#: D' of every route at the head dims of the repository's configs (8:
#: bench.py; 16: the default config; 128: the flagship; 256: the flagship
#: at 6 heads, and Gemma's) and between: (the bf16 tensor-core routes,
#: every other route)
PAD_CASES = {1: (64, 32), 8: (64, 32), 16: (64, 32), 33: (64, 64),
             48: (64, 64), 64: (64, 64), 80: (128, 128), 96: (128, 128),
             128: (128, 128), 129: (256, 256), 160: (256, 256),
             192: (256, 256), 256: (256, 256)}


@pytest.mark.parametrize("route", ["tc", "tf32", "simt", "decode", "rows"])
@pytest.mark.parametrize("d", sorted(PAD_CASES))
def test_padded_dim(route, d):
    """The bf16 tensor-core routes pad to 64, 128 or 256; every other
    route (fp32 3xTF32, the CUDA-core dQ and KV8 kernels, decode, the KV8
    cluster kernel) to 32, 64, 128 or 256."""
    want = PAD_CASES[d][0 if route == "tc" else 1]
    assert fa._padded_dim(route, d) == want


@pytest.mark.parametrize("route", ["tc", "tf32", "simt", "decode", "rows"])
@pytest.mark.parametrize("d", [0, 257, 512])
def test_padded_dim_refuses_what_no_kernel_takes(route, d):
    with pytest.raises(ValueError, match="take head dims 1 to 256"):
        fa._padded_dim(route, d)


@pytest.mark.parametrize("kernel,cap", [("fwd_tc", 64), ("kv8_tc", 64),
                                        ("dq_tc", 64), ("dkv_tc", 64),
                                        ("dkv_tf32", 32)])
@pytest.mark.parametrize("rows", [32, 64, 128])
def test_capped_tile_at_head_dim_256(kernel, cap, rows):
    """At head dim 256 the bf16 forward, dQ, dK/dV and KV8 kernels take
    64-row (64-key) blocks and the 3xTF32 dK/dV kernel 32-key blocks,
    whatever :func:`_tile_rows` gives; every other head dim keeps its
    tile."""
    assert fa._capped_tile(kernel, 256, rows) == min(rows, cap)
    for dp in (32, 64, 128):
        assert fa._capped_tile(kernel, dp, rows) == rows


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


@pytest.mark.parametrize("b,n,h,sms,rows", [
    (1, 512, 12, 132, 32),     # 96 key blocks at 64 keys
    (1, 1024, 12, 132, 64),    # one fp32 training sequence: 192
    (1, 1000, 12, 132, 64),
    (1, 64, 8, 132, 32),       # the default config
])
def test_tile_rows_of_the_3xtf32_kernels(b, n, h, sms, rows):
    """The 3xTF32 dK/dV kernel's blocks: 64 keys (four key groups of two
    warps), or 32 when 64-key blocks would not give every SM one; the
    3xTF32 forward always takes 64 rows (one warpgroup)."""
    assert fa._tile_rows(b, n, h, sms, 64) == rows
    cpu = torch.device("cpu")
    assert fa._fwd_tile_rows("tf32", 128, b, n, h, cpu) == 64
    assert fa._fwd_tile_rows("tf32", 256, b, n, h, cpu) == 64


def test_launch_counts_name_every_route_and_reset():
    counts = launch_counts()
    for name in ("attention_fwd_tf32", "attention_fwd_decode",
                 "attention_fwd_tc", "attention_fwd_lse_tf32",
                 "attention_fwd_lse_tc", "attention_bwd_dq",
                 "attention_bwd_dq_tc", "attention_bwd_dkv_tf32",
                 "attention_bwd_dkv_tc"):
        assert name in counts
    # the CUDA-core forward and dK/dV kernels are gone
    assert not {"attention_fwd_tiled", "attention_fwd_lse",
                "attention_bwd_dkv"} & set(counts)
    fa.attention_fwd.tc_launches += 1
    try:
        assert launch_counts()["attention_fwd_tc"] == \
            counts["attention_fwd_tc"] + 1
    finally:
        reset_launch_counts()
    assert set(launch_counts().values()) == {0}


def test_launch_counts_carry_the_kv8_routes_and_reset():
    """Each KV8 route counts under its own name: the cluster kernel as
    ``attention_kv8_rows``, the tensor cores as ``attention_kv8_tc``, the
    tiled kernel as ``attention_kv8_tiled`` (the rest of the launches)."""
    before = launch_counts()
    kv8 = fa.attention_fwd_kv8
    kv8.launches += 6
    kv8.rows_launches += 3
    kv8.tc_launches += 2
    try:
        after = launch_counts()
        for name, n in (("attention_kv8_rows", 3), ("attention_kv8_tc", 2),
                        ("attention_kv8_tiled", 1)):
            assert after[name] == before[name] + n, name
        assert "attention_kv8_decode" not in after
    finally:
        reset_launch_counts()
    assert all(launch_counts()[name] == 0 for name in (
        "attention_kv8_rows", "attention_kv8_tc", "attention_kv8_tiled"))
    assert kv8.launches == kv8.rows_launches == kv8.tc_launches == 0


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


# -- the head-dim pad, on the plain versions ------------------------------------

#: the pad's exactness on the plain versions: zero columns add exact zeros
#: to every product, so padded and unpadded runs differ only where a sum
#: over the last dim is vectorized differently at the two widths (fp32
#: noise, measured at most about 3e-7 here)
TOL_PAD = 2e-6
PAD_DIMS = (8, 16, 48, 80, 160)


def _pad(t: torch.Tensor, dp: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, dp - t.shape[-1]))


@pytest.mark.parametrize("route", ["tc", "tf32"])
@pytest.mark.parametrize("d", PAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_at_the_padded_head_dim(route, d, causal):
    """``attention_fwd_plain`` of the zero-padded q, k, v at the true D's
    scale equals the unpadded run in its first D columns (and the lse), and
    its padded columns are exactly zero: rows at an offset over a longer
    cache row, the way a wrapper launches a padded chunk."""
    g = torch.Generator().manual_seed(51)
    dp = fa._padded_dim(route, d)
    q = torch.randn((2, 19, 3, d), generator=g)
    k, v = (torch.randn((2, 150, 3, d), generator=g) for _ in range(2))
    pos = torch.tensor([0, 77], dtype=torch.int32)
    want, lse = attention_fwd_plain(q, k, v, pos, causal, return_lse=True)
    got, lse_p = attention_fwd_plain(_pad(q, dp), _pad(k, dp), _pad(v, dp),
                                     pos, causal, return_lse=True,
                                     sm_scale=d ** -0.5)
    assert _scaled_err(got[..., :d], want) <= TOL_PAD
    assert _scaled_err(lse_p, lse) <= TOL_PAD
    assert not got[..., d:].any()
    # without the true scale, the padded run would be another function
    wrong = attention_fwd_plain(_pad(q, dp), _pad(k, dp), _pad(v, dp), pos,
                                causal)
    assert _scaled_err(wrong[..., :d], want) > 1e-3


@pytest.mark.parametrize("d", PAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_kv8_at_the_padded_head_dim(d, causal):
    """``attention_kv8_plain`` over int8 K / V padded with zero columns (the
    scales are per key and head: not padded) at the true D's scale."""
    g = torch.Generator().manual_seed(52)
    dp = fa._padded_dim("simt", d)
    (kq, ks), (vq, vs) = (decode._kv_quant(torch.randn((2, 150, 3, d),
                                                       generator=g))
                          for _ in range(2))
    q = torch.randn((2, 9, 3, d), generator=g)
    pos = torch.tensor([3, 120], dtype=torch.int32)
    want = attention_kv8_plain(q, kq, ks, vq, vs, pos, causal)
    got = attention_kv8_plain(_pad(q, dp), _pad(kq, dp), ks, _pad(vq, dp),
                              vs, pos, causal, sm_scale=d ** -0.5)
    assert _scaled_err(got[..., :d], want) <= TOL_PAD
    assert not got[..., d:].any()


@pytest.mark.parametrize("route", ["tc", "tf32"])
@pytest.mark.parametrize("d", PAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_at_the_padded_head_dim(route, d, causal):
    """dQ, dK and dV of the plain walks on zero-padded q, k, v, dO at the
    true D's scale (lse and delta come from the unpadded forward: the pad
    leaves both unchanged) equal the unpadded ones in their first D
    columns; the padded columns are exactly zero."""
    g = torch.Generator().manual_seed(53)
    dp = fa._padded_dim(route, d)
    q, k, v, do = (torch.randn((2, 70, 3, d), generator=g) for _ in range(4))
    out, lse = attention_fwd_plain(q, k, v, None, causal, return_lse=True)
    delta = attention_delta(do, out)
    want = (attention_bwd_dq_plain(q, k, v, do, lse, delta, causal),
            *attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal))
    padded = [_pad(t, dp) for t in (q, k, v, do)]
    scale = d ** -0.5
    got = (attention_bwd_dq_plain(*padded, lse, delta, causal,
                                  sm_scale=scale),
           *attention_bwd_dkv_plain(*padded, lse, delta, causal,
                                    sm_scale=scale))
    for gt, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert _scaled_err(gt[..., :d], w) <= TOL_PAD, name
        assert not gt[..., d:].any(), name
    _, lse_p = attention_fwd_plain(*padded[:3], None, causal,
                                   return_lse=True, sm_scale=scale)
    delta_p = attention_delta(padded[3], _pad(out, dp))
    assert _scaled_err(lse_p, lse) <= TOL_PAD
    assert _scaled_err(delta_p, delta) <= TOL_PAD


# -- 3xTF32, emulated on the CPU ------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest on the
    top 10 mantissa bits, ties away from zero (adding half of the dropped
    13 bits' range to the magnitude carries into the kept bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_tf32(a: torch.Tensor, b: torch.Tensor, pieces: int) -> torch.Tensor:
    """a @ b with TF32 operands in fp32 accumulators: one product of the
    rounded operands, or three of their hi / lo parts (small terms first),
    as the fp32 kernels take them."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if pieces == 1:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _attention_tf32(q, k, v, pieces: int) -> torch.Tensor:
    """Causal attention of (B, S, H, D) fp32 with both products taken as
    :func:`_mm_tf32` and the softmax in fp32, as the kernel does (one key
    block: the online softmax changes nothing but the summation order)."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))     # (B, H, S, D)
    s = _mm_tf32(qh, kh.transpose(-1, -2), pieces) * (math.log2(math.e)
                                                      / math.sqrt(q.shape[3]))
    n = q.shape[1]
    s = s.masked_fill(torch.ones(n, n, dtype=torch.bool).triu(1), -1e30)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    out = _mm_tf32(p, vh, pieces) / p.sum(-1, keepdim=True)
    return out.transpose(1, 2)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                         # a TF32 value
    x = torch.tensor([1.0 + 2.0 ** -11,            # a tie: away, to 1 + 2^-10
                      -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -20,  # below the tie: down
                      one, 3.0e-5, 0.0])
    got = _tf32(x)
    assert got.tolist()[:4] == [one, -one, 1.0, one]
    assert float(got[5]) == 0.0
    assert (_tf32(got) == got).all()               # idempotent
    assert abs(float(got[4]) - 3.0e-5) <= 3.0e-5 * 2.0 ** -11


def test_3xtf32_attention_holds_fp32_and_one_product_does_not():
    """Why the fp32 kernels take three TF32 products: at 1 x 256 x 2 x 128
    (unit normal q, k, v) the emulated 3xTF32 attention lies within 1e-5
    scaled error of fp32 (``attention_fwd_plain``), while one TF32 product
    of the rounded operands misses the fp32 limit of 1e-4 (TOL_F32) by an
    order of magnitude."""
    g = torch.Generator().manual_seed(54)
    q, k, v = (torch.randn((1, 256, 2, 128), generator=g) for _ in range(3))
    want = attention_fwd_plain(q, k, v)
    three = _scaled_err(_attention_tf32(q, k, v, 3), want)
    one = _scaled_err(_attention_tf32(q, k, v, 1), want)
    assert three <= 1e-5, three
    assert one > 10 * TOL_F32, one


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
    assert after["attention_fwd_lse_tf32"] == \
        before["attention_fwd_lse_tf32"]
    assert after["attention_fwd_tf32"] == before["attention_fwd_tf32"]
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


@pytest.mark.parametrize("width", [2, 5])
def test_cuda_tc_forward_at_verify_width(cuda, tile, width):
    """Speculative verify's shape: 8 slots of *width* rows, each at its own
    position over the whole cache (rows past its end included, as a verify
    near the end of a slot row gives them), against the plain version; a
    slot launched alone equals its row of the 8-slot launch bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(24)
    h, d, max_seq = 12, 128, 1024
    ck, cv = (torch.randn((8, max_seq, h, d), generator=g,
                          device=cuda).to(BF16) for _ in range(2))
    q = torch.randn((8, width, h, d), generator=g, device=cuda).to(BF16)
    pos = torch.tensor([0, 1, 127, 128, 511, 1000, max_seq - 2,
                        max_seq - 1], dtype=torch.int32, device=cuda)
    got = attention_fwd(q, ck, cv, pos)
    assert _scaled_err(got, attention_fwd_plain(q, ck, cv, pos)) \
        <= TOL_BF16
    for i in (0, 6):
        one = attention_fwd(q[i:i + 1], ck[i:i + 1], cv[i:i + 1],
                            pos[i:i + 1])
        assert torch.equal(one, got[i:i + 1]), i


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
    assert after["attention_bwd_dkv_tf32"] == \
        before["attention_bwd_dkv_tf32"]
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
    """The routes at head dim 32 and in fp32: bf16 at D 32 pads to 64 and
    takes the tensor-core forward, dQ and dK/dV; fp32 takes the 3xTF32
    forward (with and without the lse) and dK/dV, and keeps the CUDA-core
    dQ kernel alone."""
    q, k, v, do = _projection(cuda, 1, 70, 2, 32, seed=25)
    before = launch_counts()
    out, lse = attention_fwd_lse(q, k, v)
    attention_bwd_dkv(q, k, v, do, lse, attention_delta(do, out))
    attention_bwd_dq(q, k, v, do, lse, attention_delta(do, out))
    attention_fwd(q, k, v)
    after = launch_counts()
    for name in ("attention_fwd_lse_tc", "attention_bwd_dkv_tc",
                 "attention_bwd_dq_tc", "attention_fwd_tc"):
        assert after[name] == before[name] + 1, name
    qf, kf, vf, dof = (t.float().contiguous() for t in (q, k, v, do))
    out_f, lse_f = attention_fwd_lse(qf, kf, vf)
    attention_fwd(qf, kf, vf)
    delta_f = attention_delta(dof, out_f)
    attention_bwd_dq(qf, kf, vf, dof, lse_f, delta_f)
    attention_bwd_dkv(qf, kf, vf, dof, lse_f, delta_f)
    end = launch_counts()
    for name in ("attention_fwd_lse_tf32", "attention_fwd_tf32",
                 "attention_bwd_dq", "attention_bwd_dkv_tf32"):
        assert end[name] == after[name] + 1, name
    for name in ("attention_fwd_tc", "attention_fwd_lse_tc",
                 "attention_bwd_dq_tc", "attention_bwd_dkv_tc"):
        assert end[name] == after[name], name


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


# -- the int8 KV cache (KV8) and the W8A8 product, on the card ----------------

def _kv8_inputs(dev, dtype, b, sq, skv, h, d, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    (kq, ks), (vq, vs) = (decode._kv_quant(rnd(b, skv, h, d))
                          for _ in range(2))
    return rnd(b, sq, h, d).to(dtype), kq, ks, vq, vs


#: KV8 slot positions on the card: the chunk edges, the middle and the end
#: of a 1024-key cache row, and of a 2048-key row (more chunks than a
#: cluster has blocks, so each block walks two)
KV8_POSITIONS = {1024: (0, 127, 128, 511, 1023), 2048: (0, 128, 1023, 1500,
                                                       2047)}


def _kv8_route_name(dtype, d, sq) -> str:
    return {"rows": "attention_kv8_rows", "tc": "attention_kv8_tc",
            "simt": "attention_kv8_tiled"}[fa._kv8_route(dtype, d, sq)]


@pytest.mark.parametrize("dtype,tol", [(BF16, TOL_BF16), (F32, TOL_F32)])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sq", (1, 2, 5) + KV8_WIDTHS[2:])
@pytest.mark.parametrize("skv", sorted(KV8_POSITIONS))
def test_cuda_kv8_kernels_match_plain(cuda, dtype, tol, d, sq, skv):
    """Each KV8 route (:func:`_kv8_route`: the cluster kernel up to
    KV8_ROWS_MAX rows, the tensor cores or the tiled kernel past it) within
    the limits of chip_smoke.py of ``attention_kv8_plain`` (every route
    rounds P * v_s with P normalized), one slot at each of KV8_POSITIONS."""
    pos0 = KV8_POSITIONS[skv]
    q, kq, ks, vq, vs = _kv8_inputs(cuda, dtype, len(pos0), sq, skv, 3, d,
                                    41)
    pos = torch.tensor(pos0, dtype=torch.int32, device=cuda)
    before = launch_counts()
    got = attention_fwd_kv8(q, kq, ks, vq, vs, pos)
    moved = [n for n, c in launch_counts().items() if c != before[n]]
    assert moved == [_kv8_route_name(dtype, d, sq)]
    assert _scaled_err(got, attention_kv8_plain(q, kq, ks, vq, vs, pos)) \
        <= tol


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("sq", [2, 5, fa.KV8_ROWS_MAX])
@pytest.mark.parametrize("skv", sorted(KV8_POSITIONS))
def test_cuda_kv8_verify_row_equals_decode_row(cuda, dtype, d, sq, skv):
    """The cluster kernel's invariant: row i of a launch of sq rows at
    positions p equals a one-row launch of the same query at p + i under
    ``torch.equal`` (a row's result depends on its query, its keys, the
    chunk and the cluster size alone)."""
    pos0 = KV8_POSITIONS[skv]
    q, kq, ks, vq, vs = _kv8_inputs(cuda, dtype, len(pos0), sq, skv, 3, d,
                                    45)
    pos = torch.tensor(pos0, dtype=torch.int32, device=cuda)
    rows = attention_fwd_kv8(q, kq, ks, vq, vs, pos)
    for i in range(sq):
        one = attention_fwd_kv8(q[:, i:i + 1], kq, ks, vq, vs, pos + i)
        assert torch.equal(one, rows[:, i:i + 1]), i


@pytest.mark.parametrize("dtype,tol", [(BF16, TOL_BF16), (F32, TOL_F32)])
@pytest.mark.parametrize("scale", [1e5, 1e-6])
@pytest.mark.parametrize("sq", [1, 5])
def test_cuda_kv8_rows_take_queries_outside_fp16_range(cuda, dtype, tol,
                                                        scale, sq):
    """The cluster kernel takes its scores in fp16 products after scaling
    each query row by a power of two, so queries far above fp16's range
    (1e5) or below its normal range (1e-6), with k_s scaled the other way
    (the same scores), match the plain version as ordinary ones do."""
    pos0 = KV8_POSITIONS[1024]
    q, kq, ks, vq, vs = _kv8_inputs(cuda, dtype, len(pos0), sq, 1024, 3, 128,
                                    49)
    q = (q.float() * scale).to(dtype)
    ks = ks / scale
    pos = torch.tensor(pos0, dtype=torch.int32, device=cuda)
    got = attention_fwd_kv8(q, kq, ks, vq, vs, pos)
    assert bool(torch.isfinite(got).all())
    assert _scaled_err(got, attention_kv8_plain(q, kq, ks, vq, vs, pos)) \
        <= tol


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_cuda_kv8_decode_row_does_not_depend_on_the_batch(cuda, dtype):
    q, kq, ks, vq, vs = _kv8_inputs(cuda, dtype, 8, 1, 1024, 12, 128, 43)
    pos = torch.tensor([511, 3, 1023, 128, 0, 700, 64, 900],
                       dtype=torch.int32, device=cuda)
    full = attention_fwd_kv8(q, kq, ks, vq, vs, pos)
    for i in (0, 2, 5):
        one = attention_fwd_kv8(*(t[i:i + 1] for t in (q, kq, ks, vq, vs)),
                                pos[i:i + 1])
        assert torch.equal(one, full[i:i + 1]), i


def test_cuda_w8a8_product_is_exact(cuda):
    """The padded int8 product on the card equals the int32 product, for a
    column-major weight (the int8 tree's layout, and that of the
    transposed embedding the logits take) and a row-major one."""
    g = torch.Generator().manual_seed(47)
    xq = torch.randint(-127, 128, (2, 4, 64), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (64, 48), generator=g, dtype=torch.int8)
    want = (xq.int().reshape(8, 64) @ w.int()).reshape(2, 4, 48)
    for right in (w.t().contiguous().t(), w):
        got = decode._int8_mm(xq.to(cuda), right.to(cuda))
        assert torch.equal(got.cpu(), want)


# -- every head dim, and the 3xTF32 kernels, on the card ------------------------

def _counted(fn):
    """``(fn(), the launch_counts names it moved)``."""
    before = launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, sorted(n for n, c in launch_counts().items()
                       if c != before[n])


@pytest.mark.parametrize("dtype,tol", [(BF16, TOL_BF16), (F32, TOL_F32)])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_head_dim_16_training_wrappers_match_plain(cuda, dtype, tol,
                                                        causal):
    """tests/test_ops.py's shape (2 x 64 x 2 x 16) through the forward,
    the forward with the lse, dQ and dK/dV on the card: each pads D 16 to
    its route's head dim, scales by 1 / sqrt(16) and matches its plain
    version."""
    g = torch.Generator(device=cuda).manual_seed(61)
    q, k, v, do = (torch.randn((2, 64, 2, 16), generator=g,
                               device=cuda).to(dtype) for _ in range(4))
    tc = dtype == BF16
    out, names = _counted(lambda: attention_fwd(q, k, v, None, causal))
    assert names == ["attention_fwd_tc" if tc else "attention_fwd_tf32"]
    assert out.shape == q.shape and out.is_contiguous()
    assert _scaled_err(out, attention_fwd_plain(q, k, v, None, causal)) \
        <= tol
    (o, lse), names = _counted(lambda: attention_fwd_lse(q, k, v, causal))
    assert names == ["attention_fwd_lse_tc" if tc
                     else "attention_fwd_lse_tf32"]
    o_p, lse_p = attention_fwd_plain(q, k, v, None, causal, return_lse=True)
    assert _scaled_err(o, o_p) <= tol and _scaled_err(lse, lse_p) <= tol
    delta = attention_delta(do, o)
    dq, names = _counted(lambda: attention_bwd_dq(q, k, v, do, lse, delta,
                                                  causal))
    assert names == ["attention_bwd_dq_tc" if tc else "attention_bwd_dq"]
    assert _scaled_err(dq, attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                                  causal)) <= tol
    (dk, dv), names = _counted(lambda: attention_bwd_dkv(q, k, v, do, lse,
                                                         delta, causal))
    assert names == ["attention_bwd_dkv_tc" if tc
                     else "attention_bwd_dkv_tf32"]
    dk_p, dv_p = attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal)
    assert _scaled_err(dk, dk_p) <= tol and _scaled_err(dv, dv_p) <= tol


@pytest.mark.parametrize("dtype,tol", [(BF16, TOL_BF16), (F32, TOL_F32)])
def test_cuda_head_dim_16_decode_and_kv8_match_plain(cuda, dtype, tol):
    """D 16 on the one-row decode kernels and on both KV8 routes (the
    cluster kernel at decode and verify widths, the tiled KV8 kernel for a
    chunk), each padded to 32 and scaled by 1 / sqrt(16)."""
    q, ck, cv, pos = _decode_inputs(dtype, 16, h=2, max_seq=300,
                                    device=cuda)
    got, names = _counted(lambda: attention_fwd(q, ck, cv, pos))
    assert names == ["attention_fwd_decode"]
    assert _scaled_err(got, attention_fwd_plain(q, ck, cv, pos)) <= tol
    for sq, route in ((1, "attention_kv8_rows"), (5, "attention_kv8_rows"),
                      (40, "attention_kv8_tiled")):
        qk, kq, ks, vq, vs = _kv8_inputs(cuda, dtype, 3, sq, 300, 2, 16, 62)
        p = torch.tensor([0, 130, 300 - sq], dtype=torch.int32, device=cuda)
        got, names = _counted(lambda: attention_fwd_kv8(qk, kq, ks, vq, vs,
                                                        p))
        assert names == [route]
        assert _scaled_err(got, attention_kv8_plain(qk, kq, ks, vq, vs, p)) \
            <= tol


@pytest.mark.parametrize("s", [50, 130, 1000])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_tf32_kernels_match_plain(cuda, monkeypatch, s, d, causal):
    """The 3xTF32 forward (with and without the lse) and dK/dV against
    their plain versions in fp32, q / k / v as views of one projection, the
    dK/dV kernel at both block heights."""
    g = torch.Generator(device=cuda).manual_seed(63)
    qkv = torch.randn((2, s, 9 * d), generator=g, device=cuda)
    q, k, v = (t.unflatten(-1, (3, d)) for t in qkv.split(3 * d, -1))
    do = torch.randn((2, s, 3, d), generator=g, device=cuda)
    for sms in (1, 1 << 30):   # 64-row (64-key) blocks, then 32
        monkeypatch.setattr(fa, "_sms", lambda device, n=sms: n)
        (out, lse), names = _counted(lambda: attention_fwd_lse(q, k, v,
                                                               causal))
        assert names == ["attention_fwd_lse_tf32"]
        o2, names = _counted(lambda: attention_fwd(q, k, v, None, causal))
        assert names == ["attention_fwd_tf32"]
        delta = attention_delta(do, out)
        (dk, dv), names = _counted(lambda: attention_bwd_dkv(
            q, k, v, do, lse, delta, causal))
        assert names == ["attention_bwd_dkv_tf32"]
        out_p, lse_p = attention_fwd_plain(q, k, v, None, causal,
                                           return_lse=True)
        assert _scaled_err(out, out_p) <= TOL_F32
        assert _scaled_err(lse, lse_p) <= TOL_F32
        assert torch.equal(out, o2)
        dk_p, dv_p = attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal)
        assert _scaled_err(dk, dk_p) <= TOL_F32
        assert _scaled_err(dv, dv_p) <= TOL_F32
        # no atomics: the same inputs give the same gradients bit for bit
        again = attention_bwd_dkv(q, k, v, do, lse, delta, causal)
        assert torch.equal(again[0], dk) and torch.equal(again[1], dv)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("offset", [0, 64, 256, 300])
def test_cuda_tf32_forward_at_offset_over_a_slot_row(cuda, d, offset):
    """A chunk of 130 fp32 rows at ``offset`` against one slot's row of a
    (slots, max_seq, H, D) cache (a strided view), against the plain
    version."""
    g = torch.Generator(device=cuda).manual_seed(64)
    h, max_seq = 3, 512
    ck, cv = (torch.randn((4, max_seq, h, d), generator=g, device=cuda)
              for _ in range(2))
    q = torch.randn((1, 130, h, d), generator=g, device=cuda)
    pos = torch.tensor([offset], dtype=torch.int32, device=cuda)
    got, names = _counted(lambda: attention_fwd(q, ck[2:3], cv[2:3], pos))
    assert names == ["attention_fwd_tf32"]
    assert _scaled_err(got, attention_fwd_plain(q, ck[2:3], cv[2:3], pos)) \
        <= TOL_F32


@pytest.mark.parametrize("d", [32, 64, 128])
def test_cuda_tf32_chunk_equals_whole_prefill(cuda, d):
    """The forward's invariant in fp32: chunks of a prompt computed against
    the cache row equal the whole prompt's rows (key tiles anchored at key
    0, no row's arithmetic touching another's: bit for bit)."""
    g = torch.Generator(device=cuda).manual_seed(65)
    h, p, max_seq = 3, 512, 1024
    q, k, v = (torch.randn((1, p, h, d), generator=g, device=cuda)
               for _ in range(3))
    whole = attention_fwd(q, k, v)
    ck, cv = (torch.randn((2, max_seq, h, d), generator=g, device=cuda)
              for _ in range(2))
    ck[1, :p], cv[1, :p] = k[0], v[0]
    for a, b in ((0, 256), (256, 512), (64, 130), (300, 512)):
        pos = torch.tensor([a], dtype=torch.int32, device=cuda)
        part = attention_fwd(q[:, a:b], ck[1:2], cv[1:2], pos)
        assert torch.equal(part, whole[:, a:b]), (a, b)


def test_cuda_head_dim_above_256_raises(cuda):
    q = torch.zeros((1, 4, 1, 257), device=cuda)
    for call in (lambda: attention_fwd(q, q, q),
                 lambda: attention_fwd_lse(q, q, q)):
        with pytest.raises(ValueError, match="take head dims 1 to 256"):
            call()


# -- head dims 129-256, on the card ----------------------------------------------

#: past 128: a head dim padded to 256, and 256 itself
WIDE_DIMS = (160, 256)


@pytest.mark.parametrize("dtype,tol", [(BF16, TOL_BF16), (F32, TOL_F32)])
@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_wide_head_dim_training_wrappers_match_plain(cuda, dtype, tol, d,
                                                          causal):
    """The forward, the forward with the lse, dQ and dK/dV at head dims
    160 and 256 (q / k / v views of one projection, a ragged 200 rows), each
    against its plain version (one tile height: :func:`_capped_tile`); dQ
    and dK/dV twice equal (no atomics)."""
    g = torch.Generator(device=cuda).manual_seed(71)
    b, s, h = 2, 200, 2
    qkv = torch.randn((b, s, 3 * h * d), generator=g, device=cuda).to(dtype)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, -1))
    do = torch.randn((b, s, h, d), generator=g, device=cuda).to(dtype)
    tc = dtype == BF16
    out, names = _counted(lambda: attention_fwd(q, k, v, None, causal))
    assert names == ["attention_fwd_tc" if tc else "attention_fwd_tf32"]
    assert _scaled_err(out, attention_fwd_plain(q, k, v, None, causal)) \
        <= tol
    (o, lse), names = _counted(lambda: attention_fwd_lse(q, k, v, causal))
    assert names == ["attention_fwd_lse_tc" if tc
                     else "attention_fwd_lse_tf32"]
    o_p, lse_p = attention_fwd_plain(q, k, v, None, causal, return_lse=True)
    assert _scaled_err(o, o_p) <= tol and _scaled_err(lse, lse_p) <= tol
    assert torch.equal(o, out)
    delta = attention_delta(do, o)
    dq, names = _counted(lambda: attention_bwd_dq(q, k, v, do, lse, delta,
                                                  causal))
    assert names == ["attention_bwd_dq_tc" if tc else "attention_bwd_dq"]
    assert _scaled_err(dq, attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                                  causal)) <= tol
    (dk, dv), names = _counted(lambda: attention_bwd_dkv(q, k, v, do, lse,
                                                         delta, causal))
    assert names == ["attention_bwd_dkv_tc" if tc
                     else "attention_bwd_dkv_tf32"]
    dk_p, dv_p = attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal)
    assert _scaled_err(dk, dk_p) <= tol and _scaled_err(dv, dv_p) <= tol
    assert torch.equal(dq, attention_bwd_dq(q, k, v, do, lse, delta, causal))
    again = attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    assert torch.equal(again[0], dk) and torch.equal(again[1], dv)


@pytest.mark.parametrize("dtype,tol", [(BF16, TOL_BF16), (F32, TOL_F32)])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_cuda_wide_head_dim_decode_and_offsets_match_plain(cuda, dtype, tol,
                                                           d):
    """At head dims 160 and 256: the split decode kernels (one row a slot
    at POSITIONS over a 1024-key cache row) against the forward's plain
    version and the plain split, and a chunk of 130 rows at an offset over
    one slot's row of the cache against the plain forward."""
    q, ck, cv, pos = _decode_inputs(dtype, d, h=2, device=cuda)
    got, names = _counted(lambda: attention_fwd(q, ck, cv, pos))
    assert names == ["attention_fwd_decode"]
    assert _scaled_err(got, attention_fwd_plain(q, ck, cv, pos)) <= tol
    assert _scaled_err(got, attention_decode_plain(q, ck, cv, pos)) <= tol
    g = torch.Generator(device=cuda).manual_seed(72)
    qc = torch.randn((1, 130, 2, d), generator=g, device=cuda).to(dtype)
    for off in (0, 300):
        p = torch.tensor([off], dtype=torch.int32, device=cuda)
        got = attention_fwd(qc, ck[2:3], cv[2:3], p)
        assert _scaled_err(got, attention_fwd_plain(qc, ck[2:3], cv[2:3],
                                                    p)) <= tol


@pytest.mark.parametrize("dtype,tol", [(BF16, TOL_BF16), (F32, TOL_F32)])
@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("sq", [1, 5, fa.KV8_ROWS_MAX, 40])
def test_cuda_wide_head_dim_kv8_matches_plain(cuda, dtype, tol, d, sq):
    """Each KV8 route at head dims 160 and 256: the cluster kernel (1-8
    rows), then the tensor cores (bf16) or the tiled kernel (fp32), one
    slot at each of KV8_POSITIONS[1024]."""
    pos0 = KV8_POSITIONS[1024]
    q, kq, ks, vq, vs = _kv8_inputs(cuda, dtype, len(pos0), sq, 1024, 2, d,
                                    73)
    pos = torch.tensor(pos0, dtype=torch.int32, device=cuda)
    got, names = _counted(lambda: attention_fwd_kv8(q, kq, ks, vq, vs, pos))
    assert names == [_kv8_route_name(dtype, d, sq)]
    assert _scaled_err(got, attention_kv8_plain(q, kq, ks, vq, vs, pos)) \
        <= tol


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_cuda_head_dim_256_chunk_equals_whole_prefill(cuda, dtype):
    """The forward's invariant at head dim 256: chunks of a prompt against
    the cache row equal the whole prompt's rows bit for bit (bf16: the
    tensor-core kernel; fp32: the 3xTF32 kernel of head dim 256)."""
    g = torch.Generator(device=cuda).manual_seed(74)
    h, p, max_seq, d = 2, 512, 1024, 256
    q, k, v = (torch.randn((1, p, h, d), generator=g, device=cuda).to(dtype)
               for _ in range(3))
    whole = attention_fwd(q, k, v)
    ck, cv = (torch.randn((2, max_seq, h, d), generator=g,
                          device=cuda).to(dtype) for _ in range(2))
    ck[1, :p], cv[1, :p] = k[0], v[0]
    for a, b in ((0, 256), (256, 512), (64, 130), (300, 512)):
        pos = torch.tensor([a], dtype=torch.int32, device=cuda)
        part = attention_fwd(q[:, a:b], ck[1:2], cv[1:2], pos)
        assert torch.equal(part, whole[:, a:b]), (a, b)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("sq", [2, 5, fa.KV8_ROWS_MAX])
def test_cuda_head_dim_256_kv8_verify_row_equals_decode_row(cuda, dtype, sq):
    """The cluster kernel's invariant at head dim 256: row i of a launch of
    sq rows equals the one-row launch of its query at its position under
    ``torch.equal``; a slot decoded alone equals its row of the batch."""
    pos0 = KV8_POSITIONS[1024]
    q, kq, ks, vq, vs = _kv8_inputs(cuda, dtype, len(pos0), sq, 1024, 2, 256,
                                    75)
    pos = torch.tensor(pos0, dtype=torch.int32, device=cuda)
    rows = attention_fwd_kv8(q, kq, ks, vq, vs, pos)
    for i in range(sq):
        one = attention_fwd_kv8(q[:, i:i + 1], kq, ks, vq, vs, pos + i)
        assert torch.equal(one, rows[:, i:i + 1]), i
    alone = attention_fwd_kv8(*(t[1:2] for t in (q, kq, ks, vq, vs)),
                              pos[1:2])
    assert torch.equal(alone, rows[1:2])
