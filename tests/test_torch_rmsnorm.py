"""The RMSNorm kernel of the PyTorch/CUDA port and its routes.

A row of whole aligned 16-byte pieces (at most 32 x 8 in bf16, 32 x 12 in
fp32) takes the warp layout: one warp a row (the row held in registers,
``scale`` loaded once a warp, a grid sized to the card), or for fewer rows
than the card's SMs one block a row with the same arithmetic to the bit;
any other row one block a row of its own design. On the CPU these tests
hold the route rule (:func:`_rms_pieces`, a function of the row's shape
alone) and the property the kernel is built around on the plain version (a
row's result does not depend on the rows normalized with it). The ``cuda``
tests hold every route against the plain version on the card and a
batched row against its one-row launch bit for bit, and skip without a
card.

This file imports no JAX, so on a machine with the card and without JAX it
runs alone: ``python3 -m pytest --noconftest tests/test_torch_rmsnorm.py``.
"""

import importlib

import pytest
import torch

from dpu_operator_tpu_torch.ops import fused_rmsnorm, fused_rmsnorm_plain

#: the module (the package's ``rmsnorm`` name is not exported)
rn = importlib.import_module("dpu_operator_tpu_torch.ops.rmsnorm")

BF16, F32 = torch.bfloat16, torch.float32
#: kernel vs plain, elementwise (tests/test_torch_ops.py's limits): fp32
#: differs in the order of the sum of squares, bf16 by at most one step
TOL = {F32: 1e-5, BF16: 2.0 ** -7}
#: the flagship's width (d_model 1536): the serving shapes (8 slots, a
#: 256-token chunk, a 512-token prompt) and the training shape (8 x 1024)
SERVE_ROWS = (8, 256, 512)
TRAIN_ROWS = 8 * 1024


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode; "
                    "chip_smoke.py runs them on the card)")
    return torch.device("cuda")


# -- the route, on the CPU -------------------------------------------------------

@pytest.mark.parametrize("d,elt,vectorized,pieces", [
    (1536, 2, True, 6),      # the flagship, bf16: 192 pieces over 32 lanes
    (1536, 4, True, 12),     # the flagship, fp32: 384 pieces
    (64, 2, True, 1),        # the tests' tiny configs
    (64, 4, True, 1),
    (128, 2, True, 1),       # the default config
    (256, 4, True, 2),
    (512, 2, True, 2),
    (512, 4, True, 4),
    (1000, 2, True, 4),      # 125 pieces: the last lanes hold 3
    (2048, 2, True, 8),      # the longest bf16 row the warps hold
    (2056, 2, True, 0),      # longer: one block a row
    (3072, 2, True, 0),
    (2048, 4, True, 0),
    (1536, 2, False, 0),     # not in aligned 16-byte pieces
    (100, 4, False, 0),
])
def test_rms_pieces(d, elt, vectorized, pieces):
    assert rn._rms_pieces(d, elt, vectorized) == pieces


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("d", [64, 1536])
def test_plain_row_does_not_depend_on_the_batch(dtype, d):
    """The plain version: each row of a batch equals the same row
    normalized alone, bit for bit."""
    g = torch.Generator().manual_seed(81)
    x = torch.randn((37, d), generator=g).to(dtype)
    scale = (1.0 + 0.1 * torch.randn((d,), generator=g)).to(dtype)
    batch = fused_rmsnorm(x, scale)
    for i in (0, 5, 36):
        assert torch.equal(fused_rmsnorm(x[i:i + 1], scale), batch[i:i + 1])


# -- the kernel, on the card ---------------------------------------------------

def _inputs(dev, rows, d, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((rows, d), generator=g, device=dev).to(dtype)
    scale = (1.0 + 0.1 * torch.randn((d,), generator=g,
                                     device=dev)).to(dtype)
    return x, scale


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("rows,d", [(8, 1536), (300, 1536), (5, 100),
                                    (3, 64), (600, 64), (700, 512),
                                    (1000, 1000), (7, 2048), (200, 2048),
                                    (9, 4096), (17, 3072)])
def test_cuda_rmsnorm_routes_match_plain(cuda, dtype, rows, d):
    """Every route against the plain version: the warp layout at every
    piece count the shapes reach, on one block a row (fewer rows than the
    card's SMs) and on the persistent warps (more), the block route for a
    row too long for the warps (fp32 2048, 3072 and 4096 in both types) and
    one not in 16-byte pieces (100 in bf16: 200 bytes)."""
    x, scale = _inputs(cuda, rows, d, dtype, 82)
    n = fused_rmsnorm.launches
    got = fused_rmsnorm(x, scale)
    assert fused_rmsnorm.launches == n + 1
    torch.testing.assert_close(got.float(), fused_rmsnorm_plain(x, scale)
                               .float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("rows", SERVE_ROWS + (TRAIN_ROWS,))
def test_cuda_rmsnorm_row_equals_its_one_row_launch(cuda, dtype, rows):
    """The kernel's invariant: a row of a batched launch equals the same
    row launched alone under ``torch.equal`` (its arithmetic depends on the
    row and D only, not on the grid or the rows beside it: a lone row takes
    one block, 256 rows and more the persistent warps), and two launches
    agree; the batch holds to the plain version."""
    x, scale = _inputs(cuda, rows, 1536, dtype, 83)
    batch = fused_rmsnorm(x, scale)
    for i in sorted({0, 1, rows // 2, rows - 1}):
        assert torch.equal(fused_rmsnorm(x[i:i + 1], scale),
                           batch[i:i + 1]), i
    assert torch.equal(fused_rmsnorm(x, scale), batch)
    torch.testing.assert_close(batch.float(), fused_rmsnorm_plain(x, scale)
                               .float(), rtol=TOL[dtype], atol=TOL[dtype])
