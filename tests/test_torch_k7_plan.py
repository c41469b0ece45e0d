"""PyTorch port, K7's bf16 route on the CPU: the grid plan of the
halo-staged tensor-core conv (``residual_block.chain_plan``) and an
emulation of the kernel's indexing (``fused_residual_chain_emulation``).

A CUDA kernel cannot run here.  What surrounds it can:
  * ``chain_plan`` at every branch of hrnet_w32 and hrnet_w48 at 256x192
    (C = 32/64/128/256 and 48/96/192/384) at b = 1, 2, 32 and 64: the
    tiles cover the maps, a tile fits its warps' slabs and the opt-in
    shared memory, and the grid fills a wave of the H100's 132 SMs, or
    the plan is at its finest tiling and says it cannot (b = 1);
  * the emulation (halo-band staging, the nine tap offsets, tiles that
    span images, bands that do not divide H, C % 8 != 0, slabs of
    output channels narrower than C, input channels split into parts
    whose sums meet) against
    ``fused_residual_chain_reference`` up to the order of float32 sums
    (relative norm <= 1e-6): float32 weights on random data, and bf16
    weights on small dyadic data, whose first conv is exact in float32 in
    any order (elsewhere an ulp of reassociation before a rounding to
    bf16 would now and then become a bf16 ulp).
Pure torch (no JAX), one intra-op thread.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu_torch.kernels import (  # noqa: E402
    residual_block as rb)

SMS = 132  # the H100's SMs
# (H, W, C) of hrnet_w32's and hrnet_w48's four branches at 256x192
BRANCHES = [(64, 48, 32), (32, 24, 64), (16, 12, 128), (8, 6, 256),
            (64, 48, 48), (32, 24, 96), (16, 12, 192), (8, 6, 384)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: several test processes share the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _finest_blocks(B, H, C):
    """The most blocks any tiling launches: one-row bands, the narrowest
    slab of output channels and the most input-channel parts."""
    return B * H * -(-C // min(rb._slab_widths(C))) * max(rb._parts(C))


@pytest.mark.parametrize("B", [1, 2, 32, 64])
@pytest.mark.parametrize("H,W,C", BRANCHES)
def test_chain_plan_fills_a_wave_and_fits(B, H, W, C):
    plan = rb.chain_plan(B, H, W, C, SMS)
    rows, slots, tco = plan["rows"], plan["slots"], plan["tco"]
    # the tiles: bands of rows rows, or slots whole images (rows == H)
    assert 1 <= rows <= H and slots >= 1 and (slots == 1 or rows == H)
    bands = -(-H // rows)
    assert plan["tiles"] == -(-B * bands // slots)
    assert slots * rows * W <= rb.TILE_PIXELS[tco]
    # the slab: C rounded up to a compiled width up to 128, 64 or 128 above
    assert tco in rb._slab_widths(C)
    if C <= 128:
        assert tco == C  # every branch width is compiled: no wider slab
    parts = plan["parts"]
    assert parts in rb._parts(C) and (-(-C // 16) * 16) % (16 * parts) == 0
    assert plan["blocks"] == plan["tiles"] * -(-C // tco) * parts
    assert plan["smem"] == rb.chain_smem(W, C, rows, slots, tco,
                                         plan["whole"], parts) <= rb.MAX_SMEM
    assert not plan["whole"] or (tco <= 64
                                 and plan["smem"] <= rb.WHOLE_SMEM)
    if plan["fills_wave"]:
        assert plan["blocks"] >= SMS
    else:  # the docstring's case: one image's rows are too few for a wave
        assert B == 1 and plan["blocks"] < SMS
        assert plan["blocks"] == _finest_blocks(B, H, C)


def _dyadic(rng, shape, scale):
    """Small integers times a power of two: a conv of such maps and weights
    is exact in float32, whatever the order of its sums."""
    return torch.from_numpy(rng.randint(-3, 4, shape).astype(np.float32)
                            * scale)


def _chain_inputs(B, H, W, C, n, seed, exact):
    rng = np.random.RandomState(seed)
    if exact:
        x = _dyadic(rng, (B, H, W, C), 2.0 ** -2)
        w = _dyadic(rng, (2 * n, 9 * C, C), 2.0 ** -4)
        a = torch.from_numpy(2.0 ** rng.randint(-1, 1, (2 * n, C))
                             .astype(np.float32))
        b = _dyadic(rng, (2 * n, C), 2.0 ** -3)
    else:
        x = torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32))
        w = torch.from_numpy(rng.randn(2 * n, 9 * C, C).astype(np.float32)
                             * (2 / (9 * C)) ** 0.5)
        a = torch.from_numpy(rng.uniform(0.5, 1.5, (2 * n, C))
                             .astype(np.float32))
        b = torch.from_numpy(rng.uniform(-0.2, 0.2, (2 * n, C))
                             .astype(np.float32))
    return x, w, torch.stack([a, b], dim=1).contiguous()


# (B, H, W, C), rows, slots: what each case exercises
TILINGS = [
    ((3, 5, 7, 12), 2, 1),    # bands 2, 2, 1 (not dividing H); C % 8 != 0
    ((3, 5, 7, 12), 5, 2),    # tiles of two whole images, the last of one
    ((2, 6, 4, 32), 3, 1),    # bands dividing H
    ((4, 3, 5, 20), 1, 1),    # one-row bands; C % 16 != 0 (taps padded)
    ((5, 2, 3, 16), 2, 4),    # four images a tile, the last tile one
    ((1, 4, 3, 192), 4, 1),   # C > 128: three slabs of 64 (or two of 128)
    ((2, 3, 4, 48), 3, 2),    # C = 48: three parts of 16 channels
]


@pytest.mark.parametrize("exact", [False, True], ids=["random", "exact"])
@pytest.mark.parametrize("shape,rows,slots", TILINGS)
def test_emulation_matches_reference(shape, rows, slots, exact):
    B, H, W, C = shape
    n = 2
    x, w, ab = _chain_inputs(B, H, W, C, n, sum(shape) + rows, exact)
    wdt = torch.bfloat16 if exact else torch.float32
    w = w.to(wdt)
    ref = rb.fused_residual_chain_reference(x, w, ab, n)
    for tco in rb._slab_widths(C):
        for parts in rb._parts(C):
            plan = dict(rows=rows, slots=slots, tco=tco, parts=parts)
            got = rb.fused_residual_chain_emulation(x, w, ab, n, plan)
            assert got.dtype == x.dtype and got.shape == x.shape
            rel = ((got - ref).norm() / ref.norm()).item()
            assert rel <= 1e-6, (shape, plan, rel)


@pytest.mark.parametrize("shape", [(2, 5, 7, 12), (3, 4, 6, 32)])
def test_emulation_at_the_plans_own_tiling(shape):
    """The tiling ``chain_plan`` picks at a tiny size (bf16 weights, the
    route it plans), against the plain version on dyadic data."""
    B, H, W, C = shape
    x, w, ab = _chain_inputs(B, H, W, C, 2, seed=7, exact=True)
    w = w.to(torch.bfloat16)
    plan = rb.chain_plan(B, H, W, C, SMS)
    got = rb.fused_residual_chain_emulation(x, w, ab, 2, plan)
    ref = rb.fused_residual_chain_reference(x, w, ab, 2)
    assert ((got - ref).norm() / ref.norm()).item() <= 1e-6
