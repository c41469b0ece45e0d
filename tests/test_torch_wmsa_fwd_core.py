"""PyTorch port, the two kernels redesigned for Hopper in slice 9, on the
CPU: K4's staged forward with its tensor-core attention core
(csrc/fused_attn.cu, csrc/wmsa_core.cuh ``attention_fwd``) and K6's
band-staged 3x3 weight gradient (csrc/conv_wgrad.cu).

A CUDA kernel cannot run here.  What the kernels add to the plain
versions' maths is emulated in plain PyTorch and held to the bounds that
chip_smoke.py holds the kernels to on the card, unchanged:
  * the forward core's split-bf16 products (``window_msa.
    attention_fwd_core_emulation``: q, k, v in K4_CORE_TERMS bf16 terms, P
    in two) against the float32 attention of the plain version, each
    output's relative norm of the difference within FUSED_REL_TOL[float32]
    and every element within FUSED_LOCAL_TOL of its largest magnitude
    (phase 7's bounds), at hrformer_base's b0 and b3 shapes and at window 8;
  * K4's three stages (``fused_block.fused_attn_half_fwd_emulation``)
    against ``fused_attn_half_reference`` and against the JAX kernel
    ``fused_attn_half`` (jitted, interpreted), on a tiny map with pad
    tokens, within FUSED_REL_TOL[dtype] and FUSED_LOCAL_TOL;
  * K6's plan (``conv_wgrad.wgrad_plan``) at every stride-1 3x3 conv shape
    of hrnet_w32 + fusion (chip_smoke.hrnet_conv3x3_shapes, here on the
    CPU): the bands tile the pixels exactly, the chunks the bands, the
    shared memory fits the opt-in, the grid fills a wave of 132 SMs;
  * K6's band-order sum (``conv_wgrad.conv3x3_wgrad_band_emulation``)
    against ``conv3x3_wgrad_reference`` and the JAX ``conv3x3_wgrad``
    (interpreted) within K6_TOL.
Inputs are numpy-seeded.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402  (the card's bounds, one source of truth)
from infantposeestimation_gaussianbias_tpu.ops.pallas import (  # noqa: E402
    conv_wgrad as jcw, fused_block as jfb)
from infantposeestimation_gaussianbias_tpu_torch.kernels import (  # noqa: E402
    conv_wgrad as cw, fused_block as fb, window_msa)
from infantposeestimation_gaussianbias_tpu_torch.ops import msa  # noqa: E402

SMS = 132  # the H100's SMs
# (map, batch, ws, heads, C): hrformer_base's b0 (2 images: 140 windows)
# and b3 (32 images: 64 windows), and b0 at window 8
CORE_SHAPES = {"b0": ((64, 48), 2, 7, 2, 78), "b3": ((8, 6), 32, 7, 16, 624),
               "b0 ws8": ((64, 48), 2, 8, 2, 78)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: several test processes share the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _within(out: torch.Tensor, ref: torch.Tensor, rel_tol: float,
            local_tol: float, what: str) -> None:
    diff = out.float() - ref.float()
    rel = (diff.norm() / ref.float().norm()).item()
    assert rel <= rel_tol, (what, rel)
    assert diff.abs().max() <= local_tol * ref.float().abs().max(), what


def _attn_case(branch: str):
    """Numpy-seeded inputs of one attention half at a branch shape, with
    the plain version's per-head float32 q, k, v and o."""
    (Hm, Wm), B, ws, H, C = CORE_SHAPES[branch]
    geom = (Hm, Wm, ws)
    nW = B * fb.window_geometry(geom)[0]
    N = ws * ws
    rng = np.random.RandomState(C + ws)

    def rn(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))

    xw = rn(nW, N, C)
    gamma, beta = 1 + 0.2 * rn(C), 0.1 * rn(C)
    wqkv, bqkv = rn(C, 3 * C, scale=C ** -0.5), 0.1 * rn(3 * C)
    rpe = rn(H, N, N)
    *_, (q, k, v), _, o = fb._attn_forward_parts(xw, gamma, beta, wqkv, bqkv,
                                                 rpe, H, geom)
    return q, k, v, rpe, o.reshape(nW, N, H, C // H).permute(0, 2, 1, 3)


@pytest.mark.parametrize("branch", sorted(CORE_SHAPES))
def test_fwd_core_emulation_holds_fused_bounds(branch):
    q, k, v, rpe, o = _attn_case(branch)
    out = window_msa.attention_fwd_core_emulation(q, k, v, rpe,
                                                  window_msa.K4_CORE_TERMS)
    assert out.shape == o.shape
    _within(out, o, chip_smoke.FUSED_REL_TOL[torch.float32],
            chip_smoke.FUSED_LOCAL_TOL, branch)


def test_fwd_core_is_the_backward_recompute():
    """The backward's recomputed O is the forward core's, bit for bit (one
    function on the card; the emulations share it too)."""
    q, k, v, rpe, _ = _attn_case("b3")
    o_fwd = window_msa.attention_fwd_core_emulation(
        q, k, v, rpe, window_msa.K4_CORE_TERMS)
    o_bwd = window_msa.attention_bwd_core_emulation(
        q, k, v, torch.zeros_like(q), rpe, window_msa.K4_CORE_TERMS,
        with_o=True)[4]
    assert torch.equal(o_fwd, o_bwd)


# -- K4's three stages against the plain version and JAX --------------------------

def _tiny_half(seed=0):
    """Two 10 x 9 maps cut into 4 x 4 windows (pad tokens in the last row
    and column of windows), C = 16, two heads; sample 0 dropped."""
    B, Hm, Wm, C, heads, ws = 2, 10, 9, 16, 2, 4
    rng = np.random.RandomState(seed)
    N = ws * ws
    xw = msa.window_partition(
        torch.from_numpy(rng.randn(B, Hm, Wm, C).astype(np.float32)), ws)[0]
    return dict(
        xw=xw.numpy(), gamma=rng.rand(C) + 0.5, beta=rng.randn(C) * 0.1,
        wqkv=rng.randn(C, 3 * C) * 0.3, bqkv=rng.randn(3 * C) * 0.3,
        rpe=rng.randn(heads, N, N), wproj=rng.randn(C, C) * 0.3,
        bproj=rng.randn(C) * 0.1,
        dp=np.array([0.0] + [1 / 0.7] * (B - 1), np.float32),
        heads=heads, geom=(Hm, Wm, ws))


_ATTN = ["xw", "gamma", "beta", "wqkv", "bqkv", "rpe", "wproj", "bproj", "dp"]


def _port_args(a, dtype):
    td = TDT[dtype]
    return [torch.from_numpy(np.asarray(a[n], np.float32)).to(
        td if n in ("xw", "wqkv", "wproj") else torch.float32) for n in _ATTN]


@functools.lru_cache(maxsize=None)
def _jax_forward(dtype: str) -> np.ndarray:
    a = _tiny_half()
    jd = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}[dtype]
    dpv = np.zeros((1, 128), np.float32)
    dpv[0, :len(a["dp"])] = a["dp"]
    vec = {"gamma", "beta", "bqkv", "bproj"}
    args = tuple(jnp.asarray(a[n], jnp.float32)[None] if n in vec else
                 jnp.asarray(a[n], jnp.float32 if n == "rpe" else jd)
                 for n in _ATTN[:-1])
    f = jax.jit(lambda *xs: jfb.fused_attn_half(
        *xs, jnp.asarray(dpv), a["heads"], a["geom"]))
    with jfb.interpret_mode():
        return np.array(f(*args).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_staged_forward_matches_plain_and_jax(dtype):
    a = _tiny_half()
    args = _port_args(a, dtype)
    dt = TDT[dtype]
    y = fb.fused_attn_half_fwd_emulation(*args, a["heads"], a["geom"])
    ref = fb.fused_attn_half_reference(*args, a["heads"], a["geom"])
    assert y.dtype == dt and y.shape == ref.shape
    rel_tol, local_tol = chip_smoke.FUSED_REL_TOL[dt], chip_smoke.FUSED_LOCAL_TOL
    _within(y, ref, rel_tol, local_tol, "plain")
    _within(y, torch.from_numpy(_jax_forward(dtype)), rel_tol, local_tol,
            "jax")
    # the dropped sample's windows pass x through unchanged
    nwin = fb.window_geometry(a["geom"])[0]
    assert torch.equal(y[:nwin], args[0][:nwin])


def test_attn_fwd_plan():
    """Stage (b)'s chunks are the backward's (a wave of about four blocks
    per SM at every branch); ln and o rows 16-byte wide; stage (c) takes
    K5's tile rule."""
    for Hm, Wm, C, H in ((64, 48, 78, 2), (32, 24, 156, 4), (16, 12, 312, 8),
                         (8, 6, 624, 16)):
        for B in (64, 32):
            for ws in (7, 8):
                nW = B * fb.window_geometry((Hm, Wm, ws))[0]
                plan = fb.attn_fwd_plan(nW, ws * ws, C, H, SMS)
                assert plan["wpb"] == window_msa.bwd_windows_per_block(
                    nW, H, SMS)
                chunks = -(-nW // plan["wpb"])  # the kernel's grid
                assert chunks * H >= 2 * SMS
                assert plan["width"] % 8 == 0 and 0 <= plan["width"] - C < 8
                assert plan["proj"] == fb._mlp_tile(nW * ws * ws, C, SMS)


# -- K6 -------------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _hrnet_shapes() -> tuple:
    return tuple(chip_smoke.hrnet_conv3x3_shapes(device="cpu"))


def test_hrnet_conv3x3_shapes():
    assert len(_hrnet_shapes()) == 9
    assert (64, 48, 32, 32) in _hrnet_shapes()
    assert (8, 6, 256, 256) in _hrnet_shapes()


def _check_plan(B, H, W, Ci, Co, plan):
    rows, bpc, bands = plan["rows"], plan["bands_per_chunk"], plan["bands"]
    nb = -(-H // rows)
    # each image's bands cover its rows once: rows r0 .. min(H, r0 + rows)
    covered = sum(min(H, r0 + rows) - r0 for r0 in range(0, H, rows))
    assert covered == H and bands == B * nb
    assert sum(min(H, (b % nb) * rows + rows) - (b % nb) * rows
               for b in range(bands)) * W == B * H * W
    # the chunks cover the bands once
    assert (plan["splits"] - 1) * bpc < bands <= plan["splits"] * bpc
    assert plan["smem"] <= cw.MAX_SMEM
    assert plan["smem"] == cw.band_smem(rows, W, plan["tco"])
    assert plan["tiles"] == -(-Ci // cw.BAND_CI) * -(-Co // plan["tco"])


@pytest.mark.parametrize("index", range(9))
def test_wgrad_plan_at_hrnet_shapes(index):
    H, W, Ci, Co = _hrnet_shapes()[index]
    B = chip_smoke.TRAIN_BATCH
    plan = cw.wgrad_plan(B, H, W, Ci, Co, SMS)
    _check_plan(B, H, W, Ci, Co, plan)
    # a wave: at least one block per SM, at most two (two fit by shared
    # memory)
    blocks = plan["tiles"] * plan["splits"]
    assert SMS <= blocks <= 2 * SMS, (blocks, plan)
    assert 2 * plan["smem"] <= cw.MAX_SMEM


def _wgrad_inputs(B, H, W, Ci, Co, dtype):
    rng = np.random.RandomState(B + H + Ci + Co)
    x = torch.from_numpy(rng.randn(B, H, W, Ci).astype(np.float32))
    dy = torch.from_numpy(rng.randn(B, H, W, Co).astype(np.float32))
    return x.to(TDT[dtype]), dy.to(TDT[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,sms", [
    ((2, 10, 48, 16, 24), 4),    # ragged last band, Ci and Co not x 32
    ((2, 64, 48, 32, 32), SMS),  # hrnet's b0 conv: 32 bands, one a chunk
    ((3, 8, 6, 64, 64), 8)])     # b3's map: one band an image, two a chunk
def test_wgrad_band_order_matches_plain_and_jax(shape, sms, dtype):
    B, H, W, Ci, Co = shape
    x, dy = _wgrad_inputs(*shape, dtype)
    plan = cw.wgrad_plan(B, H, W, Ci, Co, sms)
    _check_plan(B, H, W, Ci, Co, plan)
    assert plan["splits"] > 1
    got = cw.conv3x3_wgrad_band_emulation(x, dy, plan)
    ref = cw.conv3x3_wgrad_reference(x, dy)
    jx, jdy = (jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))
               for t in (x, dy))
    with jcw.interpret_mode():
        jref = torch.from_numpy(np.array(jcw.conv3x3_wgrad(jx, jdy)))
    rel_tol, local_tol = chip_smoke.K6_TOL[TDT[dtype]]
    assert got.shape == ref.shape == (3, 3, Ci, Co)
    _within(got, ref, rel_tol, local_tol, "plain")
    _within(got, jref, rel_tol, local_tol, "jax")
