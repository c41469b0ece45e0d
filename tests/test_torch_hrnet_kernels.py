"""PyTorch port, the HRNet kernels' plain versions on the CPU: K7 (the
fused residual chain, kernels/residual_block.py) and K6 (the 3x3 weight
gradient, kernels/conv_wgrad.py) against the JAX package's Pallas kernels
in interpret mode, at the shapes of tests/test_pallas.py, and against the
port's own BasicBlocks and ``Conv2d`` autograd.  On the CPU each wrapper
takes its plain version; the CUDA kernels are held against these on the
card by ``chip_smoke.py`` (phases 10, 11, 12 and 13)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu.models.layers import (
    BasicBlock as JBasicBlock,
)
from infantposeestimation_gaussianbias_tpu.ops.pallas import conv_wgrad as jcw
from infantposeestimation_gaussianbias_tpu.ops.pallas import (
    residual_block as jrb,
)
from infantposeestimation_gaussianbias_tpu_torch.kernels import conv_wgrad
from infantposeestimation_gaussianbias_tpu_torch.kernels import (
    residual_block,
)
from infantposeestimation_gaussianbias_tpu_torch.models.layers import (
    BasicBlock,
    Conv2d,
)
from tests.torch_tiny import one_torch_thread  # noqa: F401 (autouse)

# K7's shape in tests/test_pallas.py:159; K6's at :292.
CHAIN = (2, 16, 12, 32)
WGRAD_SHAPES = [(8, 16, 12, 32, 32), (4, 8, 6, 16, 64)]


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def chain():
    """Four JAX BasicBlocks with random batch statistics (as
    tests/test_pallas.py builds them), the same blocks in the port, and a
    seeded input."""
    B, H, W, C = CHAIN
    x = np.random.RandomState(0).randn(B, H, W, C).astype(np.float32)
    jparams, jstats, blocks = [], [], []
    for i in range(4):
        v = JBasicBlock(C).init(jax.random.PRNGKey(i), jnp.asarray(x), False)
        rng = np.random.RandomState(10 + i)
        p = jax.tree_util.tree_map(np.array, v["params"])
        s = jax.tree_util.tree_map(
            lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
            v["batch_stats"])
        for conv in ("conv1", "conv2"):  # non-trivial BN affines too
            bn = p[conv]["norm"]["bn"]
            bn["scale"][...] = rng.uniform(0.5, 1.5, C)
            bn["bias"][...] = rng.uniform(-0.2, 0.2, C)
        blk = BasicBlock(C).eval()
        with torch.no_grad():
            for k in (1, 2):
                q = p[f"conv{k}"]
                getattr(blk, f"conv{k}").weight.copy_(
                    _t(q["conv"]["kernel"].transpose(3, 2, 0, 1)))
                bn = getattr(blk, f"bn{k}")
                st = s[f"conv{k}"]["norm"]["bn"]
                bn.weight.copy_(_t(q["norm"]["bn"]["scale"]))
                bn.bias.copy_(_t(q["norm"]["bn"]["bias"]))
                bn.running_mean.copy_(_t(st["mean"]))
                bn.running_var.copy_(_t(st["var"]))
        jparams.append(p)
        jstats.append(s)
        blocks.append(blk)
    return x, jparams, jstats, blocks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_matches_jax(chain, dtype):
    """pack_basic_block_params on the port's blocks against the JAX packer
    on the same blocks' trees: weights bit for bit, affines to 1e-6
    (rsqrt in two frameworks)."""
    _, jparams, jstats, blocks = chain
    jw, jab = jrb.pack_basic_block_params(jparams, jstats,
                                          dtype=getattr(jnp, dtype))
    w, ab = residual_block.pack_basic_block_params(
        blocks, dtype=getattr(torch, dtype))
    assert w.dtype == getattr(torch, dtype) and ab.dtype == torch.float32
    assert tuple(w.shape) == jw.shape == (8, 9 * 32, 32)
    assert tuple(ab.shape) == jab.shape == (8, 2, 32)
    np.testing.assert_array_equal(w.float().numpy(),
                                  np.asarray(jw.astype(jnp.float32)))
    np.testing.assert_allclose(ab.numpy(), np.asarray(jab), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chain_matches_jax_kernel(chain, dtype):
    """K7's plain version (what the wrapper takes on the CPU) against the
    JAX kernel in interpret mode, both from the JAX packer's arrays.
    Float32 weights: exact float32 maths in two summation orders, 1e-5.
    bf16 weights: both round every conv input to bf16 from float32 values
    that agree to ~1e-6, and a value on the other side of a bf16 rounding
    boundary moves by 2^-8 of itself: relative norm 1e-3 and no element
    further off than 2^-6 of the output's largest."""
    x, jparams, jstats, _ = chain
    jw, jab = jrb.pack_basic_block_params(jparams, jstats,
                                          dtype=getattr(jnp, dtype))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jrb.fused_residual_chain(jnp.asarray(x), jw, jab, 4))
    w = _t(np.asarray(jw.astype(jnp.float32))).to(getattr(torch, dtype))
    got = residual_block.fused_residual_chain(_t(x), w, _t(np.asarray(jab)),
                                              4).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        assert np.linalg.norm(got - ref) <= 1e-3 * np.linalg.norm(ref)
        assert np.abs(got - ref).max() <= 2.0 ** -6 * np.abs(ref).max()


def test_chain_is_four_basic_blocks(chain):
    """In float32 K7's maths is the eval-mode BasicBlocks' (no roundings):
    the plain version equals the port's four blocks."""
    x, _, _, blocks = chain
    w, ab = residual_block.pack_basic_block_params(blocks, torch.float32)
    with torch.no_grad():
        want = _t(x)
        for blk in blocks:
            want = blk(want)
    got = residual_block.fused_residual_chain(_t(x), w, ab, 4)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_chain_bf16_input_carries_float32(chain):
    """bf16 x with bf16 weights: the chain carries float32 and casts only
    its output (the TPU kernel's arithmetic), so it differs from the bf16
    blocks, which round after every op, and the float32 chain rounded once
    is closer to it than the bf16 blocks are."""
    x, _, _, blocks = chain
    w, ab = residual_block.pack_basic_block_params(blocks, torch.bfloat16)
    xb = _t(x).to(torch.bfloat16)
    got = residual_block.fused_residual_chain(xb, w, ab, 4)
    assert got.dtype == torch.bfloat16
    want = residual_block.fused_residual_chain_reference(
        xb.float(), w, ab, 4).to(torch.bfloat16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    bf_blocks = [BasicBlock(32, compute_dtype=torch.bfloat16).eval()
                 for _ in blocks]
    with torch.no_grad():
        y = xb
        for src, blk in zip(blocks, bf_blocks):
            blk.load_state_dict(src.state_dict())
            y = blk(y)
    exact = residual_block.fused_residual_chain(_t(x), *(
        residual_block.pack_basic_block_params(blocks, torch.float32)), 4)
    assert ((got.float() - exact).norm() < (y.float() - exact).norm())


def test_chain_refuses_other_devices():
    x = torch.empty((1, 4, 4, 8), device="meta")
    w = torch.empty((2, 72, 8), device="meta")
    ab = torch.empty((2, 2, 8), device="meta")
    with pytest.raises(RuntimeError, match="no residual chain kernel"):
        residual_block.fused_residual_chain(x, w, ab, 1)


@pytest.mark.parametrize("shape", WGRAD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wgrad_matches_jax_kernel(shape, dtype):
    """K6's plain version against the JAX kernel in interpret mode and the
    JAX VJP of the SAME conv.  Both sum products of the same inputs in
    float32 (exact for bf16 inputs) in another order: 1e-4, as
    tests/test_pallas.py holds the JAX kernel to its VJP."""
    B, H, W, Ci, Co = shape
    rng = np.random.RandomState(Ci + Co)
    x = rng.randn(B, H, W, Ci).astype(np.float32)
    dy = rng.randn(B, H, W, Co).astype(np.float32)
    jx, jdy = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (x, dy))
    with jcw.interpret_mode():
        ref = np.asarray(jcw.conv3x3_wgrad(jx, jdy))

    def conv(w):
        return lax.conv_general_dilated(
            jx.astype(jnp.float32), w, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    vjp = np.asarray(jax.vjp(conv, jnp.zeros((3, 3, Ci, Co)))[1](
        jdy.astype(jnp.float32))[0])
    tx, tdy = (_t(a).to(getattr(torch, dtype)) for a in (x, dy))
    got = conv_wgrad.conv3x3_wgrad(tx, tdy)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 3, Ci, Co)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), vjp, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgrad_is_conv2d_weight_grad(dtype):
    """K6 permuted (3, 2, 0, 1) is the weight gradient of the port's SAME
    stride-1 Conv2d in that compute dtype (autograd; a bf16 conv's weight
    gradient is rounded to bf16 once: 2^-8 of each element)."""
    rng = np.random.RandomState(3)
    x = _t(rng.randn(2, 10, 7, 12).astype(np.float32)).to(dtype)
    dy = _t(rng.randn(2, 10, 7, 20).astype(np.float32)).to(dtype)
    conv = Conv2d(12, 20, 3, compute_dtype=dtype)
    (g,) = torch.autograd.grad(conv(x), conv.weight, dy)
    got = conv_wgrad.conv3x3_wgrad(x, dy)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(got.permute(3, 2, 0, 1), g, rtol=tol,
                               atol=tol * g.abs().max().item())


def test_wgrad_refuses_other_devices():
    x = torch.empty((1, 4, 4, 8), device="meta")
    with pytest.raises(RuntimeError, match="no 3x3 weight-gradient kernel"):
        conv_wgrad.conv3x3_wgrad(x, x)
