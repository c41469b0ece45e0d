"""PyTorch port, window attention: the K1 and K2 wrappers' plain paths and
the window primitives against the JAX package, on the same numpy inputs.

On the CPU ``window_attention_qkv`` (K1) and ``window_attention_qkv_bwd``
(K2) take their plain PyTorch versions, which are what the CUDA kernels
are held against on the card (chip_smoke.py).  Here they are held against
the JAX Pallas kernels in TPU interpret mode and against the JAX einsum
path or torch autograd.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu.models import layers as jlayers
from infantposeestimation_gaussianbias_tpu.ops import msa as jmsa
from infantposeestimation_gaussianbias_tpu.ops.pallas.window_msa import (
    window_attention_pallas_qkv,
    window_attention_pallas_qkv_vjp,
)
from infantposeestimation_gaussianbias_tpu_torch.kernels import window_msa
from infantposeestimation_gaussianbias_tpu_torch.models import layers
from infantposeestimation_gaussianbias_tpu_torch.ops import msa
from tests.torch_tiny import one_torch_thread  # noqa: F401 (autouse)

# Both sides are exact float32 CPU maths; only the summation order differs.
ATOL = RTOL = 1e-4
SHAPES = [(70, 49, 2, 39), (12, 49, 4, 32), (5, 64, 2, 39), (6, 49, 16, 39)]


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("nW,N,H,hd", SHAPES)
def test_window_attention_qkv_matches_jax(nW, N, H, hd, with_bias):
    rng = np.random.RandomState(nW + N + H + hd)
    C = H * hd
    qkv = rng.randn(nW, N, 3 * C).astype(np.float32)
    bias = rng.randn(H, N, N).astype(np.float32) if with_bias else None

    launches = window_msa.LAUNCHES
    out = window_msa.window_attention_qkv(
        torch.from_numpy(qkv),
        None if bias is None else torch.from_numpy(bias), H).numpy()
    assert window_msa.LAUNCHES == launches  # the CPU path launches nothing

    jbias = None if bias is None else jnp.asarray(bias)
    with pltpu.force_tpu_interpret_mode():
        ref_pallas = np.asarray(
            window_attention_pallas_qkv(jnp.asarray(qkv), jbias, H))
    split = jnp.asarray(qkv).reshape(nW, N, 3, H, hd).transpose(2, 0, 3, 1, 4)
    ref_xla = np.asarray(jmsa.window_attention(split[0], split[1], split[2],
                                               jbias))
    ref_xla = ref_xla.transpose(0, 2, 1, 3).reshape(nW, N, C)

    assert out.shape == (nW, N, C) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref_pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out, ref_xla, atol=ATOL, rtol=RTOL)


def test_window_attention_qkv_keeps_bf16():
    """bf16 qkv in, bf16 out, maths in float32 (the JAX Dense emits qkv in
    the compute dtype)."""
    rng = np.random.RandomState(0)
    qkv = torch.from_numpy(rng.randn(4, 49, 3 * 78).astype(np.float32))
    out = window_msa.window_attention_qkv(qkv.bfloat16(), None, 2)
    assert out.dtype == torch.bfloat16
    ref = window_msa.window_attention_qkv_reference(
        qkv.bfloat16().float(), None, 2)
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)


def test_window_attention_qkv_rejects_other_devices():
    qkv = torch.zeros(2, 49, 3 * 8, device="meta")
    with pytest.raises(RuntimeError, match="no W-MSA kernel"):
        window_msa.window_attention_qkv(qkv, None, 2)
    bias = torch.zeros(2, 49, 49, device="meta")
    dout = torch.zeros(2, 49, 8, device="meta")
    with pytest.raises(RuntimeError, match="no W-MSA kernel"):
        window_msa.window_attention_qkv_bwd(qkv, bias, dout, 2)


@pytest.mark.parametrize("nW,N,H,hd", SHAPES)
def test_window_attention_qkv_bwd_matches_jax(nW, N, H, hd):
    """K2's plain version against the JAX custom VJP (Pallas backward
    kernel, interpret mode) and against torch autograd through K1's plain
    version: dqkv and dbias, float32."""
    rng = np.random.RandomState(nW * N + H * hd)
    C = H * hd
    qkv = rng.randn(nW, N, 3 * C).astype(np.float32)
    bias = rng.randn(H, N, N).astype(np.float32)
    dout = rng.randn(nW, N, C).astype(np.float32)

    launches = window_msa.BWD_LAUNCHES
    dqkv, dbias = window_msa.window_attention_qkv_bwd(
        torch.from_numpy(qkv), torch.from_numpy(bias), torch.from_numpy(dout),
        H)
    assert window_msa.BWD_LAUNCHES == launches  # the CPU path launches nothing
    assert dqkv.shape == (nW, N, 3 * C) and dqkv.dtype == torch.float32
    assert dbias.shape == (H, N, N) and dbias.dtype == torch.float32

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda q, b: window_attention_pallas_qkv_vjp(q, b, H),
                         jnp.asarray(qkv), jnp.asarray(bias))
        j_dqkv, j_dbias = (np.asarray(g) for g in vjp(jnp.asarray(dout)))
    np.testing.assert_allclose(dqkv.numpy(), j_dqkv, atol=ATOL, rtol=RTOL)
    # dbias sums dS over all windows: float32 sums of up to 70 terms
    np.testing.assert_allclose(dbias.numpy(), j_dbias, atol=ATOL, rtol=RTOL)

    tq = torch.from_numpy(qkv).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    out = window_msa.window_attention_qkv_reference(tq, tb, H)
    a_dqkv, a_dbias = torch.autograd.grad(out, (tq, tb),
                                          torch.from_numpy(dout))
    torch.testing.assert_close(dqkv, a_dqkv, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(dbias, a_dbias, atol=ATOL, rtol=RTOL)


def test_window_attention_autograd_function_gradcheck():
    """The autograd Function (K1 forward, K2 backward; their plain versions
    on the CPU) against finite differences, in float64."""
    rng = np.random.RandomState(3)
    qkv = torch.from_numpy(rng.randn(3, 9, 3 * 2 * 4)).requires_grad_()
    bias = torch.from_numpy(rng.randn(2, 9, 9)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda q, b: window_msa.window_attention(q, b, 2), (qkv, bias))


def test_window_attention_qkv_bwd_keeps_bf16():
    """bf16 qkv and dout in, bf16 dqkv and float32 dbias out."""
    rng = np.random.RandomState(4)
    qkv = torch.from_numpy(rng.randn(4, 49, 3 * 78).astype(np.float32))
    dout = torch.from_numpy(rng.randn(4, 49, 78).astype(np.float32))
    bias = torch.from_numpy(rng.randn(2, 49, 49).astype(np.float32))
    dqkv, dbias = window_msa.window_attention_qkv_bwd(
        qkv.bfloat16(), bias, dout.bfloat16(), 2)
    assert dqkv.dtype == torch.bfloat16 and dbias.dtype == torch.float32
    ref_q, ref_b = window_msa.window_attention_qkv_bwd_reference(
        qkv.bfloat16().float(), bias, dout.bfloat16().float(), 2)
    torch.testing.assert_close(dqkv.float(), ref_q, atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(dbias, ref_b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("nW,H,sms,want", [(2240, 2, 132, 9), (64, 16, 132, 2),
                                            (5, 2, 132, 1)])
def test_bwd_windows_per_block(nW, H, sms, want):
    """K2's grid holds about 4 blocks per SM and never fewer windows than
    one per block."""
    wpb = window_msa.bwd_windows_per_block(nW, H, sms)
    assert wpb == want
    assert -(-nW // wpb) * H <= max(4 * sms, H)


@pytest.mark.parametrize("ws", [7, 8])
def test_relative_position_index_matches_jax(ws):
    np.testing.assert_array_equal(msa.relative_position_index(ws),
                                  jmsa.relative_position_index(ws))


@pytest.mark.parametrize("H,W", [(14, 21), (10, 9)])
def test_window_partition_round_trip_matches_jax(H, W):
    x = np.random.RandomState(H * W).randn(2, H, W, 5).astype(np.float32)
    wins, (Hp, Wp) = msa.window_partition(torch.from_numpy(x), 7)
    jwins, jpad = jmsa.window_partition(jnp.asarray(x), 7)
    assert (Hp, Wp) == jpad
    np.testing.assert_array_equal(wins.numpy(), np.asarray(jwins))
    back = msa.window_reverse(wins, 7, H, W, Hp, Wp)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("in_hw,out_hw", [((6, 5), (12, 10)),
                                          ((6, 5), (24, 20)),
                                          ((4, 3), (32, 24)),
                                          ((6, 5), (9, 13))])
def test_resize_bilinear_matches_jax(in_hw, out_hw):
    """Upsampling x2/x4/x8 and a non-integer size: half-pixel centres with
    the edge clamp, on the border rows and columns too."""
    x = np.random.RandomState(sum(out_hw)).randn(2, *in_hw, 3).astype(
        np.float32)
    out = layers.resize_bilinear(torch.from_numpy(x), *out_hw).numpy()
    ref = np.asarray(jlayers.resize_bilinear(jnp.asarray(x), *out_hw))
    assert out.shape == ref.shape == (2, *out_hw, 3)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out[:, [0, -1]], ref[:, [0, -1]],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out[:, :, [0, -1]], ref[:, :, [0, -1]],
                               atol=1e-5, rtol=1e-5)
