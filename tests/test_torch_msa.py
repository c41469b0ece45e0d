"""PyTorch port, window attention: the K1 wrapper's plain path and the
window primitives against the JAX package, on the same numpy inputs.

On the CPU ``window_attention_qkv`` takes its plain PyTorch version, which
is what the CUDA kernel is held against on the card (chip_smoke.py).
Here it is held against the JAX Pallas kernel in TPU interpret mode and
against the JAX einsum path.
"""

import numpy as np
import pytest

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu.models import layers as jlayers
from infantposeestimation_gaussianbias_tpu.ops import msa as jmsa
from infantposeestimation_gaussianbias_tpu.ops.pallas.window_msa import (
    window_attention_pallas_qkv,
)
from infantposeestimation_gaussianbias_tpu_torch.kernels import window_msa
from infantposeestimation_gaussianbias_tpu_torch.models import layers
from infantposeestimation_gaussianbias_tpu_torch.ops import msa

# Both sides are exact float32 CPU maths; only the summation order differs.
ATOL = RTOL = 1e-4


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("nW,N,H,hd", [(70, 49, 2, 39), (12, 49, 4, 32),
                                       (5, 64, 2, 39), (6, 49, 16, 39)])
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
