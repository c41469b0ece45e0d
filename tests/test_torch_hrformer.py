"""PyTorch port, HRFormer: WindowAttention, HRFormerBlock and a tiny
backbone against the JAX modules with identical weights, on the CPU."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu.models import hrformer as jhr
from infantposeestimation_gaussianbias_tpu.tools.import_torch_checkpoint import (
    convert_hrformer_backbone,
)
from infantposeestimation_gaussianbias_tpu_torch.models import hrformer
from infantposeestimation_gaussianbias_tpu_torch.weights import (
    init_weights,
    state_dict_from_jax,
)
from tests.torch_tiny import one_torch_thread  # noqa: F401 (autouse)

_BLOCK = "backbone.stage2.0.branches.0.0."


def _block_state_dict(block_params):
    """weights.py on a lone block: place it where a backbone holds its first
    transformer block and strip that prefix off again."""
    sd = state_dict_from_jax(
        {"backbone": {"stage2_module0": {"branch0_block0": block_params}}},
        {})
    return {k[len(_BLOCK):]: v for k, v in sd.items()}


def _randomize_buffers(model, seed):
    """Non-trivial BN statistics and LayerNorm affines, so the comparison
    sees every normalisation."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.LayerNorm)):
                m.weight.copy_(torch.rand(m.weight.shape, generator=g) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(
                    torch.randn(m.running_mean.shape, generator=g) * 0.1)
                m.running_var.copy_(
                    torch.rand(m.running_var.shape, generator=g) * 0.5 + 0.75)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_window_attention_matches_jax(use_pallas):
    dim, heads, ws = 78, 2, 7
    x = np.random.RandomState(1).randn(6, ws * ws, dim).astype(np.float32)
    jmod = jhr.WindowAttention(dim, ws, heads, use_pallas=use_pallas)
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    # an asymmetric table, so a transposed bias cannot pass
    table = np.arange(13 * 13 * heads, dtype=np.float32).reshape(-1, heads)
    params = dict(variables["params"], rpe_table=(table % 17) * 0.05)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x), False))

    block_sd = _block_state_dict({"attn": params})
    tmod = hrformer.WindowAttention(dim, ws, heads)
    tmod.load_state_dict({k[len("attn."):]: v for k, v in block_sd.items()},
                         strict=True)
    with torch.no_grad():
        out = tmod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("H,W", [(10, 9), (14, 7)])
def test_hrformer_block_matches_jax(H, W):
    """Maps whose sides are not multiples of 7 compare the zero-padded
    windows too."""
    dim, heads = 32, 2
    x = np.random.RandomState(H * W).randn(2, H, W, dim).astype(np.float32)
    jblock = jhr.HRFormerBlock(dim, heads, 7, use_pallas=True)
    variables = jax.jit(jblock.init)(jax.random.PRNGKey(2), jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    rng = np.random.RandomState(3)
    params["norm1"]["scale"] = rng.rand(dim).astype(np.float32) + 0.5
    params["norm2"]["bias"] = rng.randn(dim).astype(np.float32) * 0.1
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jblock.apply({"params": params}, jnp.asarray(x),
                                      False))

    tblock = hrformer.HRFormerBlock(dim, heads, 7)
    tblock.load_state_dict(_block_state_dict(params), strict=True)
    with torch.no_grad():
        out = tblock(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_tiny_backbone_matches_jax():
    """Tiny HRFormer (every structural element: stem, Bottlenecks, all
    three transitions, fuse up/down chains) at a 64x48 input.  The port's
    seeded weights go to JAX through the JAX package's own importer."""
    channels, heads = (8, 16, 32, 64), (1, 2, 4, 8)
    tm = hrformer.HRFormer(channels=channels, num_heads=heads,
                           stage_modules=(1, 1, 1)).eval()
    init_weights(tm, seed=4)
    _randomize_buffers(tm, seed=5)
    sd = {f"backbone.{k}": v.numpy() for k, v in tm.state_dict().items()}
    params, stats = convert_hrformer_backbone(sd)

    jm = jhr.HRFormer(channels=channels, num_heads=heads,
                      stage_modules=(1, 1, 1), drop_path_rate=0.0)
    x = np.random.RandomState(6).randn(2, 64, 48, 3).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 16, 12, channels[0])
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3)


def test_hrformer_bf16_forward_is_finite():
    """The compute dtype reaches every layer: a bf16 tiny backbone returns
    bf16 features close to the float32 ones."""
    channels, heads = (8, 16, 32, 64), (1, 2, 4, 8)
    f32 = hrformer.HRFormer(channels=channels, num_heads=heads,
                            stage_modules=(1, 1, 1)).eval()
    init_weights(f32, seed=7)
    bf16 = hrformer.HRFormer(channels=channels, num_heads=heads,
                             stage_modules=(1, 1, 1),
                             compute_dtype=torch.bfloat16).eval()
    bf16.load_state_dict(f32.state_dict())
    x = torch.from_numpy(
        np.random.RandomState(8).randn(1, 64, 48, 3).astype(np.float32))
    with torch.no_grad():
        ref, out = f32(x), bf16(x)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    scale = ref.abs().max().item()
    assert (out.float() - ref).abs().max().item() < 0.1 * scale
