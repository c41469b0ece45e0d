"""PyTorch port, the twin of ``__graft_entry__.entry()``: the flagship
HRNet-W32 + fusion head at 256x192, forward then ``decode_outputs``,
against JAX ``build_model`` + ``decode_outputs`` on the CPU from one set
of weights.

The weights are seeded numpy on ``jax.eval_shape``'s tree of the full
model (``torch_tiny.random_variables``: no full-width JAX init to
compile), the offset branch's final conv scaled down so that offsets
stay within a few pixels, taken to the port by ``state_dict_from_jax``.
Both sides run float32 on two seeded non-zero images (the entry's
example arguments are zeros).  Keypoints within 1e-3 heatmap px off
decode ties (a soft-argmax within 1e-3 of a half-integer), scores within
1e-4 of the largest.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu.config import Config as JConfig
from infantposeestimation_gaussianbias_tpu.models import pose_estimator as jpe
from infantposeestimation_gaussianbias_tpu.ops import decode as jdecode
from infantposeestimation_gaussianbias_tpu_torch import graft_entry
from infantposeestimation_gaussianbias_tpu_torch.weights import (
    state_dict_from_jax,
)
from tests import torch_tiny
from tests.torch_tiny import one_torch_thread  # noqa: F401 (autouse)


def _jax_cfg():
    """``__graft_entry__._flagship_cfg()`` in float32."""
    cfg = JConfig()
    cfg.model.backbone = "hrnet_w32"
    cfg.model.head_type = "fusion"
    cfg.data.input_size = (192, 256)
    cfg.data.heatmap_size = (48, 64)
    cfg.model.compute_dtype = "float32"
    return cfg


def test_flagship_cfg_matches_graft_entry():
    import __graft_entry__

    assert graft_entry.flagship_cfg().model.compute_dtype == \
        __graft_entry__._flagship_cfg().model.compute_dtype == "bfloat16"
    ours, theirs = graft_entry.flagship_cfg(), __graft_entry__._flagship_cfg()
    for key in ("backbone", "head_type", "hidden_dim", "norm"):
        assert getattr(ours.model, key) == getattr(theirs.model, key), key
    assert tuple(ours.data.input_size) == tuple(theirs.data.input_size)
    assert tuple(ours.data.heatmap_size) == tuple(theirs.data.heatmap_size)


def test_graft_entry_twin_matches_jax():
    jcfg = _jax_cfg()
    jmodel = jpe.build_model(jcfg)
    variables = torch_tiny.random_variables(jmodel, seed=50, shape=(256, 192))
    # offsets of a few pixels, as a trained head's (N(0, 1/fan_in) finals
    # put the fused coordinates hundreds of pixels off the map)
    variables["params"]["head"]["off_final"]["kernel"] *= 1e-3
    images = np.random.RandomState(51).randn(2, 256, 192, 3).astype(
        np.float32)

    @jax.jit
    def jax_forward(v, x):
        out = jmodel.apply(v, x, False)
        return out["heatmaps"], jpe.decode_outputs(out, "fusion")

    hm, (want_c, want_s) = jax_forward(variables, jnp.asarray(images))
    fn, (example,) = graft_entry.entry(
        device="cpu", compute_dtype="float32",
        state_dict=state_dict_from_jax(variables["params"],
                                       variables["batch_stats"]))
    assert example.shape == (4, 256, 192, 3) and example.dtype == torch.float32
    assert not example.any()
    got_c, got_s = fn(torch.from_numpy(images))
    assert got_c.shape == (2, 17, 2) and got_s.shape == (2, 17)
    g, _ = jdecode.soft_argmax(hm)
    keep = ~(np.abs(np.asarray(g) % 1.0 - 0.5) < 1e-3).any(axis=-1)
    assert keep.sum() >= keep.size // 2
    np.testing.assert_allclose(got_c.numpy()[keep], np.asarray(want_c)[keep],
                               atol=1e-3)
    want_s = np.asarray(want_s)
    np.testing.assert_allclose(got_s.numpy(), want_s,
                               atol=1e-4 * np.abs(want_s).max())
