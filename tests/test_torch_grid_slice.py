"""PyTorch port, process grid: serving over a 2 x 2 grid of gloo ranks on
the CPU against the JAX package, on the tiny HRFormer + fusion head of
tests/test_torch_serving.py (heads 1/2/4/8: branch 0's one head makes K3
replicate the model axis, the others split their heads).

``PoseInference(mesh=grid)`` on a ragged batch of 5 frames is held against
JAX's single-device ``PoseInference`` (equal to its mesh serving by
tests/test_sharded_serving.py); under IPE_FUSED_BLOCK=1 the grid still
runs the unfused blocks and K3, bit for bit.  The grid train step is held
against JAX in tests/test_torch_train.py, which shares its JAX step.

The weights are the port's seeded init (sharpened), taken to JAX by its
own importer: no JAX init to compile.  One ``run_grid`` spawn (module
fixture, tests/torch_grid.py ``serve_rank``) runs every rank-side case.
"""
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu import inference as jinference
from infantposeestimation_gaussianbias_tpu.models import hrformer as jhr
from infantposeestimation_gaussianbias_tpu.models import pose_estimator as jpe
from infantposeestimation_gaussianbias_tpu.tools.import_torch_checkpoint import (
    convert_checkpoint,
)
from infantposeestimation_gaussianbias_tpu_torch import PoseInference, parallel
from infantposeestimation_gaussianbias_tpu_torch.models import pose_estimator
from infantposeestimation_gaussianbias_tpu_torch.ops import affine, decode

from tests import torch_grid
from tests.torch_tiny import one_torch_thread  # noqa: F401 (autouse)


def _t(x):
    return torch.from_numpy(np.array(x))


def _seeded_state_dict(seed):
    """The port's seeded tiny model with random BatchNorm statistics and
    stronger prediction convs (flat heatmaps would put every soft-argmax
    on the map centre)."""
    model = pose_estimator.build_model(torch_grid.tiny_cfg(), device="cpu")
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(_t(rng.randn(*buf.shape) * 0.1))
            elif name.endswith("running_var"):
                buf.copy_(_t(rng.rand(*buf.shape) * 0.5 + 0.75))
        for final in (model.head.heatmap_branch[3],
                      model.head.offset_branch[3]):
            final.weight.copy_(_t(rng.randn(*final.weight.shape) * 0.3))
    return {k: v.clone() for k, v in model.state_dict().items()}


def _frames_and_boxes():
    rng = np.random.RandomState(7)
    frames = rng.randint(0, 256, (5, 80, 100, 3)).astype(np.uint8)
    bboxes = np.array([[10, 5, 70, 75], [0, 0, 100, 80], [30, 20, 90, 60],
                       [5, 10, 95, 70], [20, 0, 80, 80]], np.float32)
    return frames, bboxes


@pytest.fixture(scope="module")
def setup():
    """(cfg, state dict, JAX model and variables) with the tiny backbone
    registered in both BACKBONES for the module."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("tiny_hrformer", "hrformer_tiny"):
            mp.setitem(jpe.BACKBONES, name, lambda **kw: jhr.HRFormer(
                drop_path_rate=0.0, **torch_grid.TINY, **kw))
        for name in ("tiny_hrformer", "tiny_hrformer_dp", "hrformer_tiny"):
            mp.setitem(pose_estimator.BACKBONES, name, None)
        torch_grid.register_tiny()
        cfg = torch_grid.tiny_cfg()
        sd = _seeded_state_dict(seed=1)
        params, stats = convert_checkpoint(
            {k: v.numpy().copy() for k, v in sd.items()}, head_type="fusion")
        jcfg = torch_grid.tiny_cfg()
        yield SimpleNamespace(
            cfg=cfg, sd=sd, jmodel=jpe.build_model(jcfg), jcfg=jcfg,
            variables={"params": params, "batch_stats": stats})


@pytest.fixture(scope="module")
def ranks(setup, request):
    """Every rank's results of tests/torch_grid.py ``serve_rank``; the
    ranks run while this process compiles and runs JAX's serving."""
    with ThreadPoolExecutor(1) as pool:
        out = pool.submit(
            parallel.run_grid, torch_grid.serve_rank, 2, 2, "gloo",
            device="cpu", args=(setup.sd, *_frames_and_boxes()), timeout=300)
        request.getfixturevalue("jax_serving")
        return out.result()


@pytest.fixture(scope="module")
def jax_serving(setup):
    """JAX's single-device PoseInference on the frames of the test: BN-fold
    off (False) and the default, which folds ``hrformer_tiny`` (None)."""
    out = {}
    variables = jax.tree_util.tree_map(jnp.asarray, setup.variables)
    for fold, backbone in ((False, "tiny_hrformer"), (None, "hrformer_tiny")):
        jcfg = torch_grid.tiny_cfg(backbone)
        jinf = jinference.PoseInference(
            jcfg, state=SimpleNamespace(
                apply_fn=jpe.build_model(jcfg).apply, variables=variables),
            fold=fold)
        out[fold] = jinf.predict_batch(*_frames_and_boxes())
    return out


def test_ranks_import_no_jax(ranks):
    assert all(r["jax_modules"] == [] for r in ranks)


def test_grid_serving_matches_jax(setup, ranks, jax_serving):
    """Every rank returns the whole trimmed batch; keypoints off decode
    ties within 1e-3 px and scores within 1e-4 of JAX's (the tolerances of
    tests/test_torch_serving.py); the fused flag changes nothing under the
    grid.  BN-fold off on both sides."""
    _grid_serving_matches_jax(setup, ranks, jax_serving, fold=False)


def test_grid_serving_folded_matches_jax(setup, ranks, jax_serving):
    """The same with each side's default, which folds ``hrformer_tiny``."""
    _grid_serving_matches_jax(setup, ranks, jax_serving, fold=None)


def _grid_serving_matches_jax(setup, ranks, jax_serving, fold):
    frames, bboxes = _frames_and_boxes()
    ref_k, ref_s = jax_serving[fold]

    # soft-argmax of the flip-averaged heatmaps (single process), for ties
    cfg = torch_grid.tiny_cfg("tiny_hrformer" if fold is False
                              else "hrformer_tiny")
    port = PoseInference(cfg, state_dict=setup.sd, device="cpu", fold=fold)
    assert port.fold == (fold is None)
    centers = (bboxes[:, :2] + bboxes[:, 2:]) / 2
    scales = (bboxes[:, 2:] - bboxes[:, :2]) * setup.cfg.data.bbox_padding
    with torch.no_grad():
        crops = affine.crop_and_normalize(_t(frames), _t(centers),
                                          _t(scales), (48, 64))
        hm = port.model(crops)["heatmaps"]
        hm_f = decode.flip_heatmaps(port.model(torch.flip(crops, [2]))[
            "heatmaps"], port._flip_index)
        g, _ = decode.soft_argmax((hm + hm_f) * 0.5)
    frac = np.abs(g.numpy() % 1.0 - 0.5)
    keep = ~(frac < 1e-3).any(axis=-1)
    assert keep.sum() >= keep.size // 2
    for r in ranks:
        kpts, scores = r["serve0" if fold is False else "serve_fold"]
        assert kpts.shape == (5, 17, 2) and scores.shape == (5, 17)
        np.testing.assert_allclose(kpts[keep], ref_k[keep], atol=1e-3)
        np.testing.assert_allclose(scores, ref_s, atol=1e-4)
        if fold is False:
            for a, b in zip(r["serve1"], r["serve0"]):
                np.testing.assert_array_equal(a, b)
