"""PyTorch port, post-processing and geometry: the temporal smoothers,
``StreamingSmoother``, ``nms_pose``, ``postprocess_predictions``, the
rotated crop (``get_affine_matrix``, ``transform_points``,
``warp_affine_batch``, ``warp_affine_twopass``, ``crop_and_normalize(rots=
...)``) and ``multiscale_flip_inference`` against the JAX package on the
CPU, on the same seeded numpy inputs.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu import postprocess as jpost
from infantposeestimation_gaussianbias_tpu.config import get_config as jget_config
from infantposeestimation_gaussianbias_tpu.models import pose_estimator as jpe
from infantposeestimation_gaussianbias_tpu.ops import affine as jaffine
from infantposeestimation_gaussianbias_tpu.ops import decode as jdecode
from infantposeestimation_gaussianbias_tpu_torch import Config, postprocess
from infantposeestimation_gaussianbias_tpu_torch.models import (
    multiscale_flip_inference)
from infantposeestimation_gaussianbias_tpu_torch.ops import affine, decode
from tests import torch_tiny
from tests.torch_tiny import one_torch_thread  # noqa: F401 (autouse)


def _t(x):
    return torch.from_numpy(np.array(x))


def _trajectory(seed, T=24, K=17):
    """A smooth path plus jitter, in frame pixels."""
    rng = np.random.RandomState(seed)
    t = np.arange(T)[:, None, None]
    base = rng.uniform(50, 400, (1, K, 2))
    path = base + 30 * np.sin(t / 5.0 + rng.rand(1, K, 2) * 6)
    return (path + rng.randn(T, K, 2) * 2).astype(np.float32)


# -- smoothers ----------------------------------------------------------------

@pytest.mark.parametrize("method,window", [("gaussian", 5), ("gaussian", 7),
                                           ("moving_average", 5),
                                           ("one_euro", 5)])
def test_temporal_smooth_matches_jax(method, window):
    """float32 on both sides, within 1e-5 relative of the pixel values."""
    traj = _trajectory(1)
    got = decode.temporal_smooth(_t(traj), window, method, fps=25.0).numpy()
    want = np.asarray(jdecode.temporal_smooth(jnp.asarray(traj), window,
                                              method, fps=25.0))
    assert got.shape == traj.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * 400)


def test_one_euro_smooth_matches_jax():
    traj = _trajectory(2)
    kw = dict(fps=30.0, min_cutoff=0.5, beta=0.05, d_cutoff=2.0)
    got = decode.one_euro_smooth(_t(traj), **kw).numpy()
    want = np.asarray(jdecode.one_euro_smooth(jnp.asarray(traj), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * 400)


def test_streaming_smoother_matches_one_euro_smooth():
    """Frame by frame, the port's StreamingSmoother equals the JAX one
    and follows the batch ``one_euro_smooth`` (float32, 1e-5 relative)."""
    traj = _trajectory(3)
    ours, theirs = postprocess.StreamingSmoother(fps=25.0), \
        jpost.StreamingSmoother(fps=25.0)
    frames = [ours(x) for x in traj]
    for x, y in zip(frames, (theirs(x) for x in traj)):
        np.testing.assert_array_equal(x, y)
    batch = decode.one_euro_smooth(_t(traj), fps=25.0).numpy()
    np.testing.assert_allclose(np.stack(frames), batch, rtol=1e-5,
                               atol=1e-5 * 400)
    ours.reset()
    np.testing.assert_array_equal(ours(traj[5]), traj[5])


# -- pose NMS, confidence filter, the Stack-B pipeline ------------------------

def _clustered(seed, B=3, K=17):
    rng = np.random.RandomState(seed)
    centres = rng.uniform(0, 60, (B, 4, 2))
    pick = rng.randint(0, 4, (B, K))
    pts = np.take_along_axis(centres, pick[..., None], 1) + rng.randn(
        B, K, 2) * 3
    conf = rng.rand(B, K).astype(np.float32)
    conf[0, 3] = conf[0, 5]  # a tie
    return pts.astype(np.float32), conf


@pytest.mark.parametrize("threshold", [2.0, 5.0, 12.0])
def test_nms_pose_matches_jax(threshold):
    pts, conf = _clustered(int(threshold))
    got, keep = postprocess.nms_pose(_t(pts), _t(conf), threshold)
    want, jkeep = jpost.nms_pose(jnp.asarray(pts), jnp.asarray(conf),
                                 threshold)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < keep.sum() < keep.numel()


def _heatmaps(seed, B=2, H=16, W=12, K=17):
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:H, 0:W]
    hm = np.zeros((B, H, W, K), np.float32)
    for b in range(B):
        for k in range(K):
            cx, cy = rng.uniform(-1, W), rng.uniform(-1, H)
            hm[b, :, :, k] = rng.uniform(0.1, 1.0) * np.exp(
                -((xs - cx) ** 2 + (ys - cy) ** 2) / 4.0)
    return hm + rng.rand(B, H, W, K).astype(np.float32) * 0.01


@pytest.mark.parametrize("with_coords,with_meta", [(False, False),
                                                   (True, True)])
def test_postprocess_predictions_matches_jax(with_coords, with_meta):
    """Taylor decode, window refinement, blend, filter and back-projection
    in float32: within 1e-4 px of image coordinates."""
    hm = _heatmaps(4)
    rng = np.random.RandomState(5)
    outputs, meta = {"heatmaps": hm}, {}
    if with_coords:
        outputs["coords"] = rng.rand(2, 17, 2).astype(np.float32)
    if with_meta:
        meta = {"center": rng.uniform(100, 300, (2, 2)).astype(np.float32),
                "scale": rng.uniform(100, 200, (2, 2)).astype(np.float32)}
    got = postprocess.postprocess_predictions(
        {k: _t(v) for k, v in outputs.items()},
        {k: _t(v) for k, v in meta.items()}, conf_threshold=0.4)
    want = jpost.postprocess_predictions(
        {k: jnp.asarray(v) for k, v in outputs.items()},
        {k: jnp.asarray(v) for k, v in meta.items()}, conf_threshold=0.4)
    for k in ("preds", "maxvals", "mask"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-4, err_msg=k)
    assert 0 < got["mask"].sum() < got["mask"].numel()


def test_window_centroid_refine_and_filter_match_jax():
    hm = _heatmaps(6)
    coords = np.random.RandomState(7).uniform(-1, 13, (2, 17, 2)).astype(
        np.float32)
    got = decode.window_centroid_refine(_t(hm), _t(coords), 5).numpy()
    want = np.asarray(jdecode.window_centroid_refine(
        jnp.asarray(hm), jnp.asarray(coords), 5))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    conf = np.random.RandomState(8).rand(2, 17).astype(np.float32)
    p, m = postprocess.filter_low_confidence(_t(coords), _t(conf), 0.5)
    jp, jm = jpost.filter_low_confidence(jnp.asarray(coords),
                                         jnp.asarray(conf), 0.5)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))


# -- the rotated crop ---------------------------------------------------------

ROTS = np.array([0.0, 17.5, -40.0, 75.0, 90.0], np.float32)  # 75, 90: joint


def _geometry(seed, n=len(ROTS)):
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (n, 70, 90, 3)).astype(np.uint8)
    centers = rng.uniform(20, 70, (n, 2)).astype(np.float32)
    scales = rng.uniform(40, 90, (n, 2)).astype(np.float32)
    return frames, centers, scales


def test_rotated_affine_matrix_and_points_match_jax():
    _, centers, scales = _geometry(9)
    mats = affine.get_affine_matrix(_t(centers), _t(scales), (48, 64),
                                    _t(ROTS))
    jmats = jaffine.get_affine_matrix(jnp.asarray(centers),
                                      jnp.asarray(scales), (48, 64),
                                      jnp.asarray(ROTS))
    np.testing.assert_allclose(mats.numpy(), np.asarray(jmats), rtol=1e-5,
                               atol=1e-4)
    pts = np.random.RandomState(10).uniform(0, 90, (len(ROTS), 17, 2))
    pts = pts.astype(np.float32)
    got = affine.transform_points(_t(pts), mats).numpy()
    want = np.asarray(jaffine.transform_points(jnp.asarray(pts), jmats))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    # unrotated: the scalar default agrees with a zero per-sample angle
    np.testing.assert_array_equal(
        affine.get_affine_matrix(_t(centers), _t(scales), (48, 64)).numpy(),
        affine.get_affine_matrix(_t(centers), _t(scales), (48, 64),
                                 _t(np.zeros_like(ROTS))).numpy())


@pytest.mark.parametrize("warp", ["warp_affine_batch", "warp_affine_twopass"])
def test_rotated_warps_match_jax(warp):
    """Both warps on the same forward matrices (JAX's), uint8 frames,
    within 1e-2 of 0-255 pixel values: a sample position ~90 px off the
    origin carries float32 rounding of ~1e-5 px, times steps of up to 255
    between neighbouring pixels.  The two-pass warp at 75 and 90 degrees
    takes the joint gather (equal to warp_affine_batch)."""
    frames, centers, scales = _geometry(11)
    jmats = np.asarray(jaffine.get_affine_matrix(
        jnp.asarray(centers), jnp.asarray(scales), (48, 64),
        jnp.asarray(ROTS)))
    got = getattr(affine, warp)(_t(frames), _t(jmats), 48, 64).numpy()
    want = np.asarray(getattr(jaffine, warp)(
        jnp.asarray(frames, jnp.float32), jnp.asarray(jmats), 48, 64))
    assert got.shape == (len(ROTS), 64, 48, 3)
    np.testing.assert_allclose(got, want, atol=1e-2)
    if warp == "warp_affine_twopass":
        joint = affine.warp_affine_batch(_t(frames), _t(jmats), 48, 64)
        np.testing.assert_array_equal(got[3:], joint[3:].numpy())


def test_crop_and_normalize_rotated_matches_jax():
    frames, centers, scales = _geometry(12)
    got = affine.crop_and_normalize(_t(frames), _t(centers), _t(scales),
                                    (48, 64), rots=_t(ROTS)).numpy()
    want = np.asarray(jaffine.crop_and_normalize(
        jnp.asarray(frames), jnp.asarray(centers), jnp.asarray(scales),
        (48, 64), rots=jnp.asarray(ROTS)))
    # the warps' 1e-2 of a pixel value over ImageNet's std * 255 (~57)
    np.testing.assert_allclose(got, want, atol=2e-4)


# -- multi-scale + flip test-time augmentation --------------------------------

def test_multiscale_flip_inference_matches_jax():
    """The tiny HRNet + fusion head of tests/torch_tiny.py (seeded numpy
    weights on ``jax.eval_shape``'s tree) at scales (1.0, 0.75), flip on,
    one jitted JAX apply: float32, coordinates within 1e-3 heatmap px,
    scores within 1e-4."""
    head = "fusion"
    with torch_tiny.registered():
        jcfg = torch_tiny.tiny_cfg(jget_config(), head)
        jmodel = jpe.build_model(jcfg)
        variables = torch_tiny.random_variables(jmodel, seed=20)
        cfg = torch_tiny.tiny_cfg(Config(), head)
        port = torch_tiny.port(cfg, variables)
        crops = torch_tiny.crops(seed=21, n=2)
        flip_index = cfg.data.keypoint_schema.flip_index()
        scales = (1.0, 0.75)
        want_c, want_s = jpe.multiscale_flip_inference(
            jax.jit(jmodel.apply, static_argnums=2), variables,
            jnp.asarray(crops), jnp.asarray(flip_index), head, scales=scales)
    with torch.no_grad():
        got_c, got_s = multiscale_flip_inference(
            port, _t(crops), _t(flip_index), head, scales=scales)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-3)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=1e-4, atol=1e-4)
