"""PyTorch port, serving slice: decode, crops, weights and the whole
``PoseInference.predict_batch`` against the JAX package on the CPU.

The whole-slice tests register a tiny HRFormer in both packages'
``BACKBONES`` (test-only) and share its seeded numpy weights on
``jax.eval_shape``'s tree (``torch_tiny.random_variables``: no JAX init to
compile).
"""

import copy
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu import inference as jinference
from infantposeestimation_gaussianbias_tpu.config import get_variant
from infantposeestimation_gaussianbias_tpu.models import hrformer as jhr
from infantposeestimation_gaussianbias_tpu.models import pose_estimator as jpe
from infantposeestimation_gaussianbias_tpu.ops import affine as jaffine
from infantposeestimation_gaussianbias_tpu.ops import decode as jdecode
from infantposeestimation_gaussianbias_tpu.tools.import_torch_checkpoint import (
    convert_checkpoint,
)
from infantposeestimation_gaussianbias_tpu_torch import PoseInference
from infantposeestimation_gaussianbias_tpu_torch.models import hrformer
from infantposeestimation_gaussianbias_tpu_torch.models import pose_estimator
from infantposeestimation_gaussianbias_tpu_torch.ops import affine, decode
from infantposeestimation_gaussianbias_tpu_torch.weights import (
    state_dict_from_jax,
)
from tests import torch_tiny
from tests.torch_tiny import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
TINY = dict(channels=(8, 16, 32, 64), num_heads=(1, 2, 4, 8),
            stage_modules=(1, 1, 1))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _near_half_integer(coords, tol=1e-3):
    """(B, K) mask of soft-argmax coordinates within ``tol`` of a
    half-integer on either axis: there round() sits on a tie and a 1e-7
    difference can move the local-refine window by a pixel."""
    frac = np.abs(np.asarray(coords) % 1.0 - 0.5)
    return (frac < tol).any(axis=-1)


# -- decode and crops on identical inputs -------------------------------------

def _peaked_heatmaps(seed, B=2, H=16, W=12, K=17):
    rng = np.random.RandomState(seed)
    hm = rng.rand(B, H, W, K).astype(np.float32) * 0.1
    ys, xs = rng.randint(0, H, (B, K)), rng.randint(0, W, (B, K))
    for b in range(B):
        for k in range(K):
            hm[b, ys[b, k], xs[b, k], k] += 1.0 + rng.rand()
    return hm


@pytest.mark.parametrize("beta,radius", [(1.0, 2), (10.0, 2), (10.0, 1)])
def test_fusion_decode_matches_jax(beta, radius):
    hm = _peaked_heatmaps(int(beta) + radius)
    rng = np.random.RandomState(1)
    off = rng.randn(*hm.shape, 2).astype(np.float32)
    alpha, fw = np.float32(0.3), np.float32(-0.2)
    coords, scores = decode.fusion_decode(_t(hm), _t(off), _t(alpha), _t(fw),
                                          beta=beta, radius=radius)
    jc, js = jdecode.fusion_decode(jnp.asarray(hm), jnp.asarray(off), alpha,
                                   fw, beta=beta, radius=radius)
    np.testing.assert_allclose(coords.numpy(), np.asarray(jc), atol=1e-4)
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), atol=1e-6)


def test_sample_at_coords_clamps_like_jax():
    rng = np.random.RandomState(2)
    maps = rng.randn(2, 8, 6, 3, 2).astype(np.float32)
    coords = rng.uniform(-3, 10, (2, 3, 2)).astype(np.float32)
    out = decode.sample_at_coords(_t(maps), _t(coords)).numpy()
    ref = np.asarray(jdecode.sample_at_coords(jnp.asarray(maps),
                                              jnp.asarray(coords)))
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize("shift", [False, True])
def test_flip_heatmaps_and_transform_preds_match_jax(shift):
    hm = _peaked_heatmaps(3)
    flip_idx = get_variant("hrformer_base").data.keypoint_schema.flip_index()
    out = decode.flip_heatmaps(_t(hm), _t(flip_idx), shift=shift).numpy()
    ref = np.asarray(jdecode.flip_heatmaps(jnp.asarray(hm),
                                           jnp.asarray(flip_idx), shift=shift))
    np.testing.assert_array_equal(out, ref)
    rng = np.random.RandomState(4)
    coords = rng.rand(2, 17, 2).astype(np.float32) * 192
    centers = rng.rand(2, 2).astype(np.float32) * 300
    scales = rng.rand(2, 2).astype(np.float32) * 200 + 50
    got = decode.transform_preds(_t(coords), _t(centers), _t(scales),
                                 (192, 256)).numpy()
    want = np.asarray(jdecode.transform_preds(
        jnp.asarray(coords), jnp.asarray(centers), jnp.asarray(scales),
        (192, 256)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_crop_and_normalize_matches_jax():
    rng = np.random.RandomState(5)
    frames = rng.randint(0, 256, (3, 80, 100, 3)).astype(np.uint8)
    centers = np.array([[50, 40], [30, 20], [70, 60]], np.float32)
    scales = np.array([[60, 80], [100, 120], [40, 50]], np.float32)
    mats = affine.get_affine_matrix(_t(centers), _t(scales), (48, 64))
    jmats = jaffine.get_affine_matrix(jnp.asarray(centers),
                                      jnp.asarray(scales), (48, 64))
    np.testing.assert_allclose(mats.numpy(), np.asarray(jmats), rtol=1e-6)
    np.testing.assert_allclose(affine.invert_affine(mats).numpy(),
                               np.asarray(jaffine.invert_affine(jmats)),
                               rtol=1e-6, atol=1e-5)
    crops = affine.crop_and_normalize(_t(frames), _t(centers), _t(scales),
                                      (48, 64)).numpy()
    ref = np.asarray(jaffine.crop_and_normalize(
        jnp.asarray(frames), jnp.asarray(centers), jnp.asarray(scales),
        (48, 64)))
    assert crops.shape == (3, 64, 48, 3)
    np.testing.assert_allclose(crops, ref, atol=1e-4)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 33])
def test_bucket_rows_matches_jax(n):
    assert (PoseInference._bucket_rows(n)
            == jinference.PoseInference._bucket_rows(n))


# -- the whole slice on a tiny backbone --------------------------------------

def _tiny_cfg():
    cfg = get_variant("hrformer_base")
    cfg.model.backbone = "tiny_hrformer"
    cfg.model.hidden_dim = 16
    cfg.model.compute_dtype = "float32"
    cfg.data.input_size = (48, 64)
    cfg.data.heatmap_size = (12, 16)
    return cfg


def _sharpen(variables, seed):
    """Random BN statistics and stronger prediction convs: the default
    init's flat heatmaps would put every soft-argmax on the map centre."""
    rng = np.random.RandomState(seed)
    v = jax.tree_util.tree_map(np.asarray, variables)
    v = jax.tree_util.tree_map(np.array, v)  # writable copies
    for path, leaf in jax.tree_util.tree_leaves_with_path(v["batch_stats"]):
        name = jax.tree_util.keystr(path)
        if name.endswith("['mean']"):
            leaf[...] = rng.randn(*leaf.shape) * 0.1
        elif name.endswith("['var']"):
            leaf[...] = rng.rand(*leaf.shape) * 0.5 + 0.75
    for final in ("hm_final", "off_final"):
        k = v["params"]["head"][final]["kernel"]
        k[...] = rng.randn(*k.shape) * 0.3
    return v


@pytest.fixture(scope="module")
def jax_slice():
    """(cfg, JAX variables as numpy) with the tiny backbone registered in
    both BACKBONES dicts for the module's duration."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jpe.BACKBONES, "tiny_hrformer", lambda **kw: jhr.HRFormer(
            drop_path_rate=0.0, **TINY, **kw))
        mp.setitem(pose_estimator.BACKBONES, "tiny_hrformer",
                   lambda **kw: hrformer.HRFormer(**TINY, **kw))
        mp.setitem(jpe.BACKBONES, "hrformer_tiny",
                   jpe.BACKBONES["tiny_hrformer"])
        mp.setitem(pose_estimator.BACKBONES, "hrformer_tiny",
                   pose_estimator.BACKBONES["tiny_hrformer"])
        cfg = _tiny_cfg()
        model = jpe.build_model(cfg)
        # seeded numpy weights on jax.eval_shape's tree: no init to compile
        variables = torch_tiny.random_variables(model, seed=0, shape=(64, 48))
        yield cfg, model, _sharpen(variables, seed=1)


def _frames_and_boxes():
    rng = np.random.RandomState(7)
    frames = rng.randint(0, 256, (3, 80, 100, 3)).astype(np.uint8)
    bboxes = np.array([[10, 5, 70, 75], [0, 0, 100, 80], [30, 20, 90, 60]],
                      np.float32)
    return frames, bboxes


def test_weights_round_trip_is_exact(jax_slice):
    """flax variables -> state_dict_from_jax -> convert_checkpoint gives
    the same arrays back, bit for bit."""
    _, _, variables = jax_slice
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    params, stats = convert_checkpoint({k: v.numpy() for k, v in sd.items()},
                                       head_type="fusion")
    flat_in = jax.tree_util.tree_leaves_with_path(variables["params"])
    flat_out = jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in flat_in] == [p for p, _ in flat_out]
    for (_, a), (_, b) in zip(flat_in, flat_out):
        np.testing.assert_array_equal(a, b)
    s_in = jax.tree_util.tree_leaves_with_path(variables["batch_stats"])
    s_out = jax.tree_util.tree_leaves_with_path(stats)
    assert [p for p, _ in s_in] == [p for p, _ in s_out]
    for (_, a), (_, b) in zip(s_in, s_out):
        np.testing.assert_array_equal(a, b)


def test_state_dict_loads_strict(jax_slice):
    cfg, _, variables = jax_slice
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    model = pose_estimator.build_model(cfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)


def test_model_outputs_match_jax(jax_slice):
    """Heatmaps, offsets, variances and the logits of the forward on the
    same crops, at a tight tolerance."""
    cfg, model, variables = jax_slice
    crops = np.random.RandomState(8).randn(2, 64, 48, 3).astype(np.float32)
    ref = jax.jit(lambda v, x: model.apply(v, x, False))(
        variables, jnp.asarray(crops))
    port = pose_estimator.build_model(cfg, device="cpu")
    port.load_state_dict(state_dict_from_jax(variables["params"],
                                             variables["batch_stats"]))
    with torch.no_grad():
        out = port(_t(crops))
    for key in ("heatmaps", "offsets", "variances", "fusion_weight_logit",
                "subpixel_alpha_logit"):
        assert out[key].shape == ref[key].shape, key
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(ref[key]),
                                   atol=1e-4, rtol=1e-4, err_msg=key)


def test_predict_batch_matches_jax(jax_slice):
    """Whole slice: crop -> flip-tested forward -> fusion decode ->
    back-projection, 3 frames padded to a bucket of 4; BN-fold off on both
    sides (eval-mode BatchNorm)."""
    _predict_batch_matches_jax(*jax_slice, fold=False)


def test_predict_batch_folded_matches_jax(jax_slice):
    """The same with each side's default, which folds (the backbone named
    ``hrformer_tiny``, so that both packages' ``validate_serving_mode``
    take it for an HRFormer)."""
    cfg, model, variables = jax_slice
    cfg = copy.deepcopy(cfg)
    cfg.model.backbone = "hrformer_tiny"
    _predict_batch_matches_jax(cfg, jpe.build_model(cfg), variables,
                               fold=None)


def _predict_batch_matches_jax(cfg, model, variables, fold):
    frames, bboxes = _frames_and_boxes()
    jinf = jinference.PoseInference(
        cfg, state=SimpleNamespace(
            apply_fn=model.apply,
            variables=jax.tree_util.tree_map(jnp.asarray, variables)),
        fold=fold)
    ref_k, ref_s = jinf.predict_batch(frames, bboxes)

    port = PoseInference(cfg, state_dict=state_dict_from_jax(
        variables["params"], variables["batch_stats"]), device="cpu",
        fold=fold)
    assert port.fold == (fold is None)
    kpts, scores = port.predict_batch(frames, bboxes)
    assert kpts.shape == (3, 17, 2) and scores.shape == (3, 17)
    assert np.isfinite(kpts).all() and np.isfinite(scores).all()

    # soft-argmax coordinates of the flip-averaged heatmaps, for the ties
    centers = (bboxes[:, :2] + bboxes[:, 2:]) / 2
    scales = (bboxes[:, 2:] - bboxes[:, :2]) * cfg.data.bbox_padding
    with torch.no_grad():
        crops = affine.crop_and_normalize(_t(frames), _t(centers),
                                          _t(scales), (48, 64))
        hm = port.model(crops)["heatmaps"]
        hm_f = decode.flip_heatmaps(port.model(torch.flip(crops, [2]))[
            "heatmaps"], port._flip_index)
        g, _ = decode.soft_argmax((hm + hm_f) * 0.5)
    keep = ~_near_half_integer(g.numpy())
    print(f"left out {int((~keep).sum())} of {keep.size} keypoints "
          f"near a half-integer soft-argmax")
    assert keep.sum() >= keep.size // 2
    np.testing.assert_allclose(kpts[keep], ref_k[keep], atol=1e-3)
    np.testing.assert_allclose(scores, ref_s, atol=1e-4)


def test_predict_single_image(jax_slice):
    cfg, _, variables = jax_slice
    frames, bboxes = _frames_and_boxes()
    port = PoseInference(cfg, state_dict=state_dict_from_jax(
        variables["params"], variables["batch_stats"]), device="cpu")
    k1, s1 = port.predict(frames[1], bboxes[1])
    kb, sb = port.predict_batch(frames[1:2], bboxes[1:2])
    np.testing.assert_array_equal(k1, kb[0])
    kd, _ = port.predict(frames[1])  # full-image box, same as bboxes[1]
    np.testing.assert_array_equal(kd, k1)


# -- full width ---------------------------------------------------------------

def test_hrformer_base_state_dict_matches_jax_shapes():
    """At full width the port's hrformer_base + fusion state dict converts
    to the JAX init tree's shapes, with the same parameter count."""
    cfg = get_variant("hrformer_base")
    port = pose_estimator.build_model(cfg, device="cpu")
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params, stats = convert_checkpoint(sd, head_type="fusion")
    model = jpe.PoseEstimator(backbone_name="hrformer_base",
                              head_type="fusion", num_keypoints=17,
                              hidden_dim=cfg.model.hidden_dim)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 192, 3)), False))
    as_shape = lambda t: jax.tree_util.tree_map(lambda s: tuple(s.shape), t)
    assert as_shape(shapes["params"]) == jax.tree_util.tree_map(np.shape,
                                                                params)
    assert as_shape(shapes["batch_stats"]) == jax.tree_util.tree_map(
        np.shape, stats)
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in port.parameters()) == n_jax


# -- no jax at run time -------------------------------------------------------

def test_port_runs_without_jax():
    """With jax, flax and the JAX package unimportable, the port imports
    (its process grid and the grid tests' rank helper too), serves a batch
    and takes a training step (DropPath on), on the CPU."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = sys.modules["flax"] = None
        sys.modules["infantposeestimation_gaussianbias_tpu"] = None
        import numpy as np
        import torch
        from infantposeestimation_gaussianbias_tpu_torch import (
            PoseInference, create_train_state, get_variant, make_train_step)
        from infantposeestimation_gaussianbias_tpu_torch.models import (
            hrformer, pose_estimator)
        from infantposeestimation_gaussianbias_tpu_torch import parallel
        from tests import torch_grid
        pose_estimator.BACKBONES["tiny"] = lambda **kw: hrformer.HRFormer(
            channels=(8, 16, 32, 64), num_heads=(1, 2, 4, 8),
            stage_modules=(1, 1, 1), **kw)
        cfg = get_variant("hrformer_base")
        cfg.model.backbone, cfg.model.hidden_dim = "tiny", 16
        cfg.data.input_size, cfg.data.heatmap_size = (48, 64), (12, 16)
        frames = np.zeros((2, 40, 30, 3), np.uint8)
        boxes = np.array([[0, 0, 30, 40]] * 2, np.float32)
        k, s = PoseInference(cfg, device="cpu").predict_batch(frames, boxes)
        assert k.shape == (2, 17, 2) and np.isfinite(k).all()
        state = create_train_state(cfg, device="cpu")
        rng = np.random.RandomState(0)
        batch = {"image": torch.from_numpy(
                     rng.randn(2, 64, 48, 3).astype(np.float32)),
                 "keypoints": torch.from_numpy(
                     rng.uniform(0, 48, (2, 17, 2)).astype(np.float32)),
                 "visible": torch.full((2, 17), 2.0)}
        _, metrics = make_train_step(cfg)(
            state, batch, torch.Generator().manual_seed(0))
        assert state.step == 1
        assert all(np.isfinite(v.item()) for v in metrics.values())
        assert not any(m.split(".")[0] in (
            "jax", "flax", "infantposeestimation_gaussianbias_tpu")
            for m, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("IPE_PLATFORM", None)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
