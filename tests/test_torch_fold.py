"""PyTorch port, BN-fold serving: ``fold_state_dict``, the folded models,
``PoseInference``'s default fold and ``validate_serving_mode`` against the
JAX package's ``fold_variables``, ``build_model(cfg, fold=True)`` and its
default ``PoseInference``, on the CPU.

Models: the tiny HRNet of tests/torch_tiny.py with the fusion head, and a
tiny HRFormer (widths 8/16/32/64, one module a stage) with the heatmap
head, both registered in the two packages' ``BACKBONES`` for the module.
Their weights are seeded numpy on ``jax.eval_shape``'s tree
(``torch_tiny.random_variables``): non-trivial running statistics (mean
N(0, 0.1), variance in [0.75, 1.25)) and BatchNorm scales 1 +- 0.1, so
every fold moves its conv.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu import inference as jinference
from infantposeestimation_gaussianbias_tpu.config import get_config as jget_config
from infantposeestimation_gaussianbias_tpu.models import fold as jfold
from infantposeestimation_gaussianbias_tpu.models import hrformer as jhr
from infantposeestimation_gaussianbias_tpu.models import pose_estimator as jpe
from infantposeestimation_gaussianbias_tpu.ops import quant as jquant
from infantposeestimation_gaussianbias_tpu_torch import Config, PoseInference
from infantposeestimation_gaussianbias_tpu_torch.models import (
    fold, hrformer, pose_estimator)
from infantposeestimation_gaussianbias_tpu_torch.models.layers import (
    BatchNorm, GroupNorm)
from infantposeestimation_gaussianbias_tpu_torch.weights import (
    state_dict_from_jax,
)
from tests import torch_tiny
from tests.torch_tiny import one_torch_thread  # noqa: F401 (autouse)

SIZE = torch_tiny.SIZE
TINY_HRFORMER = dict(channels=(8, 16, 32, 64), num_heads=(1, 2, 4, 8),
                     stage_modules=(1, 1, 1))
# float32 on both sides: the folded weights agree to an ulp (rsqrt), the
# forwards to summation order; relative to the map's largest magnitude.
OUT_TOL = 1e-4
MODELS = [("hrnet_tiny", "fusion"), ("hrformer_tiny", "heatmap")]


def _cfg(cfg, backbone, head):
    torch_tiny.tiny_cfg(cfg, head)
    cfg.model.backbone = backbone
    return cfg


@pytest.fixture(scope="module")
def models():
    """{(backbone, head): (port cfg, JAX cfg, JAX model, variables,
    jitted folded JAX apply)} with both tiny backbones registered."""
    with torch_tiny.registered(), pytest.MonkeyPatch.context() as mp:
        mp.setitem(jpe.BACKBONES, "hrformer_tiny", lambda **kw: jhr.HRFormer(
            drop_path_rate=0.0, **TINY_HRFORMER, **kw))
        mp.setitem(pose_estimator.BACKBONES, "hrformer_tiny",
                   lambda **kw: hrformer.HRFormer(**TINY_HRFORMER, **kw))
        out = {}
        for seed, (backbone, head) in enumerate(MODELS):
            jcfg = _cfg(jget_config(), backbone, head)
            jmodel = jpe.build_model(jcfg)
            variables = torch_tiny.random_variables(jmodel, seed=10 + seed)
            folded = jax.jit(jpe.build_model(jcfg, fold=True).apply,
                             static_argnums=2)
            out[(backbone, head)] = (_cfg(Config(), backbone, head), jcfg,
                                     jmodel, variables, folded)
        yield out


def _jax_foldable(params, stats) -> int:
    """The ConvNorms that the JAX ``fold_variables`` folds."""
    if jfold._foldable(params, stats):
        return 1
    if not isinstance(params, dict):
        return 0
    return sum(_jax_foldable(v, (stats or {}).get(k) or {})
               for k, v in params.items())


def _port_sd(variables):
    return state_dict_from_jax(variables["params"], variables["batch_stats"])


@pytest.mark.parametrize("key", MODELS, ids=lambda m: "-".join(m))
def test_folded_pair_count_matches_jax(models, key):
    _, _, _, variables, _ = models[key]
    pairs = fold.convnorm_pairs(_port_sd(variables))
    want = _jax_foldable(variables["params"], variables["batch_stats"])
    assert want > 10
    assert len(pairs) == want
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("key", MODELS, ids=lambda m: "-".join(m))
def test_fold_state_dict_matches_fold_variables(models, key):
    """The port's fold of the converted weights against the JAX fold
    converted: same names, each value within 2 float32 ulps (rsqrt)."""
    cfg, _, _, variables, _ = models[key]
    got = fold.fold_state_dict(_port_sd(variables))
    fv = jfold.fold_variables(variables)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                      fv["params"]),
                               variables["batch_stats"])
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=3e-7, atol=1e-7, err_msg=name)
    folded = pose_estimator.build_model(cfg, device="cpu", fold=True)
    assert set(folded.state_dict()) == set(got)
    assert not any(isinstance(m, BatchNorm) for m in folded.modules())
    assert fold.fold_state_dict(got).keys() == got.keys()  # idempotent


@pytest.mark.parametrize("key", MODELS, ids=lambda m: "-".join(m))
def test_folded_model_matches_jax(models, key):
    """The port's folded forward against JAX ``build_model(cfg,
    fold=True)`` on the folded variables, and against the port's own
    unfolded forward, on the same crops."""
    cfg, _, _, variables, jfolded = models[key]
    crops = torch_tiny.crops(seed=3)
    fv = jfold.fold_variables(variables)
    ref = jfolded(fv, jnp.asarray(crops), False)
    port = pose_estimator.build_model(cfg, device="cpu", fold=True)
    port.load_state_dict(fold.fold_state_dict(_port_sd(variables)))
    plain = torch_tiny.port(cfg, variables)
    with torch.no_grad():
        out, out_plain = port(torch_tiny.t(crops)), plain(torch_tiny.t(crops))
    for k, v in out.items():
        want = np.asarray(ref[k])
        tol = OUT_TOL * (np.abs(want).max() + 1)
        got = v.detach().numpy()
        np.testing.assert_allclose(got, want, atol=tol, rtol=OUT_TOL,
                                   err_msg=k)
        np.testing.assert_allclose(got, out_plain[k].detach().numpy(),
                                   atol=tol, rtol=OUT_TOL, err_msg=k)


def test_pose_inference_folds_by_default(models):
    """``PoseInference``'s default folds (hrnet + fusion, BatchNorm) and
    its keypoints match the JAX default ``PoseInference`` (folded), flip
    test on: within 1e-3 px off decode ties, scores within 1e-4."""
    cfg, jcfg, jmodel, variables, _ = models[("hrnet_tiny", "fusion")]
    rng = np.random.RandomState(4)
    frames = rng.randint(0, 256, (3, 90, 80, 3)).astype(np.uint8)
    bboxes = np.array([[5, 5, 70, 85], [0, 0, 80, 90], [20, 10, 60, 70]],
                      np.float32)
    jinf = jinference.PoseInference(jcfg, state=SimpleNamespace(
        apply_fn=jmodel.apply,
        variables=jax.tree_util.tree_map(jnp.asarray, variables)))
    ref_k, ref_s = jinf.predict_batch(frames, bboxes)
    port = PoseInference(cfg, state_dict=_port_sd(variables), device="cpu")
    assert port.fold
    assert not any(isinstance(m, BatchNorm) for m in port.model.modules())
    kpts, scores = port.predict_batch(frames, bboxes)
    unfolded = PoseInference(cfg, state_dict=_port_sd(variables),
                             device="cpu", fold=False)
    assert not unfolded.fold
    k_plain, _ = unfolded.predict_batch(frames, bboxes)
    # ties: soft-argmax of the flip-averaged heatmaps near a half-integer
    with torch.no_grad():
        from infantposeestimation_gaussianbias_tpu_torch.ops import (
            affine, decode)
        centers = (bboxes[:, :2] + bboxes[:, 2:]) / 2
        scales = (bboxes[:, 2:] - bboxes[:, :2]) * cfg.data.bbox_padding
        crops = affine.crop_and_normalize(
            torch.from_numpy(frames), torch.from_numpy(centers),
            torch.from_numpy(scales), cfg.data.input_size)
        hm = port.model(crops)["heatmaps"]
        hm_f = decode.flip_heatmaps(port.model(torch.flip(crops, [2]))[
            "heatmaps"], port._flip_index)
        g, _ = decode.soft_argmax((hm + hm_f) * 0.5)
    keep = ~(np.abs(g.numpy() % 1.0 - 0.5) < 1e-3).any(axis=-1)
    assert keep.sum() >= keep.size // 2
    np.testing.assert_allclose(kpts[keep], ref_k[keep], atol=1e-3)
    np.testing.assert_allclose(scores, ref_s, atol=1e-4)
    np.testing.assert_allclose(kpts[keep], k_plain[keep], atol=1e-3)


@pytest.mark.parametrize("backbone,head,norm", [
    ("hrnet_w32", "heatmap", "batchnorm"),
    ("hrformer_base", "fusion", "batchnorm"),
    ("hrnet_w32", "fusion", "groupnorm"),
    ("hrformer_small", "heatmap", "groupnorm"),
    ("litehrnet", "heatmap", "batchnorm"),
    ("hrnet_w32", "simcc", "batchnorm"),
    ("hrformer_base", "fused", "batchnorm"),
])
def test_validate_serving_mode_matches_jax(backbone, head, norm):
    """Which architectures fold and which quantize to int8, and the error,
    as the JAX package's ``validate_serving_mode``: int8 for hrformer, and
    for hrnet with the fusion or heatmap head; the rest raise
    ValueError."""
    for mode in (dict(fold=True), dict(quant=True)):
        ok = jpe.serving_mode_supported(backbone, head, norm, **mode)
        assert pose_estimator.serving_mode_supported(
            backbone, head, norm, **mode) == ok
        if not ok:
            with pytest.raises(ValueError) as jerr:
                jpe.validate_serving_mode(backbone, head, norm, **mode)
            with pytest.raises(ValueError) as err:
                pose_estimator.validate_serving_mode(backbone, head, norm,
                                                     **mode)
            assert str(err.value) == str(jerr.value)
    quant_ok = pose_estimator.serving_mode_supported(backbone, head, norm,
                                                     quant=True)
    assert quant_ok == (backbone.startswith("hrformer") or (
        backbone.startswith("hrnet") and head in ("fusion", "heatmap")))


def test_fold_true_with_groupnorm_raises(models):
    """``fold=True`` on a GroupNorm model raises as the JAX check does; the
    default (None) then serves unfolded, GroupNorm in place."""
    cfg, _, _, _, _ = models[("hrnet_tiny", "fusion")]
    cfg.model.norm = "groupnorm"
    try:
        with pytest.raises(ValueError, match="BN-fold requires batchnorm"):
            PoseInference(cfg, device="cpu", fold=True)
        with pytest.raises(ValueError, match="BN-fold requires batchnorm"):
            pose_estimator.build_model(cfg, device="cpu", fold=True)
        inf = PoseInference(cfg, device="cpu")
        assert not inf.fold
        assert any(isinstance(m, GroupNorm) for m in inf.model.modules())
        assert fold.convnorm_pairs(inf.model.state_dict()) == []
    finally:
        cfg.model.norm = "batchnorm"


def test_fold_batchnorm_matches_jax():
    rng = np.random.RandomState(5)
    w, b, m = rng.randn(3, 24).astype(np.float32)
    v = rng.rand(24).astype(np.float32) + 0.1
    a, c = fold.fold_batchnorm(*(torch.from_numpy(x) for x in (w, b, m, v)))
    ja, jc = jquant.fold_batchnorm(w, b, m, v)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=3e-7)
    # b = bias - mean * a cancels: 2 float32 ulps of its terms
    np.testing.assert_allclose(
        c.numpy(), np.asarray(jc), rtol=0,
        atol=2.4e-7 * (np.abs(b) + np.abs(m * a.numpy())).max())
