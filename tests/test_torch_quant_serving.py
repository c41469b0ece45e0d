"""PyTorch port, int8 PTQ serving: HRFormer's Dense-only int8 mode and
``PoseInference(quantize=True)`` against the JAX package, on the CPU.

Models: a tiny HRFormer (widths 16/32/64/128, heads 1/2/4/8, one module a
stage, 64x64) with the fusion head: its 128-wide branch quantizes qkv,
proj, fc1 and fc2, the 32- and 64-wide ones only fc2 (hidden 128, 256),
the 16-wide one nothing, so int8 and float Dense layers both run; and the
tiny HRNet of tests/torch_tiny.py with the fusion head, sharpened
(``torch_tiny.sharpen``) so that its heatmaps have peaks to decode.
Weights are seeded numpy on ``jax.eval_shape``'s tree.

Tolerances, with their reasons:
* calibration: the same float32 model in another summation order,
  ``CALIB_RTOL``;
* the int8 forward on JAX's qparams against JAX's jitted int8 forward:
  K10's plain version equals JAX's ``qdense`` bit for bit, XLA's
  epilogue FMA and the float layers around it (LayerNorm, attention, the
  conv trunk) differ by ulps, which may move a quantized Dense input
  across a .5 boundary (measured 8e-7 of each output's scale): cosine
  ``FORWARD_COS``, max error ``FORWARD_ATOL`` of each output's scale;
* ``predict_batch``: JAX's serving pipeline is jitted (its epilogues'
  multiply-adds contracted) and each side calibrates itself on the same
  crops (scales an ulp apart), so some int8 values round the other way:
  jit alone moves JAX's int8 heatmaps to a cosine of 0.9997 from its
  op-by-op ones, peaks by a few percent.  Keypoints within
  ``KEYPOINT_ATOL_PX`` frame pixels, leaving out keypoints whose
  soft-argmax lies within ``TIE_TOL`` heatmap pixels of a half-integer
  (the refine window's tie; a random model's flat maps put many near
  the centre, 7.5); scores within ``SCORE_RTOL`` of the largest.
"""

import warnings
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu import inference as jinference
from infantposeestimation_gaussianbias_tpu.config import get_config as jget_config
from infantposeestimation_gaussianbias_tpu.models import hrformer as jhr
from infantposeestimation_gaussianbias_tpu.models import pose_estimator as jpe
from infantposeestimation_gaussianbias_tpu.models import quantize as jquantize
from infantposeestimation_gaussianbias_tpu.ops import quant as J
from infantposeestimation_gaussianbias_tpu_torch import Config, PoseInference
from infantposeestimation_gaussianbias_tpu_torch.models import (
    build_model, calibrate, hrformer, pose_estimator, quantize_model)
from infantposeestimation_gaussianbias_tpu_torch.models.layers import (
    BatchNorm, Linear, QConvNorm, QDense)
from infantposeestimation_gaussianbias_tpu_torch.weights import (
    quant_state_from_jax, state_dict_from_jax)
from tests import torch_tiny
from infantposeestimation_gaussianbias_tpu_torch import weights
from tests.test_torch_quant import _cos, _flat

TINY_HRFORMER = dict(channels=(16, 32, 64, 128), num_heads=(1, 2, 4, 8),
                     stage_modules=(1, 1, 1))
CALIB_RTOL = 1e-5
FORWARD_COS = 0.9999
FORWARD_ATOL = 1e-4
KEYPOINT_ATOL_PX = 0.5
TIE_TOL = 0.05
SCORE_RTOL = 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several test processes share the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(cfg, backbone):
    torch_tiny.tiny_cfg(cfg, "fusion")
    cfg.model.backbone = backbone
    return cfg


@pytest.fixture(scope="module")
def registered():
    with torch_tiny.registered(), pytest.MonkeyPatch.context() as mp:
        mp.setitem(jpe.BACKBONES, "hrformer_tiny", lambda **kw: jhr.HRFormer(
            drop_path_rate=0.0, **TINY_HRFORMER, **kw))
        mp.setitem(pose_estimator.BACKBONES, "hrformer_tiny",
                   lambda **kw: hrformer.HRFormer(**TINY_HRFORMER, **kw))
        yield


@pytest.fixture(scope="module")
def hrformer_setup(registered):
    """(port cfg, JAX cfg, float variables, JAX calib tree, JAX quantized
    variables (numpy), batches), by JAX ``quantize_model``'s steps for an
    HRFormer (one jitted ``calibrate``)."""
    jcfg = _cfg(jget_config(), "hrformer_tiny")
    variables = torch_tiny.random_variables(jpe.build_model(jcfg), seed=70)
    batches = [torch_tiny.crops(71), torch_tiny.crops(72)]
    calib = jax.tree_util.tree_map(np.asarray, dict(jquantize.calibrate(
        jcfg, variables, [jnp.asarray(b) for b in batches])))
    qparams = jquantize._prune_non_dense_qparams(jax.tree_util.tree_map(
        np.asarray, J.convert_tree(variables["params"],
                                   variables["batch_stats"], calib)))
    qvars = {"params": jquantize.strip_quantized_dense(variables["params"],
                                                       qparams),
             "qparams": qparams, "batch_stats": variables["batch_stats"]}
    return (_cfg(Config(), "hrformer_tiny"), jcfg, variables, calib, qvars,
            batches)


def _port_sd(variables):
    return state_dict_from_jax(variables["params"], variables["batch_stats"])


def test_hrformer_calibration_matches_jax(hrformer_setup):
    """Only the wide Dense inputs are recorded (qkv, proj, fc1 by C; fc2 by
    the hidden width), as JAX's calib tree, within CALIB_RTOL."""
    cfg, _, variables, jcal, _, batches = hrformer_setup
    got = calibrate(cfg, _port_sd(variables), batches, "cpu")
    want = {}
    for path, v in _flat(jcal).items():
        leaf = path[-1]
        assert leaf.endswith("_in_absmax"), path
        layer = path[1:-1] + (leaf[: -len("_in_absmax")],)
        want[f"{weights._dense_name(path[0], layer)}.in_absmax"] = v
    assert set(got) == set(want)
    # two blocks a branch; C = 128: qkv, proj, fc1, fc2; C = 32, 64: fc2;
    # stage 2 has branches 0-1, stage 3 0-2, stage 4 0-3
    assert len(want) == 2 * 1 + 2 * (1 + 1) + 2 * (1 + 1 + 4)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=CALIB_RTOL,
                                   err_msg=k)


def test_hrformer_int8_forward_matches_jax(hrformer_setup):
    """Dense-only int8: QDense exactly where the width gate says, the conv
    trunk float with its BatchNorms; the port's forward on JAX's qparams
    against JAX's jitted int8 forward; the port's own quantize_model
    loads strictly with the same int8 weights."""
    cfg, jcfg, variables, _, qvars, batches = hrformer_setup
    model = build_model(cfg, "cpu", quant=True)
    assert sum(isinstance(m, QDense) for m in model.modules()) == 18
    assert any(isinstance(m, Linear) for m in model.modules())
    assert any(isinstance(m, BatchNorm) for m in model.modules())
    assert not any(isinstance(m, QConvNorm) for m in model.modules())
    carried = quant_state_from_jax(qvars["params"], qvars["qparams"],
                                   qvars["batch_stats"])
    own = quantize_model(cfg, _port_sd(variables), batches, "cpu")
    assert set(own) == set(carried)
    for k, v in carried.items():
        if v.dtype == torch.int8:
            assert torch.equal(own[k], v), k
    model.load_state_dict(own, strict=True)
    model.load_state_dict(carried, strict=True)
    x = torch_tiny.crops(73)
    want = jax.jit(jpe.build_model(jcfg, quant=True).apply, static_argnums=2)(
        jax.tree_util.tree_map(jnp.asarray, qvars), x, False)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for k in ("heatmaps", "offsets", "variances"):
        w, g = np.asarray(want[k]), got[k].numpy()
        assert _cos(g, w) >= FORWARD_COS, k
        assert np.abs(g - w).max() <= FORWARD_ATOL * np.abs(w).max(), k


def _decode_ties(infer, frames, bboxes, tol: float) -> np.ndarray:
    """(B, K) keypoints whose soft-argmax of the flip-averaged heatmaps
    lies within ``tol`` of a half-integer (the refine window's round()
    tie), from the port's served model."""
    from infantposeestimation_gaussianbias_tpu_torch.ops import (
        affine, decode)

    cfg = infer.cfg
    centers = (bboxes[:, :2] + bboxes[:, 2:]) / 2
    scales = (bboxes[:, 2:] - bboxes[:, :2]) * cfg.data.bbox_padding
    with torch.no_grad():
        crops = affine.crop_and_normalize(
            torch.from_numpy(frames), torch.from_numpy(centers),
            torch.from_numpy(scales), cfg.data.input_size,
            mean=cfg.data.pixel_mean, std=cfg.data.pixel_std)
        hm = infer.model(crops)["heatmaps"]
        hm_f = decode.flip_heatmaps(infer.model(torch.flip(crops, [2]))[
            "heatmaps"], infer._flip_index)
        g, _ = decode.soft_argmax((hm + hm_f) * 0.5)
    return (np.abs(g.numpy() % 1.0 - 0.5) < tol).any(axis=-1)


@pytest.fixture(scope="module")
def int8_fusion(registered):
    """The int8 HRNet + fusion serving case (flip test on): (port cfg,
    float variables as numpy, frames, bboxes, calibration crops, JAX's
    live int8 ``PoseInference`` keypoints and scores on them)."""
    jcfg = torch_tiny.tiny_cfg(jget_config(), "fusion")
    variables = torch_tiny.sharpen(torch_tiny.random_variables(
        jpe.build_model(jcfg), seed=80), seed=81)
    cfg = torch_tiny.tiny_cfg(Config(), "fusion")
    rng = np.random.RandomState(82)
    frames = rng.randint(0, 256, (3, 90, 80, 3)).astype(np.uint8)
    bboxes = np.array([[5, 5, 70, 85], [0, 0, 80, 90], [20, 10, 60, 70]],
                      np.float32)
    calib = torch_tiny.crops(83, n=4)
    jinf = jinference.PoseInference(jcfg, quantize=True,
                                    calibration_crops=calib,
                                    state=SimpleNamespace(
        apply_fn=jpe.build_model(jcfg).apply,
        variables=jax.tree_util.tree_map(jnp.asarray, variables)))
    return (cfg, variables, frames, bboxes, calib,
            jinf.predict_batch(frames, bboxes))


def _close_to_jax(infer, kpts, scores, frames, bboxes, ref) -> None:
    """Keypoints within KEYPOINT_ATOL_PX of JAX's off decode ties, scores
    within SCORE_RTOL of the largest (the module doc's reasons)."""
    ref_k, ref_s = ref
    keep = ~_decode_ties(infer, frames, bboxes, TIE_TOL)
    assert keep.mean() > 0.7
    assert np.abs(kpts - ref_k)[keep].max() <= KEYPOINT_ATOL_PX
    assert np.abs(scores - ref_s).max() <= SCORE_RTOL * np.abs(ref_s).max()


def test_pose_inference_int8_matches_jax(int8_fusion):
    """``PoseInference(quantize=True, device="cpu")`` against JAX's on the
    same frames and calibration crops (HRNet + fusion, flip test on):
    keypoints and scores; the int8 model is installed once; without
    calibration crops the first batch calibrates, with the JAX package's
    warning below MIN_SELF_CALIB_CROPS."""
    cfg, variables, frames, bboxes, calib, ref = int8_fusion
    port = PoseInference(cfg, state_dict=state_dict_from_jax(
        variables["params"], variables["batch_stats"]), device="cpu",
        quantize=True, calibration_crops=calib)
    assert port.quantize and not port.fold
    installed = port.model
    assert any(isinstance(m, QConvNorm) for m in installed.modules())
    kpts, scores = port.predict_batch(frames, bboxes)
    assert port.model is installed
    _close_to_jax(port, kpts, scores, frames, bboxes, ref)

    lazy = PoseInference(cfg, state_dict=state_dict_from_jax(
        variables["params"], variables["batch_stats"]), device="cpu",
        quantize=True)
    assert not any(isinstance(m, QConvNorm) for m in lazy.model.modules())
    with pytest.warns(UserWarning, match="self-calibrating"):
        lazy.predict_batch(frames[:1], bboxes[:1])
    installed = lazy.model
    assert any(isinstance(m, QConvNorm) for m in installed.modules())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        lazy.predict_batch(frames, bboxes)
    assert lazy.model is installed


def test_concurrent_first_batches_calibrate_once(registered, monkeypatch):
    """The micro-batching server's dispatch threads may send the first
    batches together: the int8 model is calibrated and installed exactly
    once (under the lock), and every thread is served by it."""
    import sys
    import threading

    jcfg = torch_tiny.tiny_cfg(jget_config(), "heatmap")
    variables = torch_tiny.random_variables(jpe.build_model(jcfg), seed=90)
    cfg = torch_tiny.tiny_cfg(Config(), "heatmap")
    inf = PoseInference(cfg, state_dict=state_dict_from_jax(
        variables["params"], variables["batch_stats"]), device="cpu",
        quantize=True)
    installs = []
    install = inf._install_quant
    monkeypatch.setattr(inf, "_install_quant",
                        lambda crops: installs.append(1) or install(crops))
    frames = np.random.RandomState(91).randint(
        0, 256, (2, 90, 80, 3)).astype(np.uint8)
    bboxes = np.array([[5, 5, 70, 85], [0, 0, 80, 90]], np.float32)
    results, errors = [None] * 6, []
    start = threading.Barrier(6)

    def call(i):
        try:
            start.wait(timeout=60)
            results[i] = inf.predict_batch(frames, bboxes)
        except Exception as e:  # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the small-calibration warning
            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert installs == [1]
    assert any(isinstance(m, QConvNorm) for m in inf.model.modules())
    for k, s in results:
        np.testing.assert_array_equal(k, results[0][0])
        np.testing.assert_array_equal(s, results[0][1])


def test_exported_int8_matches_live_and_jax(int8_fusion):
    """The int8 pipeline of ``test_pose_inference_int8_matches_jax``
    exported by tools/export_model.py (saved, loaded, called at its 3
    frames): equal bit for bit to the live int8 pipeline it was exported
    from (the same int8 state), within that test's bounds of JAX's live
    int8 pipeline, and holding one K9 operator node per int8 conv call
    (two passes: the flip test)."""
    from collections import Counter

    from infantposeestimation_gaussianbias_tpu_torch.tools import (
        export_model)

    cfg, variables, frames, bboxes, calib, ref = int8_fusion
    inf = PoseInference(cfg, state_dict=state_dict_from_jax(
        variables["params"], variables["batch_stats"]), device="cpu",
        quantize=True, calibration_crops=calib)
    program = export_model.load_pipeline(export_model.export_serving(
        export_model.ServingPipeline(inf, frames.shape[1:3]), len(frames)))
    centers = (bboxes[:, :2] + bboxes[:, 2:]) / 2
    scales = (bboxes[:, 2:] - bboxes[:, :2]) * cfg.data.bbox_padding
    args = tuple(map(torch.from_numpy, (frames, centers, scales)))
    kpts, scores = program.call(*args)
    live_k, live_s = inf._pipeline(*args)
    assert torch.equal(kpts, live_k) and torch.equal(scores, live_s)
    _close_to_jax(inf, kpts.numpy(), scores.numpy(), frames, bboxes, ref)
    nodes = Counter(str(n.target) for n in program.program.graph.nodes)
    convs = sum(isinstance(m, QConvNorm) for m in inf.model.modules())
    assert nodes["ipe.qconv.default"] == 2 * convs > 0
