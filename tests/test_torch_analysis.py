"""PyTorch port, analysis: ``analysis/introspection.py`` and
``analysis/benchmark.py`` against the JAX package's functions on the CPU,
on the tiny HRNet (tests/torch_tiny.py) with the same seeded weights.

The weights are seeded numpy arrays on the tree of ``jax.eval_shape`` (no
JAX init to compile), handed to the port by ``state_dict_from_jax``.  The
JAX analysis functions call ``model.apply`` op by op, which costs ~15 s
for one saliency map on the CPU; they are given the same flax model with
its ``apply`` jit-compiled (``_Jitted``), which changes nothing of their
own code.  Both sides are float32 on the CPU.
"""

import json
import os

import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu.analysis import (  # noqa: E402
    introspection as J,
)
from infantposeestimation_gaussianbias_tpu.config import (  # noqa: E402
    get_config as jget_config,
)
from infantposeestimation_gaussianbias_tpu.models import (  # noqa: E402
    pose_estimator as jpe,
)
from infantposeestimation_gaussianbias_tpu_torch import analysis  # noqa: E402
from infantposeestimation_gaussianbias_tpu_torch.analysis import (  # noqa: E402
    introspection as P,
)
from infantposeestimation_gaussianbias_tpu_torch.models import (  # noqa: E402
    hrformer, pose_estimator,
)
from tests import torch_tiny  # noqa: E402

# Forward maps: float32 on both sides, summation orders differ (the HRNet
# tests' OUT_TOL: of the tensor's largest magnitude, and relative).
OUT_TOL = 1e-4
# Gradients through the tiny HRNet: the forwards agree to ~1e-6 of a map's
# scale; a ReLU input on the other side of 0 in one of them moves what lies
# below it (ROADMAP Queue 3, ReLU ties).  Relative norm of the difference.
GRAD_RTOL = 2e-2
# The Q-Q sample is every n-th weight of the concatenation, so it depends
# on the order and layout of the leaves (torch (Co, Ci, kh, kw) against
# flax (kh, kw, Ci, Co)); its fitted slope and r differ by that, not by
# arithmetic.  Measured here: slope 0.6% and r 2.1e-4 apart.
QQ_SLOPE_RTOL = 2e-2
QQ_R_ATOL = 1e-3
KEYPOINT = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small torch ops: with
    several test processes sharing the CPU's cores, torch's default of a
    thread per core makes each op wait on the others (the probe's timing
    loop took ~2 min that way, 0.4 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Jitted:
    """A flax model whose ``apply`` is jit-compiled; ``mutable`` lists
    become tuples (jit's static arguments must hash)."""

    def __init__(self, model):
        self._apply = jax.jit(model.apply, static_argnums=(2,),
                              static_argnames=("method", "mutable",
                                               "capture_intermediates"))

    def apply(self, variables, x, train, **kw):
        if isinstance(kw.get("mutable"), list):
            kw["mutable"] = tuple(kw["mutable"])
        return self._apply(variables, x, train, **kw)


@pytest.fixture(scope="module")
def tiny():
    """(port cfg, port model, JAX model (jitted apply), JAX variables) of
    the tiny HRNet with the heatmap head, ``hrnet_tiny`` registered."""
    with torch_tiny.registered():
        jcfg = torch_tiny.tiny_cfg(jget_config(), "heatmap")
        jmodel = jpe.build_model(jcfg)
        variables = torch_tiny.random_variables(jmodel, seed=0)
        cfg = torch_tiny.tiny_cfg(torch_tiny.Config(), "heatmap")
        yield cfg, torch_tiny.port(cfg, variables), _Jitted(jmodel), variables


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def _jkey(acts: dict, prefix: str) -> str:
    """The JAX capture key of module ``prefix``'s output."""
    keys = [k for k in acts if k.startswith(prefix + "/__call__")]
    assert len(keys) == 1, (prefix, keys)
    return keys[0]


# -- parameters and weights -----------------------------------------------------

def test_parameter_counts_match_jax(tiny):
    _, model, _, variables = tiny
    assert P.count_parameters(model) == J.count_parameters(
        variables["params"])
    assert sorted(P.per_layer_parameters(model).values()) == sorted(
        J.per_layer_parameters(variables["params"]).values())
    assert (P.parameter_summary(model).splitlines()[0]
            == J.parameter_summary(variables["params"]).splitlines()[0])


def test_weight_statistics_match_jax(tiny):
    """Conv and linear weights only, as the JAX package's ``kernel`` leaves:
    BatchNorm's scale, which torch also names ``weight``, stays out."""
    _, model, _, variables = tiny
    got = P.weight_statistics(model)
    want = J.weight_statistics(variables["params"])
    assert all(not isinstance(m, torch.nn.BatchNorm2d)
               for name, m in model.named_modules()
               if f"{name}.weight" in got["per_layer"])
    assert got["overall"]["n"] == want["overall"]["n"]
    for k in ("mean", "std"):
        assert got["overall"][k] == pytest.approx(want["overall"][k],
                                                  rel=1e-9, abs=1e-12)
    assert got["sparsity"] == want["sparsity"]

    def rows(per_layer):
        return sorted((v["n"], v["mean"], v["std"], v["min"], v["max"])
                      for v in per_layer.values())

    np.testing.assert_allclose(rows(got["per_layer"]),
                               rows(want["per_layer"]), rtol=1e-9,
                               atol=1e-12)
    assert got["qq"]["slope"] == pytest.approx(want["qq"]["slope"],
                                               rel=QQ_SLOPE_RTOL)
    assert got["qq"]["r"] == pytest.approx(want["qq"]["r"], abs=QQ_R_ATOL)


def test_gradient_statistics_match_jax():
    rng = np.random.RandomState(11)
    grads = {f"layer{i}": rng.randn(*shape).astype(np.float32)
             for i, shape in enumerate([(3, 3, 4, 8), (8,), (16, 4)])}
    got = P.gradient_statistics({k: torch.from_numpy(v)
                                 for k, v in grads.items()})
    want = J.gradient_statistics(grads)
    assert got.keys() == want.keys()
    for k in got:
        for stat in ("mean", "std", "min", "max", "norm"):
            assert got[k][stat] == pytest.approx(want[k][stat], rel=1e-9,
                                                 abs=1e-12)


# -- activations ------------------------------------------------------------------

def test_capture_and_activation_statistics_match_jax(tiny):
    """Forward hooks keyed by module name against flax
    ``capture_intermediates``: the backbone's features and the head's
    conv, arrays and statistics."""
    _, model, jmodel, variables = tiny
    x = torch_tiny.crops(3, 2)
    got = P.capture_activations(model, x)
    want = J.capture_activations(jmodel, variables, x)
    got_stats = P.activation_statistics(got)
    want_stats = J.activation_statistics(want)
    for port_name, jax_prefix in (("backbone", "backbone"),
                                  ("head.final_layer", "head/final")):
        key = _jkey(want, jax_prefix)
        a, b = got[port_name], want[key]
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=OUT_TOL,
                                   atol=OUT_TOL * np.abs(b).max())
        g, w = got_stats[port_name], want_stats[key]
        assert g["shape"] == w["shape"]
        assert g["dead_channel_fraction"] == w["dead_channel_fraction"]
        for stat in ("mean", "std"):
            assert g[stat] == pytest.approx(w[stat], rel=1e-3,
                                            abs=OUT_TOL * np.abs(b).max())
    assert "head/heatmaps" in got and not model.training


def test_activation_statistics_dead_channels_on_the_channel_axis(tiny):
    """The port's maps are NHWC, as the JAX package's (its convolutions
    hand PyTorch an NCHW view and return NHWC), so dead channels are
    counted on the last axis, over (0, 1, 2): on a ReLU output of the
    tiny model and on a map with two dead channels of 8."""
    _, model, _, _ = tiny
    acts = P.capture_activations(
        model, torch_tiny.crops(5, 2),
        filter_fn=lambda name, m: name == "backbone.layer1.0.relu"
        or name.endswith("bn1"))
    for name, a in acts.items():
        assert a.shape[-1] in (8, 64, 256) or a.shape[-1] % 8 == 0, name
    rng = np.random.RandomState(6)
    a = np.maximum(rng.randn(2, 5, 4, 8), 0).astype(np.float32)
    a[..., [1, 6]] = 0.0
    a[:, :, :, 3] = -np.abs(a[:, :, :, 3])  # an NCHW reading would miss it
    ours = P.activation_statistics({"map": a})["map"]
    theirs = J.activation_statistics({"map": a})["map"]
    assert ours == theirs
    assert ours["dead_channel_fraction"] == 3 / 8


def test_error_distribution_and_calibration_match_jax():
    rng = np.random.RandomState(8)
    pred = rng.randn(6, 17, 2).astype(np.float32) * 4
    gt = rng.randn(6, 17, 2).astype(np.float32) * 4
    mask = (rng.rand(6, 17) > 0.3).astype(np.float32)
    mask[:, 2] = 0  # a keypoint never visible: NaN, as in JAX
    got, want = P.error_distribution(pred, gt, mask), J.error_distribution(
        pred, gt, mask)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    scores, correct = rng.rand(200), rng.rand(200) > 0.4
    got, want = (P.confidence_calibration(scores, correct, bins=7),
                 J.confidence_calibration(scores, correct, bins=7))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# -- sensitivity ---------------------------------------------------------------

def test_saliency_matches_jax(tiny):
    _, model, jmodel, variables = tiny
    x = torch_tiny.crops(3, 1)[0]
    got = P.saliency_map(model, x, KEYPOINT)
    want = J.saliency_map(jmodel, variables, x, KEYPOINT)
    assert got.shape == want.shape == x.shape[:2]
    assert _rel(got, want) <= GRAD_RTOL


def test_grad_cam_matches_jax(tiny):
    """Split at ``model.backbone`` and ``model.head``; NHWC features."""
    _, model, jmodel, variables = tiny
    x = torch_tiny.crops(4, 1)[0]
    got = P.grad_cam(model, x, KEYPOINT)
    want = J.grad_cam(jmodel, variables, x, KEYPOINT)
    assert got.shape == want.shape == (torch_tiny.HM, torch_tiny.HM)
    assert _rel(got, want) <= GRAD_RTOL
    assert got.max() == pytest.approx(1.0, abs=1e-6)


def test_occlusion_matches_jax(tiny, monkeypatch):
    """Batched occluded forwards (16 images in chunks of 5, the last one
    short) against the JAX one-at-a-time loop."""
    _, model, jmodel, variables = tiny
    x = torch_tiny.crops(5, 1)[0]
    monkeypatch.setattr(P, "OCCLUSION_BATCH", 5)
    got = P.occlusion_sensitivity(model, x, KEYPOINT, patch=16, stride=16)
    want = J.occlusion_sensitivity(jmodel, variables, x, KEYPOINT, patch=16,
                                   stride=16)
    assert got.shape == want.shape == (4, 4)
    base = P._peak(model(torch.from_numpy(x)[None])["heatmaps"], KEYPOINT)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=OUT_TOL * abs(base.item()))


def test_mc_droppath_keeps_batch_stats(tiny):
    """Train-mode forwards (batch statistics) that leave the running
    statistics as they were and give the model back in eval mode; HRNet
    has no DropPath, so every sample is the same train-mode forward."""
    _, model, _, _ = tiny
    x = torch_tiny.crops(6, 2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = P.mc_droppath_uncertainty(model, x, torch.Generator().manual_seed(0),
                                    n_samples=2)
    assert all(torch.equal(v, model.state_dict()[k])
               for k, v in before.items())
    assert not model.training
    with torch.no_grad():
        eval_out = model(torch.from_numpy(x))["heatmaps"].numpy()
    assert got["mean"].shape == eval_out.shape
    assert got["std"].max() == 0.0
    assert not np.allclose(got["mean"], eval_out)  # batch, not running, stats


def test_mc_droppath_masks_come_from_the_generator(monkeypatch):
    """On a small HRFormer (drop-path 0.1) the masks are drawn from the
    caller's generator: the same seed gives the same samples, another
    seed others, and the running statistics stay."""
    monkeypatch.setitem(
        pose_estimator.BACKBONES, "hrformer_tiny",
        lambda **kw: hrformer.HRFormer(channels=(8, 16, 32, 64),
                                       num_heads=(1, 1, 1, 1),
                                       stage_modules=(1, 1, 1),
                                       drop_path_rate=0.5, **kw))
    cfg = torch_tiny.tiny_cfg(torch_tiny.Config(), "heatmap")
    cfg.model.backbone = "hrformer_tiny"
    cfg.model.hrformer_window_size = 4
    model = pose_estimator.build_model(cfg, device="cpu")
    x = torch_tiny.crops(7, 2)[:, :32, :32]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    runs = [P.mc_droppath_uncertainty(model, x,
                                      torch.Generator().manual_seed(s),
                                      n_samples=3) for s in (1, 1, 2)]
    assert all(torch.equal(v, model.state_dict()[k])
               for k, v in before.items())
    np.testing.assert_array_equal(runs[0]["mean"], runs[1]["mean"])
    assert not np.array_equal(runs[0]["mean"], runs[2]["mean"])
    assert runs[0]["std"].max() > 0


# -- benchmark ---------------------------------------------------------------------

def test_benchmark_model_pipeline_and_trace_on_cpu(tiny, tmp_path):
    cfg, model, _, _ = tiny
    stats = analysis.benchmark_model(cfg, batch_size=2, warmup=0, runs=2,
                                     device="cpu")
    assert stats["runs"] == 2 and stats["batch_size"] == 2
    assert stats["device"] == "cpu"
    assert 0 < stats["min_ms"] <= stats["median_ms"] <= stats["max_ms"]
    assert stats["images_per_sec"] == pytest.approx(
        2 / (stats["median_ms"] / 1e3))
    pipe = analysis.benchmark_pipeline(lambda i: np.zeros(i + 1).sum(),
                                       iterations=20)
    assert pipe["iterations"] == 20 and pipe["samples_per_sec"] > 0
    x = torch.from_numpy(torch_tiny.crops(9, 1))
    with torch.no_grad():
        out = analysis.profile_trace(model, x, trace_dir=str(tmp_path),
                                     iters=1)
    assert out == str(tmp_path)
    with open(os.path.join(out, "trace.json")) as f:
        assert json.load(f)["traceEvents"]
