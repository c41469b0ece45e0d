"""PyTorch port, the last surfaces of the JAX package, on the CPU:
``analysis/extension`` (equal to JAX's), ``analysis/plots`` (every figure
writes a PNG), ``viz/clinical`` (the figures, and the video overlay frame
for frame equal to JAX's: both are numpy + cv2), ``cli/analyze`` (its
files, its maps equal to the analysis API's), the reference-checkpoint
validator's dry run (the table; its checkpoint in the reference's layout,
key for key the torch oracles'), the HTTP probe and the multi-scale
training example.  (A video's ``--output`` and ``--clinical-report`` in
``cli/infer`` are held in tests/test_torch_serve_cli.py's
``test_infer_cli``.)"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from infantposeestimation_gaussianbias_tpu.analysis import extension as jext
from infantposeestimation_gaussianbias_tpu.viz import clinical as jclinical
from infantposeestimation_gaussianbias_tpu_torch import Config
from infantposeestimation_gaussianbias_tpu_torch.analysis import (
    capture_activations, confidence_calibration, extension, grad_cam,
    gradient_statistics, occlusion_sensitivity, plots, saliency_map,
    weight_statistics)
from infantposeestimation_gaussianbias_tpu_torch.cli import analyze
from infantposeestimation_gaussianbias_tpu_torch.models import build_model
from infantposeestimation_gaussianbias_tpu_torch.schemas import INFANT13
from infantposeestimation_gaussianbias_tpu_torch.tools import (
    probe_serve_http, validate_reference_checkpoint as vrc)
from infantposeestimation_gaussianbias_tpu_torch.viz import clinical
from tests import torch_tiny
from tests.torch_tiny import one_torch_thread  # noqa: F401 (autouse)

TINY_SET = ["model.backbone=hrnet_tiny", "model.hrnet_stage_modules=1,1,1",
            "model.hidden_dim=16", "model.compute_dtype=float32",
            "data.input_size=64,64", "data.heatmap_size=16,16"]
WHOLE_BODY = ("body_17", "face_68", "hand_21", "hand_21")


# -- analysis/extension --------------------------------------------------------

def test_extension_matches_jax(tmp_path):
    """Templates, the 127-point whole-body merge, annotations (boxes from
    the visible keypoints), the saved file, the category's schema,
    keypoint groups and per-group targets, equal to the JAX package's."""
    assert extension.TEMPLATES == jext.TEMPLATES
    rng = np.random.RandomState(0)
    kpts = np.concatenate([rng.uniform(0, 200, (127, 2)),
                           rng.choice([0, 1, 2], (127, 1))], 1)
    outs = []
    for mod in (extension, jext):
        ext = mod.COCOKeypointExtender()
        cat = ext.merge_keypoint_categories(WHOLE_BODY)
        ext.add_keypoint_category(2, "face", template_name="face_68")
        anns = [ext.add_annotation(1, 1, kpts),
                ext.add_annotation(2, 2, kpts[:68], bbox=[1, 2, 3, 4])]
        path = tmp_path / f"{mod.__name__.split('.')[0]}.json"
        ext.save(str(path))
        schema = ext.schema(1)
        groups = mod.detect_keypoint_groups(cat["keypoints"])
        split = mod.split_group_targets(kpts[None, :, :2], kpts[None, :, 2],
                                        groups)
        outs.append((cat, anns, json.loads(path.read_text()), schema,
                     groups, split))
    (cat, anns, saved, schema, groups, split), ref = outs[0], outs[1]
    assert len(cat["keypoints"]) == 127
    assert (cat, anns, saved, groups) == (ref[0], ref[1], ref[2], ref[4])
    for field in ("name", "keypoint_names", "flip_pairs", "skeleton",
                  "oks_sigmas", "upper_body", "lower_body"):
        assert getattr(schema, field) == getattr(ref[3], field), field
    assert set(split) == set(ref[5]) == {"body", "face", "left_hand",
                                         "right_hand"}
    for g in split:
        for k in ("keypoints", "visible"):
            np.testing.assert_array_equal(split[g][k], ref[5][g][k])
    with pytest.raises(KeyError):
        extension.COCOKeypointExtender().schema(3)


# -- analysis/plots -----------------------------------------------------------

@pytest.fixture(scope="module")
def analysed(tmp_path_factory):
    """The tiny HRNet + heatmap (seeded) and what the plots draw: weight,
    gradient and activation statistics, a calibration, a metrics JSONL."""
    with torch_tiny.registered():
        cfg = torch_tiny.tiny_cfg(Config(), "heatmap")
        model = build_model(cfg, "cpu")
        x = torch.from_numpy(torch_tiny.crops(5))
        model(x)["heatmaps"].square().mean().backward()
        grads = {n: p.grad for n, p in model.named_parameters()
                 if p.grad is not None}
        acts = capture_activations(model, x.numpy())
    rng = np.random.RandomState(6)
    pred, gt = rng.uniform(0, 64, (2, 20, 17, 2))
    mask = rng.rand(20, 17) > 0.2
    scores = rng.rand(20, 17)
    jsonl = tmp_path_factory.mktemp("metrics") / "metrics.jsonl"
    jsonl.write_text("".join(json.dumps({"step": s, "loss": 1.0 / s,
                                         "lr": 1e-3}) + "\n"
                             for s in range(1, 6)))
    return dict(model=model, grads=grads, acts=acts, pred=pred, gt=gt,
                mask=mask, scores=scores, jsonl=str(jsonl),
                correct=(np.linalg.norm(pred - gt, axis=-1) < 20))


PLOTS = {
    "pck_curves": lambda a, out: plots.plot_pck_curves(
        a["pred"], a["gt"], a["mask"], np.full(20, 64.0),
        [f"kp_{k}" for k in range(17)], out_path=out),
    "accuracy_heatmap": lambda a, out: plots.plot_accuracy_heatmap(
        a["correct"].mean(0), [f"kp_{k}" for k in range(17)], out_path=out),
    "error_histogram": lambda a, out: plots.plot_error_histogram(
        np.linalg.norm(a["pred"] - a["gt"], axis=-1), a["mask"],
        out_path=out),
    "pr_curve": lambda a, out: plots.plot_pr_curve(
        a["scores"], a["correct"], out_path=out),
    "calibration": lambda a, out: plots.plot_calibration(
        confidence_calibration(a["scores"], a["correct"]), out_path=out),
    "training_curves": lambda a, out: plots.plot_training_curves(
        a["jsonl"], out_path=out),
    "gradient_flow": lambda a, out: plots.plot_gradient_flow(
        plots.per_layer_grad_norms(a["grads"]), out_path=out),
    "weight_distribution": lambda a, out: plots.plot_weight_distribution(
        weight_statistics(a["model"]), out_path=out),
    "feature_maps": lambda a, out: plots.plot_feature_maps(
        a["acts"], "backbone.conv2", out_path=out),
    "gradient_statistics": lambda a, out: plots.plot_gradient_statistics(
        gradient_statistics(a["grads"]), out_path=out),
}


@pytest.mark.parametrize("name", sorted(PLOTS))
def test_plot_writes_a_png(analysed, name, tmp_path):
    """Every figure of analysis/plots.py, drawn from the port's analysis
    outputs (dotted layer names), writes a PNG that cv2 reads back."""
    out = str(tmp_path / f"{name}.png")
    PLOTS[name](analysed, out)
    assert cv2.imread(out) is not None


def test_plots_numbers_match_jax(analysed):
    """``precision_recall_curve`` equal to JAX's; ``per_layer_grad_norms``
    takes the port's name -> gradient mapping, one norm per name."""
    from infantposeestimation_gaussianbias_tpu.analysis import plots as jplots

    for got, want in zip(
            plots.precision_recall_curve(analysed["scores"],
                                         analysed["correct"]),
            jplots.precision_recall_curve(analysed["scores"],
                                          analysed["correct"])):
        np.testing.assert_array_equal(got, want)
    norms = plots.per_layer_grad_norms(analysed["grads"])
    assert set(norms) == set(analysed["grads"])
    name = "head.final_layer.weight"
    assert norms[name] == pytest.approx(
        float(analysed["grads"][name].double().norm()), rel=1e-12)


# -- viz/clinical ---------------------------------------------------------------

def _trajectory(T=12, K=13, seed=7):
    rng = np.random.RandomState(seed)
    traj = (rng.uniform(10, 50, (K, 2))
            + np.cumsum(rng.randn(T, K, 2), 0)).astype(np.float32)
    return traj, rng.uniform(0.2, 1.0, (T, K)).astype(np.float32)


CLINICAL = {
    "trajectory": lambda t, s, out: clinical.plot_movement_trajectory(
        t, out_path=out),
    "report": lambda t, s, out: clinical.create_clinical_report_figure(
        t, s, out_path=out, fps=10.0, cfg_clinical=Config().clinical),
    "pseudo_3d": lambda t, s, out: clinical.plot_pseudo_3d_pose(
        t[0], s[0], out_path=out),
    "position_heatmaps": lambda t, s, out:
        clinical.plot_joint_position_heatmaps(t, out_path=out),
    "confidence": lambda t, s, out: clinical.plot_confidence_over_time(
        s, fps=10.0, out_path=out),
}


@pytest.mark.parametrize("name", sorted(CLINICAL))
def test_clinical_figure_writes_a_png(name, tmp_path):
    traj, scores = _trajectory()
    out = str(tmp_path / f"{name}.png")
    CLINICAL[name](traj, scores, out)
    assert cv2.imread(out) is not None


def test_video_with_pose_matches_jax(tmp_path):
    """``create_video_with_pose`` over a short cv2 video, frame for frame
    equal to the JAX package's (both numpy + cv2), every frame written,
    the skeleton drawn."""
    traj, scores = _trajectory(T=6)
    traj = traj * 1.5
    video = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                             (80, 64))
    rng = np.random.RandomState(8)
    for _ in range(6):
        writer.write(rng.randint(0, 255, (64, 80, 3)).astype(np.uint8))
    writer.release()
    frames = []
    for fn, name in ((clinical.create_video_with_pose, "port.mp4"),
                     (jclinical.create_video_with_pose, "jax.mp4")):
        out = str(tmp_path / name)
        fn(video, traj, scores, out, fps=10.0, trail_len=3)
        cap = cv2.VideoCapture(out)
        read = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            read.append(f)
        cap.release()
        frames.append(np.stack(read))
    assert frames[0].shape == (6, 64, 80, 3)
    np.testing.assert_array_equal(frames[0], frames[1])
    src = cv2.VideoCapture(video)
    ok, first = src.read()
    src.release()
    assert ok and not np.array_equal(frames[0][0], first)  # drawn on


# -- cli/analyze ---------------------------------------------------------------

def test_analyze_cli(tmp_path, capsys):
    """``cli.analyze`` on the tiny HRNet + heatmap (seeded, CPU): the
    summary printed, parameters.txt, activations.json and the three
    figures written; its maps equal to the analysis API's on the same
    model and input."""
    out_dir = tmp_path / "an"
    with torch_tiny.registered():
        out = analyze.main(["--device", "cpu", "--out-dir", str(out_dir),
                            "--keypoint", "3", "--set", *TINY_SET])
        cfg = torch_tiny.tiny_cfg(Config(), "heatmap")
        model = build_model(cfg, "cpu")
    printed = capsys.readouterr().out
    assert printed.startswith("total parameters: ")
    assert f"captured {out['activations']} activations" in printed
    assert (out_dir / "parameters.txt").read_text().startswith(
        "total parameters: ")
    stats = json.loads((out_dir / "activations.json").read_text())
    assert len(stats) == out["activations"] > 0
    for name in analyze.MAPS:
        assert cv2.imread(str(out_dir / f"{name}.png")) is not None
    img = np.random.RandomState(0).randn(1, 64, 64, 3).astype(
        np.float32)[0]
    np.testing.assert_array_equal(out["maps"]["saliency"],
                                  saliency_map(model, img, 3))
    np.testing.assert_array_equal(out["maps"]["gradcam"],
                                  grad_cam(model, img, 3))
    np.testing.assert_array_equal(
        out["maps"]["occlusion"],
        occlusion_sensitivity(model, img, 3, patch=8, stride=8))


# -- tools/validate_reference_checkpoint ---------------------------------------

@pytest.mark.parametrize("int8", [False, True])
def test_validate_reference_dry_run(int8, capsys):
    """The dry run on the tiny HRNet + fusion (64x64, CPU): the seeded model
    written as a reference checkpoint, loaded strictly, flip-test
    validated on 4 synthetic images; the AP table (and with --int8 the
    float-vs-int8 table) printed."""
    args = ["--dry-run", "--batch-size", "2", "--device", "cpu",
            "--input-size", "64", "64", "--set", *TINY_SET]
    with torch_tiny.registered():
        out = vrc.main(args + (["--int8"] if int8 else []))
    printed = capsys.readouterr().out
    results = out[0] if int8 else out
    assert 0.0 <= results["AP"] <= 1.0
    assert f"{'metric':>6} | {'ours':>8} | {'reference':>9}" in printed
    assert f"{'AP':>6} | {results['AP']:8.4f}" in printed
    assert ("int8 PTQ re-validate" in printed) == int8
    assert (f"{'metric':>6} | {'float':>8} | {'int8':>8}" in printed) == int8
    assert "dry-run OK" in printed


@pytest.mark.parametrize("backbone", ["hrnet_w32", "hrformer_small"])
def test_dry_run_checkpoint_has_the_reference_layout(backbone, tmp_path):
    """The dry run's checkpoint (the port's seeded model's state dict in a
    ``model_state_dict`` wrapper) holds exactly the reference's keys and
    shapes, as the reference-structured torch oracles of the tests name
    them (tests/torch_hrnet_oracle.py, tests/torch_hrformer_oracle.py),
    fusion head included, and loads back strictly."""
    from tests.torch_hrnet_oracle import TorchFusionHead, TorchHRNet

    cfg = Config()
    cfg.model.backbone = backbone
    cfg.model.head_type = "fusion"
    cfg.data.input_size = (64, 64)
    ckpt, data_root = vrc._make_dry_run_fixtures(str(tmp_path), cfg)
    sd = vrc.load_reference_state_dict(ckpt)
    assert set(torch.load(ckpt, weights_only=True)) == {"model_state_dict",
                                                         "epoch"}
    with torch.device("meta"):
        if backbone == "hrnet_w32":
            oracle = TorchHRNet(base=32)
        else:
            from tests.torch_hrformer_oracle import TorchHRFormer

            oracle = TorchHRFormer(channels=(32, 64, 128, 256),
                                   heads=(1, 2, 4, 8), stage_modules=(1, 4, 2))
        head = TorchFusionHead(in_ch=32, K=17, hidden=cfg.model.hidden_dim)
    want = {f"backbone.{k}": v.shape for k, v in oracle.state_dict().items()}
    want.update({f"head.{k}": v.shape for k, v in head.state_dict().items()})
    assert {k: v.shape for k, v in sd.items()} == want
    state = vrc.build_state(cfg, ckpt, "cpu")
    assert all(torch.equal(v, sd[k])
               for k, v in state.model.state_dict().items())
    synth = json.loads(open(os.path.join(
        data_root, "annotations", "val.json")).read())
    assert len(synth["images"]) == 4


# -- tools/probe_serve_http ----------------------------------------------------

def test_probe_serve_http(monkeypatch, capsys):
    """The probe on the tiny HRNet + fusion (folded, CPU): 2 clients x 2
    requests through ``cli.serve.make_server``, every answer a 200; the
    JSON line printed with the batches the dispatcher formed."""
    for k, v in dict(PROBE_CLIENTS="2", PROBE_REQS="2", PROBE_QUANT="0",
                     PROBE_MAX_BATCH="2", PROBE_FRAME="64",
                     PROBE_TIMEOUT_S="60").items():
        monkeypatch.setenv(k, v)
    with torch_tiny.registered():
        cfg = torch_tiny.tiny_cfg(Config(), "fusion")
        cfg.eval.flip_test = False
        out = probe_serve_http.main(cfg, device="cpu")
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out
    assert out["requests_ok"] == 4
    assert out["errors"] == out["shed_503"] == out["timeout_504"] == 0
    assert out["num_device_batches"] >= 2 and out["max_device_batch"] <= 2
    assert out["precision"] == "float32-fold"
    assert out["latency_ms_p50"] > 0 and out["batch_ms_p50"] > 0


# -- examples ----------------------------------------------------------------

def test_multi_scale_training_example():
    """One model trains across the reference's three scales
    (examples/multi_scale_training_torch.py; the port's twin of the JAX
    example, run as tests/test_end_to_end.py runs that one)."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from examples.multi_scale_training_torch import run

    _, history = run(epochs=3, steps_per_scale=1, batch_size=2,
                     verbose=False, device="cpu")
    assert len({s for s, _ in history}) == 3
    assert all(np.isfinite(l) for _, l in history)
