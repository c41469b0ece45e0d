"""PyTorch port, the training loop on its own (no JAX): resume from an
epoch boundary bit for bit, the ``preemie`` config's jitter, SIGTERM,
``debug_nans``, the checks on a caller's state, and the ``train`` and
``validate`` CLIs on the CPU.

The models are HRNets registered for the module: ``hrnet_tiny``
(``HRNet(base_channels=8)``, stage modules (1, 1, 1), 64x64), and
``preemie``'s own hrnet_w32 cut to stage modules (1, 1, 1) at 64x64.
"""

import json
import os
import signal
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from infantposeestimation_gaussianbias_tpu_torch import data
from infantposeestimation_gaussianbias_tpu_torch.cli import train as cli_train
from infantposeestimation_gaussianbias_tpu_torch.cli import (
    validate as cli_validate,
)
from infantposeestimation_gaussianbias_tpu_torch.config import get_variant
from infantposeestimation_gaussianbias_tpu_torch.models import hrnet
from infantposeestimation_gaussianbias_tpu_torch.models import pose_estimator
from infantposeestimation_gaussianbias_tpu_torch.train import loop, step
from infantposeestimation_gaussianbias_tpu_torch.train.step import (
    create_train_state,
)

TINY_SET = ["model.backbone=hrnet_tiny", "model.hrnet_stage_modules=1,1,1",
            "model.head_type=heatmap", "model.compute_dtype=float32",
            "data.input_size=64,64", "data.heatmap_size=16,16",
            "train.global_batch_size=4", "train.warmup_epochs=0",
            "train.val_interval=1", "eval.batch_size=4"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: several test processes share the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _tiny_hrnet(monkeypatch):
    monkeypatch.setitem(pose_estimator.BACKBONES, "hrnet_tiny",
                        lambda **kw: hrnet.HRNet(base_channels=8, **kw))
    # metrics to JSONL alone: importing TensorBoard here drags in
    # TensorFlow (~13 s)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _tiny_cfg(tmp, name):
    cfg = get_variant("hrnet_w32")
    from infantposeestimation_gaussianbias_tpu_torch.config import (
        apply_overrides)

    apply_overrides(cfg, TINY_SET)
    cfg.train.checkpoint_dir = str(tmp / name / "ck")
    cfg.log_dir = str(tmp / name / "logs")
    return cfg


def _loaders(cfg, n=8, seed=0):
    """Train and val loaders over n synthetic in-memory images."""
    schema = cfg.data.keypoint_schema
    gt = data.synthetic_coco_dataset(
        num_images=n, num_keypoints=schema.num_keypoints, seed=seed,
        keypoint_names=schema.keypoint_names, skeleton=schema.skeleton)
    rng = np.random.RandomState(seed)
    cache = {im["file_name"]: rng.randint(0, 255, (256, 320, 3)).astype(
        np.uint8) for im in gt["images"]}
    recs = data.build_records(data.CocoIndex(dataset=gt))
    bs = cfg.train.global_batch_size
    return (data.DataLoader(data.PoseDataset(cfg, recs, "", True,
                                             image_cache=cache), bs,
                            shuffle=True, seed=cfg.train.seed, num_threads=2,
                            drop_last=True),
            data.DataLoader(data.PoseDataset(cfg, recs, "", False,
                                             image_cache=cache), bs,
                            shuffle=False, num_threads=2), gt)


def test_resume_from_epoch_boundary_is_bit_equal(tmp_path):
    """Three epochs in one run, and two epochs then a resume from
    ``latest`` to three: the same parameters, statistics and optimizer
    moments bit for bit (drop path 0 and no jitter: no draws, so the
    generator re-seeded on resume changes nothing)."""
    finals = []
    for name, stops in (("straight", (3,)), ("resumed", (2, 3))):
        cfg = _tiny_cfg(tmp_path, name)
        train_loader, val_loader, gt = _loaders(cfg)
        for epochs in stops:
            state = loop.train(cfg, train_loader, val_loader, gt,
                               max_epochs=epochs, device="cpu")
        assert state.step == 6
        finals.append(state)
    a, b = finals
    for (name, x), y in zip(a.model.state_dict().items(),
                            b.model.state_dict().values()):
        assert torch.equal(x, y), name
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    for k, v in sa["state"].items():
        for name, t in v.items():
            assert torch.equal(t, sb["state"][k][name]), (k, name)


def test_preemie_trains_with_jitter(tmp_path, monkeypatch):
    """get_variant("preemie") (hrnet_w32 + heatmap, infant13, jitter 0.2;
    cut to stage modules (1, 1, 1) at 64x64): one epoch through train();
    finite terms, and every step's images jittered (the jitter's output
    differs from its input and stays finite).  The heatmaps are the
    model's stride-4 maps, input / 4: the config's 128x128 at 256x256
    presumes a stride-2 head that neither package's HRNet has (the JAX
    package's loss refuses the shapes as the port's does)."""
    cfg = get_variant("preemie")
    assert tuple(cfg.data.color_jitter) == (0.2, 0.2, 0.2)
    cfg.model.hrnet_stage_modules = (1, 1, 1)
    cfg.model.compute_dtype = "float32"
    cfg.data.input_size, cfg.data.heatmap_size = (64, 64), (16, 16)
    cfg.train.global_batch_size = 2
    cfg.train.log_interval = 1
    cfg.train.save_latest_interval = cfg.train.save_every = 0
    cfg.train.checkpoint_dir = str(tmp_path / "ck")
    cfg.log_dir = str(tmp_path / "logs")
    seen = []
    jitter = step.photometric.color_jitter_normalized

    def recording(images, *a, **kw):
        out = jitter(images, *a, **kw)
        seen.append((images.clone(), out.clone()))
        return out

    monkeypatch.setattr(step.photometric, "color_jitter_normalized",
                        recording)
    train_loader, _, _ = _loaders(cfg, n=4)
    state = loop.train(cfg, train_loader, max_epochs=1, device="cpu")
    assert state.step == 2 and len(seen) == 2
    for before, after in seen:
        assert torch.isfinite(after).all()
        assert (after - before).abs().amax(dim=(1, 2, 3)).min() > 1e-3
    with open(tmp_path / "logs" / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert len(lines) == 2
    assert all(np.isfinite(v) for r in lines for v in r.values())


def test_debug_nans_raises(tmp_path):
    """Under train.debug_nans a non-finite term stops the loop at its step
    (a NaN in the head's last conv makes the loss NaN)."""
    cfg = _tiny_cfg(tmp_path, "nan")
    cfg.train.debug_nans = True
    train_loader, _, _ = _loaders(cfg)
    cfg.train.steps_per_epoch = len(train_loader)
    state = create_train_state(cfg, device="cpu")
    with torch.no_grad():
        state.model.head.final_layer.weight[0, 0, 0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="total_loss.*epoch 0 step 1"):
        loop.train(cfg, train_loader, max_epochs=1, state=state)


def test_state_and_mesh_checks(tmp_path):
    """A caller's state built for another epoch length raises; the mesh
    (``use_mesh=True``, the default) without a process group is the one
    process."""
    cfg = _tiny_cfg(tmp_path, "checks")
    train_loader, _, _ = _loaders(cfg)
    cfg.train.warmup_epochs = 2
    cfg.train.steps_per_epoch = 1000
    state = create_train_state(cfg, device="cpu")
    with pytest.raises(ValueError, match="another epoch length"):
        loop.train(cfg, train_loader, max_epochs=1, state=state)
    cfg.train.warmup_epochs = 0
    state = loop.train(cfg, train_loader, max_epochs=1, device="cpu",
                       use_mesh=True)
    assert state.grid is None and state.step == len(train_loader)


def test_preemption_guard_catches_sigterm():
    """The guard turns SIGTERM into the preemption flag and puts the old
    handler back."""
    prev = signal.getsignal(signal.SIGTERM)
    try:
        with loop._PreemptionGuard():
            os.kill(os.getpid(), signal.SIGTERM)
            assert loop._PREEMPTED.wait(timeout=5)
        assert signal.getsignal(signal.SIGTERM) is prev
    finally:
        loop._PREEMPTED.clear()
        signal.signal(signal.SIGTERM, prev)


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """A synthetic COCO validation set on disk (JPEGs)."""
    root = tmp_path_factory.mktemp("coco")
    os.makedirs(root / "val")
    os.makedirs(root / "annotations")
    gt = data.synthetic_coco_dataset(num_images=6, image_dir=str(root / "val"))
    with open(root / "annotations" / "val.json", "w") as f:
        json.dump(gt, f)
    return root


def test_cli_train_resume_and_validate(tmp_path, disk, capsys):
    """cli.train --synthetic 8 --epochs 2, then --epochs 3 ("resumed from
    epoch 2"), then cli.validate --checkpoint on the trained ``latest``
    (served BN-folded, and --no-fold), on device cpu."""
    ck, logs = tmp_path / "ck", tmp_path / "logs"
    common = ["--device", "cpu", "--set", *TINY_SET,
              f"train.checkpoint_dir={ck}", f"log_dir={logs}",
              "train.log_interval=1"]
    cli_train.main(["--synthetic", "8", "--epochs", "2"] + common)
    with open(ck / "latest.meta.json") as f:
        assert json.load(f)["epoch"] == 1
    cli_train.main(["--synthetic", "8", "--epochs", "3"] + common)
    with open(ck / "latest.meta.json") as f:
        assert json.load(f)["epoch"] == 2
    log_text = (logs / "hrnet_w32_coco_256x192.log").read_text()
    assert "resumed from epoch 2" in log_text
    with open(logs / "metrics.jsonl") as f:
        steps = [json.loads(line)["step"] for line in f
                 if "train/total_loss" in line]
    assert steps == [1, 2, 3, 4, 5, 6]
    assert {"latest", "best"} <= set(os.listdir(ck))

    val = ["--device", "cpu", "--checkpoint", str(ck / "latest"), "--set",
           *TINY_SET, f"data.data_root={disk}",
           "data.val_ann=annotations/val.json", "data.val_img_prefix=val/"]
    capsys.readouterr()
    cli_validate.main(val)
    folded = capsys.readouterr().out
    cli_validate.main(val + ["--no-fold"])
    unfolded = capsys.readouterr().out
    assert "AP:" in folded and "val_loss:" in folded
    # BN folding is exact up to rounding: the same metrics to 4 places
    assert folded == unfolded
    with pytest.raises(SystemExit):
        cli_validate.main(["--device", "cpu", "--checkpoint",
                           str(ck / "nothing"), "--set", *TINY_SET,
                           f"data.data_root={disk}",
                           "data.val_ann=annotations/val.json",
                           "data.val_img_prefix=val/"])


def test_cli_options_not_ported_raise_and_profile(tmp_path, disk, capsys):
    """validate --int8 serves int8 PTQ, calibrated on the first validation
    batch, and reports AP without a loss; --mesh without torchrun's
    environment evaluates as the one process, the same AP; train's
    --profile writes a torch.profiler trace of the window (under --mesh,
    which without torchrun's environment trains as the one process)."""
    capsys.readouterr()
    cli_validate.main(["--int8", "--device", "cpu", "--set", *TINY_SET,
                       f"data.data_root={disk}",
                       "data.val_ann=annotations/val.json",
                       "data.val_img_prefix=val/"])
    printed = capsys.readouterr().out
    assert "AP:" in printed and "val_loss" not in printed, printed
    cli_validate.main(["--int8", "--mesh", "--device", "cpu", "--set",
                       *TINY_SET, f"data.data_root={disk}",
                       "data.val_ann=annotations/val.json",
                       "data.val_img_prefix=val/"])
    assert capsys.readouterr().out == printed
    cli_train.main(["--synthetic", "8", "--epochs", "1", "--no-val",
                    "--profile", "1:2", "--device", "cpu", "--mesh",
                    "--backend", "gloo", "--set",
                    *TINY_SET, f"train.checkpoint_dir={tmp_path}/ck",
                    f"log_dir={tmp_path}/logs"])
    trace = tmp_path / "logs" / "profile" / "steps_1_2.json"
    assert trace.exists() and "traceEvents" in trace.read_text()
