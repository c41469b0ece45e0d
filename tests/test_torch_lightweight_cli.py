"""PyTorch port, the ``lightweight`` config through the CLIs and the
overfit check, on the CPU (no JAX): ``cli/train.py --config
configs/lightweight.yaml`` (LiteHRNet + heatmap head at 192 x 192, bf16 as
configured) for two steps on synthetic images, then ``cli/validate.py``
and ``cli/infer.py`` on its checkpoint; and ``tools/overfit_check.run``
at a small size.
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from infantposeestimation_gaussianbias_tpu_torch import data
from infantposeestimation_gaussianbias_tpu_torch.cli import infer as cli_infer
from infantposeestimation_gaussianbias_tpu_torch.cli import train as cli_train
from infantposeestimation_gaussianbias_tpu_torch.cli import (
    validate as cli_validate,
)
from infantposeestimation_gaussianbias_tpu_torch.config import load_yaml
from infantposeestimation_gaussianbias_tpu_torch.schemas import COCO17
from infantposeestimation_gaussianbias_tpu_torch.tools import overfit_check

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "lightweight.yaml")


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """One intra-op thread (several test processes share the CPU's cores);
    metrics to JSONL alone (importing TensorBoard drags in TensorFlow)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """A synthetic COCO validation set on disk (JPEGs)."""
    root = tmp_path_factory.mktemp("coco")
    os.makedirs(root / "val")
    os.makedirs(root / "annotations")
    gt = data.synthetic_coco_dataset(num_images=4, image_dir=str(root / "val"))
    with open(root / "annotations" / "val.json", "w") as f:
        json.dump(gt, f)
    return root


def test_lightweight_cli_train_validate_infer(tmp_path, disk, capsys):
    """Train two steps of the lightweight config (batch 4 over 8 synthetic
    images), then validate its ``latest`` checkpoint (served unfolded:
    LiteHRNet does not fold) and run infer on an image with the
    checkpoint's weights."""
    cfg = load_yaml(CONFIG)
    assert (cfg.model.backbone, cfg.model.head_type) == ("litehrnet",
                                                         "heatmap")
    assert tuple(cfg.data.input_size) == (192, 192)
    ck, logs = tmp_path / "ck", tmp_path / "logs"
    cli_train.main([
        "--config", CONFIG, "--synthetic", "8", "--epochs", "1", "--no-val",
        "--device", "cpu", "--set", "train.global_batch_size=4",
        f"train.checkpoint_dir={ck}", f"log_dir={logs}",
        "train.log_interval=1"])
    with open(logs / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f
                 if "train/total_loss" in line]
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(r["train/total_loss"]) for r in lines)
    ckpt = torch.load(ck / "latest", map_location="cpu", weights_only=True)
    assert "backbone.stage3.1.branches.2.1.dw.weight" in ckpt["model"]

    capsys.readouterr()
    cli_validate.main([
        "--config", CONFIG, "--device", "cpu", "--checkpoint",
        str(ck / "latest"), "--set", "eval.batch_size=4",
        f"data.data_root={disk}", "data.val_ann=annotations/val.json",
        "data.val_img_prefix=val/"])
    printed = capsys.readouterr().out
    assert "AP:" in printed and "val_loss:" in printed, printed

    weights = tmp_path / "light.pt"
    torch.save(ckpt["model"], weights)
    frame = np.random.RandomState(3).randint(0, 256, (120, 90, 3)).astype(
        np.uint8)
    cv2.imwrite(str(tmp_path / "im.png"), frame)
    cli_infer.main(["--config", CONFIG, "--input", str(tmp_path / "im.png"),
                    "--device", "cpu", "--checkpoint", str(weights)])
    rows = capsys.readouterr().out.splitlines()
    assert len(rows) == 17
    assert rows[0].startswith(f"{COCO17.keypoint_names[0]:>16}: (")


def test_overfit_check_small():
    """The overfit check's whole path (seeded state, fixed batch, fusion
    decode of the eval model, the e1 < 0.3 e0 assertion) at 64 x 64 on
    4 crops in float32: 120 steps overfit on the CPU (measured 10.3 ->
    1.8 px)."""
    out = overfit_check.run(steps=120, batch=4, device="cpu",
                            input_size=(64, 64), compute_dtype="float32",
                            verbose=False)
    assert out["e1"] < 0.3 * out["e0"] and np.isfinite(out["loss"])
    assert out["steps"] == 120
