"""PyTorch port, evaluation and checkpoints: ``COCOEvaluator`` (native
OKS-AP), ``compute_oks``, the meters, PCK and the clinical metrics against
the JAX package's on the same predictions (the same numpy code: equal to
the bit), and ``CheckpointManager``'s latest / best / periodic policy
against the JAX package's on the same metric sequence: the same files and
the same metadata.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu import eval as jeval
from infantposeestimation_gaussianbias_tpu.data import synthetic_coco_dataset
from infantposeestimation_gaussianbias_tpu.schemas import COCO17
from infantposeestimation_gaussianbias_tpu.train.checkpoint import (
    CheckpointManager as JCheckpointManager,
)
from infantposeestimation_gaussianbias_tpu_torch import eval as peval
from infantposeestimation_gaussianbias_tpu_torch.train.checkpoint import (
    CheckpointManager,
)
from infantposeestimation_gaussianbias_tpu_torch.train.optim import (
    build_optimizer,
)
from infantposeestimation_gaussianbias_tpu_torch.train.state import TrainState
from infantposeestimation_gaussianbias_tpu_torch.config import get_variant

SIGMAS = COCO17.oks_sigma_array()


def _gt_and_predictions(seed):
    """A COCO GT set (two people in one image, a crowd region, a person
    with no labelled keypoint) and predictions: the GT keypoints perturbed
    by a few pixels, one image predicted twice, one missed, and padded
    rows (valid 0) that must be left out."""
    gt = synthetic_coco_dataset(num_images=12, seed=seed)
    anns = gt["annotations"]
    anns.append(dict(anns[0], id=50, keypoints=(np.asarray(anns[0][
        "keypoints"]) + 9.0).tolist()))
    anns.append(dict(anns[1], id=51, iscrowd=1))
    anns.append(dict(anns[2], id=52, image_id=anns[3]["image_id"],
                     num_keypoints=0, keypoints=[0.0] * 51))
    rng = np.random.RandomState(seed + 1)
    ids, kpts = [], []
    for a in anns[:12]:
        if a["image_id"] == 5:
            continue  # a missed person
        k = np.asarray(a["keypoints"], np.float32).reshape(17, 3)[:, :2]
        ids.append(a["image_id"])
        kpts.append(k + rng.randn(17, 2).astype(np.float32) * rng.choice(
            [0.5, 3.0, 20.0]))
    ids.append(anns[0]["image_id"])
    kpts.append(kpts[0] + 40.0)
    n_pad = 3
    ids += [ids[-1]] * n_pad
    kpts += [kpts[-1]] * n_pad
    kpts = np.stack(kpts)
    scores = rng.uniform(0.1, 1.0, kpts.shape[:2]).astype(np.float32)
    valid = np.r_[np.ones(len(ids) - n_pad), np.zeros(n_pad)] > 0
    return gt, np.asarray(ids, np.int64), kpts, scores, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluator_matches_jax(seed):
    gt, ids, kpts, scores, valid = _gt_and_predictions(seed)
    results = []
    for mod in (peval, jeval):
        ev = mod.COCOEvaluator(SIGMAS, gt)
        for rows in (slice(0, 5), slice(5, None)):  # two batches
            ev.update(ids[rows], kpts[rows], scores[rows], valid=valid[rows])
        assert len(ev.predictions) == int(valid.sum())
        results.append((ev.evaluate(), ev.evaluate(backend="native"),
                        ev.simple_ap(0.5)))
    assert results[0] == results[1]
    got = results[0][0]
    assert set(got) == {"AP", "AP50", "AP75", "AP_M", "AP_L", "AR", "AR50",
                        "AR75", "AR_M", "AR_L"}
    assert 0.0 < got["AP"] < 1.0


def test_evaluator_empty_and_errors():
    gt, *_ = _gt_and_predictions(0)
    assert peval.COCOEvaluator(SIGMAS, gt).evaluate() == \
        jeval.COCOEvaluator(SIGMAS, gt).evaluate()
    with pytest.raises(ValueError, match="GT"):
        peval.COCOEvaluator(SIGMAS).evaluate()
    with pytest.raises(ValueError, match="backend"):
        peval.COCOEvaluator(SIGMAS, gt).evaluate(backend="other")


def test_compute_oks_matches_jax():
    rng = np.random.RandomState(3)
    g = np.c_[rng.uniform(0, 300, (17, 2)), rng.choice([0, 1, 2], 17)]
    d = np.concatenate([g[None, :, :2] + rng.randn(5, 17, 2) * 4,
                        np.ones((5, 17, 1))], -1)
    bbox = np.array([10.0, 20.0, 200.0, 150.0])
    for gt_k in (g, np.c_[g[:, :2], np.zeros(17)]):  # labelled, unlabelled
        np.testing.assert_array_equal(
            peval.compute_oks(gt_k, 5000.0, d, SIGMAS, bbox),
            jeval.compute_oks(gt_k, 5000.0, d, SIGMAS, bbox))


def test_meters_pck_and_clinical_metrics_match_jax():
    rng = np.random.RandomState(4)
    la, lb = peval.MetricLogger(), jeval.MetricLogger()
    for n in (1, 3, 2):
        v = rng.rand(2)
        la.update(n=n, loss=v[0], ap=v[1])
        lb.update(n=n, loss=v[0], ap=v[1])
    assert la.summary() == lb.summary() and str(la) == str(lb)
    assert la.loss.count == 6
    pred, gt = rng.rand(4, 17, 2) * 100, rng.rand(4, 17, 2) * 100
    mask, norm = rng.choice([0, 1], (4, 17)), rng.rand(4) * 80 + 10
    a = peval.pck_accuracy(pred, gt, mask, norm)
    b = jeval.pck_accuracy(pred, gt, mask, norm)
    assert a["pck"] == b["pck"]
    np.testing.assert_array_equal(a["per_keypoint"], b["per_keypoint"])
    traj = rng.rand(9, 13, 2) * 50
    for k, v in jeval.calculate_movement_amplitude(traj).items():
        np.testing.assert_array_equal(
            peval.calculate_movement_amplitude(traj)[k], v)
    assert peval.calculate_temporal_consistency(traj) == \
        jeval.calculate_temporal_consistency(traj)
    assert peval.asymmetry_score(traj, [1, 3], [2, 4]) == \
        jeval.asymmetry_score(traj, [1, 3], [2, 4])


# -- checkpoints ---------------------------------------------------------------

# (epoch, AP) in order; AP None leaves the metric out (no validation that
# epoch).  The resumed part starts from a new manager on the same directory
# with the best read back from latest's metadata.
SEQUENCE = [(0, 0.10), (1, None), (2, 0.30), (3, 0.20)]
RESUMED = [(4, 0.25), (5, 0.40)]


def _port_state():
    model = torch.nn.Linear(3, 2)
    cfg = get_variant("hrformer_base")
    opt, schedule = build_optimizer(cfg, model, 4)
    return TrainState(model, opt, schedule)


class _JaxState(SimpleNamespace):
    """The fields of a JAX TrainState that its CheckpointManager reads."""

    def replace(self, **kw):
        return _JaxState(**{**vars(self), **kw})


def _jax_state():
    leaf = np.arange(6, dtype=np.float32).reshape(2, 3)
    return _JaxState(params={"w": leaf}, batch_stats={},
                     opt_state={"m": leaf * 0}, step=np.zeros((), np.int32))


def _run_policy(mgr_cls, directory, state):
    mgr = mgr_cls(directory, save_every=2)
    best = -np.inf
    for epoch, ap in SEQUENCE:
        metrics = {"total_loss": 1.0 / (epoch + 1)}
        if ap is not None:
            metrics["AP"] = ap
        best, _ = mgr.save(state, epoch, metrics, best, monitor="AP",
                           latest_interval=1)
    mgr.save_interrupt(state, 3, best)
    _, meta = mgr.restore(state)
    mgr = mgr_cls(directory, save_every=2)  # a resumed run
    best = float(meta["best"])
    flags = []
    for epoch, ap in RESUMED:
        best, is_best = mgr.save(state, epoch, {"AP": ap}, best,
                                 latest_interval=2)
        flags.append(is_best)
    return meta, flags


def _files(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        if name.endswith(".meta.json"):
            with open(os.path.join(directory, name)) as f:
                out[name] = json.load(f)
        else:
            out[name] = None
    return out


def test_checkpoint_policy_matches_jax(tmp_path):
    """The same files (``latest``, ``best``, ``epoch_N`` and their
    ``.meta.json``) and metadata as JAX's; ``save_interrupt`` stamps
    ``preempted``; the best survives a resume (AP 0.25 after a best of
    0.30 does not replace ``best``, 0.40 does)."""
    meta, flags = _run_policy(CheckpointManager, str(tmp_path / "port"),
                              _port_state())
    jmeta, jflags = _run_policy(JCheckpointManager, str(tmp_path / "jax"),
                                _jax_state())
    assert meta == jmeta == {"epoch": 3.0, "best": 0.3, "preempted": 1.0}
    assert flags == jflags == [False, True]
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax")
    assert set(files) == {"latest", "latest.meta.json", "best",
                          "best.meta.json", "epoch_2", "epoch_2.meta.json",
                          "epoch_4", "epoch_4.meta.json", "epoch_6",
                          "epoch_6.meta.json"}
    assert files["best.meta.json"]["epoch"] == 5.0


def test_checkpoint_restore_roundtrip(tmp_path):
    """A restore brings back the parameters, the optimizer's moments and
    the step; a missing checkpoint gives (state, None)."""
    state = _port_state()
    x = torch.randn(4, 3)
    for _ in range(3):
        state.optimizer.zero_grad()
        state.model(x).square().sum().backward()
        state.apply_gradients()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, 0, {"AP": 0.5}, -np.inf)
    other = _port_state()
    assert mgr.restore(other, "nothing_here") == (other, None)
    other, meta = mgr.restore(other)
    assert meta["AP"] == 0.5 and other.step == 3
    for a, b in zip(state.model.parameters(), other.model.parameters()):
        assert torch.equal(a, b)
    sa, sb = state.optimizer.state_dict(), other.optimizer.state_dict()
    for k, v in sa["state"].items():
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(v[name], sb["state"][k][name])
    assert not [n for n in os.listdir(tmp_path) if ".tmp" in n]
