"""PyTorch port, the training loop over a process grid and ``--mesh`` in
the CLIs, on the CPU (no JAX: the tensor-parallel step is held against
JAX in tests/test_torch_train.py, which shares its jitted JAX step).

``train(use_mesh=True)`` for one epoch of two steps, with validation,
over a 1 x 2 tensor-parallel grid of gloo CPU ranks (tests/torch_grid.py
``loop_rank``; the grid is the one ``cfg.parallel`` asks of the 2-rank
process group) against one process on the tiny HRFormer + fusion head
(tests/torch_grid.py ``TINY``), at lr 1e-5: at the configs' 5e-4 AdamW
moves a weight whose gradient is rounding noise by +-lr a step, which
parts two summation orders (tests/test_torch_loop.py runs its parity at
1e-5 for that reason).  The grid's checkpoint, written once by rank 0,
whole, restores into one process, and the one process's into the grid.
"""
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu_torch import data, parallel
from infantposeestimation_gaussianbias_tpu_torch.cli import common
from infantposeestimation_gaussianbias_tpu_torch.models import pose_estimator
from infantposeestimation_gaussianbias_tpu_torch.train import (
    create_train_state, loop)
from infantposeestimation_gaussianbias_tpu_torch.train.checkpoint import (
    CheckpointManager)

from tests import torch_grid
from tests.torch_tiny import one_torch_thread  # noqa: F401 (autouse)

LR = 1e-5
# The grid's weights after two steps against one process's: 2 lr a step
# (a weight whose gradient is rounding noise moves by +-lr either way).
PARAM_ATOL = 2 * LR * 2


def _cfg():
    cfg = torch_grid.tiny_cfg()
    cfg.train.lr = LR
    return cfg


def _synthetic(cfg, n=8):
    """(train records, val records, images, gt) of n synthetic images."""
    schema = cfg.data.keypoint_schema
    gt = data.synthetic_coco_dataset(
        num_images=n, num_keypoints=schema.num_keypoints, seed=0,
        keypoint_names=schema.keypoint_names, skeleton=schema.skeleton)
    rng = np.random.RandomState(0)
    images = {im["file_name"]: rng.randint(0, 255, (128, 160, 3)).astype(
        np.uint8) for im in gt["images"]}
    recs = data.build_records(data.CocoIndex(dataset=gt))
    return recs, recs, images, gt


def _loop_cfg(tmp, name):
    cfg = _cfg()
    cfg.train.global_batch_size = 4
    cfg.eval.batch_size = 4
    cfg.train.val_interval = 1
    cfg.train.checkpoint_dir = str(tmp / name / "ck")
    cfg.log_dir = str(tmp / name / "logs")
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The one-process loop run (its checkpoint is what the grid
    restores) and the grid's config."""
    tmp = tmp_path_factory.mktemp("mesh_loop")
    with pytest.MonkeyPatch.context() as mp:
        for name in ("tiny_hrformer", "tiny_hrformer_dp", "hrformer_tiny"):
            mp.setitem(pose_estimator.BACKBONES, name, None)
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        torch_grid.register_tiny()
        cfg = _loop_cfg(tmp, "one")
        recs, val, images, gt = _synthetic(cfg)
        loaders = [data.DataLoader(data.PoseDataset(
            cfg, r, "", train, image_cache=images), 4, shuffle=train,
            seed=cfg.train.seed) for r, train in ((recs, True), (val, False))]
        results = {}
        orig = loop.validate
        mp.setattr(loop, "validate",
                   lambda *a, **kw: results.update(orig(*a, **kw)) or results)
        state = loop.train(cfg, *loaders, gt, max_epochs=1, device="cpu")
        mp.setattr(loop, "validate", orig)
        grid_cfg = _loop_cfg(tmp, "grid")
        grid_cfg.parallel.model_axis = 2
        grid_cfg.parallel.tensor_parallel = True
        yield SimpleNamespace(
            one_state=state, one_val=dict(results),
            one_dir=cfg.train.checkpoint_dir, grid_cfg=grid_cfg,
            synthetic=(recs, val, images, gt))


@pytest.fixture(scope="module")
def ranks(setup):
    """Both ranks' results of the loop over the 1 x 2 grid."""
    return parallel.run_grid(torch_grid.loop_rank, 1, 2, "gloo", device="cpu",
                             args=(setup.grid_cfg, *setup.synthetic,
                                   setup.one_dir), timeout=300)


def test_ranks_import_no_jax(ranks):
    assert all(r["jax_modules"] == [] for r in ranks)


def test_train_use_mesh_matches_one_process(setup, ranks):
    """train(use_mesh=True) under a 2-rank process group meshes it as
    cfg.parallel says (1 x 2, tensor parallel), takes the epoch's two
    steps and validates; its validation (AP, AR, the loss) is one
    process's, its weights within PARAM_ATOL."""
    one = {n: p.detach().numpy()
           for n, p in setup.one_state.model.named_parameters()}
    for r in ranks:
        assert r["grid"] == (1, 2) and r["table"] and r["step"] == 2
        assert set(r["val"]) == set(setup.one_val) and "AP" in r["val"]
        for k, v in setup.one_val.items():
            np.testing.assert_allclose(r["val"][k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        for n, v in one.items():
            np.testing.assert_allclose(r["trained"][n], v, atol=PARAM_ATOL,
                                       rtol=0, err_msg=n)


def test_checkpoints_move_between_grid_and_one_process(setup, ranks):
    """The grid's ``latest`` (written once, whole, in the reference
    naming) restores into one process; the one process's restores into the
    grid, each rank cutting its blocks: its weights and AdamW moments
    equal the file's bit for bit."""
    ck = setup.grid_cfg.train.checkpoint_dir
    assert sorted(f for f in os.listdir(ck) if not f.startswith(".")) == [
        "best", "best.meta.json", "latest", "latest.meta.json"]
    with open(os.path.join(ck, "latest.meta.json")) as f:
        assert json.load(f)["epoch"] == 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(pose_estimator.BACKBONES, "tiny_hrformer", None)
        torch_grid.register_tiny()
        fresh = create_train_state(_cfg(), device="cpu")
    state, meta = CheckpointManager(ck).restore(fresh)
    assert meta is not None and state.step == 2
    trained = ranks[0]["trained"]
    for n, v in state.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), trained[n], err_msg=n)
    saved = torch.load(os.path.join(setup.one_dir, "latest"),
                       weights_only=True)
    for r in ranks:
        assert r["restored_step"] == saved["step"]
        for n, v in saved["model"].items():
            np.testing.assert_array_equal(r["restored"][n], v.numpy(),
                                          err_msg=n)
        for i, entry in saved["optimizer"]["state"].items():
            for k, v in entry.items():
                np.testing.assert_array_equal(r["restored_opt"][i][k],
                                              v.numpy(), err_msg=(i, k))
        for n in r["table"]:
            assert r["restored_moments"][n][0] == saved["model"][n].shape[0] // 2


def test_training_grid_shrinks_the_data_axis(ranks):
    """A global batch of 3 on a data axis of 2 ranks: the loop's grid is
    JAX's gcd shrink, a 1 x 1 grid of rank 0; rank 1 is left out."""
    assert [r["shrunk"] for r in ranks] == [(1, 1), None]


def test_cli_mesh_is_one_process_below_two_ranks(monkeypatch):
    """--mesh without torchrun's environment (a world below two ranks) is
    the one process; a model axis that one rank cannot hold raises, as
    JAX's create_mesh does; the backend is an explicit choice."""
    import argparse

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    parser = argparse.ArgumentParser()
    common.add_mesh_args(parser)
    parser.add_argument("--device", default="cpu")
    assert common.make_grid(parser.parse_args([])) is None
    assert common.make_grid(parser.parse_args(["--mesh"])) is None
    args = parser.parse_args(["--mesh", "2", "--backend", "gloo"])
    assert (args.mesh, args.backend) == (2, "gloo")
    with pytest.raises(ValueError, match="mesh 1x2 does not cover 1"):
        common.make_grid(args)
    flag = argparse.ArgumentParser()
    common.add_mesh_args(flag, model_axis=False)
    flag.add_argument("--device", default="cpu")
    assert flag.parse_args(["--mesh"]).mesh is True
    assert common.make_grid(flag.parse_args(["--mesh"])) is None
    with pytest.raises(SystemExit):
        parser.parse_args(["--backend", "mpi"])


def test_grid_loop_refuses_a_share_of_the_batch():
    """Over a grid the loop trains on global batches only: a loader that
    gives a process's share (half of ``train.global_batch_size`` rows)
    raises before a step, as the grid step would cut it again."""
    cfg = _cfg()
    half = cfg.train.global_batch_size // 2
    loader = SimpleNamespace(epoch=lambda e: iter(
        [{"image_u8": np.zeros((half, 8, 8, 3), np.uint8)}]))

    def step(*a):
        raise AssertionError("stepped on a share of the batch")

    with pytest.raises(ValueError, match="global batches"):
        loop._epoch_loop(cfg, None, step, None, loader, None, None, None,
                         0, 1, -np.inf, None, None, "cpu", grid=object())
