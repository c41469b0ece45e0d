"""PyTorch port, the training loop (train/loop.py) against the JAX
package's ``train()`` and ``validate()`` on the CPU.

A tiny HRFormer with the fusion head (drop path 0, no jitter: the two
frameworks cannot draw the same random bits) is registered in both
packages' ``BACKBONES`` for the module.  Both loops start from one set of
weights: the port's seeded init, converted for JAX by the JAX package's
importer, and carried back into the port by ``train_state_from_jax`` (JAX's
own ``create_train_state`` would run a 45 s unjitted init, so the test
hands JAX's loop that state instead).  Both read the same synthetic
batches: the two loaders give the same crops bit for bit
(tests/test_torch_data.py).

Tolerances (float32 on both sides; only summation orders differ):
* every logged loss term and lr within 1e-4 relative at every step
  (measured <= 1.8e-5 over the four steps);
* grad_norm within 1e-3 relative (measured <= 9.1e-5): gradients are not
  smooth in the forward's roundings, a ReLU input on the other side of 0
  moves the gradients below it by ~1e-3 (test_torch_train.py's bounds);
* the optimizer is the configs' AdamW at lr 1e-5: AdamW's first update
  moves every weight by about lr times the sign of its gradient, so the
  weights whose gradient is rounding noise (a bias before a train-mode
  BatchNorm) move by +-lr in each framework at random; at the configs'
  5e-4 that alone put the variance term 6e-3 apart after four steps;
* after validation, keypoints within the serving tests' 1e-3 px where no
  beta=1 soft-argmax of the flip-averaged heatmaps lies within 1e-3 of a
  half-integer (there round() sits on a tie and the local-refine window
  may move by a pixel), scores within 1e-4, AP within 1e-3 absolute.
"""

import json
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu.config import get_variant as jget
from infantposeestimation_gaussianbias_tpu.data import (
    CocoIndex as JCocoIndex,
    DataLoader as JDataLoader,
    PoseDataset as JPoseDataset,
    build_records as jbuild_records,
)
from infantposeestimation_gaussianbias_tpu.models import hrformer as jhr
from infantposeestimation_gaussianbias_tpu.models import pose_estimator as jpe
from infantposeestimation_gaussianbias_tpu.tools.import_torch_checkpoint import (
    convert_checkpoint,
)
from infantposeestimation_gaussianbias_tpu.train import loop as jloop
from infantposeestimation_gaussianbias_tpu.train import optim as joptim
from infantposeestimation_gaussianbias_tpu.train import step as jstep
from infantposeestimation_gaussianbias_tpu.train.state import (
    TrainState as JTrainState,
)
from infantposeestimation_gaussianbias_tpu_torch import data
from infantposeestimation_gaussianbias_tpu_torch.config import get_variant
from infantposeestimation_gaussianbias_tpu_torch.models import hrformer
from infantposeestimation_gaussianbias_tpu_torch.models import pose_estimator
from infantposeestimation_gaussianbias_tpu_torch.ops import decode
from infantposeestimation_gaussianbias_tpu_torch.train import loop
from infantposeestimation_gaussianbias_tpu_torch.weights import (
    train_state_from_jax,
)

TINY = dict(channels=(8, 16, 32, 64), num_heads=(1, 2, 4, 8),
            stage_modules=(1, 1, 1))
N_IMAGES = 8
BATCH = 4
TERM_RTOL = 1e-4
GRAD_NORM_RTOL = 1e-3
KEYPOINT_ATOL = 1e-3
AP_ATOL = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: several test processes share the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny(cfg):
    cfg.model.backbone = "tiny_hrformer"
    cfg.model.hidden_dim = 16
    cfg.model.compute_dtype = "float32"
    cfg.data.input_size = (48, 64)
    cfg.data.heatmap_size = (12, 16)
    cfg.train.warmup_epochs = 0
    cfg.train.lr = 1e-5  # see the module doc
    cfg.train.global_batch_size = cfg.eval.batch_size = BATCH
    cfg.train.log_interval = 1
    cfg.train.val_interval = 1
    cfg.train.save_every = 0
    return cfg


class _Stop:
    """A loader that sets a preemption flag as it hands out batch
    ``at[1]`` of epoch ``at[0]`` (the step that takes it runs, then the
    loop sees the flag)."""

    def __init__(self, loader, flag, at):
        self.loader, self.flag, self.at = loader, flag, at

    def __len__(self):
        return len(self.loader)

    def epoch(self, epoch):
        for i, batch in enumerate(self.loader.epoch(epoch)):
            if (epoch, i) == self.at:
                self.flag.set()
            yield batch


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both packages' configs, loaders and GT on one synthetic set, the
    port's seeded weights as JAX variables, and JAX's loop patched to
    start from them (one jitted step for the module)."""
    with pytest.MonkeyPatch.context() as mp:
        # metrics to JSONL alone: importing TensorBoard here drags in
        # TensorFlow (~13 s) and neither loop's JSONL depends on it
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        mp.setitem(jpe.BACKBONES, "tiny_hrformer", lambda **kw: jhr.HRFormer(
            drop_path_rate=0.0, **TINY, **kw))
        mp.setitem(pose_estimator.BACKBONES, "tiny_hrformer",
                   lambda **kw: hrformer.HRFormer(drop_path_rate=0.0, **TINY,
                                                  **kw))
        cfg, jcfg = _tiny(get_variant("hrformer_base")), _tiny(
            jget("hrformer_base"))
        gt = data.synthetic_coco_dataset(num_images=N_IMAGES, seed=3)
        rng = np.random.RandomState(5)
        cache = {im["file_name"]: rng.randint(0, 255, (256, 320, 3)).astype(
            np.uint8) for im in gt["images"]}
        recs = data.build_records(data.CocoIndex(dataset=gt))
        jrecs = jbuild_records(JCocoIndex(dataset=gt))

        def loaders(is_train):
            kw = dict(shuffle=is_train, seed=cfg.train.seed, num_threads=2,
                      drop_last=is_train)
            return (data.DataLoader(data.PoseDataset(
                        cfg, recs, "", is_train, image_cache=cache), BATCH,
                        **kw),
                    JDataLoader(JPoseDataset(
                        jcfg, jrecs, "", is_train, image_cache=cache), BATCH,
                        **kw))

        port_model = pose_estimator.build_model(cfg, device="cpu")
        params, stats = convert_checkpoint(
            {k: v.numpy().copy() for k, v in port_model.state_dict().items()},
            head_type="fusion")
        jmodel = jpe.build_model(jcfg)
        step = jstep.make_train_step(jcfg, jcfg.data.keypoint_schema)
        train_loaders, val_loaders = loaders(True), loaders(False)
        # as both loops set it; the carried state's schedule needs it
        cfg.train.steps_per_epoch = jcfg.train.steps_per_epoch = len(
            train_loaders[0])
        # one optimizer object: it is a static field of JAX's TrainState,
        # so a new one would compile the step again
        tx, _ = joptim.build_optimizer(jcfg, jcfg.train.steps_per_epoch)

        def create_state(cfg_, model, rng, mesh=None):
            # committed to the device, as a restored state is: the step's
            # executable is then the same for both
            assert cfg_.train.steps_per_epoch == jcfg.train.steps_per_epoch
            return jax.device_put(JTrainState.create(
                apply_fn=jmodel.apply, params=params, batch_stats=stats,
                tx=tx), jax.devices()[0])

        mp.setattr(jloop, "create_train_state", create_state)
        mp.setattr(jloop, "make_train_step", lambda *a: step)
        yield dict(cfg=cfg, jcfg=jcfg, train=train_loaders, val=val_loaders,
                   gt=gt, init=create_state(jcfg, None, None),
                   tmp=tmp_path_factory)


def _dirs(world, cfg, name):
    root = world["tmp"].mktemp(name)
    cfg.train.checkpoint_dir = str(root / "ck")
    cfg.log_dir = str(root / "logs")
    return root


def _carried_init(world, device="cpu"):
    """The JAX initial state carried across into a port TrainState."""
    s = jax.tree_util.tree_map(np.array, world["init"])
    return train_state_from_jax(world["cfg"], s.params, s.batch_stats,
                                s.opt_state, s.step, device=device)


def _train_lines(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k != "time"} for r in lines
            if any(k.startswith("train/") for k in r)]


def _assert_lines_close(got, want):
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in b:
            rtol = GRAD_NORM_RTOL if k.endswith("grad_norm") else TERM_RTOL
            np.testing.assert_allclose(a[k], b[k], rtol=rtol,
                                       err_msg=f"step {b['step']} {k}")


@pytest.fixture(scope="module")
def runs(world):
    """Two epochs of JAX's train() and of the port's (with validation
    after each epoch), from the same state on the same batches."""
    cfg, jcfg = world["cfg"], world["jcfg"]
    _dirs(world, jcfg, "jax_run")
    jstate = jloop.train(jcfg, world["train"][1], max_epochs=2,
                         use_mesh=False)
    _dirs(world, cfg, "port_run")
    state = loop.train(cfg, world["train"][0], world["val"][0], world["gt"],
                       max_epochs=2, state=_carried_init(world))
    return dict(jstate=jstate, state=state, jlog=jcfg.log_dir,
                log=cfg.log_dir, ck=cfg.train.checkpoint_dir)


def test_train_loop_logs_match_jax(world, runs):
    """Every step's logged terms, grad_norm and lr; the step count; the
    port's validation lines and checkpoints."""
    got, want = _train_lines(runs["log"]), _train_lines(runs["jlog"])
    assert [r["step"] for r in want] == [1, 2, 3, 4]
    assert {"train/total_loss", "train/heatmap_loss", "train/offset_loss",
            "train/grad_norm", "train/lr"} <= set(want[0])
    _assert_lines_close(got, want)
    assert runs["state"].step == int(runs["jstate"].step) == 4
    with open(os.path.join(runs["log"], "metrics.jsonl")) as f:
        val = [json.loads(line) for line in f if "val/AP" in line]
    assert [r["step"] for r in val] == [2, 4]
    assert {"latest", "best"} <= set(os.listdir(runs["ck"]))


def _captured_predictions(module, monkeypatch):
    """Record the evaluator that ``module``'s validate() builds."""
    seen = []

    class Recording(module.COCOEvaluator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.append(self)

    monkeypatch.setattr(module, "COCOEvaluator", Recording)
    return seen


def _tie_mask(cfg, model, loader):
    """(N, K) True where the beta=1 soft-argmax of the flip-averaged
    heatmaps lies within 1e-3 of a half-integer, in prediction order."""
    flip = torch.as_tensor(cfg.data.keypoint_schema.flip_index())
    out = []
    model.eval()
    with torch.no_grad():
        for batch in loader.epoch(0):
            x = data.device_batch(batch, cfg.data.pixel_mean,
                                  cfg.data.pixel_std, "cpu")["image"]
            hm = model(x)["heatmaps"]
            hm_f = decode.flip_heatmaps(model(torch.flip(x, [2]))["heatmaps"],
                                        flip)
            g, _ = decode.soft_argmax((hm + hm_f) * 0.5)
            near = (np.abs(g.numpy() % 1.0 - 0.5) < 1e-3).any(axis=-1)
            out.append(near[batch["valid"] > 0])
    model.train()
    return np.concatenate(out)


def test_validate_matches_jax(world, runs, monkeypatch):
    """validate() on JAX's trained weights carried across (with sharper
    prediction convs), against JAX's validate() on them: the keypoints in
    frame pixels (off ties), the scores, every COCO metric."""
    # JAX's trained weights with sharper prediction convs (the same on both
    # sides): four steps at lr 1e-5 leave the tiny model's heatmaps flat,
    # and a flat map puts every soft-argmax on the map's centre, a tie
    jstate = runs["jstate"]
    rng = np.random.RandomState(6)
    params = jax.tree_util.tree_map(np.array, jstate.params)
    for name in ("hm_final", "off_final"):
        kernel = params["head"][name]["kernel"]
        kernel[...] = rng.randn(*kernel.shape) * 0.3
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                          params))
    jseen = _captured_predictions(jloop, monkeypatch)
    want = jloop.validate(world["jcfg"], jstate, world["val"][1], world["gt"],
                          with_loss=False)
    s = jax.tree_util.tree_map(np.array, jstate)
    state = train_state_from_jax(world["cfg"], s.params, s.batch_stats,
                                 s.opt_state, s.step, device="cpu")
    seen = _captured_predictions(loop, monkeypatch)
    got = loop.validate(world["cfg"], state, world["val"][0], world["gt"],
                        with_loss=False)
    assert state.model.training  # back in train mode
    ties = _tie_mask(world["cfg"], state.model, world["val"][0])
    assert ties.sum() <= ties.size // 2, ties
    preds, jpreds = seen[0].predictions, jseen[0].predictions
    assert len(preds) == len(jpreds) == N_IMAGES
    for p, q, tie in zip(preds, jpreds, ties):
        assert p["image_id"] == q["image_id"]
        np.testing.assert_allclose(p["keypoints"][:, 2],
                                   q["keypoints"][:, 2], atol=1e-4)
        np.testing.assert_allclose(p["keypoints"][~tie, :2],
                                   q["keypoints"][~tie, :2],
                                   atol=KEYPOINT_ATOL)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= AP_ATOL, (k, got[k], want[k])


def _meta(ck):
    with open(os.path.join(ck, "latest.meta.json")) as f:
        return json.load(f)


def test_preemption_and_resume_match_jax(world):
    """Set the preemption flag as the first batch of epoch 1 is handed out:
    both loops take that step, save ``latest`` stamped with epoch 0 and
    ``preempted``, with 3 steps taken; the resume replays epoch 1 from its
    start (steps 4 and 5), as JAX's save_interrupt documents; the logged
    terms agree throughout."""
    cfg, jcfg = world["cfg"], world["jcfg"]
    lines = []
    for pkg, conf, ldr in ((jloop, jcfg, world["train"][1]),
                           (loop, cfg, world["train"][0])):
        _dirs(world, conf, f"preempt_{pkg is loop}")
        kw = {} if pkg is loop else dict(use_mesh=False)
        start = dict(state=_carried_init(world)) if pkg is loop else {}
        try:
            s = pkg.train(conf, _Stop(ldr, pkg._PREEMPTED, (1, 0)),
                          max_epochs=2, **kw, **start)
        finally:
            pkg._PREEMPTED.clear()
        assert int(s.step) == 3
        assert _meta(conf.train.checkpoint_dir) == {
            "epoch": 0.0, "best": -1e30, "preempted": 1.0}
        start = dict(state=_carried_init(world)) if pkg is loop else {}
        s = pkg.train(conf, ldr, max_epochs=2, **kw, **start)
        assert int(s.step) == 5
        meta = _meta(conf.train.checkpoint_dir)
        assert meta["epoch"] == 1.0 and "preempted" not in meta
        lines.append(_train_lines(conf.log_dir))
    assert [r["step"] for r in lines[0]] == [1, 2, 4, 5]
    _assert_lines_close(lines[1], lines[0])
