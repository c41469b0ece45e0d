"""Training and validation loops (the top layer of training).

Port of infantposeestimation_gaussianbias_tpu/train/loop.py: the epoch
loop with per-term loss logging, periodic flip-test validation with COCO
OKS-AP, latest / best / periodic checkpoints, resume, and a checkpoint on
SIGTERM, over the threaded host loader (data/pipeline.py) and the train
step (train/step.py) on one device.

Per step the host waits for the device only where it must: the loss terms
become Python floats on the log steps alone (the first of an epoch and
every ``log_interval``), as in JAX, unless ``train.debug_nans`` asks for
every step's terms to be checked.  The DropPath masks and jitter draws
come from one generator on the model's device, seeded ``train.seed + 1``
at every call of ``train``, as the JAX loop seeds its dropout key.

The JAX loop's device mesh (``use_mesh``) waits for the port's
multi-card training, ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.pipeline import DataLoader, device_batch
from ..eval import COCOEvaluator, MetricLogger
from ..models import flip_inference
from ..ops import decode as decode_ops
from .checkpoint import CheckpointManager
from .logging import MetricsWriter
from .optim import lr_schedule
from .state import TrainState
from .step import create_train_state, make_eval_step, make_train_step

log = logging.getLogger("ipe_torch.train")

MESH_TODO = ("training over a device mesh (use_mesh) is not ported yet: "
             "ROADMAP Queue 1 item 9")

# Preemption flag: set by SIGTERM (what a preemptible machine receives
# shortly before eviction) while ``train`` runs, checked once per step.
# Module-level so that a test can stop a run at a chosen step without a
# real signal.
_PREEMPTED = threading.Event()


class _PreemptionGuard:
    """SIGTERM sets ``_PREEMPTED`` while the block runs (installed on the
    main thread only: a signal handler cannot be installed elsewhere); the
    previous handler comes back on exit."""

    def __enter__(self):
        self._prev = None
        if threading.current_thread() is threading.main_thread():
            self._prev = signal.signal(
                signal.SIGTERM, lambda signum, frame: _PREEMPTED.set())
        return self

    def __exit__(self, *exc):
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)
        return False


def setup_logging(log_file: Optional[str] = None) -> None:
    handlers = [logging.StreamHandler()]
    if log_file:
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s",
                        handlers=handlers, force=True)


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def validate(cfg: Config, state: TrainState, loader: DataLoader,
             gt_dataset: Dict, with_loss: bool = True,
             model: Optional[torch.nn.Module] = None) -> Dict[str, float]:
    """Flip-test validation: COCO AP (and the validation loss) over one
    pass of ``loader``.  ``model``: another serving model (the BN-folded
    one) in place of ``state.model``; the loss still runs on the state's
    model.  Each model is in eval mode during the pass and in its own mode
    after."""
    schema = cfg.data.keypoint_schema
    serve = model if model is not None else state.model
    device = _device(serve)
    flip_idx = torch.as_tensor(schema.flip_index(), device=device)
    evaluator = COCOEvaluator(schema.oks_sigma_array(), gt_dataset)
    W, H = cfg.data.input_size
    hm_w, hm_h = cfg.data.heatmap_size
    to_input = torch.tensor([W / hm_w, H / hm_h], dtype=torch.float32,
                            device=device)
    eval_step = make_eval_step(cfg) if with_loss else None
    loss_meter = MetricLogger()
    n = 0
    t0 = time.time()
    was_training = serve.training
    serve.eval()
    try:
        for batch in loader.epoch(0):
            db = device_batch(batch, cfg.data.pixel_mean, cfg.data.pixel_std,
                              device)
            with torch.no_grad():
                coords, scores = flip_inference(
                    serve, db["image"], flip_idx, cfg.model.head_type,
                    cfg.eval.decode, shift_heatmap=cfg.eval.shift_heatmap,
                    flip=cfg.eval.flip_test)
                coords = decode_ops.transform_preds(
                    coords * to_input, db["center"], db["scale"], (W, H))
            valid = batch["valid"] > 0
            evaluator.update(batch["image_id"], coords.cpu().numpy(),
                             scores.cpu().numpy(), valid=valid)
            if eval_step is not None:
                _, terms = eval_step(state, db)
                loss_meter.update(n=int(valid.sum()),
                                  val_loss=float(terms["total_loss"]))
            n += int(valid.sum())
    finally:
        serve.train(was_training)
    results = evaluator.evaluate()
    if eval_step is not None:
        results.update(loss_meter.summary())
    log.info("validated %d samples in %.1fs: AP=%.4f AP50=%.4f AP75=%.4f "
             "AR=%.4f", n, time.time() - t0, results["AP"],
             results["AP50"], results["AP75"], results["AR"])
    return results


def _check_schedule(state: TrainState, cfg: Config, steps_per_epoch: int
                    ) -> None:
    """A caller's state must carry the schedule of this loader's epoch
    length: compare the two at the warmup's end and at every milestone."""
    want = lr_schedule(cfg, steps_per_epoch)
    t = cfg.train
    probes = {0, t.warmup_epochs * steps_per_epoch}
    for m in t.lr_milestones:
        probes |= {m * steps_per_epoch - 1, m * steps_per_epoch}
    for step in sorted(p for p in probes if p >= 0):
        if state.schedule(step) != want(step):
            raise ValueError(
                f"the state's lr schedule was built for another epoch "
                f"length: at step {step} it gives {state.schedule(step)}, "
                f"{steps_per_epoch} steps per epoch give {want(step)}")


def train(cfg: Config, train_loader: DataLoader,
          val_loader: Optional[DataLoader] = None,
          gt_dataset: Optional[Dict] = None,
          max_epochs: Optional[int] = None,
          state: Optional[TrainState] = None,
          device="cuda",
          profile_steps: Optional[Tuple[int, int]] = None,
          use_mesh: bool = False) -> TrainState:
    """The training entry point; returns the final state.

    ``state``: start from this state (weights carried across from JAX, for
    one) instead of the seeded model of ``create_train_state``; its
    schedule must be the one of ``len(train_loader)`` steps per epoch.  A
    ``latest`` checkpoint in ``train.checkpoint_dir`` is resumed from
    either way.  ``device``: the card unless the caller asks for "cpu"
    (ignored with ``state``, which is on its device already).
    ``profile_steps=(start, stop)``: a torch.profiler trace of global
    steps [start, stop) of this call into ``<log_dir>/profile``.
    """
    if use_mesh:
        raise NotImplementedError(MESH_TODO)
    steps_per_epoch = len(train_loader)
    cfg.train.steps_per_epoch = steps_per_epoch
    if state is None:
        state = create_train_state(cfg, device=device)
    else:
        _check_schedule(state, cfg, steps_per_epoch)
    device = _device(state.model)
    step_fn = make_train_step(cfg)

    ckpt = CheckpointManager(cfg.train.checkpoint_dir, cfg.train.save_every)
    state, meta = ckpt.restore(state)
    start_epoch = int(meta["epoch"]) + 1 if meta is not None else 0
    best = float(meta.get("best", -np.inf)) if meta is not None else -np.inf
    if start_epoch:
        log.info("resumed from epoch %d", start_epoch)

    epochs = max_epochs if max_epochs is not None else cfg.train.max_epochs
    generator = torch.Generator(device=device).manual_seed(cfg.train.seed + 1)
    initialised = (torch.distributed.is_available()
                   and torch.distributed.is_initialized())
    writer = (MetricsWriter(cfg.log_dir)
              if not initialised or torch.distributed.get_rank() == 0
              else None)
    profiler = _StepProfiler(profile_steps,
                             os.path.join(cfg.log_dir, "profile"))
    try:
        with _PreemptionGuard():
            _epoch_loop(cfg, state, step_fn, generator, train_loader,
                        val_loader, gt_dataset, ckpt, start_epoch, epochs,
                        best, writer, profiler, device)
    finally:
        profiler.stop()  # a window that ran past the end of training
        if writer is not None:
            writer.close()
    return state


class _StepProfiler:
    """A torch.profiler trace of global steps [start, stop) of one
    ``train`` call, written as a Chrome trace into ``directory``."""

    def __init__(self, window: Optional[Tuple[int, int]], directory: str):
        self.start, self.stop_at = window or (None, None)
        self.directory = directory
        self._prof = None

    def before_step(self, steps_done: int) -> None:
        if steps_done == self.start:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                torch.cuda.synchronize()  # the trace starts on an idle card
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()

    def after_step(self, steps_done: int) -> None:
        if self._prof is not None and steps_done == self.stop_at:
            self.stop()

    def stop(self) -> None:
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory,
                            f"steps_{self.start}_{self.stop_at}.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        log.info("profiler trace for steps [%d, %d) written to %s",
                 self.start, self.stop_at, path)


def _epoch_loop(cfg, state, step_fn, generator, train_loader, val_loader,
                gt_dataset, ckpt, start_epoch, epochs, best, writer,
                profiler, device) -> None:
    mean, std = cfg.data.pixel_mean, cfg.data.pixel_std
    steps_per_epoch = cfg.train.steps_per_epoch
    steps_done = 0
    for epoch in range(start_epoch, epochs):
        logger = MetricLogger()
        t0 = time.time()
        for i, batch in enumerate(train_loader.epoch(epoch)):
            profiler.before_step(steps_done)
            db = device_batch(batch, mean, std, device)
            state, metrics = step_fn(state, db, generator)
            steps_done += 1
            if cfg.train.debug_nans:
                bad = [k for k, v in metrics.items()
                       if not torch.isfinite(v).all()]
                if bad:
                    raise FloatingPointError(
                        f"non-finite {', '.join(bad)} at epoch {epoch} "
                        f"step {i + 1}")
            if _PREEMPTED.is_set():
                profiler.stop()
                ckpt.save_interrupt(state, epoch - 1, best)
                log.warning(
                    "SIGTERM: saved preemption checkpoint at epoch %d "
                    "step %d (resume replays epoch %d from its start)",
                    epoch, i + 1, epoch)
                return
            profiler.after_step(steps_done)
            if (i + 1) % cfg.train.log_interval == 0 or i == 0:
                # one device-to-host copy for every term
                values = torch.stack([v.float() for v in metrics.values()])
                scalars = dict(zip(metrics, values.tolist()))
                scalars["lr"] = state.schedule(state.step)
                logger.update(**scalars)
                if writer is not None:
                    writer.write(state.step, scalars, prefix="train/")
                log.info("epoch %d [%d/%d] %s", epoch, i + 1,
                         steps_per_epoch,
                         " ".join(f"{k}={v:.4f}"
                                  for k, v in scalars.items()))
        log.info("epoch %d done in %.1fs  %s", epoch, time.time() - t0,
                 logger)

        metrics_out = logger.summary()
        if (val_loader is not None and gt_dataset is not None
                and (epoch + 1) % cfg.train.val_interval == 0):
            results = validate(cfg, state, val_loader, gt_dataset)
            metrics_out.update(results)
            if writer is not None:
                writer.write(state.step, results, prefix="val/")
        best, is_best = ckpt.save(
            state, epoch, metrics_out, best, monitor=cfg.train.save_best,
            latest_interval=cfg.train.save_latest_interval)
        if is_best:
            log.info("new best %s=%.4f at epoch %d", cfg.train.save_best,
                     best, epoch)
