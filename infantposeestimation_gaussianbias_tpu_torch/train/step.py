"""Training and evaluation steps.

Port of infantposeestimation_gaussianbias_tpu/train/step.py.  One call of
the train step does, on the model's device: Gaussian targets -> forward in
train mode (HRFormer: W-MSA through K1) -> every loss term in float32 (the
heatmap head: the weighted MSE; the fusion head: the six terms) ->
backward (HRFormer: W-MSA through K2) -> optimizer update, and returns the
per-term losses and ``grad_norm`` as 0-d device tensors (no host sync).

Batch contract (tensors, moved to the model's device):
  image:     (B, H, W, 3) float32, normalised crops
  keypoints: (B, K, 2) in input-image pixels
  visible:   (B, K) raw COCO visibility (0/1/2)
Optional 'target' (B, h, w, K) and 'target_weight' (B, K) replace the
on-device targets.

DropPath (HRFormer): the step draws the keep masks of all blocks for the
whole batch from the ``torch.Generator`` it is given, before the forward
(see ``draw_drop_masks``), or takes them from the caller (``drop_masks``);
microbatch i uses the masks of its samples.  HRNet has no DropPath and
needs no generator.

Photometric jitter (a non-zero ``data.color_jitter``, as the ``preemie``
config sets): per microbatch, after the targets and before the forward,
on the normalised image, as the JAX step puts it (ops/photometric.py).
The step draws every sample's factors and op order for the whole batch
from its generator after the DropPath masks, or takes them from the
caller (``jitter``); microbatch i uses the draws of its samples.

Under a process grid (``make_train_step(cfg, grid)``, parallel/mesh.py)
every rank is handed the same global batch, as the JAX step is handed a
batch sharded over 'data', and works on its data rank's share of each
microbatch; the DropPath masks are drawn for the global batch from the
shared generator and each rank keeps its columns.  Each loss term is the
rank's share of the global term (its numerator over the global
denominator, losses/fusion.py ``global_sum``), so the terms and the
gradients add up over the data ranks to JAX's.  After the backward one
all-reduce over the world group sums every gradient, flattened in
parameter order, and a scale takes it back to the sum over the data
ranks: 1/m (the m model ranks of a data index hold the same gradient),
and 1/(d m) for the RPE tables, whose gradient K3 returns already summed
over the d data ranks.  Summing over the world, and not over the data
group alone, is what keeps the ranks equal: on the card the model ranks'
gradients agree only up to the order of atomic sums (the RPE table's
scatter-add, the bilinear upsample's backward), and two data groups would
sum two such versions.  Then the global-norm clip and the same AdamW
update run on every rank, which keeps the parameters equal bit for bit.
No DDP: it would reduce the RPE tables a second time.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from .. import losses as L
from ..models import build_model
from ..models.hrformer import WindowAttention
from ..ops import heatmap as heatmap_ops
from ..ops import photometric
from ..parallel.mesh import TENSOR_PARALLEL_TODO
from .optim import build_optimizer
from .state import TrainState, optax_global_norm

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


def _targets(batch: Batch, heatmap_size, input_size, sigma
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    if "target" in batch:
        return batch["target"], batch["target_weight"]
    return heatmap_ops.generate_targets(
        batch["keypoints"], batch["visible"], heatmap_size, input_size,
        sigma, "msra")


def make_loss_fn(cfg, global_sum: L.GlobalSum = None) -> Callable:
    """Loss: (outputs, batch, target, weight) -> (loss, terms dict), for
    the fusion and heatmap heads.  ``global_sum``: see losses/fusion.py."""
    head = cfg.model.head_type
    if head not in ("fusion", "heatmap"):
        raise NotImplementedError(f"no loss for the {head!r} head in the "
                                  f"port yet")
    m = cfg.model
    input_size = tuple(cfg.data.input_size)
    skeleton_np = cfg.data.keypoint_schema.skeleton_array()
    skeletons: Dict[torch.device, torch.Tensor] = {}
    fusion_weights = (m.heatmap_loss_weight, m.offset_loss_weight,
                      m.peak_loss_weight, m.variance_loss_weight,
                      m.overlap_loss_weight, m.shape_loss_weight)

    def loss_fn(outputs, batch, target, weight):
        if head == "heatmap":
            loss = L.keypoint_mse_loss(outputs["heatmaps"], target, weight,
                                       m.use_target_weight, global_sum)
            return loss, {"total_loss": loss, "heatmap_loss": loss}
        dev = target.device
        if dev not in skeletons:
            skeletons[dev] = torch.as_tensor(skeleton_np, dtype=torch.long,
                                             device=dev)
        terms = L.fusion_pose_loss(
            outputs, target, weight, batch["keypoints"], skeletons[dev],
            input_size=input_size, weights=fusion_weights,
            target_sigma=cfg.data.sigma,
            use_target_weight=m.use_target_weight, global_sum=global_sum)
        return terms["total_loss"], terms

    return loss_fn


def draw_drop_masks(model: nn.Module, batch_size: int,
                    generator: torch.Generator,
                    device=None) -> Optional[torch.Tensor]:
    """(num_drop_paths, batch_size) bool DropPath keep masks for every
    block of ``model``'s backbone, each True with probability
    1 - drop_path_rate; None at rate 0 (HRNet).  Drawn on the generator's device,
    returned on ``device``."""
    backbone = model.backbone
    rate = backbone.drop_path_rate
    if rate == 0:
        return None
    u = torch.rand((backbone.num_drop_paths, batch_size),
                   generator=generator, device=generator.device)
    return (u < 1.0 - rate).to(device)


def _on(batch: Batch, device) -> Batch:
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


def _data_sum(grid) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """Sum of a tensor over the grid's data ranks (None: no data axis)."""
    if grid is None or grid.data == 1:
        return None

    def data_sum(t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t, group=grid.data_group)
        return t

    return data_sum


def make_train_step(cfg, grid=None) -> Callable:
    """The train step ``(state, batch, generator, drop_masks=None,
    jitter=None) -> (state, metrics)``.  The state is updated in place and
    returned.  ``jitter``: (factors, orders) of ``photometric.draw_jitter``
    for the batch.  ``grid``: the ProcessGrid the state's model was built
    over (see the module doc); ``batch``, ``drop_masks`` and ``jitter`` are
    then the global ones."""
    amounts = tuple(float(a) for a in cfg.data.color_jitter)
    jitter_on = photometric.jitter_enabled(amounts)
    mean, std = cfg.data.pixel_mean, cfg.data.pixel_std
    heatmap_size = tuple(cfg.data.heatmap_size)
    input_size = tuple(cfg.data.input_size)
    sigma = cfg.data.sigma
    data_sum = _data_sum(grid)
    loss_fn = make_loss_fn(cfg, data_sum)
    accum = max(1, int(cfg.train.grad_accum_steps))
    D, d = (1, 0) if grid is None else (grid.data, grid.data_index)

    def micro_grads(model, batch, keep, jitter) -> Metrics:
        """Targets -> jitter -> forward -> loss -> backward for one
        (micro)batch; the gradients add into the parameters' ``.grad``."""
        target, weight = _targets(batch, heatmap_size, input_size, sigma)
        images = photometric.color_jitter_normalized(
            batch["image"], mean, std, amounts, jitter=jitter)
        outputs = model(images, keep)
        loss, terms = loss_fn(outputs, batch, target, weight)
        loss.backward()
        return {k: v.detach() for k, v in terms.items()}

    def train_step(state: TrainState, batch: Batch,
                   generator: torch.Generator,
                   drop_masks: Optional[torch.Tensor] = None,
                   jitter: Optional[photometric.Jitter] = None
                   ) -> Tuple[TrainState, Metrics]:
        model = state.model
        device = next(model.parameters()).device
        batch = _on(batch, device)
        b = batch["image"].shape[0]
        if b % (accum * D):
            raise ValueError(f"global batch {b} not divisible by "
                             f"grad_accum_steps={accum} x {D} data ranks")
        model.train()
        if drop_masks is None:
            drop_masks = draw_drop_masks(model, b, generator, device)
        if jitter_on:
            jitter = (photometric.draw_jitter(b, amounts, generator, device)
                      if jitter is None else tuple(t.to(device)
                                                   for t in jitter))
        state.optimizer.zero_grad(set_to_none=True)
        mb = b // accum
        per = mb // D  # this data rank's rows of each microbatch
        sums: Optional[Metrics] = None
        for i in range(accum):
            rows = slice(i * mb + d * per, i * mb + (d + 1) * per)
            keep = None if drop_masks is None else drop_masks[:, rows]
            jit = None if not jitter_on else tuple(t[rows] for t in jitter)
            terms = micro_grads(model, {k: v[rows] for k, v in batch.items()},
                                keep, jit)
            sums = terms if sums is None else {
                k: sums[k] + terms[k] for k in terms}
        params = state.params
        for p in params:  # optax sees a zero gradient for an unused leaf
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if grid is not None and grid.size > 1:
            _sum_gradients(model, params, grid)
        if data_sum is not None:
            sums = dict(zip(sums, data_sum(torch.stack(list(sums.values())))))
        if accum > 1:  # gradients were summed in float32; average them
            torch._foreach_mul_(grads, 1.0 / accum)
            sums = {k: v * (1.0 / accum) for k, v in sums.items()}
        metrics = dict(sums)
        metrics["grad_norm"] = optax_global_norm(grads)
        state.apply_gradients()
        return state, metrics

    return train_step


def _sum_gradients(model: nn.Module, params, grid) -> None:
    """Every gradient summed over the grid's data ranks, the same bits on
    every rank: one all-reduce over the world group, flattened in
    parameter order, then 1/m, and 1/(d m) for the RPE tables (K3 returns
    those summed over the data ranks already); see the module doc."""
    rpe = {id(m.relative_position_bias_table) for m in model.modules()
           if isinstance(m, WindowAttention)}
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=grid.world_group)
    torch._foreach_copy_(grads, [t.view_as(g) for t, g in zip(
        flat.split([g.numel() for g in grads]), grads)])
    for scale, group in ((1.0 / grid.model, [p.grad for p in params
                                             if id(p) not in rpe]),
                         (1.0 / grid.size, [p.grad for p in params
                                            if id(p) in rpe])):
        if scale != 1.0 and group:
            torch._foreach_mul_(group, scale)


def make_eval_step(cfg) -> Callable:
    """Eval forward and loss, no update: ``(state, batch) -> (outputs,
    terms)``.  The model's train/eval mode is restored afterwards."""
    heatmap_size = tuple(cfg.data.heatmap_size)
    input_size = tuple(cfg.data.input_size)
    sigma = cfg.data.sigma
    loss_fn = make_loss_fn(cfg)

    def eval_step(state: TrainState, batch: Batch):
        model = state.model
        batch = _on(batch, next(model.parameters()).device)
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                target, weight = _targets(batch, heatmap_size, input_size,
                                          sigma)
                outputs = model(batch["image"])
                _, terms = loss_fn(outputs, batch, target, weight)
        finally:
            model.train(was_training)
        return outputs, terms

    return eval_step


def create_train_state(cfg, device="cuda", state_dict=None,
                       grid=None) -> TrainState:
    """Model (seeded weights from ``cfg.train.seed``, or ``state_dict`` in
    the reference checkpoint's naming) in train mode on ``device`` (the
    CUDA card unless the caller asks for ``"cpu"``), with its optimizer and
    schedule.  ``grid``: build the model over this ProcessGrid (see
    models.build_model); ``cfg.parallel.tensor_parallel`` is not ported
    and raises."""
    if grid is not None and cfg.parallel.tensor_parallel:
        raise NotImplementedError(TENSOR_PARALLEL_TODO)
    model = build_model(cfg, device, grid)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    model.train()
    optimizer, schedule = build_optimizer(
        cfg, model, cfg.train.steps_per_epoch or 1000)
    return TrainState(model=model, optimizer=optimizer, schedule=schedule,
                      grad_clip_norm=cfg.train.grad_clip_norm)
