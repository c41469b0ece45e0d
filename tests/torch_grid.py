"""Rank-side bodies of the port's process-grid tests.

``parallel.run_grid`` spawns the ranks, and each imports this module by
name, so it imports torch and the port only (never jax): each body checks
that too.  A body takes the rank's ProcessGrid first and returns numpy
values, which the test compares in its own process.
"""

import functools
import os
import sys
from typing import Optional

import numpy as np
import torch

from infantposeestimation_gaussianbias_tpu_torch import (PoseInference,
                                                          get_variant)
from infantposeestimation_gaussianbias_tpu_torch.kernels.window_msa import (
    window_attention_sharded)
from infantposeestimation_gaussianbias_tpu_torch.models import (
    hrformer, pose_estimator)
from infantposeestimation_gaussianbias_tpu_torch.models import hrnet
from infantposeestimation_gaussianbias_tpu_torch.parallel import (
    allgather_host_values, create_mesh, full_state_dict, gather_data_rows,
    shard_batch, sharding_table)
from infantposeestimation_gaussianbias_tpu_torch.parallel.tensor import (
    assemble_rows)
from infantposeestimation_gaussianbias_tpu_torch.train import (
    create_train_state, make_train_step)

TINY = dict(channels=(8, 16, 32, 64), num_heads=(1, 2, 4, 8),
            stage_modules=(1, 1, 1))


def no_jax() -> list:
    """Modules of JAX, flax or the JAX package this rank has loaded."""
    return [m for m in sys.modules
            if m.split(".")[0] in ("jax", "flax",
                                   "infantposeestimation_gaussianbias_tpu")]


def register_tiny() -> None:
    """The tiny HRFormers of the slice tests in the port's BACKBONES:
    ``tiny_hrformer`` without DropPath, ``tiny_hrformer_dp`` at 0.2, and
    ``hrformer_tiny``, the first under a name that ``validate_serving_mode``
    takes for an HRFormer (so that it serves folded by default)."""
    pose_estimator.BACKBONES["tiny_hrformer"] = functools.partial(
        hrformer.HRFormer, drop_path_rate=0.0, **TINY)
    pose_estimator.BACKBONES["hrformer_tiny"] = pose_estimator.BACKBONES[
        "tiny_hrformer"]
    pose_estimator.BACKBONES["tiny_hrformer_dp"] = functools.partial(
        hrformer.HRFormer, drop_path_rate=0.2, **TINY)


def register_hrnet_tiny() -> None:
    """The tiny HRNet of tests/torch_tiny.py (base channels 8), in the
    port's BACKBONES only (a rank imports no JAX)."""
    pose_estimator.BACKBONES["hrnet_tiny"] = functools.partial(
        hrnet.HRNet, base_channels=8)


def tiny_cfg(backbone: str = "tiny_hrformer"):
    cfg = get_variant("hrformer_base")
    cfg.model.backbone = backbone
    cfg.model.hidden_dim = 16
    cfg.model.compute_dtype = "float32"
    cfg.data.input_size = (48, 64)
    cfg.data.heatmap_size = (12, 16)
    cfg.train.warmup_epochs = 0
    return cfg


def raise_on(grid, rank: int) -> int:
    """Raise on rank ``rank``; the others return their rank."""
    if grid.rank == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    return grid.rank


def mesh_rank(grid, cases) -> dict:
    """K3 forward and backward on this rank's rows of each case, under
    the loss sum(sin(out)) over the unpadded windows; create_mesh's errors;
    the host gathers."""
    out = dict(rank=grid.rank, coords=(grid.data_index, grid.model_index),
               jax_modules=no_jax(), cases=[])
    for case in cases:
        qkv = torch.from_numpy(shard_batch(case["qkv"], grid)).requires_grad_()
        bias = torch.from_numpy(case["bias"]).requires_grad_()
        y = window_attention_sharded(qkv, bias, case["H"], grid)
        first = grid.data_index * qkv.shape[0]  # global index of row 0
        torch.sin(y[:max(0, case["nW"] - first)]).sum().backward()
        out["cases"].append(dict(out=y.detach().numpy(),
                                 dqkv=qkv.grad.numpy(),
                                 dbias=bias.grad.numpy()))
    errors = []
    for data_axis, model_axis in ((3, 2), (0, 3)):
        try:
            create_mesh(data_axis, model_axis, device="cpu")
        except ValueError as e:
            errors.append(str(e))
    out["mesh_errors"] = errors
    rows = np.arange(8 * 3).reshape(8, 3)
    out["gathered"] = gather_data_rows(
        {"rows": shard_batch(rows, grid)}, grid)["rows"]
    out["all_ranks"] = allgather_host_values(np.array([grid.rank]))
    return out


def serve_rank(grid, state_dict, frames, bboxes) -> dict:
    """Serving a ragged batch over the grid, BN-fold off, under
    IPE_FUSED_BLOCK=0 and =1; and with the default fold (``serve_fold``,
    ``hrformer_tiny``)."""
    register_tiny()
    out = dict(jax_modules=no_jax())
    inf = PoseInference(tiny_cfg(), state_dict=state_dict, device="cpu",
                        mesh=grid, fold=False)
    for flag in ("0", "1"):
        os.environ["IPE_FUSED_BLOCK"] = flag
        try:
            out[f"serve{flag}"] = inf.predict_batch(frames, bboxes)
        finally:
            os.environ.pop("IPE_FUSED_BLOCK")
    folded = PoseInference(tiny_cfg("hrformer_tiny"), state_dict=state_dict,
                           device="cpu", mesh=grid)
    assert folded.fold
    out["serve_fold"] = folded.predict_batch(frames, bboxes)
    return out


def train_rank(grid, state_dict, batch, dp_masks) -> dict:
    """One train step of the tiny model at the global batch, and one of
    the DropPath model (the same weights) with given global masks; then
    three tensor-parallel steps at the config's learning rate (``tp``)
    and three at 1e-5 (``tp_low``), see ``tp_train_rank``."""
    register_tiny()
    out = dict(jax_modules=no_jax())
    for name, backbone, masks in (("train", "tiny_hrformer", None),
                                  ("train_dp", "tiny_hrformer_dp", dp_masks)):
        cfg = tiny_cfg(backbone)
        state = create_train_state(cfg, device="cpu", state_dict=state_dict,
                                   grid=grid)
        _, metrics = make_train_step(cfg, grid)(
            state, {k: torch.from_numpy(v) for k, v in batch.items()}, None,
            drop_masks=None if masks is None else torch.from_numpy(masks))
        out[name] = dict(
            metrics={k: v.item() for k, v in metrics.items()},
            params={n: p.detach().numpy().copy()
                    for n, p in state.model.named_parameters()},
            buffers={n: b.numpy().copy()
                     for n, b in state.model.named_buffers()
                     if n.endswith(("running_mean", "running_var"))})
    out["tp"] = tp_train_rank(grid, state_dict, batch, 3)
    out["tp_low"] = tp_train_rank(grid, state_dict, batch, 3, lr=1e-5)
    return out


def _numpy(sd) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


def tp_serve_rank(grid, state_dict, frames, bboxes, calib, hrnet_sd,
                  hrnet_calib, stream) -> dict:
    """Tensor-parallel serving of the tiny HRFormer + fusion (folded, the
    default; flip test off, as JAX's tensor-parallel serving test) on the
    frames; its sharding table and the shapes it holds;
    int8 over the grid (the HRFormer with tensor parallelism, and the
    tiny HRNet + heatmap head) calibrated on ``calib``: the whole int8
    state dicts and the predictions; ``predict_stream`` of the TP model
    over ``stream``; and, on a 2 x 2 grid, two batches served through the
    server's ``GridLeader`` on rank 0 while the others ``follow``."""
    from infantposeestimation_gaussianbias_tpu_torch.cli import serve

    register_tiny()
    register_hrnet_tiny()
    out = dict(jax_modules=no_jax(), rank=grid.rank)
    cfg = tiny_cfg("hrformer_tiny")
    cfg.eval.flip_test = False
    inf = PoseInference(cfg, state_dict=state_dict, device="cpu", mesh=grid,
                        tensor_parallel=True)
    out["table"] = sharding_table(inf.model)
    out["shapes"] = {n: tuple(p.shape)
                     for n, p in inf.model.named_parameters()}
    out["serve"] = inf.predict_batch(frames, bboxes)
    out["stream"] = list(inf.predict_stream(iter(stream), max_in_flight=2))
    if grid.size < 4:
        return out
    q = PoseInference(cfg, state_dict=state_dict, device="cpu", mesh=grid,
                      tensor_parallel=True, quantize=True,
                      calibration_crops=calib)
    out["int8_table"] = sharding_table(q.model)
    out["int8_sd"] = _numpy(full_state_dict(q.model))
    out["int8"] = q.predict_batch(frames, bboxes)
    hcfg = tiny_cfg("hrnet_tiny")
    hcfg.model.head_type = "heatmap"
    hcfg.model.hrnet_stage_modules = (1, 1, 1)
    hcfg.data.input_size = (64, 64)
    hcfg.data.heatmap_size = (16, 16)
    h = PoseInference(hcfg, state_dict=hrnet_sd, device="cpu", mesh=grid,
                      tensor_parallel=True, quantize=True,
                      calibration_crops=hrnet_calib)
    out["hrnet_int8_sd"] = _numpy(full_state_dict(h.model))
    out["hrnet_int8"] = h.predict_batch(frames, bboxes)
    if grid.rank == 0:
        leader = serve.GridLeader(inf, grid)
        out["leader"] = [leader.predict_batch(frames[:n], bboxes[:n])
                         for n in (3, 5)]
        leader.stop()
    else:
        serve.follow(inf, grid)
    return out


def tp_train_rank(grid, state_dict, batch, steps: int,
                  lr: Optional[float] = None) -> dict:
    """``steps`` float32 steps of the tiny HRFormer under
    ``cfg.parallel.tensor_parallel`` at the global batch and learning rate
    ``lr`` (None: the config's): the metrics of
    each, the first step's gradients (the blocks assembled), the sharded
    names with the shapes of the blocks, their AdamW moments' shapes, the
    replicated parameters after the steps and the whole state dict
    (assembled)."""
    register_tiny()
    cfg = tiny_cfg()
    cfg.parallel.tensor_parallel = True
    if lr is not None:
        cfg.train.lr = lr
    state = create_train_state(cfg, device="cpu", state_dict=state_dict,
                               grid=grid)
    step = make_train_step(cfg, grid)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    named = dict(state.model.named_parameters())
    sharded = state.shards
    metrics, grads = [], None
    for _ in range(steps):
        _, m = step(state, tb, None)
        metrics.append({k: v.item() for k, v in m.items()})
        if grads is None:  # every model rank assembles, in one order
            grads = {n: (assemble_rows(p.grad, sharded[id(p)])
                         if id(p) in sharded else p.grad).numpy().copy()
                     for n, p in named.items()}
    moments = {n: tuple(state.optimizer.state[p]["exp_avg"].shape)
               for n, p in named.items() if id(p) in sharded}
    return dict(
        jax_modules=no_jax(), rank=grid.rank, metrics=metrics, grads=grads,
        table=sharding_table(state.model),
        shapes={n: tuple(p.shape) for n, p in named.items()},
        moments=moments,
        replicated={n: p.detach().numpy().copy() for n, p in named.items()
                    if id(p) not in sharded},
        full=_numpy(full_state_dict(state.model)))


def loop_rank(grid, cfg, train_records, val_records, images, gt,
              one_process_dir) -> dict:
    """``train(use_mesh=True)`` over the process group (one epoch, with
    validation; the grid is ``cfg.parallel``'s), then a checkpoint of one
    process restored into a fresh state over that grid; and the loop's
    grid for a global batch of 3 on a data axis of every rank (JAX's gcd
    shrink: a grid of rank 0 alone)."""
    import copy

    from infantposeestimation_gaussianbias_tpu_torch.data import (
        DataLoader, PoseDataset)
    from infantposeestimation_gaussianbias_tpu_torch.train import (
        checkpoint, loop)

    register_tiny()
    sys.modules["torch.utils.tensorboard"] = None  # JSONL metrics only
    bs = cfg.train.global_batch_size
    train_loader = DataLoader(PoseDataset(cfg, train_records, "", True,
                                          image_cache=images), bs,
                              shuffle=True, seed=cfg.train.seed)
    val_loader = DataLoader(PoseDataset(cfg, val_records, "", False,
                                        image_cache=images),
                            cfg.eval.batch_size, shuffle=False)
    results = {}
    orig = loop.validate

    def keep(*a, **kw):
        results.update(orig(*a, **kw))
        return results

    loop.validate = keep
    state = loop.train(cfg, train_loader, val_loader, gt, max_epochs=1,
                       device="cpu")
    loop.validate = orig
    fresh = create_train_state(cfg, device="cpu", grid=state.grid)
    checkpoint.CheckpointManager(one_process_dir).restore(fresh)
    opt = fresh.optimizer.state
    named = dict(fresh.model.named_parameters())
    moments = checkpoint._moments(fresh.optimizer.state_dict(), fresh,
                                  checkpoint.assemble_rows)["state"]
    odd = copy.deepcopy(cfg)
    odd.train.global_batch_size = 3
    odd.parallel.data_axis, odd.parallel.model_axis = 0, 1
    shrunk = loop.training_grid(odd, "cpu")
    return dict(
        jax_modules=no_jax(), rank=grid.rank, step=state.step,
        grid=(state.grid.data, state.grid.model),
        table=sharding_table(state.model), val=dict(results),
        trained=_numpy(full_state_dict(state.model)),
        restored=_numpy(full_state_dict(fresh.model)),
        restored_moments={n: tuple(opt[p]["exp_avg"].shape)
                          for n, p in named.items()},
        restored_opt={i: {k: v.numpy().copy() for k, v in e.items()}
                      for i, e in moments.items()},
        restored_step=fresh.step,
        shrunk=None if shrunk is None else (shrunk.data, shrunk.model))
