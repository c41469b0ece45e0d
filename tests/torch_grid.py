"""Rank-side bodies of the port's process-grid tests.

``parallel.run_grid`` spawns the ranks, and each imports this module by
name, so it imports torch and the port only (never jax): each body checks
that too.  A body takes the rank's ProcessGrid first and returns numpy
values, which the test compares in its own process.
"""

import functools
import os
import sys

import numpy as np
import torch

from infantposeestimation_gaussianbias_tpu_torch import (PoseInference,
                                                          get_variant)
from infantposeestimation_gaussianbias_tpu_torch.kernels.window_msa import (
    window_attention_sharded)
from infantposeestimation_gaussianbias_tpu_torch.models import (
    hrformer, pose_estimator)
from infantposeestimation_gaussianbias_tpu_torch.parallel import (
    allgather_host_values, create_mesh, gather_data_rows, shard_batch)
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
    the DropPath model (the same weights) with given global masks."""
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
    return out
