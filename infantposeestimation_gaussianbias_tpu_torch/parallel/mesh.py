"""Process grid: the port's ('data', 'model') mesh over torch.distributed.

Port of infantposeestimation_gaussianbias_tpu/parallel/mesh.py.  The JAX
package is single-controller: one process drives every device, builds a
``Mesh`` and lets GSPMD insert the collectives.  PyTorch runs one process
per rank, so the port's mesh is a ``ProcessGrid`` over an initialised
process group, and the collectives are written out where the JAX package
leaves them to XLA: K3 (kernels/window_msa.py ``window_attention_sharded``)
all-reduces its heads and its bias gradient, a train-mode BatchNorm its
sums (models/layers.py), the train step the gradients (train/step.py) and
serving its keypoints (inference.py).

Rank r sits at (data index, model index) = divmod(r, model), as JAX's
``np.asarray(devices).reshape(data, model)``.  The data group of a rank
holds the ranks with its model index (they see different batch rows: the
gradient and BatchNorm reductions); its model group the ranks with its data
index (they see the same rows: K3's head assembly).

The backend is the caller's explicit choice, never switched behind its
back: "nccl" needs a card per rank, "gloo" runs on the CPU and, for
``all_reduce`` and ``broadcast``, on CUDA tensors (several ranks on one
card).  ``batch_sharding`` and ``replicated`` place JAX arrays on a
mesh; they have no counterpart here (a rank holds its own rows).  Tensor
parallelism (``param_sharding_rules``, ``shard_params``,
``sharding_table``) is parallel/tensor.py: a column-parallel Linear or
Conv2d holds its model rank's block of output rows and assembles its
output over the model group.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
TIMEOUT = timedelta(seconds=300)


@dataclass(frozen=True)
class ProcessGrid:
    """This rank's place in a (data, model) grid of ranks, and its groups."""

    data: int                 # size of the 'data' axis
    model: int                # size of the 'model' axis
    rank: int
    data_index: int
    model_index: int
    data_group: Any           # the ranks with this model index
    model_group: Any          # the ranks with this data index
    world_group: Any
    device: torch.device

    @property
    def size(self) -> int:
        return self.data * self.model


def check_backend(backend: str, ranks_per_host: int) -> None:
    """Raise unless ``backend`` can run ``ranks_per_host`` ranks here:
    "gloo" always, "nccl" with a card for each of them."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if ranks_per_host > cards:
            raise RuntimeError(
                f"nccl needs a card per rank: {ranks_per_host} ranks, "
                f"{cards} cards; pass backend='gloo' to share cards")


def initialize_multihost(backend: str, coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         timeout: timedelta = TIMEOUT) -> None:
    """Initialise the default process group: with coordinator,
    num_processes and process_id all None, from torchrun's environment
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE); with all three set, at
    ``tcp://coordinator`` ("host:port") as rank ``process_id`` of
    ``num_processes``; anything between raises.  ``check_backend`` counts
    torchrun's LOCAL_WORLD_SIZE (else WORLD_SIZE) ranks on this host on the
    environment path, and every one of ``num_processes`` on the explicit
    path: ranks spread over hosts come through torchrun."""
    explicit = (coordinator, num_processes, process_id)
    if any(v is None for v in explicit) and any(
            v is not None for v in explicit):
        raise ValueError(
            "coordinator, num_processes and process_id are set together or "
            f"not at all, got {coordinator!r}, {num_processes!r}, "
            f"{process_id!r}")
    if coordinator is None:
        env = os.environ
        check_backend(backend, int(env.get("LOCAL_WORLD_SIZE",
                                           env.get("WORLD_SIZE", "1"))))
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        check_backend(backend, num_processes)
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)


def maybe_initialize_multihost(cfg, backend: str) -> None:
    """Config-driven init: with ``parallel.multihost`` set, initialise from
    ``parallel.coordinator``, ``num_processes`` and ``process_id`` (or
    torchrun's environment where they are unset)."""
    p = cfg.parallel
    if getattr(p, "multihost", False):
        initialize_multihost(backend, p.coordinator, p.num_processes,
                             p.process_id)


def process_shard(records: Sequence, process_index: Optional[int] = None,
                  process_count: Optional[int] = None,
                  equalize: str = "truncate") -> list:
    """Per-process slice of the record list: records[pi::pc] (identity on a
    single process); pi and pc default to this rank and the world size.

    Every process must iterate the same number of batches, so shards are
    equalized: 'truncate' drops the ragged tail (training), 'pad' repeats
    the shard's last record flagged `_pad: True` so the loader can mask it
    out (validation)."""
    initialised = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if initialised else 0) if process_index is None \
        else process_index
    pc = (dist.get_world_size() if initialised else 1) \
        if process_count is None else process_count
    recs = list(records)[pi::pc]
    if pc == 1:
        return recs
    n = len(records)
    if equalize == "truncate":
        return recs[: n // pc]
    if equalize == "pad":
        target = -(-n // pc)
        while len(recs) < target:
            pad = dict(recs[-1])
            pad["_pad"] = True
            recs.append(pad)
        return recs
    raise ValueError(f"Unknown equalize mode {equalize!r}")


def _rank_device(device, rank: int) -> torch.device:
    from ..models import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)  # "cuda" in this rank is its card
    return dev


def create_mesh(data_axis: int = 0, model_axis: int = 1,
                device="cuda", ranks: Optional[int] = None
                ) -> Optional[ProcessGrid]:
    """This rank's ProcessGrid over the initialised default process group;
    every rank must call it (it creates the groups).  data_axis <= 0 means
    "all remaining ranks" (world // model_axis).  ``device``: "cpu", or a
    CUDA device ("cuda" picks card LOCAL_RANK, else rank, modulo the cards
    here, which becomes this process's current card).  ``ranks``: a grid
    over ranks [0, ranks) of a larger world (the
    training loop's shrunk data axis, as the JAX loop meshes the first
    devices); the ranks outside it get None."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("create_mesh needs an initialised process group "
                           "(initialize_multihost or parallel.run_grid)")
    world = dist.get_world_size()
    n = world if ranks is None else ranks
    if not 0 < n <= world:
        raise ValueError(f"a grid over {n} of {world} ranks")
    model = max(1, model_axis)
    data = n // model if data_axis <= 0 else data_axis
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} does not cover {n} devices")
    rank = dist.get_rank()
    d, m = divmod(rank, model)
    data_groups = [dist.new_group([i * model + j for i in range(data)])
                   for j in range(model)]
    model_groups = [dist.new_group([i * model + j for j in range(model)])
                    for i in range(data)]
    world_group = (dist.group.WORLD if n == world
                   else dist.new_group(list(range(n))))
    if rank >= n:
        return None
    return ProcessGrid(data=data, model=model, rank=rank, data_index=d,
                       model_index=m, data_group=data_groups[m],
                       model_group=model_groups[d], world_group=world_group,
                       device=_rank_device(device, rank))


def _rows(n: int, grid: ProcessGrid) -> slice:
    if n % grid.data:
        raise ValueError(f"{n} rows do not split over {grid.data} data "
                         f"ranks")
    per = n // grid.data
    return slice(grid.data_index * per, (grid.data_index + 1) * per)


def shard_batch(batch, grid: ProcessGrid):
    """This data rank's rows of a global batch: a tensor, an array, or a
    dict of them (contiguous blocks of rows, in data-index order)."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, grid) for k, v in batch.items()}
    return batch[_rows(batch.shape[0], grid)]


def host_local_rows(x) -> np.ndarray:
    """The rows this process holds, as numpy.  A rank holds only its own
    rows of a batch (``shard_batch``), so this is its local tensor on the
    host (in JAX, the process's shards of a global array)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _gather_objects(obj, group=None) -> list:
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def _concat(values: list):
    first = values[0]
    if isinstance(first, dict):
        return {k: _concat([v[k] for v in values]) for k in first}
    if isinstance(first, tuple):
        return tuple(_concat([v[i] for v in values])
                     for i in range(len(first)))
    return np.concatenate([np.asarray(v) for v in values], axis=0)


def allgather_host_values(tree):
    """All-gather a dict or tuple (or a leaf) of per-process numpy arrays
    over the world group; returns it with each leaf concatenated over
    ranks in rank order (identity on one process)."""
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return tree
    return _concat(_gather_objects(tree))


def gather_data_rows(tree, grid: ProcessGrid):
    """Every data rank's rows of a dict or tuple (or a leaf) of arrays, in
    data-index order, on every rank: the world gather of
    ``allgather_host_values`` keeping one rank per data index (the model
    ranks of a data index hold the same rows)."""
    if grid.size == 1:
        return tree
    values = _gather_objects(tree, grid.world_group)
    return _concat([values[d * grid.model] for d in range(grid.data)])
