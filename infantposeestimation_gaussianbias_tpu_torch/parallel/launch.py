"""``run_grid``: run a function on every rank of a (data, model) grid.

PyTorch needs a process per rank to have a mesh (the JAX package, single
controller, has no counterpart).  ``run_grid`` spawns ``data * model``
processes with ``torch.multiprocessing`` ("spawn": each child imports the
function by name, so it lives in an importable module; the function and
its arguments go to the children through a file, since a spawn blocks
until its child has read its arguments from a pipe), initialises them
through a FileStore in a temporary directory (no port to race for when
several callers run side by side), builds each rank's ProcessGrid and
calls ``fn(grid, *args)``.  It returns the ranks' results, which must
pickle, in rank order.  A rank that raises fails the call (the others are
stopped), and so does a call that outlasts ``timeout`` seconds; the
collectives time out after ``timeout`` too.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from datetime import timedelta
from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import check_backend, create_mesh


def _rank_main(rank: int, data: int, model: int, backend: str, device: str,
               root: str, timeout: float) -> None:
    if device == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    with open(os.path.join(root, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    dist.init_process_group(backend, init_method=f"file://{root}/store",
                            rank=rank, world_size=data * model,
                            timeout=timedelta(seconds=timeout))
    try:
        result = fn(create_mesh(data, model, device), *args)
        with open(os.path.join(root, f"result{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def run_grid(fn: Callable, data_axis: int, model_axis: int, backend: str,
             device: str = "cuda", args: Sequence = (),
             timeout: float = 600.0) -> list:
    """``fn(grid, *args)`` on each of ``data_axis * model_axis`` ranks, each
    a spawned process; returns the results in rank order.  ``backend``:
    "gloo" or "nccl" (a card per rank); ``device``: "cuda" (the default;
    raises without CUDA) or "cpu"."""
    from ..models import resolve_device

    world = data_axis * model_axis
    if data_axis <= 0 or model_axis <= 0:
        raise ValueError(f"grid {data_axis}x{model_axis} has no ranks")
    resolve_device(device)
    check_backend(backend, world)
    with tempfile.TemporaryDirectory(prefix="ipe_grid_") as root:
        with open(os.path.join(root, "call.pkl"), "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        ctx = mp.start_processes(
            _rank_main, args=(data_axis, model_axis, backend, str(device),
                              root, timeout),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(f"run_grid: {world} ranks still running "
                                   f"after {timeout} s")
        results = []
        for rank in range(world):
            with open(os.path.join(root, f"result{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
