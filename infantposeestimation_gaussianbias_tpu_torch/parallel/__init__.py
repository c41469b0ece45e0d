"""Process grids for the port: mesh (the ProcessGrid and its helpers) and
launch (``run_grid``, ranks as spawned processes)."""

from .launch import run_grid
from .mesh import (ProcessGrid, allgather_host_values, check_backend,
                   create_mesh, gather_data_rows, host_local_rows,
                   initialize_multihost, maybe_initialize_multihost,
                   process_shard, shard_batch)

__all__ = [
    "ProcessGrid",
    "allgather_host_values",
    "check_backend",
    "create_mesh",
    "gather_data_rows",
    "host_local_rows",
    "initialize_multihost",
    "maybe_initialize_multihost",
    "process_shard",
    "run_grid",
    "shard_batch",
]
