"""Process grids for the port: mesh (the ProcessGrid and its helpers),
tensor (tensor parallelism over the grid's model axis) and launch
(``run_grid``, ranks as spawned processes)."""

from .launch import run_grid
from .mesh import (ProcessGrid, allgather_host_values, check_backend,
                   create_mesh, gather_data_rows, host_local_rows,
                   initialize_multihost, maybe_initialize_multihost,
                   process_shard, shard_batch)
from .tensor import (full_state_dict, param_sharding_rules, shard_params,
                     shard_state_dict, sharded_parameters, sharding_table)

__all__ = [
    "ProcessGrid",
    "allgather_host_values",
    "check_backend",
    "create_mesh",
    "full_state_dict",
    "gather_data_rows",
    "host_local_rows",
    "initialize_multihost",
    "maybe_initialize_multihost",
    "param_sharding_rules",
    "process_shard",
    "run_grid",
    "shard_batch",
    "shard_params",
    "shard_state_dict",
    "sharded_parameters",
    "sharding_table",
]
