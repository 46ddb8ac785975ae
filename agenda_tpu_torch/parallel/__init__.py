"""Multi-card runs: the process-group mesh and the ``--fsdp`` block runs."""

from agenda_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_objects,
    all_reduce_sum_,
    barrier,
    batch_mean,
    batch_split,
    draw_rows,
    global_rows,
    global_sum,
    make_mesh,
    param_sharding_rules,
    replicate,
    shard_batch,
    split_mesh,
)

__all__ = [
    "Mesh",
    "all_gather_objects",
    "all_reduce_sum_",
    "barrier",
    "batch_mean",
    "batch_split",
    "draw_rows",
    "global_rows",
    "global_sum",
    "make_mesh",
    "param_sharding_rules",
    "replicate",
    "shard_batch",
    "split_mesh",
]
