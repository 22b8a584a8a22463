from .mesh import (
    Mesh,
    all_reduce_sum,
    data_parallel,
    gather,
    make_mesh,
    parallel_apply,
    reduce_max,
    replica_context,
    replicate,
    shard_batch,
)
from .pipeline import pad_moving_plans, render_mixture_sources

__all__ = [
    "Mesh",
    "all_reduce_sum",
    "data_parallel",
    "gather",
    "make_mesh",
    "pad_moving_plans",
    "parallel_apply",
    "reduce_max",
    "render_mixture_sources",
    "replica_context",
    "replicate",
    "shard_batch",
]
