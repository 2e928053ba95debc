"""Env-axis data parallelism over ``torch.distributed``: one process per
rank, each holding a slice of the envs (the port of ``tacex_tpu/parallel``)."""

from .group import EnvGroup, close_env_parallel, init_env_parallel  # noqa: F401
from .mesh import (  # noqa: F401
    all_gather_envs,
    all_reduce_sum,
    gather_env_state,
    mean_over_envs,
    shard_env_state,
    slice_envs,
)
