"""The process group of env-axis data parallelism.

The JAX package puts the env axis on a 1-D device mesh and lets XLA insert
the cross-env sums (``tacex_tpu/parallel/mesh.py``). The port runs one
process per rank instead, each holding ``num_envs // world_size`` envs of
the global batch: rank ``r`` holds the envs ``[r n, (r + 1) n)``. Every
quantity that spans envs is made global by hand (``parallel/mesh.py``).

Launch under ``torchrun --nproc_per_node K`` (which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``), or
pass ``init_method``, ``rank`` and ``world_size`` yourself. NCCL is the
backend for a CUDA device and gloo for the CPU, unless the caller names
another; no code switches backend or device when one fails.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import DEFAULT_DEVICE, resolve

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


@dataclasses.dataclass(frozen=True)
class EnvGroup:
    """One rank's view of the env axis: its rank, the world size, the global
    and the local env counts and its ``[start, stop)`` range of global envs.
    The collectives run on the default process group."""

    rank: int
    world_size: int
    num_envs: int
    local_envs: int
    start: int
    stop: int
    device: torch.device
    backend: str

    def for_envs(self, num_envs: int) -> "EnvGroup":
        """The same ranks over another global env count."""
        if num_envs % self.world_size != 0:
            raise ValueError(f"num_envs {num_envs} is not divisible by the world size {self.world_size}")
        n = num_envs // self.world_size
        return dataclasses.replace(self, num_envs=num_envs, local_envs=n, start=self.rank * n, stop=(self.rank + 1) * n)


def trainer_seeds(seed: int, group: EnvGroup | None = None) -> tuple[int, int | None, int]:
    """(env seed, exploration seed, shared seed) of a trainer on this rank.

    The shared seed is ``seed``'s alone and draws what every rank must
    draw alike (the network, PPO's permutations, SAC's batches and update
    noise); across ranks the env and exploration seeds come from ``(seed,
    rank)``. Without a group, or at world size 1, the exploration seed is
    None (exploration draws from the shared generator) and the seeds are
    the plain trainers', so a 1-rank run draws what the plain one draws."""
    s_env, s_shared = torch.randint(0, 2**62, (2,), generator=torch.Generator().manual_seed(seed)).tolist()
    if group is None or group.world_size == 1:
        return s_env, None, s_shared
    s_env, s_explore = (int(x) for x in np.random.SeedSequence((seed, group.rank)).generate_state(2, np.uint64) >> 2)
    return s_env, s_explore, s_shared


def init_env_parallel(
    num_envs: int,
    device=DEFAULT_DEVICE,
    backend: str | None = None,
    init_method: str | None = None,
    rank: int | None = None,
    world_size: int | None = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> EnvGroup:
    """Join the process group and return this rank's ``EnvGroup``.

    Without ``init_method`` the rank, world size, local rank and rendezvous
    come from torchrun's environment, and a missing variable raises; with
    it, the local rank is the rank (one host). A CUDA device becomes the
    card of the local rank (``torch.cuda.set_device``). One
    all-reduce is issued before returning, so the backend's communicator
    exists before the first step (NCCL builds it at its first collective).
    Raises unless ``world_size`` divides ``num_envs``."""
    if init_method is None:
        missing = [v for v in TORCHRUN_VARS if v not in os.environ]
        if missing:
            raise RuntimeError(
                f"env-parallel training needs torchrun's environment ({', '.join(missing)} unset): launch with "
                "`torchrun --nproc_per_node K scripts/train_torch.py --shard ...`, or pass init_method, rank and world_size"
            )
        rank, world_size, local_rank = (int(os.environ[v]) for v in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))
        init_method = "env://"
    elif rank is None or world_size is None:
        raise ValueError("an explicit init_method needs rank and world_size")
    else:
        local_rank = rank
    if num_envs % world_size != 0:
        raise ValueError(f"num_envs {num_envs} is not divisible by the world size {world_size}")
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed process group is already initialised in this process")
    dev = resolve(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size, timeout=timeout)
    warm = torch.zeros((1,), device=dev)
    dist.all_reduce(warm)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return EnvGroup(rank, world_size, 0, 0, 0, 0, dev, backend).for_envs(num_envs)


def close_env_parallel() -> None:
    """Leave the process group (a no-op when none is initialised)."""
    if dist.is_initialized():
        dist.destroy_process_group()
