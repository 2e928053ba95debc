"""One sharded PPO train step over n processes: the port's counterpart of
``__graft_entry__.dryrun_multichip``.

    python -m tacex_tpu_torch.parallel.dryrun --nproc 2 --device cpu

spawns ``--nproc`` ranks (gloo on the CPU; NCCL with ``--device cuda``, one
card a rank), each holding 2 of the ``2 n`` envs of the flagship, and runs
one ``PPO.train_step`` under ``PPOConfig(rollouts=2, mini_batches=2,
learning_epochs=1, hidden=(16,))``. Every rank asserts a finite loss and
``steps == 2 * num_envs``; rank 0 prints one line.
"""

from __future__ import annotations

import argparse
import datetime
import math
import sys
import tempfile
import time
from pathlib import Path

ENV_ID = "TacEx-Ball-Rolling-Taxim-Fots-v0"
JOIN_TIMEOUT_S = 300


def train_step_on(group) -> tuple[float, int]:
    """The dryrun's PPO train step on this rank of ``group`` (2 envs a rank):
    (loss, global env steps), after asserting both."""
    from .. import envs
    from ..rl import PPO, PPOConfig

    num_envs = 2 * group.world_size
    group = group.for_envs(num_envs)
    env = envs.make(ENV_ID, num_envs=group.local_envs, device=group.device)
    ppo = PPO(env, PPOConfig(rollouts=2, mini_batches=2, learning_epochs=1, hidden=(16,)), group=group)
    ppo.init(0)
    loss = float(ppo.train_step()["loss"])
    assert math.isfinite(loss), f"rank {group.rank}: loss {loss}"
    assert ppo.steps == 2 * num_envs, f"rank {group.rank}: {ppo.steps} env steps, expected {2 * num_envs}"
    return loss, ppo.steps


def _rank(rank: int, nproc: int, device: str, init_file: str, timeout_s: float) -> None:
    import torch

    from .group import close_env_parallel, init_env_parallel

    torch.set_num_threads(1)
    group = init_env_parallel(2 * nproc, device, init_method=f"file://{init_file}", rank=rank, world_size=nproc,
                              timeout=datetime.timedelta(seconds=timeout_s))
    try:
        loss, steps = train_step_on(group)
        if rank == 0:
            print(f"dryrun OK on {nproc} ranks ({group.backend}, {group.device.type}): full PPO train step ran, "
                  f"loss={loss:.4f}, env_steps={steps}", flush=True)
    finally:
        close_env_parallel()


def start_ranks(fn, nproc: int, args: tuple = ()):
    """``fn(rank, *args)`` in ``nproc`` spawned processes; returns their
    context for ``join_ranks`` (the caller may work meanwhile)."""
    import torch.multiprocessing as mp

    return mp.start_processes(fn, args=args, nprocs=nproc, join=False, start_method="spawn")


def join_ranks(ctx, timeout_s: float = JOIN_TIMEOUT_S) -> None:
    """Wait for the ranks of ``start_ranks``: raises if one failed, and kills
    them all and raises if they have not finished within ``timeout_s`` (a
    hung collective fails instead of waiting)."""
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"{len(ctx.processes)} ranks did not finish within {timeout_s} s")


def run(nproc: int, device: str = "cpu", timeout_s: float = 60.0) -> None:
    """Spawn the ranks and wait for them (``timeout_s`` is each collective's)."""
    with tempfile.TemporaryDirectory() as tmp:
        join_ranks(start_ranks(_rank, nproc, (nproc, device, str(Path(tmp) / "pg"), timeout_s)))


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--device", default="cpu", help="cpu (gloo) or cuda (NCCL, one card a rank)")
    args = p.parse_args(argv)
    run(args.nproc, args.device)


if __name__ == "__main__":
    sys.exit(main())
