#!/usr/bin/env python3
"""Where one PPO iteration of the PyTorch/CUDA port spends its time, on one NVIDIA GPU.

    python3 scripts/benchmarking/torch_train_probe.py [--task ID] [--num_envs N] [--rollouts T] [--top K]

It builds the task's env and its tuned ``PPO`` trainer on the card, runs one
warm-up ``train_step``, one timed with the host's clock (each of the
rollout, GAE and update spans ends in a synchronise), then one under
``torch.profiler`` (CPU and CUDA activities) with the same spans marked. It
prints, for the iteration and for each span: the untraced wall time, the
wall time under the profiler (which slows the host), the device time of the
kernels launched inside, that time's share of the untraced wall time (the
rest is the device waiting for the host), and the number of kernels; then
the kernels that took the most device time. It imports nothing of JAX, and
exits non-zero without a CUDA device or if the profiler saw no device time.
``--rollouts`` cuts the tuned rollout length (a Factory step launches ~10^4
kernels, so its 128-step rollout is long to trace); the per-step line
divides the rollout span by it.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

SPANS = ("rollout", "gae", "update")


def _marked(fn, name, wall: dict):
    """``fn`` as a profiler span that ends in a synchronise; its host wall
    time is added to ``wall[name]``."""
    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        with record_function(f"ppo.{name}"):
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
        wall[name] = wall.get(name, 0.0) + time.perf_counter() - t0
        return out

    return wrapped


def _launches(event) -> int:
    return len(event.kernels) + sum(_launches(child) for child in event.cpu_children)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--task", default="TacEx-Ball-Rolling-Taxim-Fots-v0")
    p.add_argument("--num_envs", type=int, default=4096)
    p.add_argument("--rollouts", type=int, default=None, help="override the task's tuned rollout length")
    p.add_argument("--top", type=int, default=12, help="how many kernels to list")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_train_probe: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from tacex_tpu_torch import envs
    from tacex_tpu_torch.rl import PPO
    from tacex_tpu_torch.rl.agents import agent_cfg_for

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    cfg = agent_cfg_for(args.task, "ppo", rollouts=args.rollouts)
    ppo = PPO(envs.make(args.task, num_envs=args.num_envs), cfg)
    ppo.init(0)
    wall: dict[str, float] = {}
    for name in SPANS:
        setattr(ppo, name, _marked(getattr(ppo, name), name, wall))
    step = _marked(ppo.train_step, "train_step", wall)
    step()
    wall.clear()
    step()
    untraced = dict(wall)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()

    # the profiler also lists the spans themselves as device ranges
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("ppo.")]
    if not kernels or sum(e.device_time for e in kernels) == 0:
        raise SystemExit("torch_train_probe: the profiler saw no device time")
    spans = {e.name: e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("ppo.")}
    print(f"{args.task}, {args.num_envs} envs, rollouts {cfg.rollouts}, {cfg.learning_epochs} epochs x "
          f"{cfg.mini_batches} minibatches")
    print(f"{'span':<12}{'wall s':>9}{'traced s':>10}{'device s':>10}{'busy %':>8}{'kernels':>9}")
    for name in ("train_step",) + SPANS:
        # a kernel belongs to the span whose host range launched it: the
        # profiler links each launch to its kernel and sums them up the tree
        span = spans[f"ppo.{name}"]
        busy = span.device_time_total / 1e6
        print(f"{name:<12}{untraced[name]:>9.3f}{span.cpu_time_total / 1e6:>10.3f}{busy:>10.3f}"
              f"{100 * busy / untraced[name]:>8.1f}{_launches(span):>9d}")
    roll = spans["ppo.rollout"]
    print(f"per rollout step (policy sample + env step): {1e3 * untraced['rollout'] / cfg.rollouts:.3f} ms wall, "
          f"{1e3 * roll.device_time_total / 1e6 / cfg.rollouts:.3f} ms device, "
          f"{_launches(roll) / cfg.rollouts:.1f} kernels")

    by_name: dict[str, list] = {}
    for k in kernels:
        by_name.setdefault(k.name, []).append(k.device_time)
    total = sum(sum(v) for v in by_name.values())
    print(f"kernels by device time ({len(by_name)} names, {len(kernels)} launches, {total / 1e6:.3f} s in all):")
    for name, times in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[: args.top]:
        print(f"  {sum(times) / 1e3:>9.2f} ms {100 * sum(times) / total:>5.1f}% {len(times):>7d} x {name[:110]}")


if __name__ == "__main__":
    main()
