"""Train PPO or SAC on a task of the PyTorch/CUDA port (``tacex_tpu_torch``).

The port's counterpart of ``scripts/train.py``: the env and the trainer run
on one CUDA device (``--device cpu`` runs them on the CPU). It prints one
JSON line per logged iteration, writes ``config.json`` and ``metrics.jsonl``
into the run folder (``--viz_dir``, else ``--checkpoint_dir``) and saves the
policy's ``state_dict`` into ``--checkpoint_dir`` as ``ckpt_<iteration>.pt``
with ``torch.save`` (PPO's actor-critic, SAC's actor; the last three
checkpoints are kept; ``scripts/play_torch.py`` plays PPO's back).
``--viz_dir`` also gets the dashboard ``metrics.png`` (``metrics_panels.txt``
names its panels) and the strip of env 0's vision observations
``tactile_obs_strip.png``, every ``--viz_interval`` iterations and at the end.
``--rollouts`` sets PPO's rollout length or SAC's env steps per iteration.

``--shard`` trains one slice of the envs per process (env-axis data
parallelism, ``tacex_tpu_torch/parallel``): launch it with ``torchrun
--nproc_per_node K``, one rank a card (NCCL; gloo with ``--device cpu``).
``--num_envs`` counts every rank's envs and must be a multiple of K. Rank 0
alone prints, writes the run folder, saves checkpoints and draws the
dashboard; ``env_steps`` and ``steps_per_sec`` count every rank's envs.

Usage:
  python scripts/train_torch.py --task TacEx-Ball-Rolling-Taxim-Fots-v0 \\
      --num_envs 4096 --iterations 200 --checkpoint_dir runs/br
  python scripts/train_torch.py --task TacEx-Ball-Rolling-Privileged-v0 \\
      --algorithm sac --num_envs 512 --iterations 4000
  torchrun --nproc_per_node 8 scripts/train_torch.py --shard --num_envs 32768 --iterations 200
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root, so the script runs from anywhere

KEEP_CHECKPOINTS = 3


def _grab_tactile_frame(viz, obs) -> None:
    """Env 0's vision observation, min-max normalised to [0, 1] as one RGB
    frame (its first three channels, or its first repeated), into the
    ``tactile_obs`` strip; a read-back of one image."""
    v = obs.get("vision_obs") if isinstance(obs, dict) else None
    if v is None:
        return
    f = v[0].detach().double().cpu().numpy()  # (h, w, c)
    f = f[..., :3] if f.shape[-1] >= 3 else f[..., :1].repeat(3, -1)
    lo, hi = f.min(), f.max()
    viz.add_frame("tactile_obs", (f - lo) / max(hi - lo, 1e-6))


def main(argv: list[str] | None = None):
    """Train; returns the trainer (``PPO`` or ``SAC``)."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--task", default="TacEx-Ball-Rolling-Taxim-Fots-v0")
    p.add_argument("--algorithm", choices=["ppo", "sac"], default="ppo")
    p.add_argument("--num_envs", type=int, default=1024)
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument("--rollouts", type=int, default=None, help="override the per-task tuned rollout length (rl/agents.py)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    p.add_argument("--shard", action="store_true",
                   help="one env slice per torchrun rank (NCCL on the cards, gloo with --device cpu)")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--checkpoint_interval", type=int, default=50)
    p.add_argument("--log_interval", type=int, default=1)
    p.add_argument("--viz_dir", default=None, help="write metric plots and a vision-obs strip (LiveVisualizer)")
    p.add_argument("--viz_interval", type=int, default=50,
                   help="refresh the metrics png + tactile-obs frame strip every N iterations")
    p.add_argument("--env_cfg", action="append", default=[], metavar="KEY=VALUE",
                   help="env config override, e.g. --env_cfg episode_length_s=6.0 (repeatable; Python literals)")
    p.add_argument("--agent_cfg", action="append", default=[], metavar="KEY=VALUE",
                   help="agent config override on top of the per-task tuned values, e.g. --agent_cfg lr_max=1e-3")
    args = p.parse_args(argv)

    group, device = None, args.device
    if args.shard:
        from tacex_tpu_torch.parallel import close_env_parallel, init_env_parallel

        group = init_env_parallel(args.num_envs, device)
        device = group.device
    try:
        return _train(args, group, device)
    finally:
        if group is not None:
            close_env_parallel()


def _train(args, group, device):
    import torch

    from tacex_tpu_torch import envs
    from tacex_tpu_torch.core.config import parse_overrides
    from tacex_tpu_torch.rl import PPO, SAC
    from tacex_tpu_torch.rl.agents import agent_cfg_for
    from tacex_tpu_torch.utils import LiveVisualizer

    lead = group is None or group.rank == 0  # the rank that prints and writes
    say = print if lead else (lambda *a, **k: None)
    env_overrides = parse_overrides(args.env_cfg)
    local_envs = args.num_envs if group is None else group.local_envs
    env = envs.make(args.task, num_envs=local_envs, device=device, **env_overrides)
    if args.algorithm == "sac":
        cfg = agent_cfg_for(args.task, "sac", rollout_steps=args.rollouts, **parse_overrides(args.agent_cfg))
        trainer, steps_per_iter = SAC(env, cfg, group=group), args.num_envs * cfg.rollout_steps
    else:
        cfg = agent_cfg_for(args.task, "ppo", rollouts=args.rollouts, **parse_overrides(args.agent_cfg))
        trainer, steps_per_iter = PPO(env, cfg, group=group), args.num_envs * cfg.rollouts
    say(f"agent cfg ({args.algorithm}): {cfg}")
    if group is not None:
        say(f"sharded over {group.world_size} ranks ({group.backend}): {group.local_envs} envs a rank")
    trainer.init(args.seed)
    policy = trainer.actor if args.algorithm == "sac" else trainer.net

    ckpt_dir = Path(args.checkpoint_dir).absolute() if args.checkpoint_dir else None
    run_dir = Path(args.viz_dir).absolute() if args.viz_dir else ckpt_dir
    if not lead:
        ckpt_dir = run_dir = None
    metrics_fp = None
    if run_dir is not None:
        run_dir.mkdir(parents=True, exist_ok=True)
        # reproducibility record: the exact launch config of this run
        with open(run_dir / "config.json", "w") as f:
            json.dump({"argv": vars(args), "env_overrides": env_overrides, "agent_cfg": str(cfg)}, f, indent=1, default=str)
        metrics_fp = open(run_dir / "metrics.jsonl", "a")
    if ckpt_dir is not None:
        ckpt_dir.mkdir(parents=True, exist_ok=True)
    viz = LiveVisualizer(args.viz_dir) if args.viz_dir and lead else None

    saved: list[Path] = []
    t_start = time.time()
    try:
        for it in range(args.iterations):
            t0 = time.time()
            metrics = trainer.train_step()
            # the iteration's one read-back, outside train_step; it waits for the device
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            if it % args.log_interval == 0:
                line = {
                    "iter": it,
                    "env_steps": trainer.steps,
                    "steps_per_sec": round(steps_per_iter / dt, 1),
                    **{k: round(v, 5) for k, v in metrics.items()},
                }
                say(json.dumps(line), flush=True)
                if metrics_fp is not None:
                    metrics_fp.write(json.dumps(line) + "\n")
                    metrics_fp.flush()
            if viz is not None:
                viz.add_scalars(trainer.steps, metrics)
                if (it + 1) % args.viz_interval == 0 or it + 1 == args.iterations:
                    _grab_tactile_frame(viz, getattr(trainer, "obs", None))
                    viz.save_plots()
                    viz.save_frame_strip("tactile_obs")
            if ckpt_dir is not None and (it + 1) % args.checkpoint_interval == 0:
                path = ckpt_dir / f"ckpt_{it}.pt"
                torch.save(policy.state_dict(), path)
                saved.append(path)
                for old in saved[:-KEEP_CHECKPOINTS]:
                    old.unlink(missing_ok=True)
                del saved[:-KEEP_CHECKPOINTS]
    finally:
        if metrics_fp is not None:
            metrics_fp.close()
    if viz is not None:
        say(f"metric plots -> {viz.save_plots()}")
    if metrics_fp is not None:
        say(f"metrics jsonl -> {run_dir / 'metrics.jsonl'}")
    say(f"done: {trainer.steps} env steps in {time.time() - t_start:.1f}s")
    return trainer


if __name__ == "__main__":
    main()
