"""Roll out a trained (or random) PPO policy of the PyTorch/CUDA port and
dump its vision observations.

The port's counterpart of ``scripts/play.py``: it restores the newest
``ckpt_<iteration>.pt`` that ``scripts/train_torch.py`` wrote into
``--checkpoint_dir``, acts deterministically (the policy's mean) for
``--steps`` steps on ``--device`` (the card by default; ``--device cpu`` runs
on the CPU), and prints the mean episode return and each ``Metric/`` log
averaged over the rollout. ``--save_frames DIR`` writes env 0's vision
observation of each step as a PNG (8x upsampled; several RGB images stacked
along the channels side by side). Like ``play.py`` it plays PPO policies
only: a SAC actor's checkpoint raises.

Usage:
  python scripts/play_torch.py --task TacEx-Ball-Rolling-Taxim-Fots-v0 \\
      --checkpoint_dir runs/br --steps 200 --save_frames runs/br/frames
"""

from __future__ import annotations

import argparse
import dataclasses
import re
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root, so the script runs from anywhere

UPSAMPLE = 8


def latest_checkpoint(checkpoint_dir: str | Path) -> tuple[Path, int]:
    """The newest ``ckpt_<iteration>.pt`` in ``checkpoint_dir`` and its
    iteration; raises ``FileNotFoundError`` if there is none."""
    found = [(int(m.group(1)), p) for p in Path(checkpoint_dir).glob("ckpt_*.pt")
             if (m := re.fullmatch(r"ckpt_(\d+)\.pt", p.name))]
    if not found:
        raise FileNotFoundError(f"no ckpt_<iteration>.pt in {checkpoint_dir}")
    it, path = max(found)
    return path, it


def restore_policy(net, path: Path, device) -> None:
    """Load the actor-critic ``state_dict`` at ``path`` into ``net``; a SAC
    actor's checkpoint raises ``ValueError``."""
    import torch

    state = torch.load(path, weights_only=True, map_location=device)
    if "mean.weight" in state and "mean_head.weight" not in state:
        raise ValueError(f"{path} holds a SAC actor; play_torch.py plays PPO policies only, as play.py does")
    net.load_state_dict(state)


def frame_image(vision: np.ndarray) -> np.ndarray:
    """Env 0's (h, w, c) vision observation as a uint8 RGB image: one channel
    scaled by its maximum and repeated, three as they are, 3k side by side;
    then 8x upsampled (``play.py``'s ``np.kron``)."""
    from tacex_tpu_torch.utils.png import to_uint8

    v = np.asarray(vision, np.float64)
    c = v.shape[-1]
    if c == 1:
        v = np.repeat(v, 3, -1) / max(v.max(), 1e-6)
    elif c % 3 == 0:
        v = np.concatenate([v[..., i:i + 3] for i in range(0, c, 3)], axis=1)
    else:
        raise ValueError(f"a vision observation of {c} channels is not an image")
    return to_uint8(np.kron(np.clip(v, 0, 1), np.ones((UPSAMPLE, UPSAMPLE, 1))))


def main(argv: list[str] | None = None) -> dict:
    """Play; returns the mean return, the mean ``Metric/`` logs, the restored
    checkpoint, the rollout's seconds (host clock to a synchronise, frames
    written included), and the first observation and action."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--task", default="TacEx-Ball-Rolling-Taxim-Fots-v0")
    p.add_argument("--num_envs", type=int, default=4)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--save_frames", default=None, help="dir for vision-obs PNGs (env 0)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    p.add_argument("--env_cfg", action="append", default=[], metavar="KEY=VALUE",
                   help="env cfg override (as train_torch.py's: evaluate at the training config)")
    args = p.parse_args(argv)

    import torch

    from tacex_tpu_torch import envs
    from tacex_tpu_torch.core.config import parse_overrides
    from tacex_tpu_torch.rl import PPO
    from tacex_tpu_torch.rl.agents import agent_cfg_for
    from tacex_tpu_torch.utils.png import write_png
    from tacex_tpu_torch.utils.profiling import synchronize

    overrides = parse_overrides(args.env_cfg)
    # staggering first-episode phases is a training-only behaviour (it
    # decorrelates resets across the batch); under evaluation it would cut
    # every env's first episode short, so it is off where the cfg has it
    if "stagger_initial_episodes" in {f.name for f in dataclasses.fields(envs.default_cfg(args.task))}:
        overrides.setdefault("stagger_initial_episodes", False)
    env = envs.make(args.task, num_envs=args.num_envs, device=args.device, **overrides)
    # the per-task tuned config (the one train_torch.py used), so the network matches the checkpoint
    ppo = PPO(env, agent_cfg_for(args.task, "ppo"))
    ppo.init(args.seed)
    checkpoint = None
    if args.checkpoint_dir:
        checkpoint, it = latest_checkpoint(args.checkpoint_dir)
        restore_policy(ppo.net, checkpoint, env.device)
        print(f"restored checkpoint step {it}")

    frames_dir = Path(args.save_frames) if args.save_frames else None
    if frames_dir:
        frames_dir.mkdir(parents=True, exist_ok=True)
    state, obs = ppo.env_state, ppo.obs
    first = None
    total_rew = torch.zeros(args.num_envs, device=env.device)
    metric_sums: dict = {}
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(args.steps):
            action = ppo.act(obs, deterministic=True)
            if first is None:
                first = {"obs": obs, "action": action}
            state, obs, reward, term, trunc, info = env.step(state, action)
            total_rew += reward
            for k, v in info.get("log", {}).items():
                if k.startswith("Metric/"):
                    metric_sums[k] = metric_sums.get(k, 0.0) + v
            if frames_dir and "vision_obs" in obs:
                write_png(frames_dir / f"frame_{i:04d}.png", frame_image(obs["vision_obs"][0].cpu().numpy()))
    synchronize(env.device)
    loop_s = time.perf_counter() - t0
    mean_return = float(total_rew.mean())
    metrics = {k: float(s) / args.steps for k, s in sorted(metric_sums.items())}
    print(f"mean episode return over {args.steps} steps: {mean_return:.2f}")
    for k, m in metrics.items():
        print(f"{k} (mean over rollout): {m:.4f}")
    return {"mean_return": mean_return, "metrics": metrics, "checkpoint": checkpoint, "loop_s": loop_s,
            "first_obs": first["obs"] if first else None, "first_action": first["action"] if first else None}


if __name__ == "__main__":
    main()
