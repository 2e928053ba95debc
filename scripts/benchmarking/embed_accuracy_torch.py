"""Embedded-surface accuracy on the PyTorch/CUDA port: a coarse solve with
a dense embedded surface against a truly dense solve.

The port's counterpart of ``embed_accuracy.py``. The tactile Grasp-Lift env
solves its pads at ``pad_resolution=(2,4,4)`` (75 vertices a pad) and
renders from a 32x32 surface embedded in the coarse inner face
(``physics/soft/embed.py``). This script runs the same deterministic
squeeze-then-lift with the same 32x32 embedded sampling while only the
solve's resolution changes, (2,4,4) [the shipped one], (2,8,8) and
(2,12,12), and reports

  * each pad's compression-image error (mm) against the finest solve,
  * the tactile RGB error at the task resolution (in /255) against it,
  * env-steps/s of each configuration (host clock, synchronised).

Prints one JSON line a configuration (``device``: the card's name and power
limit, or ``cpu``) and a summary line.

Usage: python scripts/benchmarking/embed_accuracy_torch.py [--envs 4] [--steps 40] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root, so the script runs from anywhere


def rollout(pad_resolution, n_envs, steps, device="cuda"):
    import torch

    from tacex_tpu_torch.envs.grasp_lift.env import GraspLiftEnv, GraspLiftEnvCfg
    from tacex_tpu_torch.utils.profiling import synchronize

    cfg = GraspLiftEnvCfg(
        num_envs=n_envs,
        obs_mode="tactile",
        tactile_embed=(32, 32),
        pad_resolution=tuple(pad_resolution),
        stagger_initial_episodes=False,
        reset_xy_noise=0.0,  # the same initial cube pose in every configuration
        episode_length_s=10.0,
    )
    env = GraspLiftEnv(cfg, device=device)
    state, _ = env.reset_all(env.init_state())

    # the same squeeze-then-lift script for every configuration
    acts = np.zeros((steps, n_envs, 2), np.float32)
    acts[:, :, 0] = 0.8  # squeeze throughout
    acts[10:, :, 1] = 0.7  # lift once contact is set
    acts = torch.as_tensor(acts, device=env.device)

    state = env.step(state, acts[0])[0]
    synchronize(env.device)
    imgs, comps = [], []
    t0 = time.perf_counter()
    for i in range(1, steps):
        state, obs, *_ = env.step(state, acts[i])
        if i % 10 == 0 or i == steps - 1:
            imgs.append(obs["vision_obs"].cpu().numpy())  # (N, 32, 32, 6)
            comps.append(env._pad_compression(state.gel.x, state.squeeze).cpu().numpy())  # (N, 2, 32, 32) mm
    synchronize(env.device)
    dt = time.perf_counter() - t0
    return {
        "imgs": np.stack(imgs),
        "comps": np.stack(comps),
        "env_steps_per_s": round(n_envs * (steps - 1) / dt, 1),
        "ms_per_step": round(1e3 * dt / (steps - 1), 2),
        "verts": int(env.gel.mesh.points.shape[0]),
        "device": env.device,
    }


def main(argv: list[str] | None = None) -> dict:
    """Run the three solves; returns the summary line."""
    from tacex_tpu_torch.utils.profiling import device_label

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--envs", type=int, default=4)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    resolutions = [(2, 4, 4), (2, 8, 8), (2, 12, 12)]
    runs = {}
    for r in resolutions:
        runs[r] = rollout(r, args.envs, args.steps, args.device)
        print(json.dumps({
            "pad_resolution": list(r),
            "env_steps_per_s": runs[r]["env_steps_per_s"],
            "ms_per_step": runs[r]["ms_per_step"],
            "device": device_label(runs[r]["device"]),
        }), flush=True)

    ref = runs[resolutions[-1]]
    summary = {"metric": "embed_accuracy_vs_true_dense", "ref": list(resolutions[-1])}
    for r in resolutions[:-1]:
        d_img = np.abs(runs[r]["imgs"] - ref["imgs"]) * 255.0
        d_cmp = np.abs(runs[r]["comps"] - ref["comps"])
        summary[str(r)] = {
            "rgb_err_255_mean": round(float(d_img.mean()), 3),
            "rgb_err_255_p99": round(float(np.percentile(d_img, 99)), 2),
            "rgb_err_255_max": round(float(d_img.max()), 2),
            "comp_err_mm_mean": round(float(d_cmp.mean()), 4),
            "comp_err_mm_max": round(float(d_cmp.max()), 4),
            "speedup_vs_ref": round(runs[r]["env_steps_per_s"] / ref["env_steps_per_s"], 2),
        }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
