"""Embedded-against-dense tactile accuracy in the coupled grasp world, on
the PyTorch/CUDA port.

The port's counterpart of ``embed_accuracy_grasp.py``. The tactile path
renders from a dense surface embedded in the coarse solve
(``physics/soft/embed.py``); this measures what that costs against a pad
whose solve is dense. Three single-env runs of the same scripted grasp
(squeeze for 30 steps, then hold and lift):

  A. coarse solve (2x4x4 cells a pad) + embedded 32x32 surface (the shipped path)
  B. dense solve (4x16x16 cells, 1445 vertices a pad), raw 17x17 inner grid (the truth)
  C. coarse solve, raw 5x5 inner grid (no embedding)

Every compression image is resized to the task's 32x32 (``jax.image.resize``'s
linear weights, ``ops/resize.py``) and compared step by step with B. Prints
one JSON line (and writes it to ``--out``).

Usage: python scripts/benchmarking/embed_accuracy_grasp_torch.py [--steps 60] [--out row.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root, so the script runs from anywhere


def _run(env, steps, squeeze_steps=30):
    import torch

    from tacex_tpu_torch.ops.resize import resize_linear
    from tacex_tpu_torch.utils.profiling import synchronize

    st, obs = env.reset_all(env.init_state())
    squeeze = torch.tensor([[1.0, 0.0]], device=env.device)
    hold = torch.tensor([[0.3, 1.0]], device=env.device)
    imgs, cube_z = [], []
    t0 = time.perf_counter()
    for i in range(steps):
        st, obs, r, te, tr, info = env.step(st, squeeze if i < squeeze_steps else hold)
        v = obs["vision_obs"]  # (1, gh, gw, 2) compression mm
        if tuple(v.shape[1:3]) != (32, 32):
            v = resize_linear(v, (1, 32, 32, 2))
        imgs.append(v[0].cpu().numpy())
        cube_z.append(float(info["cube_z"][0]))
    synchronize(env.device)
    return np.asarray(imgs), np.asarray(cube_z), time.perf_counter() - t0


def main(argv: list[str] | None = None) -> dict:
    """Run the three configurations; returns the line."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    from tacex_tpu_torch import envs

    common = dict(num_envs=1, obs_mode="depth", reset_xy_noise=0.0, stagger_initial_episodes=False,
                  episode_length_s=10.0)
    cfgs = {
        "A_coarse_embed32": dict(pad_resolution=(2, 4, 4), tactile_embed=(32, 32)),
        "B_dense_truth": dict(pad_resolution=(4, 16, 16), tactile_embed=None),
        "C_coarse_raw": dict(pad_resolution=(2, 4, 4), tactile_embed=None),
    }
    out = {}
    for name, kw in cfgs.items():
        env = envs.make("TacEx-Grasp-Lift-Uipc-v0", device=args.device, **common, **kw)
        imgs, cz, dt = _run(env, args.steps)
        out[name] = {"imgs": imgs, "cube_z": cz, "s_per_step": dt / args.steps}

    truth = out["B_dense_truth"]["imgs"]
    contact = truth.max(axis=(1, 2, 3)) > 0.05  # the steps with real contact
    row = {"metric": "embed_tactile_accuracy[grasp_lift]", "steps": int(contact.sum())}
    for name in ("A_coarse_embed32", "C_coarse_raw"):
        err = np.abs(out[name]["imgs"] - truth)[contact]
        scale = np.abs(truth[contact]).max()
        row[name] = {
            "mae_mm": round(float(err.mean()), 4),
            "max_mm": round(float(err.max()), 4),
            "rel_max": round(float(err.max() / max(scale, 1e-9)), 4),
            "cube_z_final_mm": round(out[name]["cube_z"][-1] * 1e3, 2),
            "s_per_step": round(out[name]["s_per_step"], 4),
        }
    row["truth_peak_compression_mm"] = round(float(np.abs(truth).max()), 3)
    row["B_s_per_step"] = round(out["B_dense_truth"]["s_per_step"], 4)
    row["B_cube_z_final_mm"] = round(out["B_dense_truth"]["cube_z"][-1] * 1e3, 2)
    print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(row, indent=1) + "\n")
    return row


if __name__ == "__main__":
    main()
