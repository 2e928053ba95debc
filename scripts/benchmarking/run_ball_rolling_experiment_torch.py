"""Ball-rolling tactile-sim performance experiment on the PyTorch/CUDA port.

The port's counterpart of ``run_ball_rolling_experiment.py`` (the reference
harness's replica): drive the ball-rolling scene through the same scripted
motion (press, then circle), time the physics-only step and the full step,
count the in-contact frames (indentation_depth > 0) and print a JSON report.

Env variants:
  * ``rigid``         - compliant-rigid gel pad + Taxim + FOTS
                        (``TacEx-Ball-Rolling-Taxim-Fots-v0``)
  * ``uipc``          - the FEM soft gel pad, batched
                        (``TacEx-Ball-Rolling-Tactile-RGB-Uipc-v0``)
  * ``uipc_textured`` - the FEM gel pad filmed with its marker texture
                        (``TacEx-Ball-Rolling-Uipc-Textured-v0``)

Each step is timed twice from the same pre-step state: ``step_physics_only``
(IK, servo, contact and the FEM solve, no tactile stage; its result is
dropped) and the full ``step``. Each call is ended by
``torch.cuda.synchronize()`` and timed on the host clock; the tactile stage
is the difference. The run is on one CUDA device unless ``--device cpu``.

Usage: python scripts/benchmarking/run_ball_rolling_experiment_torch.py \\
           --env uipc --num_envs 16 --steps 20 --out logs/report.json
"""

from __future__ import annotations

import argparse
import json
import platform
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root, so the script runs from anywhere

ENV_IDS = {
    "rigid": "TacEx-Ball-Rolling-Taxim-Fots-v0",
    "uipc": "TacEx-Ball-Rolling-Tactile-RGB-Uipc-v0",
    "uipc_textured": "TacEx-Ball-Rolling-Uipc-Textured-v0",
}


def motion_pattern(step: int) -> np.ndarray:
    """Press then circle: the reference experiment's scripted action."""
    t = step * 0.05
    press = -0.25 if step < 12 else -0.02
    dx = 0.25 * np.cos(t) * (step >= 12)
    dy = 0.25 * np.sin(t) * (step >= 12)
    return np.array([dx, dy, press, 0.0, 0.0, 0.0], np.float32)


def _card(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"name": platform.processor() or platform.machine(), "nvidia_smi": None}
    from tacex_tpu_torch.utils.profiling import device_label

    return {"name": torch.cuda.get_device_name(device), "nvidia_smi": device_label(device)}


def run(env_variant: str, num_envs: int, steps: int, device="cuda") -> dict:
    from tacex_tpu_torch import envs

    env_id = ENV_IDS[env_variant]
    env = envs.make(env_id, num_envs=num_envs, device=device)
    dev = env.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    width = env.cfg.action_space
    actions = torch.from_numpy(np.stack([motion_pattern(i)[:width] for i in range(steps)])).to(dev)
    actions = actions[:, None, :].expand(steps, num_envs, width)

    state, _ = env.reset_all(env.init_state())
    # warm-up: the first call of each op sets up its library and kernels
    env.step_physics_only(state, actions[0])
    state, *_ = env.step(state, actions[0])
    sync()

    contact = torch.zeros((), dtype=torch.int64, device=dev)
    phys, full = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        env.step_physics_only(state, actions[i])  # the same physics from the same state, dropped
        sync()
        phys.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        state, obs, reward, term, trunc, info = env.step(state, actions[i])
        sync()
        full.append(time.perf_counter() - t0)
        contact += (info["indentation_depth"] > 0).sum()
    in_contact = int(contact)
    if not bool(torch.isfinite(reward).all()):
        raise AssertionError(f"{env_id}: the reward is not finite")

    frames = steps * num_envs
    t_full = sum(full)
    phys_ms, full_ms = 1e3 * sum(phys) / steps, 1e3 * t_full / steps
    tact_ms = max(full_ms - phys_ms, 0.0)
    # the reference normalises the tactile time by the in-contact frames:
    # a frame without contact renders a trivial background image there
    contact_steps = max(in_contact / num_envs, 1e-9)
    return {
        "env_variant": env_variant,
        "env_id": env_id,
        "num_envs": num_envs,
        "steps": steps,
        "total_frames": frames,
        "in_contact_frames": in_contact,
        "avg_ms_per_step": full_ms,
        "avg_physics_ms_per_step": phys_ms,
        "avg_tactile_ms_per_step": tact_ms,
        "avg_tactile_ms_per_in_contact_step": tact_ms * steps / contact_steps,
        # medians: robust to the host's spread; the tactile one is the median
        # of each step's full-minus-physics difference
        "median_ms_per_step": 1e3 * float(np.median(full)),
        "median_physics_ms_per_step": 1e3 * float(np.median(phys)),
        "median_tactile_ms_per_step": 1e3 * float(np.median(np.subtract(full, phys))),
        "frames_per_sec": frames / t_full,
        "timing": "host clock around calls ended by torch.cuda.synchronize(), after one warm-up step",
        "system": {
            "platform": platform.platform(),
            "python": platform.python_version(),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device": str(dev),
            "card": _card(dev),
        },
    }


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--env", choices=sorted(ENV_IDS), default="rigid")
    p.add_argument("--num_envs", type=int, default=256)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    report = run(args.env, args.num_envs, args.steps, args.device)
    print(json.dumps(report, indent=2))
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
