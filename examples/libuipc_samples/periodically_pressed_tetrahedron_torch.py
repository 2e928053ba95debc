"""Periodically pressed tetrahedron on the PyTorch/CUDA port: an animated
soft position constraint presses a soft tet's apex up and down.

The port's counterpart of ``periodically_pressed_tetrahedron.py`` (a soft
tet resting on the ground, its apex driven by aim = rest - sin(pi t) * 5 cm
along the vertical, 2 envs, 120 steps at dt 0.02, friction ratio 0.1), on
``--device`` (the card by default; ``--device cpu`` runs on the CPU). Prints
the apex height every 20 steps; after the full run it checks that the tet
stayed above the ground and the apex oscillated and came back up.

Usage: python examples/libuipc_samples/periodically_pressed_tetrahedron_torch.py [--steps 120] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root, so the script runs from anywhere

NUM_ENVS = 2
DT = 0.02
STEPS = 120
POINTS = np.array([[0.0, 0.0, 0.12], [0.08, 0.0, 0.0], [-0.04, 0.06, 0.0], [-0.04, -0.06, 0.0]], np.float32)
TETS = np.array([[1, 0, 2, 3]], np.int32)


def build(device):
    import torch

    from tacex_tpu_torch.uipc import StableNeoHookeanCfg, UipcObject, UipcObjectCfg, UipcSim, UipcSimCfg

    sim = UipcSim(
        UipcSimCfg(num_envs=NUM_ENVS, dt=DT, enable_ground=True, contact=UipcSimCfg.Contact(default_friction_ratio=0.1)),
        device=device,
    )
    tet = UipcObject(UipcObjectCfg(constitution=StableNeoHookeanCfg(youngs_modulus=0.05)), sim, points=POINTS, tets=TETS)
    dev = sim.device
    rest_apex = torch.as_tensor(POINTS[0], device=dev).expand(NUM_ENVS, 1, 3)
    ez = torch.tensor([0.0, 0.0, 1.0], device=dev)
    frame = {"i": 0}

    def animate_apex():
        y = -np.sin(np.pi * frame["i"] * DT) * 0.05
        return rest_apex + float(y) * ez

    tet.set_attachments(np.array([0]), aim_provider=animate_apex, strength_ratio=100.0)
    sim.setup_sim()
    return sim, tet, frame


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sim, tet, frame = build(args.device)
    apex_hist, seconds = [], 0.0
    for i in range(args.steps):
        frame["i"] = i
        t0 = time.perf_counter()
        sim.step()
        seconds += time.perf_counter() - t0
        apex_hist.append(float(tet.nodal_pos_w[0, 0, 2]))
        if i % 20 == 0:
            print(f"step {i:3d}: apex z {apex_hist[-1]:.4f}")
    apex = np.asarray(apex_hist)
    x = tet.nodal_pos_w.cpu().numpy()
    if args.steps >= STEPS:
        assert x[..., 2].min() > -1e-4, "tet penetrated the ground"
        assert apex.max() - apex.min() > 0.02, (apex.min(), apex.max())
        assert apex[60:].max() > apex.min() + 0.015, "apex never recovered"
        print(f"pressed tet: apex oscillated over {apex.max() - apex.min():.3f} m")
    return {"x": x, "apex": apex, "ms_per_step": 1e3 * seconds / max(args.steps, 1)}


if __name__ == "__main__":
    main()
