"""Bunny cloth on the PyTorch/CUDA port: a NeoHookeanShell cloth drapes
over a fixed affine body.

The port's counterpart of ``bunny_cloth.py`` (libuipc's bunny-cloth
sample): a 16 x 16 cloth of 0.4 m (NeoHookeanShell 10 kPa, nu 0.3,
thickness 1 mm, density 200, DiscreteShellBending E = 10) falls from 0.3 m
onto a kinematic affine icosphere of radius 0.1 m standing in for the
bunny, 1 env, 120 steps at dt 1/100 over the ground, then
``check_health``. A lone cloth over kinematic bodies keeps its standalone
``ShellModel`` solve, the body its static triangle soup. Runs on
``--device`` (the card by default; ``--device cpu`` runs on the CPU).
After the full run it checks that the cloth stayed above the ground and
outside the body, rests on top of it and drapes more than 5 cm.

Usage: python examples/libuipc_samples/bunny_cloth_torch.py [--steps 120] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root, so the script runs from anywhere

STEPS = 120
CENTER = np.array([0.0, 0.0, 0.1])  # the body's centre


def build(device, cfg=None):
    """(sim, cloth) of the scene; ``cfg`` replaces the sim's ``UipcSimCfg``."""
    from tacex_tpu_torch.assets.meshes import icosphere, weld_soup
    from tacex_tpu_torch.physics.soft.shell import grid_cloth
    from tacex_tpu_torch.uipc import UipcObject, UipcObjectCfg, UipcSim, UipcSimCfg
    from tacex_tpu_torch.uipc.objects import AffineBodyConstitutionCfg, NeoHookeanShellCfg

    sim = UipcSim(cfg or UipcSimCfg(num_envs=1, dt=0.01, enable_ground=True,
                                    contact=UipcSimCfg.Contact(default_friction_ratio=0.5, d_hat=0.004,
                                                               resistance=1e4)), device=device)
    bp, bt = weld_soup(icosphere(0.1, 1))
    UipcObject(UipcObjectCfg(constitution=AffineBodyConstitutionCfg(m_kappa=100.0, kinematic=True)), sim,
               points=bp + CENTER.astype(np.float32), triangles=bt)
    cp, ct = grid_cloth(16, 16, size=0.4, z=0.3)
    cloth = UipcObject(
        UipcObjectCfg(constitution=NeoHookeanShellCfg(youngs_modulus=0.01, poisson_rate=0.3, thickness=0.001,
                                                      bending_E=10.0), mass_density=200.0),
        sim, points=cp, triangles=ct,
    )
    sim.setup_sim()
    return sim, cloth


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sim, cloth = build(args.device)
    seconds = 0.0
    for i in range(args.steps):
        t0 = time.perf_counter()
        sim.step()
        seconds += time.perf_counter() - t0
        if i % 20 == 0:
            z = cloth.nodal_pos_w[0, :, 2].cpu().numpy()
            print(f"step {i:3d}: cloth z [{z.min():.4f}, {z.max():.4f}]")
    overflow = sim.check_health()
    x = cloth.nodal_pos_w[0].cpu().numpy()
    z = x[:, 2]
    r = np.linalg.norm(x - CENTER, axis=-1)
    assert np.isfinite(x).all()
    if args.steps >= STEPS:
        assert z.min() > -2e-3, f"cloth fell through the ground: {z.min():.4f}"
        assert r.min() > 0.09, f"cloth tunneled into the body: {r.min():.4f}"
        assert z.max() > 0.15, "cloth should drape over the body"
        assert z.max() - z.min() > 0.05, "cloth stayed rigid: no drape"
        print(f"bunny cloth: draped over the fixed body (top {z.max():.3f} m, hem {z.min():.3f} m, "
              f"clearance {r.min():.3f} m)")
    return {"x": cloth.nodal_pos_w.cpu().numpy(), "z_top": float(z.max()), "z_hem": float(z.min()),
            "clearance": float(r.min()), "overflow": overflow, "ms_per_step": 1e3 * seconds / max(args.steps, 1)}


if __name__ == "__main__":
    main()
