"""Screw and nut on the PyTorch/CUDA port: a motor-driven thread turns
rotation into translation.

The port's counterpart of ``screw_and_nut.py``: a fully threaded affine
screw (a 2,922-vertex surface of revolution with a triangular thread
profile, 100 MPa) driven by a RotatingMotor about +z at -pi rad/s, inside
the analytic internal thread of a fixed nut (``sdf_threads``, side -1,
0.5 mm radial clearance), with friction 0.5; the axial advance is not
scripted, it comes from the thread-flank contact. 1 env, 120 steps at dt
1/60 (one turn), then ``check_health``; on ``--device`` (the card by
default; ``--device cpu`` runs on the CPU). After the full run it checks
that the turn advanced the screw by one pitch (-6 mm) within 10%.

Usage: python examples/libuipc_samples/screw_and_nut_torch.py [--steps 120] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root, so the script runs from anywhere

STEPS = 120  # 2 s at -pi rad/s: one full turn
R_MID = 0.006  # thread mid radius (m)
DEPTH = 0.002  # radial thread depth, crest to root
PITCH = 0.006
LENGTH = 0.036
CLEAR = 0.0005  # radial clearance between the screw's and the nut's threads
N_THETA, N_Z = 40, 73


def screw_mesh():
    """The fully threaded rod: r goes from r_mid + depth/2 at the crest to
    r_mid - depth/2 at the root, linear in the folded helical coordinate
    (the ``sdf_threads`` profile), closed with end caps."""
    thetas = np.linspace(0, 2 * np.pi, N_THETA, endpoint=False)
    zs = np.linspace(0, LENGTH, N_Z)
    pts = []
    for z in zs:
        for th in thetas:
            f = ((z - PITCH * th / (2 * np.pi)) / PITCH) % 1.0
            uf = min(f, 1.0 - f) * PITCH
            r = (R_MID + DEPTH / 2) - DEPTH * (uf / (PITCH / 2))
            pts.append([r * np.cos(th), r * np.sin(th), z])
    pts = np.asarray(pts, np.float64)
    tris = []
    for j in range(N_Z - 1):
        for i in range(N_THETA):
            a = j * N_THETA + i
            b = j * N_THETA + (i + 1) % N_THETA
            tris += [[a, b, b + N_THETA], [a, b + N_THETA, a + N_THETA]]
    lo_c = len(pts)
    pts = np.vstack([pts, [[0, 0, 0]], [[0, 0, LENGTH]]])
    for i in range(N_THETA):
        tris.append([lo_c, (i + 1) % N_THETA, i])
        top = (N_Z - 1) * N_THETA
        tris.append([lo_c + 1, top + i, top + (i + 1) % N_THETA])
    return pts, np.asarray(tris, np.int64)


def nut_thread(base_z: float) -> np.ndarray:
    """The nut's (1, 12) ``sdf_threads`` row: a long internal thread (its
    span covers the whole travel) of mid radius R_MID + CLEAR; ``base_z``
    sets the helix phase, the assembly alignment."""
    return np.asarray([[0, 0, base_z, 0, 0, 1, R_MID + CLEAR, DEPTH, PITCH, -0.05 - base_z, 0.09 - base_z, -1.0]],
                      np.float32)


def assemble_phase(screw_pts: np.ndarray, device) -> float:
    """Thread the screw into the nut: of 48 nut helix phases over one pitch,
    the one with the largest minimum clearance."""
    import torch

    from tacex_tpu_torch.ops import sdf as sdf_ops

    P = torch.as_tensor(np.asarray(screw_pts, np.float32), device=device)
    best, best_d = 0.0, -1.0
    for bz in np.linspace(0, PITCH, 48, endpoint=False):
        d = float(sdf_ops.sdf_threads(P, torch.as_tensor(nut_thread(bz), device=device)).min())
        if d > best_d:
            best, best_d = float(bz), d
    assert best_d > 0, "screw cannot be assembled into the nut without overlap"
    return best


def build(device):
    """(sim, screw, nut scene)."""
    import torch

    from tacex_tpu_torch.physics.soft.ipc import RigidSdfScene
    from tacex_tpu_torch.uipc import UipcObject, UipcObjectCfg, UipcSim, UipcSimCfg
    from tacex_tpu_torch.uipc.objects import AffineBodyConstitutionCfg

    sim = UipcSim(UipcSimCfg(num_envs=1, dt=1 / 60, enable_ground=False, newton=UipcSimCfg.Newton(max_iter=8),
                             contact=UipcSimCfg.Contact(friction=True, default_friction_ratio=0.5, d_hat=0.0004,
                                                        resistance=2e4)),
                  device=device)
    sp, st = screw_mesh()
    screw = UipcObject(UipcObjectCfg(constitution=AffineBodyConstitutionCfg(m_kappa=100.0)), sim, points=sp,
                       triangles=st)
    # the motor constrains only the rotational DOFs: the axial advance must come from the threads
    screw.set_rotating_motor(axis=(0.0, 0.0, 1.0), rot_vel=-np.pi, strength=2000.0)
    sim.setup_sim()
    bz = assemble_phase(sp, sim.device)
    sc = RigidSdfScene.empty(1, device=sim.device)
    scene = RigidSdfScene(sc.spheres, sc.boxes, sc.capsules, sc.planes,
                          threads=torch.as_tensor(nut_thread(bz), device=sim.device)[None])
    return sim, screw, scene


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sim, screw, scene = build(args.device)
    z0 = float(sim.abd_body_pose(screw)[0, 2])
    seconds = 0.0
    for i in range(args.steps):
        t0 = time.perf_counter()
        sim.step(scene)
        seconds += time.perf_counter() - t0
        if i % 30 == 0:
            q = sim.abd_body_pose(screw)[0].cpu().numpy()
            print(f"step {i:3d}: z {q[2]:+.5f} angle {np.arctan2(q[6], q[3]):+.2f}")
    overflow = sim.check_health()
    q = sim.abd_body_pose(screw)[0].cpu().numpy()
    dz = float(q[2] - z0)
    if args.steps >= STEPS:
        # u = z - pitch theta / 2 pi is invariant on the mating surfaces: -2 pi of turn is -pitch of travel
        expected = -PITCH
        print(f"screw advanced {dz * 1000:+.3f} mm (ideal thread kinematics {expected * 1000:+.1f} mm)")
        assert abs(dz - expected) < 0.1 * abs(expected), (dz, expected)
        print("screw and nut: rotation -> translation through threaded contact with friction (mu=0.5)")
    return {"q": sim.abd_body_pose(screw).cpu().numpy(), "dz": dz, "overflow": overflow,
            "ms_per_step": 1e3 * seconds / max(args.steps, 1)}


if __name__ == "__main__":
    main()
