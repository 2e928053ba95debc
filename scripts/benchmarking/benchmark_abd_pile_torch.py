"""Batched ABD pile benchmark of the PyTorch/CUDA port: env-steps/s for an
8-body pile at N envs.

The port's counterpart of ``benchmark_abd_pile.py``: 8 affine cubes (6 cm,
seeded offsets, 8 cm apart) fall onto a ground plane, with body-body contact
(8 vertex-triangle and 4 edge-edge candidates) and friction 0.3, stepped by
``AbdModel.step`` with the dense Newton solve (the full (12B, 12B) Hessian
of every env and one batched LU) or matrix-free CG. It prints one JSON line
for each of dense@1, dense@N and cg@N (or only ``--solver`` at ``--envs``):
``ms_per_step`` is the host clock around ``--steps`` steps ended by one
synchronise, after one warm-up step; ``device`` is the card's name and power
limit (``nvidia-smi``), or ``cpu`` with ``--device cpu``.

Usage: python scripts/benchmarking/benchmark_abd_pile_torch.py [--envs 64] [--steps 50] [--solver dense|cg]
       [--newton_iters 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root, so the script runs from anywhere


def _cube(half=0.03):
    """8 corners and 12 outward triangles of a cube."""
    P = np.array([[x, y, z] for x in (-half, half) for y in (-half, half) for z in (-half, half)], np.float64)
    faces = [
        (0, 1, 3, 2, [-1, 0, 0]),
        (4, 6, 7, 5, [1, 0, 0]),
        (0, 4, 5, 1, [0, -1, 0]),
        (2, 3, 7, 6, [0, 1, 0]),
        (0, 2, 6, 4, [0, 0, -1]),
        (1, 5, 7, 3, [0, 0, 1]),
    ]
    T = []
    for a, b, c, d, n in faces:
        for tri in ((a, b, c), (a, c, d)):
            p0, p1, p2 = P[list(tri)]
            if np.dot(np.cross(p1 - p0, p2 - p0), n) < 0:
                tri = (tri[0], tri[2], tri[1])
            T.append(tri)
    return P, np.asarray(T, np.int64)


def pile(solver: str, n_envs: int, n_bodies: int = 8, device="cuda", **cfg):
    """(model, state, ground scene) of the pile; ``cfg`` overrides the solver's."""
    import torch

    from tacex_tpu_torch.physics.soft.abd import AbdModel, AbdSolverCfg, AbdState
    from tacex_tpu_torch.physics.soft.ipc import RigidSdfScene

    P, T = _cube()
    rng = np.random.default_rng(3)
    offs = np.stack([rng.uniform(-0.01, 0.01, n_bodies), rng.uniform(-0.01, 0.01, n_bodies),
                     0.05 + 0.08 * np.arange(n_bodies)], axis=-1)
    model = AbdModel([P] * n_bodies, [T] * n_bodies,
                     cfg=AbdSolverCfg(contact_k=8, friction_mu=0.3, linear_solver=solver, **cfg), device=device)
    st = AbdState.identity(n_envs, n_bodies, offsets=offs, device=model.device)
    sc = RigidSdfScene.empty(n_envs, device=model.device)
    ground = torch.as_tensor(np.array([0.0, 0.0, 1.0, 0.0], np.float32), device=model.device)
    scene = RigidSdfScene(sc.spheres, sc.boxes, sc.capsules, ground.expand(n_envs, 1, 4))
    return model, st, scene


def run(solver: str, n_envs: int, n_bodies: int = 8, steps: int = 50, device="cuda", newton_iters: int = 8) -> dict:
    import torch

    from tacex_tpu_torch.utils.profiling import device_label, synchronize

    model, st, scene = pile(solver, n_envs, n_bodies, device, newton_max_iter=newton_iters)
    st = model.step(st, scene)  # warm-up
    synchronize(model.device)
    t0 = time.perf_counter()
    for _ in range(steps):
        st = model.step(st, scene)
    synchronize(model.device)
    dt = time.perf_counter() - t0
    if not bool(torch.isfinite(st.q).all()):
        raise AssertionError("non-finite pile state")
    return {
        "metric": f"abd_pile_{n_bodies}body_{solver}",
        "num_envs": n_envs,
        "env_steps_per_s": round(n_envs * steps / dt, 1),
        "ms_per_step": round(1e3 * dt / steps, 2),
        "device": device_label(model.device),
    }


def main(argv: list[str] | None = None) -> list[dict]:
    """Run the configurations; returns their lines."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--bodies", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--newton_iters", type=int, default=8, help="Newton iterations a step (the solver's default, 8)")
    ap.add_argument("--solver", default=None, choices=("dense", "cg"),
                    help="run only this solver at --envs (default: dense@1, dense@N, cg@N)")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    configs = ((args.solver, args.envs),) if args.solver else (("dense", 1), ("dense", args.envs), ("cg", args.envs))
    lines = []
    for solver, n in configs:
        lines.append(run(solver, n, args.bodies, args.steps, args.device, args.newton_iters))
        print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main()
