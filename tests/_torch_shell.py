"""Shared scenes of the shell parity tests (``test_torch_shell*.py``): a
small cloth, its colliders and the JAX reference step.

The cloth is ``grid_cloth(5, 5)`` of 8 cm, 1 mm over a kinematic icosphere
soup (the bunny-cloth pattern's static triangles), with a sphere collider
under one corner, the ground plane in env 0 and a raised plane just under
the cloth in env 1, its corners pinned at their rest positions and friction
on. It falls at 0.2 m/s with a seeded sideways drift, so that in one step
every contact term and the friction lag carry load.

The JAX step runs as one jit of ``ShellModel._step_single`` called env by
env (``_torch_uipc_api.per_env_step``): ``ShellModel.step`` is its ``vmap``.
"""

from __future__ import annotations

import numpy as np
import torch

import jax.numpy as jnp

from tacex_tpu.assets.meshes import icosphere
from tacex_tpu.physics.soft import ipc as jipc
from tacex_tpu.physics.soft import shell as jshell
from tacex_tpu_torch.physics.soft import ipc as tipc
from tacex_tpu_torch.physics.soft import shell as tshell

N = 2
# the parity iterations: the convergence stop off (a float-noise decision, ROADMAP Queue 3)
CFG = dict(dt=0.01, newton_max_iter=2, cg_iters=6, line_search_iters=4, velocity_tol=0.0, d_hat=0.002,
           friction_mu=0.5)
ATOL = 1e-5  # m
CORNERS = np.array([0, 4, 20, 24])


def cloth():
    """(points, triangles) of the 5 x 5 cloth, 1 mm over the soup's top."""
    return jshell.grid_cloth(5, 5, size=0.08, z=0.021)


def static_tris() -> np.ndarray:
    """(80, 3, 3) icosphere soup of radius 2 cm at the origin."""
    return np.asarray(icosphere(0.02, 1), np.float32)


def scene_arrays() -> dict:
    """numpy colliders of the N envs: a sphere 1.5 mm under vertex 22 (the
    middle of the edge x = 4 cm), the ground in env 0 and a plane 1.5 mm
    under the cloth in env 1."""
    spheres = np.zeros((N, 1, 4), np.float32)
    spheres[:, 0] = [0.04, 0.0, 0.0095, 0.01]
    planes = np.zeros((N, 1, 4), np.float32)
    planes[:, 0, 2] = 1.0
    planes[1, 0, 3] = 0.0195
    return dict(spheres=spheres, boxes=np.zeros((N, 1, 10), np.float32), capsules=np.zeros((N, 1, 8), np.float32),
                planes=planes)


def start(seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(x, v) (N, V, 3): the rest cloth falling at 0.2 m/s with a seeded drift."""
    P, _ = cloth()
    rng = np.random.default_rng(seed)
    x = np.broadcast_to(P, (N,) + P.shape).astype(np.float32).copy()
    v = rng.normal(0.0, 0.05, x.shape).astype(np.float32)
    v[..., 2] -= 0.2
    return x, v


def models(**cfg):
    """(JAX model, port model) of the cloth with both colliders' kinds and pinned corners."""
    P, T = cloth()
    kw = dict(static_tris=static_tris(), attachment_verts=CORNERS, attachment_strength_ratio=1000.0)
    c = {**CFG, **cfg}
    return (jshell.ShellModel(P, T, cfg=jshell.ShellSolverCfg(**c), **kw),
            tshell.ShellModel(P, T, cfg=tshell.ShellSolverCfg(**c), device="cpu", **kw))


def scenes(arrays: dict):
    return (jipc.RigidSdfScene(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            tipc.RigidSdfScene(**{k: torch.from_numpy(v) for k, v in arrays.items()}))



# ---------------------------------------------------------------- UipcSim scenes
# the scenes of tests/test_unified_shell.py through either package's ``uipc``
# module (``M``: tacex_tpu.uipc or tacex_tpu_torch.uipc, on the CPU), at the
# parity iterations
SIM_ITERS = dict(newton=2, cg=6, line_search=4)
UNION_ATOL = 1e-5  # m (ROADMAP Queue 3)
COUPLED_ATOL = 1e-4


def sim_cfg(M, **kw):
    it = SIM_ITERS
    return M.UipcSimCfg(dt=1 / 100, num_envs=1, enable_ground=True,
                        newton=M.UipcSimCfg.Newton(max_iter=it["newton"], velocity_tol=0.0),
                        linear_system=M.UipcSimCfg.LinearSystem(max_iter=it["cg"]),
                        line_search=M.UipcSimCfg.LineSearch(max_iter=it["line_search"]), **kw)


def new_sim(M, cfg):
    return M.UipcSim(cfg) if M.__name__.startswith("tacex_tpu.") else M.UipcSim(cfg, device="cpu")


def cube_mesh(half, center):
    """(points, triangles) of a closed cube."""
    P = np.array([[x, y, z] for x in (-half, half) for y in (-half, half) for z in (-half, half)],
                 np.float64) + np.asarray(center)
    T = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                  [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int64)
    return P, T


def lone_cloth(M):
    """A 5 x 5 cloth over a kinematic cube: the standalone ``ShellModel``."""
    sim = new_sim(M, sim_cfg(M, contact=M.UipcSimCfg.Contact(self_contact_k=0, coupling_k=4)))
    cp, ct = jshell.grid_cloth(5, 5, size=0.04, z=0.02)
    cloth = M.UipcObject(M.UipcObjectCfg(constitution=M.NeoHookeanShellCfg()), sim, points=cp, triangles=ct)
    bp, bt = cube_mesh(0.008, (0.0, 0.0, 0.008))
    M.UipcObject(M.UipcObjectCfg(constitution=M.AffineBodyConstitutionCfg(kinematic=True)), sim,
                 points=bp, triangles=bt)
    sim.setup_sim()
    return sim, cloth


def hairpin(M, self_k=4):
    """The hairpin strip of ``TestClothSelfCollision``: the bottom layer on
    the ground, the top layer folded back 3 mm above it and launched down at
    0.1 m/s, the far end pinned; with ``self_k > 0`` a lone cloth routes
    through the union model."""
    n, w, h, gap = 6, 3, 0.01, 0.003
    pts = [[i * h, j * h, 0.001] for i in range(n + 1) for j in range(w)]
    pts += [[(n - i) * h, j * h, 0.001 + gap] for i in range(1, n + 1) for j in range(w)]

    def vid(layer, i, j):
        return (layer * (n + 1) + i) * w + j if layer == 0 else (n + 1) * w + (i - 1) * w + j

    T = []
    for i in range(n):
        for j in range(w - 1):
            a, b, c, d = vid(0, i, j), vid(0, i + 1, j), vid(0, i + 1, j + 1), vid(0, i, j + 1)
            T += [[a, b, c], [a, c, d]]
    for j in range(w - 1):
        a, b, c, d = vid(0, n, j), vid(1, 1, j), vid(1, 1, j + 1), vid(0, n, j + 1)
        T += [[a, b, c], [a, c, d]]
    for i in range(1, n):
        for j in range(w - 1):
            a, b, c, d = vid(1, i, j), vid(1, i + 1, j), vid(1, i + 1, j + 1), vid(1, i, j + 1)
            T += [[a, b, c], [a, c, d]]
    sim = new_sim(M, sim_cfg(M, contact=M.UipcSimCfg.Contact(self_contact_k=self_k, coupling_k=0, d_hat=0.0008)))
    cloth = M.UipcObject(
        M.UipcObjectCfg(constitution=M.NeoHookeanShellCfg(youngs_modulus=0.01, bending_E=0.01), mass_density=500.0),
        sim, points=np.asarray(pts, np.float64), triangles=np.asarray(T, np.int64),
    )
    cloth.set_attachments(np.asarray([vid(0, 0, j) for j in range(w)], np.int32), strength_ratio=1e4)
    sim.setup_sim()
    return sim, cloth, (n + 1) * w  # the bottom layer's vertex count


def cloth_on_gel(M, gel_mesh):
    """A 6 x 6 cloth 0.5 mm over a soft gel block (one union model with self
    contact); ``gel_mesh``: the block's mesh in M's package."""
    sim = new_sim(M, sim_cfg(M, contact=M.UipcSimCfg.Contact(self_contact_k=4, coupling_k=0)))
    gel = M.UipcObject(M.UipcObjectCfg(constitution=M.StableNeoHookeanCfg(youngs_modulus=0.1)), sim, mesh=gel_mesh)
    cp, ct = jshell.grid_cloth(6, 6, size=0.03, z=0.0205)
    cloth = M.UipcObject(M.UipcObjectCfg(constitution=M.NeoHookeanShellCfg(), mass_density=200.0), sim,
                         points=cp, triangles=ct)
    sim.setup_sim()
    return sim, gel, cloth


def trampoline_jax(cfg):
    """``examples/cloth_trampoline.py``'s scene in the JAX package, built as
    the port's ``cloth_trampoline_torch.build`` builds it (with ``cfg``)."""
    import tacex_tpu.uipc as J

    sim = J.UipcSim(cfg)
    cp, ct = jshell.grid_cloth(7, 7, size=0.06, z=0.03)
    cloth = J.UipcObject(J.UipcObjectCfg(constitution=J.NeoHookeanShellCfg(youngs_modulus=0.1), mass_density=200.0),
                         sim, points=cp, triangles=ct)
    cloth.set_attachments(np.asarray([0, 6, 42, 48], np.int32), strength_ratio=1e4)
    bp, bt = cube_mesh(0.006, (0.0, 0.0, 0.045))
    body = J.UipcObject(J.UipcObjectCfg(constitution=J.AffineBodyConstitutionCfg(m_kappa=100.0), mass_density=1000.0),
                        sim, points=bp, triangles=bt)
    sim.setup_sim()
    return sim, cloth, body


def numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
