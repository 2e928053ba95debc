"""The coupled contact world: FEM soft bodies and affine bodies in ONE Newton solve.

Port of ``tacex_tpu/physics/soft/coupled.py`` on the path of the
Grasp-Lift and Factory-UIPC envs: gel pads (one union FEM model) and free
affine bodies, batched over envs. The unknown of env n is
``z = [x (3V) | q (12B)]``; a step minimises

    E(x, q) = E_fem(x) + E_abd(q) + E_cross(x, q)

where E_fem and E_abd are the members' own energies and E_cross adds two
vertex-triangle barrier families over step-start candidate sets (the K
nearest triangle centroids of each vertex):

    A. FEM surface vertex vs ABD surface triangle,
    B. ABD vertex vs FEM surface triangle,

each with lagged friction (A anchors the ABD material point in body
coordinates, B the FEM material point in barycentric ones). Each Newton
iteration builds the gradient's graph once (``create_graph``); each CG
product is one backward through it. CG is block-preconditioned: FEM rows
by the lumped mass over dt^2, ABD rows by each body's inverted 12x12
inertia + orthogonality + constraint block. The line search keeps a trial
only where it lowers the energy and is feasible for every family: scene
distances above their step-start floors, cross distances above theirs, and
no vertex crossing a candidate triangle in either direction (the co-moving
crossing test).

The FEM model's own families (self contact, which makes two gels of one
union model meet, static triangles and edge-edge pairs) join the energy and
the feasibility test as in ``SoftBodyModel``'s own solve, and so do the
ABD model's body-body vertex-triangle pairs when ``contact_k > 0``: their
barrier, their 1e-7 m distance floor and their co-moving crossing test (as
in the JAX package, without pair friction or body-body edge-edge pairs
here). ``broad_phase_overflow`` and ``missed_barriers`` count the pairs the
fixed-capacity candidate sets dropped. The solve takes no substeps:
``ccd_substeps`` of the FEM model's cfg is not read, as in the JAX package
(the UIPC scene API warns and applies one).

Envs never mix: every energy, mask and step length is per env, and
choices are ``torch.where``, so ``step`` reads nothing back to the host.
The candidate sets are chosen with a stable sort, which keeps the lower
index among tied centroid distances, as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from .abd import AbdModel, AbdState, inverse3, q_to_affine
from .ipc import (
    RigidSdfScene,
    SoftBodyModel,
    SoftBodyState,
    _centroids,
    _clip,
    _gather,
    _nearest,
    _point_triangle_closest,
    _point_triangle_distance,
    _segment_crosses_moving_triangle,
    _sq_dist,
    barrier_extended,
    barrier_force_mag,
    derivatives,
    friction_mollifier,
    scene_friction_basis,
)


def _triangle_barycentric(q, a, b, c):
    """Barycentric coordinates of q (on or near the triangle's plane) in
    (a, b, c), broadcast over leading dims, clamped to the simplex."""
    e1, e2, ep = b - a, c - a, q - a
    d11 = (e1 * e1).sum(-1)
    d12 = (e1 * e2).sum(-1)
    d22 = (e2 * e2).sum(-1)
    p1 = (ep * e1).sum(-1)
    p2 = (ep * e2).sum(-1)
    det = torch.clamp(d11 * d22 - d12 * d12, min=1e-30)
    v = _clip((d22 * p1 - d12 * p2) / det, 0.0, 1.0)
    w = _clip((d11 * p2 - d12 * p1) / det, 0.0, 1.0)
    s = torch.clamp(v + w, min=1.0)
    v, w = v / s, w / s
    return torch.stack([1.0 - v - w, v, w], dim=-1)


def _nearest_within(p: torch.Tensor, cent: torch.Tensor, k: int, cut: float):
    """The k nearest centroids of each point by squared distance (ties to the
    lower index, as ``jax.lax.top_k``) and whether each is within ``cut``."""
    d2s, order = _nearest(_sq_dist(p, cent), k)
    return order, d2s < cut * cut


class CoupledModel:
    """One contact world over one FEM union model and one ABD model.

    Args:
      fem: the union FEM model, every soft body of the scene.
      abd: the ABD model, every affine body of the scene.
      cross_k: candidate triangles per vertex in each cross family.
    """

    def __init__(self, fem: SoftBodyModel, abd: AbdModel, cross_k: int = 4):
        self.fem = fem
        self.abd = abd
        self.cross_k = int(cross_k)
        c, a = fem.cfg, abd.cfg
        # both configs come from one scene config: the shared barrier must mean one thing
        assert abs(c.d_hat - a.d_hat) < 1e-12 and abs(c.kappa - a.kappa_contact) < 1e-9
        assert abs(c.dt - a.dt) < 1e-12
        assert fem.device == abd.device, (fem.device, abd.device)
        self.device = fem.device
        self._gravity = torch.tensor(c.gravity, dtype=torch.float32, device=self.device)
        self._q_gravity = torch.einsum("bij,bj->bi", abd.mass_inv, abd.gravity_q)  # (B, 12)
        self._fem_pre = 1.0 / (fem.masses[:, None] / c.dt**2)  # (V, 1)
        self._eye12 = torch.eye(12, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------ candidates
    def _cross_candidates(self, xs, y):
        """Family A: for each FEM surface vertex (N, Vs, 3), its K nearest ABD
        triangles of the ABD vertices y (N, Va, 3) -> (cand, valid) (N, Vs, K)."""
        cut = 3.0 * self.fem.cfg.d_hat + self.abd._tri_radius_max
        return _nearest_within(xs, _centroids(y, self.abd.tris), self.cross_k, cut)

    def _cross_candidates_b(self, x, y):
        """Family B: for each ABD vertex, its K nearest FEM surface triangles."""
        cut = 3.0 * self.fem.cfg.d_hat + self.fem._tri_radius_max
        return _nearest_within(y, _centroids(x, self.fem.surface_tris), self.cross_k, cut)

    def broad_phase_overflow(self, x: torch.Tensor, q: torch.Tensor) -> dict[str, torch.Tensor]:
        """Within-reach candidates dropped past the K nearest, per env
        (x (N, V, 3), q (N, B, 12)) -> {key: (N,) int64}: both cross
        families (``vt_cross_a``, ``vt_cross_b``), the FEM model's own
        (``SoftBodyModel.broad_phase_overflow``) and the ABD model's, its
        keys prefixed ``abd_`` (``AbdModel.broad_phase_overflow``)."""
        c = self.fem.cfg
        xs = x.index_select(1, self.fem.surface_verts)
        y = self.abd.world_points(q)
        out: dict[str, torch.Tensor] = {}
        for key, p, cent, radius in (
            ("vt_cross_a", xs, _centroids(y, self.abd.tris), self.abd._tri_radius_max),
            ("vt_cross_b", y, _centroids(x, self.fem.surface_tris), self.fem._tri_radius_max),
        ):
            cut = 3.0 * c.d_hat + radius
            within = (_sq_dist(p, cent) < cut * cut).sum(-1)
            out[key] = torch.clamp(within - min(self.cross_k, cent.shape[1]), min=0).sum(-1)
        out.update(self.fem.broad_phase_overflow(x))
        out.update({f"abd_{k}": v for k, v in self.abd.broad_phase_overflow(y).items()})
        return out

    def missed_barriers(self, x: torch.Tensor, q: torch.Tensor, reach_frac: float = 0.5) -> torch.Tensor:
        """(N,) cross-family pairs within ``reach_frac * d_hat`` (exact
        vertex-triangle distance) beyond the K a vertex's candidate set
        holds: nonzero means a pair with real barrier force was dropped."""
        d_hat = reach_frac * self.fem.cfg.d_hat
        k = self.cross_k
        xs = x.index_select(1, self.fem.surface_verts)
        y = self.abd.world_points(q)
        missed = x.new_zeros(x.shape[0], dtype=torch.int64)
        for p, pts, tris in ((xs, y, self.abd.tris), (y, x, self.fem.surface_tris)):
            tri = [pts.index_select(1, tris[:, i])[:, None] for i in range(3)]  # (N, 1, T, 3)
            d = _point_triangle_distance(p[:, :, None, :], *tri)  # (N, P, T)
            within = (d < d_hat).sum(-1)
            missed = missed + torch.clamp(within - min(k, tris.shape[0]), min=0).sum(-1)
        return missed

    # ------------------------------------------------------------- distances
    def _cross_distances(self, xs, y, triA, triB):
        """Vertex-triangle distances of both families: FEM surface vertices
        xs against their ABD triangles triA (N, Vs, K, 3, 3), ABD vertices y
        against their FEM triangles triB (N, Va, K, 3, 3)."""
        dA = _point_triangle_distance(xs[:, :, None, :], triA[..., 0, :], triA[..., 1, :], triA[..., 2, :])
        dB = _point_triangle_distance(y[:, :, None, :], triB[..., 0, :], triB[..., 1, :], triB[..., 2, :])
        return dA, dB

    def _cross_energy(self, x, q, cand, lag, x0s, y0):
        """(N,) barrier and lagged friction energy of both cross families."""
        c = self.fem.cfg
        idxA, validA, idxB, validB, tbA = cand
        xs = x.index_select(1, self.fem.surface_verts)
        y = self.abd.world_points(q)
        triB = _gather(x, idxB)
        dA, dB = self._cross_distances(xs, y, _gather(y, idxA), triB)
        dA = torch.where(validA, dA, 10.0 * c.d_hat)
        dB = torch.where(validB, dB, 10.0 * c.d_hat)
        e = barrier_extended(dA, c.kappa, c.d_hat).sum((-2, -1)) + barrier_extended(dB, c.kappa, c.d_hat).sum((-2, -1))
        if lag is None:
            return e
        (lamA, nA, pA_local, pA0), (lamB, nB, wB, matB0) = lag
        eps = c.eps_velocity * c.dt
        mu = c.friction_mu
        # family A: the FEM vertex against the frozen ABD material point
        A, t = q_to_affine(q)
        A_rows = _gather(A.flatten(-2), tbA).unflatten(-1, (3, 3))  # (N, Vs, K, 3, 3)
        movedA = torch.einsum("nvkij,nvkj->nvki", A_rows, pA_local) + _gather(t, tbA)
        relA = (xs - x0s)[:, :, None, :] - (movedA - pA0)
        relA_t = relA - (relA * nA).sum(-1, keepdim=True) * nA
        sA = (relA_t**2).sum(-1)
        e = e + mu * torch.where(validA, lamA * friction_mollifier(sA, eps), 0.0).sum((-2, -1))
        # family B: the ABD vertex against the frozen FEM barycentric point
        matB = torch.einsum("nvkc,nvkcd->nvkd", wB, triB)
        relB = (y - y0)[:, :, None, :] - (matB - matB0)
        relB_t = relB - (relB * nB).sum(-1, keepdim=True) * nB
        sB = (relB_t**2).sum(-1)
        return e + mu * torch.where(validB, lamB * friction_mollifier(sB, eps), 0.0).sum((-2, -1))

    def _cross_lag(self, x_k, q_k, cand, x0, q0):
        """Lagged friction quantities of both families at a detached iterate:
        (lambda, normal, body-local point, its step-start world position) of
        family A, (lambda, normal, barycentric weights, the point's
        step-start position on the triangles of x0) of family B."""
        c = self.fem.cfg
        idxA, validA, idxB, validB, tbA = cand
        xs = x_k.index_select(1, self.fem.surface_verts)
        y = self.abd.world_points(q_k)
        A_k, t_k = q_to_affine(q_k)
        A0, t0 = q_to_affine(q0)
        triA = _gather(y, idxA)
        qpA = _point_triangle_closest(xs[:, :, None, :], triA[..., 0, :], triA[..., 1, :], triA[..., 2, :])
        dA = torch.sqrt(((xs[:, :, None, :] - qpA) ** 2).sum(-1) + 1e-18)
        lamA = torch.where(validA, barrier_force_mag(dA, c.kappa, c.d_hat), 0.0)
        nA = (xs[:, :, None, :] - qpA) / torch.clamp(dA, min=1e-9)[..., None]
        rows = lambda M: _gather(M.flatten(-2), tbA).unflatten(-1, (3, 3))  # noqa: E731
        pA_local = torch.einsum("nvkij,nvkj->nvki", rows(inverse3(A_k)), qpA - _gather(t_k, tbA))
        pA0 = torch.einsum("nvkij,nvkj->nvki", rows(A0), pA_local) + _gather(t0, tbA)
        triB = _gather(x_k, idxB)
        qpB = _point_triangle_closest(y[:, :, None, :], triB[..., 0, :], triB[..., 1, :], triB[..., 2, :])
        dB = torch.sqrt(((y[:, :, None, :] - qpB) ** 2).sum(-1) + 1e-18)
        lamB = torch.where(validB, barrier_force_mag(dB, c.kappa, c.d_hat), 0.0)
        nB = (y[:, :, None, :] - qpB) / torch.clamp(dB, min=1e-9)[..., None]
        wB = _triangle_barycentric(qpB, triB[..., 0, :], triB[..., 1, :], triB[..., 2, :])
        matB0 = torch.einsum("nvkc,nvkcd->nvkd", wB, _gather(x0, idxB))
        return (lamA, nA, pA_local, pA0), (lamB, nB, wB, matB0)

    # ------------------------------------------------------------- the solve
    def _problem(self, x, v, q, qd, scene, aim_pos, aim_q, aim_strength) -> SimpleNamespace:
        """One step's minimisation problem at its start (x, v) (N, V, 3) and
        (q, qd) (N, B, 12): the packed unknown ``z0``, ``unpack(z)``,
        ``lags_at(z)`` (the friction lags at a detached iterate),
        ``energy(z, lags)`` (N,), ``precond(r)`` and ``feasible(z_try,
        z_from)`` (N,) bool."""
        fem, abd = self.fem, self.abd
        c, ca = fem.cfg, abd.cfg
        n, V = x.shape[:2]
        B = abd.num_bodies

        x_tilde = x + c.dt * v + c.dt * c.dt * self._gravity
        q_tilde = q + ca.dt * qd + ca.dt**2 * self._q_gravity
        xs0 = x.index_select(1, fem.surface_verts)
        y0 = abd.world_points(q)

        # step-start candidate sets, as corner indices into x and y
        candA, validA = self._cross_candidates(xs0, y0)
        candB, validB = self._cross_candidates_b(x, y0)
        idxA = abd.tris[candA]  # (N, Vs, K, 3)
        idxB = fem.surface_tris[candB]  # (N, Va, K, 3)
        tbA = abd.tri_body[candA]  # (N, Vs, K)
        cand = (idxA, validA, idxB, validB, tbA)
        fam = fem._families(x)  # the FEM model's self, static and edge-edge families
        abd_cand = abd._select_candidates(y0) if ca.contact_k > 0 else None  # body-body pairs

        def unpack(z):
            return z[:, : 3 * V].unflatten(1, (V, 3)), z[:, 3 * V :].unflatten(1, (B, 12))

        def lags_at(z_k):
            """Friction lags at the detached iterate (the FEM's and the
            bodies' against the scene, and the cross families')."""
            if c.friction_mu <= 0:
                return None, None, None
            x_k, q_k = unpack(z_k.detach())
            fl = fem._friction_lag(x_k, scene)
            al = scene_friction_basis(abd.world_points(q_k), scene, ca.kappa_contact, ca.d_hat)
            return fl, al, self._cross_lag(x_k, q_k, cand, x, q)

        def energy_of(z, lags):
            fl, al, cl = lags
            xx, qq = unpack(z)
            e = fem._energy(xx, x_tilde, scene, aim_pos, x, fl, c.dt, fam)
            e = e + abd._energy(qq, q_tilde, scene, aim_q, aim_strength, y0, al, abd_cand)
            return e + self._cross_energy(xx, qq, cand, cl, xs0, y0)

        # ABD block preconditioner: each body's 12x12 smooth-part inverse (N, B, 12, 12)
        Hd_inv = torch.linalg.inv_ex(abd._smooth_blocks(q, aim_strength) + 1e-6 * self._eye12).inverse

        def precond(r):
            rx, rq = r[:, : 3 * V], r[:, 3 * V :].unflatten(1, (B, 12))
            px = (self._fem_pre * rx.unflatten(1, (V, 3))).flatten(1)
            pq = torch.einsum("nbij,nbj->nbi", Hd_inv, rq).flatten(1)
            return torch.cat([px, pq], 1)

        # feasibility floors: the scene's (no worsening of a penetrated
        # start), and the cross families' (no pair closer than 0.999 of its
        # step-start distance, or 1e-7 m)
        zero = x.new_zeros(())
        d_floor = torch.minimum(scene.sdf(xs0).amin(-1), zero)
        d_floor_abd = torch.minimum(scene.sdf(y0).amin(-1), zero)
        dA0, dB0 = self._cross_distances(xs0, y0, _gather(y0, idxA), _gather(x, idxB))
        crossA_floor = torch.clamp(0.999 * torch.where(validA, dA0, 1.0).amin((-2, -1)), max=1e-7)
        crossB_floor = torch.clamp(0.999 * torch.where(validB, dB0, 1.0).amin((-2, -1)), max=1e-7)

        def feasible(z_try, z_from):
            xx, qq = unpack(z_try)
            xf, qf = unpack(z_from)
            xs_t = xx.index_select(1, fem.surface_verts)
            xs_f = xf.index_select(1, fem.surface_verts)
            y_t, y_f = abd.world_points(qq), abd.world_points(qf)
            ok = (scene.sdf(xs_t).amin(-1) > d_floor) & (scene.sdf(y_t).amin(-1) > d_floor_abd)
            if fam is not None:
                ok = ok & fem._family_feasible(fam, xx, xs_t, xf, xs_f)
            if abd_cand is not None:
                ci, vld = abd_cand
                ok = ok & (torch.where(vld, abd._pair_distances(y_t, ci), 1.0).amin((-2, -1)) > 1e-7)
                tri, tri0 = abd._tri_rows(y_t, ci), abd._tri_rows(y_f, ci)
                crossed = _segment_crosses_moving_triangle(
                    y_f[:, :, None, :], y_t[:, :, None, :], tri0[..., 0, :], tri0[..., 1, :], tri0[..., 2, :],
                    tri[..., 0, :], tri[..., 1, :], tri[..., 2, :],
                )
                ok = ok & ~(crossed & vld).flatten(1).any(-1)
            triA, triA0 = _gather(y_t, idxA), _gather(y_f, idxA)
            triB, triB0 = _gather(xx, idxB), _gather(xf, idxB)
            dA, dB = self._cross_distances(xs_t, y_t, triA, triB)
            ok = ok & (torch.where(validA, dA, 1.0).amin((-2, -1)) > crossA_floor)
            ok = ok & (torch.where(validB, dB, 1.0).amin((-2, -1)) > crossB_floor)
            crossedA = _segment_crosses_moving_triangle(
                xs_f[:, :, None, :], xs_t[:, :, None, :],
                triA0[..., 0, :], triA0[..., 1, :], triA0[..., 2, :], triA[..., 0, :], triA[..., 1, :], triA[..., 2, :],
            )
            crossedB = _segment_crosses_moving_triangle(
                y_f[:, :, None, :], y_t[:, :, None, :],
                triB0[..., 0, :], triB0[..., 1, :], triB0[..., 2, :], triB[..., 0, :], triB[..., 1, :], triB[..., 2, :],
            )
            ok = ok & ~(crossedA & validA).any(-1).any(-1)
            return ok & ~(crossedB & validB).any(-1).any(-1)

        z0 = torch.cat([x.flatten(1), q.flatten(1)], 1)
        return SimpleNamespace(z0=z0, unpack=unpack, lags_at=lags_at, energy=energy_of, precond=precond,
                               feasible=feasible)

    def _solve(self, x, v, q, qd, scene, aim_pos, aim_q, aim_strength):
        c, ca = self.fem.cfg, self.abd.cfg
        n = x.shape[0]
        prob = self._problem(x, v, q, qd, scene, aim_pos, aim_q, aim_strength)
        precond, feasible = prob.precond, prob.feasible
        z = prob.z0
        done = torch.zeros((n,), dtype=torch.bool, device=x.device)
        for _ in range(c.newton_max_iter):
            lags = prob.lags_at(z)
            energy = lambda zz: prob.energy(zz, lags)  # noqa: E731
            e0, g, hvp = derivatives(energy, z)

            # block-preconditioned CG on the Hessian-vector products
            r = -g
            z0 = precond(r)
            p_dir, zv, sol = z0, z0, torch.zeros_like(z)
            for _ in range(c.cg_iters):
                hp = hvp(p_dir)
                denom = (p_dir * hp).sum(-1)
                rz = (r * zv).sum(-1)
                alpha = torch.where(denom.abs() > 1e-20, rz / denom, 0.0)[:, None]
                sol = sol + alpha * p_dir
                r = r - alpha * hp
                z_new = precond(r)
                beta = torch.where(rz > 1e-20, (r * z_new).sum(-1) / rz, 0.0)[:, None]
                p_dir, zv = z_new + beta * p_dir, z_new
            del hvp
            descent = (sol * g).sum(-1) < 0
            p = torch.where(descent[:, None], sol, -z0)

            # backtracking line search: lower energy and feasible
            alpha = torch.ones((n,), device=x.device)
            accepted = torch.zeros((n,), dtype=torch.bool, device=x.device)
            for _ in range(c.line_search_iters):
                z_try = z + alpha[:, None] * p
                ok = (energy(z_try) < e0) & feasible(z_try, z)
                alpha = torch.where(ok | accepted, alpha, alpha * 0.5)
                accepted = ok | accepted
            alpha = torch.where(accepted, alpha, 0.0)
            step_vec = alpha[:, None] * p
            z = torch.where(done[:, None], z, z + step_vec)
            # converged: the largest entry of the step, x and q alike, below tolerance
            done = done | (step_vec.abs().amax(-1) / c.dt < c.velocity_tol)

        x_new, q_new = prob.unpack(z)
        return x_new, (x_new - x) / c.dt * (1.0 - c.damping), q_new, (q_new - q) / ca.dt

    def step(
        self,
        fem_state: SoftBodyState,
        abd_state: AbdState,
        scene: RigidSdfScene,
        aim_pos: torch.Tensor | None = None,  # (N, Va, 3) FEM attachment targets
        aim_q: torch.Tensor | None = None,  # (N, B, 12) ABD constraint targets
        aim_strength: torch.Tensor | None = None,  # (N, B) or (N, B, 12)
    ) -> tuple[SoftBodyState, AbdState]:
        inputs = (fem_state.x, fem_state.v, abd_state.q, abd_state.qd, aim_pos, aim_q, aim_strength)
        if torch.is_grad_enabled() and (any(t is not None and t.requires_grad for t in inputs) or scene.requires_grad()):
            raise RuntimeError(
                "CoupledModel.step has no gradient in its inputs yet (ROADMAP Queue 1 item 3c); "
                "detach them or run under torch.no_grad()"
            )
        n = fem_state.x.shape[0]
        B = self.abd.num_bodies
        dev = fem_state.x.device
        if aim_pos is None:
            aim_pos = torch.zeros((n, max(int(self.fem.attachment_verts.shape[0]), 1), 3), device=dev)
        if aim_q is None:
            aim_q = abd_state.q
        if aim_strength is None:
            aim_strength = torch.zeros((n, B, 12), device=dev)
        elif aim_strength.ndim == 2:
            aim_strength = aim_strength[..., None].expand(n, B, 12)
        x, v, q, qd = self._solve(fem_state.x, fem_state.v, abd_state.q, abd_state.qd, scene, aim_pos, aim_q,
                                  aim_strength)
        return SoftBodyState(x=x, v=v), AbdState(q=q, qd=qd)
