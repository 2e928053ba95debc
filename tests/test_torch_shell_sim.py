"""Shells in the port's ``UipcSim`` against the JAX package: the routes of
``tests/test_unified_shell.py``'s scenes, and a step of the lone cloth, the
hairpin and the cloth on a gel.

  * Routes, without a step: a lone cloth over a kinematic cube keeps the
    standalone ``ShellModel`` (no coupled world: no dynamic body); the
    hairpin strip with self contact goes through the union model, without
    it standalone; a cloth on a gel joins the gel's union; the trampoline's
    cloth joins the union of the coupled world. Each side's models hold the
    same constants (masses, attachment stiffnesses, the merged shell
    elements), and ``to_shell_cfg`` gives JAX's values.
  * One step of the lone cloth through the sim, equal to its
    ``ShellModel``'s own step with the ground added (that model is held to
    JAX in ``test_torch_shell.py``), and one step of the hairpin through
    the union against JAX (its top
    layer launched down at 0.1 m/s, as the JAX test launches it; the self
    contact candidates are chosen and every trial's crossing tests run,
    while the layers stay ~2.6 mm apart, beyond d_hat: the cloth on a gel
    of ``test_torch_shell_coupled.py`` loads the union's barrier), at 2
    Newton x 6 CG x 4 line-search iterations with the convergence stop
    off, within 1e-5 m (the JAX union step as one jit of its
    ``_step_single``, ``_torch_uipc_api.single_env_steps``).
  * One step of a cloth 0.5 mm over a gel block, both nodal parts of one
    union model with self contact (K = 4), so that the vertex-triangle
    barrier between cloth and gel carries load (it lifts the cloth), at the
    same iterations, within 1e-5 m. Both sides mesh the block with the
    port's numpy mesher, so that the union's surface triangles come in one
    order.
"""

import dataclasses

import numpy as np
import torch

import _torch_shell as S
import tacex_tpu.uipc as J
import tacex_tpu_torch.uipc as T
from _torch_bins import setup_torch
from _torch_shell import numpy
from _torch_uipc_api import single_env_steps
from tacex_tpu.physics.soft import mesh as jmesh
from tacex_tpu_torch.physics.soft import ipc as tipc
from tacex_tpu_torch.physics.soft import mesh as tmesh
from tacex_tpu_torch.physics.soft.shell import ShellModel

setup_torch()

LAUNCH = -0.1  # m/s, the JAX test's launch of the hairpin's top layer


def gel_meshes():
    """The cloth-on-gel block meshed once by the port's numpy mesher, in each package's TetMesh."""
    m = tmesh.box_tet_mesh((0.04, 0.04, 0.02), (3, 3, 2), center=(0, 0, 0.01))
    fields = dict(points=m.points, tets=m.tets, surface_tris=m.surface_tris, surface_verts=m.surface_verts)
    return jmesh.TetMesh(**fields), m


def test_routes_and_models_match_jax():
    jg, tg = gel_meshes()
    scenes = {
        "lone": (S.lone_cloth(J), S.lone_cloth(T)),
        "hairpin": (S.hairpin(J), S.hairpin(T)),
        "hairpin_no_self": (S.hairpin(J, self_k=0), S.hairpin(T, self_k=0)),
        "gel": (S.cloth_on_gel(J, jg), S.cloth_on_gel(T, tg)),
    }
    import runpy
    build = runpy.run_path("examples/cloth_trampoline_torch.py")["build"]
    scenes["trampoline"] = (S.trampoline_jax(S.sim_cfg(J, contact=J.UipcSimCfg.Contact(coupling_k=4))),
                            build("cpu", S.sim_cfg(T, contact=T.UipcSimCfg.Contact(coupling_k=4))))
    routes = {}
    for name, (j, t) in scenes.items():
        (sj, cj), (st, ct) = j[:2], t[:2]
        if name == "gel":
            cj, ct = j[2], t[2]
        route = (isinstance(ct.model, ShellModel), ct._union_range is not None, st._coupled is not None)
        assert route == (type(cj.model).__name__ == "ShellModel", cj._union_range is not None,
                         sj._coupled is not None), name
        assert ct._union_range == cj._union_range, name
        routes[name] = route
        if route[0]:
            m_j, m_t = cj.model, ct.model
            assert dataclasses.asdict(m_t.cfg) == dataclasses.asdict(m_j.cfg), name
        else:
            m_j, m_t = sj._union_model, st._union_model
            for f in ("tris", "hinges", "hinge_w", "theta0", "rest_area", "mu", "lam", "d_inv"):
                np.testing.assert_array_equal(numpy(getattr(m_t.shell, f)), numpy(getattr(m_j.shell, f)), f)
        np.testing.assert_array_equal(numpy(m_t.masses), numpy(m_j.masses), name)
        np.testing.assert_array_equal(numpy(m_t.attachment_k).ravel(), numpy(m_j.attachment_k).ravel(), name)
    # a lone cloth's union has no tets: rest data, lumped masses and the FEM energy take 0 tets
    union = scenes["hairpin"][1][0]._union_model
    assert union.tets.shape == (0, 4) and union.rest_vol.shape == (0,)
    x = union.mesh.points[None] * np.float32(1.01)
    assert float(tipc.stable_neo_hookean_energy(torch.from_numpy(x), union.tets, union.dm_inv, union.rest_vol,
                                                union.mu, union.lam)) == 0.0
    assert routes == {"lone": (True, False, False), "hairpin": (False, True, False),
                      "hairpin_no_self": (True, False, False), "gel": (False, True, False),
                      "trampoline": (False, True, True)}
    for kw in ({}, dict(dt=1 / 60, contact=dict(friction=False, d_hat=0.004)), dict(newton=dict(max_iter=3))):
        cfgs = []
        for M in (J, T):
            c = M.UipcSimCfg(dt=kw.get("dt", 0.01))
            for part, vals in kw.items():
                if part != "dt":
                    setattr(c, part, getattr(c, part).replace(**vals))
            cfgs.append(dataclasses.asdict(c.to_shell_cfg()))
        assert cfgs[0] == cfgs[1]


def test_lone_cloth_step_matches_jax():
    """The sim's step of its standalone cloth is its ``ShellModel``'s step
    against the empty scene and the ground, with no attachment; that model's
    constants and cfg equal JAX's (``test_routes_and_models_match_jax``)
    and its step is held to JAX in ``test_torch_shell.py``."""
    st, ct = S.lone_cloth(T)
    model = ct.model
    x0 = ct.state.x.clone()
    planes = torch.tensor([[[0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 1.0, 0.0]]])
    scene = dataclasses.replace(tipc.RigidSdfScene.empty(1, device="cpu"), planes=planes)
    direct = model.step(tipc.SoftBodyState(x=x0, v=torch.zeros_like(x0)), scene)
    st.step()
    np.testing.assert_array_equal(numpy(ct.nodal_pos_w), numpy(direct.x))
    assert numpy(direct.x)[0, :, 2].max() < 0.02 - 5e-4, "the cloth fell"
    assert model.static_tris.shape == (12, 3, 3), "the kinematic cube's soup"


def _launch(sim, cloth, n_bot):
    """Launch the hairpin's top layer down at LAUNCH m/s through the union state."""
    lo, hi = cloth._union_range
    u = sim._union_state
    if isinstance(u.v, torch.Tensor):
        v = u.v.clone()
        v[:, lo + n_bot:hi, 2] = LAUNCH
    else:
        v = u.v.at[:, lo + n_bot:hi, 2].set(LAUNCH)
    sim._union_state = dataclasses.replace(u, v=v)
    cloth._refresh_union_slice()


def test_hairpin_self_contact_step_matches_jax():
    out = {}
    for M in (J, T):
        sim, cloth, n_bot = S.hairpin(M)
        if M is J:
            single_env_steps(sim)
        _launch(sim, cloth, n_bot)
        sim.step()
        out[M.__name__] = numpy(cloth.nodal_pos_w)[0]
    xj, xt = out["tacex_tpu.uipc"], out["tacex_tpu_torch.uipc"]
    np.testing.assert_allclose(xt, xj, rtol=0, atol=S.UNION_ATOL)
    assert xj[21:, 2].min() < 0.004 - 2e-4, "the top layer moved down"
    assert xj[21:, 2].min() > xj[:21, 2].max(), "the top layer above the bottom one"


def test_cloth_on_gel_union_step_matches_jax():
    jg, tg = gel_meshes()
    (sj, gj, cj), (st, gt, ct) = S.cloth_on_gel(J, jg), S.cloth_on_gel(T, tg)
    assert st._union_model.shell is not None and gt._union_range is not None and ct._union_range is not None
    single_env_steps(sj)
    sj.step()
    st.step()
    for oj, ot in ((gj, gt), (cj, ct)):
        np.testing.assert_allclose(numpy(ot.nodal_pos_w), numpy(oj.nodal_pos_w), rtol=0, atol=S.UNION_ATOL)
    # the barrier carried the cloth: free fall would lower it ~1 mm, the gel's barrier lifts it
    assert numpy(cj.nodal_pos_w)[0, :, 2].min() > 0.0205
