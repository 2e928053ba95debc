"""The UIPC scene API of the port (``tacex_tpu_torch.uipc``) against the JAX
package's, on the scenes of ``tests/test_uipc_api.py`` and
``tests/test_ccd_envelope.py``: the 20 x 25 x 4.5 mm gel of (4, 5, 2)
cells under a top-face attachment (``_torch_uipc_api.build_gel``), 4
Newton x 8 CG iterations a step (24 for the dragged gel's 1.5 mm).

Held to JAX: the gel's positions after 3 steps of its mount moved 2 mm
sideways (``_torch_uipc_api.ATOL``, 1.5e-5 m), the attachment selection
exactly. The rest are the JAX tests' behaviours on the port: lifecycle and
time report, reset by vertex write, save/replay after later writes, the
sanity and health checks, the ccd-substeps warning and plumbing, the CCD
motion guard, ``step_n``'s refusal of live providers, and the worlds that
earlier slices left out (the split ABD solve, shells), which now step.
"""

import warnings

import numpy as np
import pytest
import torch

from _torch_bins import setup_torch
from _torch_uipc_api import ATOL, J, T, build_gel, drive, numpy, single_env_steps

setup_torch()


def test_lifecycle_and_moving_attachment_match_jax():
    out = {}
    for M in (J, T):
        sim, obj, att = build_gel(M, num_envs=2)
        sim.setup_sim()
        if M is J:
            single_env_steps(sim)
        drive(M, obj, att, 2, shift=(0.002, 0.0, 0.0))
        for _ in range(3):
            sim.step()
        out[M] = numpy(obj.nodal_pos_w)
    np.testing.assert_allclose(out[T], out[J], atol=ATOL, rtol=0)
    assert np.isfinite(out[T]).all() and out[T].shape[0] == 2
    report = sim.get_sim_time_report(as_json=True)
    assert report["step"] > 0 and "step: " in sim.get_sim_time_report()
    meshes = sim.update_render_meshes()
    assert list(meshes) == [0] and tuple(meshes[0].shape) == (2, len(obj.mesh.surface_verts), 3)
    top = att.vertex_ids
    assert (out[T][:, top, 0] - obj.mesh.points[top, 0]).mean() > 5e-4  # the top face follows the mount


def test_moving_attachment_drags_gel():
    sim, obj, att = build_gel(T, num_envs=1, cg_iters=24)
    sim.setup_sim()
    drive(T, obj, att, 1, shift=(0.002, 0.0, 0.0))
    for _ in range(6):
        sim.step()
    top = att.vertex_ids
    moved = obj.nodal_pos_w[0, top, 0].numpy() - obj.mesh.points[top, 0]
    assert moved.mean() > 0.0015


def test_attachment_selection_matches_jax():
    _, obj_j, att_j = build_gel(J)
    _, obj_t, att_t = build_gel(T)
    np.testing.assert_array_equal(att_t.vertex_ids, att_j.vertex_ids)
    np.testing.assert_allclose(att_t.offsets, att_j.offsets, atol=1e-9)
    assert len(att_t.vertex_ids) == 5 * 6
    np.testing.assert_allclose(obj_t.mesh.points[att_t.vertex_ids][:, 2], 0.0, atol=1e-6)


def test_save_replay_frame_after_later_writes():
    """A saved frame is a copy: stepping and writing the live state later
    leaves it as it was, and replaying restores it, twice."""
    sim, obj, att = build_gel(T, num_envs=2)
    sim.setup_sim()
    drive(T, obj, att, 2)
    sim.step()
    f = sim.save_frame()
    x_saved = obj.nodal_pos_w.clone()
    for _ in range(2):
        sim.step()
    obj.write_vertex_positions_to_sim(obj.init_vertex_pos + 1e-3, env_mask=torch.tensor([True, False]))
    for _ in range(2):
        sim.replay_frame(f)
        assert torch.equal(obj.nodal_pos_w, x_saved) and sim._frame_counter == f
        obj.write_vertex_positions_to_sim(obj.init_vertex_pos)
    with pytest.raises(KeyError):
        sim.replay_frame(f + 5)
    sim.max_saved_frames = 2
    for _ in range(3):
        sim.step()
        sim.save_frame()
    assert len(sim._frames) == 2


def test_reset_via_vertex_write():
    sim, obj, att = build_gel(T, num_envs=2)
    sim.setup_sim()
    drive(T, obj, att, 2)
    for _ in range(3):
        sim.step()
    obj.write_vertex_positions_to_sim(obj.init_vertex_pos, env_mask=torch.tensor([True, False]))
    x = obj.nodal_pos_w.numpy()
    np.testing.assert_allclose(x[0], obj.init_vertex_pos, atol=0)
    assert np.abs(x[1] - obj.init_vertex_pos).max() > 0
    assert float(obj.state.v[0].abs().max()) == 0.0


def test_sanity_check_flags_bad_dhat():
    sim = T.UipcSim(T.UipcSimCfg(num_envs=1, contact=T.UipcSimCfg.Contact(d_hat=0.5)), device="cpu")
    T.UipcObject(T.UipcObjectCfg(mesh_cfg=T.objects.TetMeshCfg(size=(0.02, 0.02, 0.004), resolution=(2, 2, 1))), sim)
    with pytest.raises(ValueError, match="d_hat"):
        sim.setup_sim()


def test_health_checks():
    """A healthy state passes; a NaN in env 1 is caught by check_health; with
    health_check_interval = 1 step() catches it itself; diff_sim runs none."""
    sim, obj, att = build_gel(T, num_envs=2)
    sim.setup_sim()
    drive(T, obj, att, 2)
    sim.step()
    assert sim.check_health() == {}
    x = obj.state.x.clone()
    x[1, 0, 0] = float("nan")
    obj.state = T.sim.SoftBodyState(x=x, v=obj.state.v)
    with pytest.raises(FloatingPointError, match=r"envs \[1\]"):
        sim.check_health()

    sim, obj, att = build_gel(T, num_envs=1)
    sim.cfg.health_check_interval = 1
    sim.setup_sim()
    drive(T, obj, att, 1)
    sim.step()
    x = obj.state.x.clone()
    x[0, 0, 0] = float("nan")
    obj.state = T.sim.SoftBodyState(x=x, v=obj.state.v)
    with pytest.raises(FloatingPointError):
        sim.step()

    sim, obj, att = build_gel(T, num_envs=1)
    sim.cfg.diff_sim = True
    sim.setup_sim()
    drive(T, obj, att, 1)
    obj.state = T.sim.SoftBodyState(x=x, v=obj.state.v)
    sim.step()  # no health check runs


def _cube(M, kinematic, center=(0.0, 0.0, 0.0)):
    return M.UipcObjectCfg(mesh_cfg=M.objects.TetMeshCfg(size=(0.02, 0.02, 0.02), resolution=(1, 1, 1), center=center),
                           constitution=M.AffineBodyConstitutionCfg(kinematic=kinematic))


def test_ccd_substeps_warning_and_plumbing():
    """ccd_substeps > 1 is honoured only on the nodal path: an ABD-only scene
    warns and the motion guard divides by 1; a FEM scene keeps it."""
    sim = T.UipcSim(T.UipcSimCfg(num_envs=1, newton=T.UipcSimCfg.Newton(max_iter=2, ccd_substeps=4)), device="cpu")
    T.UipcObject(_cube(T, kinematic=True), sim)
    with pytest.warns(UserWarning, match="ccd_substeps"):
        sim.setup_sim()
    assert sim._effective_ccd_substeps == 1
    sim, obj, att = build_gel(T, num_envs=1)
    sim.cfg.newton.ccd_substeps = 2
    sim.setup_sim()
    assert sim._effective_ccd_substeps == 2 and obj.model.cfg.ccd_substeps == 2


def _sphere(z: float):
    sc = T.sim.RigidSdfScene.empty(1, device="cpu")
    return T.sim.RigidSdfScene(torch.tensor([[[0.0, 0.0, z, 0.005]]]), sc.boxes, sc.capsules, sc.planes)


def test_ccd_motion_guard_warns_and_raises():
    """``tests/test_ccd_envelope.py``'s guard scene: a 30 mm collider jump past
    a 5 mm limit warns, and raises with strict_ccd; the first frame and a
    guard at 0 read nothing."""
    cfg = T.UipcSimCfg(num_envs=1, dt=1 / 60)
    cfg.newton.ccd_motion_limit = 0.005
    sim = T.UipcSim(cfg, device="cpu")
    T.UipcObject(T.UipcObjectCfg(mesh_cfg=T.objects.TetMeshCfg(size=(0.02, 0.025, 0.0045), resolution=(3, 3, 2))), sim)
    sim.setup_sim()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sim.step(_sphere(0.05))  # first frame: no previous scene
    with pytest.warns(UserWarning, match="CCD envelope exceeded"):
        sim.step(_sphere(0.02))
    cfg.newton.strict_ccd = True
    with pytest.raises(RuntimeError, match="CCD envelope exceeded"):
        sim.step(_sphere(-0.02))


def test_step_n_rejects_live_providers():
    sim, obj, att = build_gel(T, num_envs=1)
    sim.setup_sim()
    drive(T, obj, att, 1)
    with pytest.raises(AssertionError, match="providers"):
        sim.step_n(2)


def test_unported_worlds_raise():
    """The worlds of ROADMAP item 8a now step: a lone dynamic affine body
    (the split ABD solve), two of them (with body-body contact) and a FEM
    object beside an affine body outside the coupled world (``coupling_k =
    0``); each body falls under gravity. So does a lone shell object (item
    8b), through its own ``ShellModel``."""
    sim = T.UipcSim(T.UipcSimCfg(num_envs=1, newton=T.UipcSimCfg.Newton(max_iter=2)), device="cpu")
    T.UipcObject(_cube(T, kinematic=False), sim)
    sim.setup_sim()
    sim.step()
    assert sim._abd_state.q[0, 0, 2].item() < 0.0 and sim._abd_model.cfg.contact_k == 0
    sim = T.UipcSim(T.UipcSimCfg(num_envs=1, newton=T.UipcSimCfg.Newton(max_iter=2)), device="cpu")
    T.UipcObject(_cube(T, kinematic=False), sim)
    T.UipcObject(_cube(T, kinematic=False, center=(0.05, 0.0, 0.0)), sim)
    sim.setup_sim()
    assert sim._abd_model.cfg.contact_k == 8 and sim._abd_model._ee_on
    sim.step()
    assert (sim._abd_state.q[0, :, 2] < 0.0).all()
    assert sorted(sim.broad_phase_overflow()) == ["abd_ee", "abd_vt_body"]
    sim = T.UipcSim(T.UipcSimCfg(num_envs=1, newton=T.UipcSimCfg.Newton(max_iter=2),
                                 contact=T.UipcSimCfg.Contact(coupling_k=0)), device="cpu")
    gel = T.UipcObject(T.UipcObjectCfg(mesh_cfg=T.objects.TetMeshCfg(size=(0.02, 0.02, 0.004), resolution=(2, 2, 1))),
                       sim)
    T.UipcObject(_cube(T, kinematic=False, center=(0.0, 0.0, 0.05)), sim)
    sim.setup_sim()
    assert sim._coupled is None
    sim.step()
    assert sim._abd_state.q[0, 0, 2].item() < 0.0 and gel.root_pos_w[0, 2].item() < 0.0
    sim = T.UipcSim(T.UipcSimCfg(num_envs=1, newton=T.UipcSimCfg.Newton(max_iter=2)), device="cpu")
    pts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    cloth = T.UipcObject(T.UipcObjectCfg(constitution=T.NeoHookeanShellCfg()), sim, points=pts,
                         triangles=np.array([[0, 1, 2]]))
    sim.setup_sim()
    assert type(cloth.model).__name__ == "ShellModel" and sim.cfg.to_shell_cfg().newton_max_iter == 2
    sim.step()
    assert (cloth.nodal_pos_w[0, :, 2] < 0.0).all()


def test_solver_cfg_matches_jax():
    for kw in ({}, dict(contact=dict(self_contact_k=4, ee_contact_k=2, friction=False)),
               dict(contact=dict(enable=False, self_contact_k=4), newton=dict(ccd_substeps=3))):
        cfgs = []
        for M in (J, T):
            c = M.UipcSimCfg(dt=1 / 120)
            for part, vals in kw.items():
                for k, v in vals.items():
                    setattr(getattr(c, part), k, v)
            cfgs.append(c.to_solver_cfg().to_dict())
        assert cfgs[0] == cfgs[1]


def _stacked_gels(k: int, overflow_errors: bool = False):
    """``tests/test_broad_phase_overflow.py``'s scene: two (4, 4, 1) slabs
    0.5 mm apart (d_hat 0.5 mm), the lower one anchored, 2 Newton iterations."""
    sim = T.UipcSim(T.UipcSimCfg(num_envs=2, newton=T.UipcSimCfg.Newton(max_iter=2),
                                 linear_system=T.UipcSimCfg.LinearSystem(max_iter=8),
                                 contact=T.UipcSimCfg.Contact(d_hat=5e-4, self_contact_k=k,
                                                              overflow_errors=overflow_errors)), device="cpu")

    def gel(cz):
        return T.UipcObjectCfg(mesh_cfg=T.objects.TetMeshCfg(size=(0.02, 0.02, 0.004), resolution=(4, 4, 1),
                                                             center=(0, 0, cz)))

    lo = T.UipcObject(gel(0.002), sim)
    T.UipcObject(gel(0.0065), sim)
    lo.set_attachments(np.where(lo.mesh.points[:, 2] < 1e-6)[0].astype(np.int32), strength_ratio=200.0)
    sim.setup_sim()
    sim.step()
    return sim


def test_broad_phase_overflow_warns_raises_or_stays_silent():
    """K = 1 on the dense interface: check_health warns and every env's
    vt_self count is nonzero; with overflow_errors it raises; K = 24 is
    clean and silent. The counts equal the narrow phase's own cut, recounted."""
    sim = _stacked_gels(1)
    with pytest.warns(RuntimeWarning, match="broad-phase overflow"):
        report = sim.check_health()
    assert (report["vt_self"] > 0).all(), report
    model = sim._union_model
    d2 = model._self_d2(sim._union_state.x)
    cut = 3.0 * model.cfg.d_hat + model._tri_radius_max
    expect = torch.clamp((d2 < cut * cut).sum(-1) - 1, min=0).sum(-1).numpy()
    np.testing.assert_array_equal(report["vt_self"], expect)
    with pytest.raises(RuntimeError, match="raise the matching contact"):
        _stacked_gels(1, overflow_errors=True).check_health()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        report = _stacked_gels(24).check_health()
    assert all(int(v.sum()) == 0 for v in report.values()), report
