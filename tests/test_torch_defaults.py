"""The port runs on the card unless the caller asks for the CPU.

Every entry point defaults to ``device="cuda"``; without a card, calling one
without ``device=`` raises instead of returning a CPU object. This file
imports neither jax nor the JAX package.
"""

import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from tacex_tpu_torch import envs
from tacex_tpu_torch.core import device as tdevice
from tacex_tpu_torch.envs.ball_rolling.convert import state_from_numpy
from tacex_tpu_torch.envs.ball_rolling.env import BallRollingEnv
from tacex_tpu_torch.envs.ball_rolling.env_uipc import BallRollingUipcEnv
from tacex_tpu_torch.envs.base import DirectRLEnv
from tacex_tpu_torch.envs.convert import state_from_numpy as any_state_from_numpy
from tacex_tpu_torch.envs.factory.env import FactoryEnv
from tacex_tpu_torch.envs.factory.env_uipc import FactoryUipcEnv
from tacex_tpu_torch.envs.grasp_lift.env import GraspLiftEnv
from tacex_tpu_torch.physics.soft.abd import AbdModel, AbdState
from tacex_tpu_torch.envs.pole_balancing.env import PoleBalancingEnv
from tacex_tpu_torch.rl import PPO, SAC
from tacex_tpu_torch.physics.soft.embed import EmbeddedFaceGrid
from tacex_tpu_torch.physics.soft.ipc import RigidSdfScene, SoftBodyModel, SoftBodyState
from tacex_tpu_torch.physics.soft.mesh import box_tet_mesh
from tacex_tpu_torch.rl.networks import ActorCritic, VisionEncoder
from tacex_tpu_torch.sensors.gelsight.fem import FemMarkerFlow, ManiSkillSimulatorCfg
from tacex_tpu_torch.sensors.gelsight.fem.mani_skill_sim import ManiSkillSimulator
from tacex_tpu_torch.sensors.gelsight.sensor import GelSightSensor
from tacex_tpu_torch.sensors.gelsight.sensor_cfg import gelsight_mini_cfg
from tacex_tpu_torch.utils import trace

ENV_ID = "TacEx-Ball-Rolling-Taxim-Fots-v0"

ENTRY_POINTS = {
    "envs.make": envs.make,
    "DirectRLEnv": DirectRLEnv,
    "BallRollingEnv": BallRollingEnv,
    "GelSightSensor": GelSightSensor,
    "state_from_numpy": state_from_numpy,
    "ActorCritic": ActorCritic,
    "VisionEncoder": VisionEncoder,
    "FactoryEnv": FactoryEnv,
    "PoleBalancingEnv": PoleBalancingEnv,
    "envs.convert.state_from_numpy": any_state_from_numpy,
    "BallRollingUipcEnv": BallRollingUipcEnv,
    "SoftBodyModel": SoftBodyModel,
    "SoftBodyState.init": SoftBodyState.init,
    "RigidSdfScene.empty": RigidSdfScene.empty,
    "EmbeddedFaceGrid": EmbeddedFaceGrid,
    "FemMarkerFlow": FemMarkerFlow,
    "GraspLiftEnv": GraspLiftEnv,
    "FactoryUipcEnv": FactoryUipcEnv,
    "AbdModel": AbdModel,
    "AbdState.identity": AbdState.identity,
    "ManiSkillSimulator": ManiSkillSimulator,
    "utils.trace": trace,
}
COUPLED_IDS = [
    "TacEx-Grasp-Lift-Uipc-v0",
    "TacEx-Grasp-Lift-Uipc-Depth-v0",
    "TacEx-Grasp-Lift-Uipc-Tactile-v0",
    "TacEx-Factory-PegInsert-Uipc-v0",
    "TacEx-Factory-PegInsert-Uipc-Depth-v0",
]
UIPC_IDS = ["TacEx-Ball-Rolling-Tactile-RGB-Uipc-v0", "TacEx-Ball-Rolling-Uipc-Textured-v0"]
OTHER_IDS = [
    "TacEx-Factory-PegInsert-Direct-v0",
    "TacEx-Factory-GearMesh-Direct-v0",
    "TacEx-Factory-NutThread-Direct-v0",
    "TacEx-Pole-Balancing-Base-v0",
]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    assert inspect.signature(ENTRY_POINTS[name]).parameters["device"].default == "cuda"


def test_make_without_a_card_raises(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        envs.make(ENV_ID, num_envs=2)


@pytest.mark.parametrize("env_id", OTHER_IDS)
def test_factory_and_pole_ids_need_the_card_unless_asked(no_card, env_id):
    """The Factory and pole ids take the card by default (at their default
    widths, 128 and 1024 envs) and raise without one; on request they run
    on the CPU, and so does SAC on them."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        envs.make(env_id)
    env = envs.make(env_id, num_envs=2, device="cpu")
    assert env.device.type == "cpu" and env.cfg.num_envs == 2
    assert envs.base._REGISTRY[env_id][1]().num_envs == (1024 if "Pole" in env_id else 128)
    assert "device" not in inspect.signature(SAC).parameters and SAC(env).device.type == "cpu"


@pytest.mark.parametrize(
    "build",
    [
        lambda: GelSightSensor(gelsight_mini_cfg(camera_resolution=(32, 24), tactile_img_res=(32, 24)), num_envs=2),
        lambda: ActorCritic(14, (24, 32, 3), 6),
        lambda: VisionEncoder(3),
        lambda: state_from_numpy({}),
    ],
    ids=["GelSightSensor", "ActorCritic", "VisionEncoder", "state_from_numpy"],
)
def test_other_entry_points_without_a_card_raise(no_card, build):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()


@pytest.mark.parametrize("env_id", UIPC_IDS)
def test_uipc_ids_need_the_card_unless_asked(no_card, env_id):
    """Both UIPC ball-rolling ids take the card at their registered 16 envs
    and raise without one; on request they run on the CPU, the gel solver
    and the marker flow with them."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        envs.make(env_id)
    env = envs.make(env_id, num_envs=2, device="cpu")
    assert env.device.type == "cpu" and env.gel.device.type == "cpu"
    assert env.marker_flow.device.type == "cpu" and env.gel.masses.device.type == "cpu"
    assert envs.base._REGISTRY[env_id][1]().num_envs == 16


def test_soft_body_parts_without_a_card_raise(no_card):
    mesh = box_tet_mesh((0.01, 0.01, 0.004), (2, 2, 1))
    rest = mesh.points[mesh.surface_verts]
    tris = np.searchsorted(mesh.surface_verts, mesh.surface_tris)  # surface_verts is sorted
    for build in (lambda: SoftBodyModel(mesh), lambda: SoftBodyState.init(2, mesh.points),
                  lambda: RigidSdfScene.empty(2), lambda: FemMarkerFlow(ManiSkillSimulatorCfg(), rest, tris)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


def test_experiment_harness_defaults_to_the_card(no_card):
    import runpy

    harness = runpy.run_path(str(Path(__file__).resolve().parents[1] / "scripts" / "benchmarking"
                                 / "run_ball_rolling_experiment_torch.py"))
    assert inspect.signature(harness["run"]).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness["main"](["--env", "uipc", "--num_envs", "2", "--steps", "1"])


def test_trainer_and_launcher_run_where_the_env_runs(no_card):
    """``PPO`` takes no device of its own: it runs on its env's, and the env
    defaults to the card. The launcher's ``--device`` defaults to ``cuda``."""
    assert "device" not in inspect.signature(PPO).parameters
    assert PPO(envs.make(ENV_ID, num_envs=2, device="cpu")).device.type == "cpu"
    import runpy

    launcher = runpy.run_path(str(Path(__file__).resolve().parents[1] / "scripts" / "train_torch.py"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher["main"](["--num_envs", "2", "--iterations", "1"])


def test_cpu_on_request():
    env = envs.make(ENV_ID, num_envs=2, device="cpu")
    assert env.device.type == "cpu" and env.sensor.device.type == "cpu"
    assert tdevice.resolve("cpu") == torch.device("cpu")


@pytest.mark.parametrize("env_id", COUPLED_IDS)
def test_coupled_ids_need_the_card_unless_asked(no_card, env_id):
    """The Grasp-Lift and Factory-UIPC ids take the card at their registered
    16 envs and raise without one; on request the env, its coupled solver
    (the gel and the affine body) and, for the tactile id, the sensor run
    on the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        envs.make(env_id)
    env = envs.make(env_id, num_envs=2, device="cpu")
    assert env.device.type == "cpu" and env.world.device.type == "cpu"
    assert env.gel.masses.device.type == "cpu" and env.world.abd.mass.device.type == "cpu"
    if "Tactile" in env_id:
        assert env.sensor.device.type == "cpu"
    cfg = envs.base._REGISTRY[env_id][1]()
    assert cfg.num_envs == 16 and (cfg.newton_iters, cfg.cg_iters, cfg.coupling_k) == (6, 24, 4)


def test_affine_body_without_a_card_raises(no_card):
    from tacex_tpu_torch.envs.grasp_lift.env import _cube_surface
    from tacex_tpu_torch.physics.soft.abd import AbdSolverCfg

    pts, tris = _cube_surface()
    for build in (lambda: AbdModel([pts], [tris], cfg=AbdSolverCfg(contact_k=0, ee_contact_k=0)),
                  lambda: AbdState.identity(2, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


def test_mani_skill_simulator_and_trace_without_a_card_raise(no_card, tmp_path):
    mesh = box_tet_mesh((0.018, 0.014, 0.004), (8, 7, 2), center=(0.0, 0.0, -0.002))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ManiSkillSimulator(ManiSkillSimulatorCfg(), mesh)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with trace(tmp_path / "tr"):
            pass
    assert not (tmp_path / "tr").exists()
    assert ManiSkillSimulator(ManiSkillSimulatorCfg(), mesh, device="cpu").device.type == "cpu"


# each user-facing script of the slice, and arguments that keep a run on a
# card small; without a card each raises before it computes or writes anything
SCRIPTS = {
    "play_torch.py": ["--num_envs", "2", "--steps", "1"],
    "list_envs_torch.py": [],
    "demos/check_taxim_sim_torch.py": ["--res", "24", "32"],
    "demos/check_fots_sim_torch.py": [],
    "demos/run_shape_touch_torch.py": ["--res", "24", "32"],
    "demos/follow_goal_torch.py": ["--steps", "1"],
    "demos/check_mani_skill_marker_torch.py": ["--steps", "1"],
    "demos/pick_up/pick_up_rigid_torch.py": ["--steps_per_phase", "1"],
    "demos/pick_up/pick_up_uipc_torch.py": ["--steps_per_phase", "1"],
    "benchmarking/benchmark_non_rl_example_torch.py": ["--num_envs", "2", "--num_frames", "1"],
    "benchmarking/benchmark_embedded_gel_torch.py": ["--envs", "2", "--steps", "1", "--skip_dense"],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_scripts_default_to_the_card(no_card, script, tmp_path):
    """``--device`` defaults to ``cuda``; without a card the script raises
    instead of running on the CPU, and writes nothing."""
    import runpy

    path = Path(__file__).resolve().parents[1] / "scripts" / script
    assert '"--device", default="cuda"' in path.read_text()
    text = path.read_text()
    argv = list(SCRIPTS[script])
    if '"--out",' in text:
        argv += ["--out", str(tmp_path / "out.png")]
    if '"--out_dir",' in text:
        argv += ["--out_dir", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runpy.run_path(str(path))["main"](argv)
    assert list(tmp_path.iterdir()) == []
