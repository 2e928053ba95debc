"""The port stands alone: it loads neither jax nor the JAX package, and its
kernel build refuses to run without nvcc instead of falling back."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tacex_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parents[1]

SLICE_MODULES = [
    "tacex_tpu_torch",
    "tacex_tpu_torch.core.config",
    "tacex_tpu_torch.core.maths",
    "tacex_tpu_torch.core.device",
    "tacex_tpu_torch.ops.blur",
    "tacex_tpu_torch.ops.resize",
    "tacex_tpu_torch.ops.pyramid",
    "tacex_tpu_torch.ops.lut_shade",
    "tacex_tpu_torch.ops._build",
    "tacex_tpu_torch.sensors.gelsight.taxim.params",
    "tacex_tpu_torch.sensors.gelsight.taxim.calib",
    "tacex_tpu_torch.sensors.gelsight.taxim.optical",
    "tacex_tpu_torch.sensors.gelsight.fots.marker_motion",
    "tacex_tpu_torch.sensors.gelsight.sensor_cfg",
    "tacex_tpu_torch.sensors.gelsight.sensor",
    "tacex_tpu_torch.render.depth_camera",
    "tacex_tpu_torch.render.mesh_raster",
    "tacex_tpu_torch.assets.meshes",
    "tacex_tpu_torch.ops.sdf",
    "tacex_tpu_torch.physics.rigid.franka",
    "tacex_tpu_torch.physics.rigid.contact",
    "tacex_tpu_torch.physics.rigid.bodies",
    "tacex_tpu_torch.physics.rigid.articulation",
    "tacex_tpu_torch.envs.base",
    "tacex_tpu_torch.envs.convert",
    "tacex_tpu_torch.envs.ball_rolling.env",
    "tacex_tpu_torch.envs.ball_rolling.convert",
    "tacex_tpu_torch.envs.factory.contact",
    "tacex_tpu_torch.envs.factory.env",
    "tacex_tpu_torch.envs.factory",
    "tacex_tpu_torch.envs.pole_balancing.env",
    "tacex_tpu_torch.envs.pole_balancing",
    "tacex_tpu_torch.envs",
    "tacex_tpu_torch.rl.networks",
    "tacex_tpu_torch.rl.ppo",
    "tacex_tpu_torch.rl.sac",
    "tacex_tpu_torch.rl.agents",
    "tacex_tpu_torch.rl",
    "tacex_tpu_torch.physics.soft.mesh",
    "tacex_tpu_torch.physics.soft.fem",
    "tacex_tpu_torch.physics.soft.ipc",
    "tacex_tpu_torch.physics.soft.embed",
    "tacex_tpu_torch.physics.soft",
    "tacex_tpu_torch.sensors.gelsight.fem.marker_flow",
    "tacex_tpu_torch.sensors.gelsight.fem",
    "tacex_tpu_torch.envs.ball_rolling.env_uipc",
    "tacex_tpu_torch.physics.soft.abd",
    "tacex_tpu_torch.physics.soft.coupled",
    "tacex_tpu_torch.envs.grasp_lift.env",
    "tacex_tpu_torch.envs.grasp_lift",
    "tacex_tpu_torch.envs.factory.env_uipc",
]
# the modules of the user-facing tools
TOOL_MODULES = [
    "tacex_tpu_torch.utils.png",
    "tacex_tpu_torch.utils.visualizer",
    "tacex_tpu_torch.utils.profiling",
    "tacex_tpu_torch.utils",
    "tacex_tpu_torch.assets.shapes",
    "tacex_tpu_torch.assets.robots",
    "tacex_tpu_torch.assets",
    "tacex_tpu_torch.sensors.gelsight.fem.mani_skill_sim",
]
SLICE_MODULES += TOOL_MODULES
# the UIPC scene API and its helpers
UIPC_MODULES = [
    "tacex_tpu_torch.uipc.objects",
    "tacex_tpu_torch.uipc.attachments",
    "tacex_tpu_torch.uipc.sim",
    "tacex_tpu_torch.uipc.scene",
    "tacex_tpu_torch.uipc",
    "tacex_tpu_torch.sensors.gelsight.sensor_data",
    "tacex_tpu_torch.sensors.gelsight.fem.geometry",
]
SLICE_MODULES += UIPC_MODULES
# shells (cloth) and the .msh reader
SHELL_MODULES = [
    "tacex_tpu_torch.physics.soft.codim",
    "tacex_tpu_torch.physics.soft.shell",
    "tacex_tpu_torch.physics.soft.msh_io",
]
SLICE_MODULES += SHELL_MODULES
# env-axis data parallelism
PARALLEL_MODULES = [
    "tacex_tpu_torch.parallel.group",
    "tacex_tpu_torch.parallel.mesh",
    "tacex_tpu_torch.parallel.dryrun",
    "tacex_tpu_torch.parallel",
]
SLICE_MODULES += PARALLEL_MODULES
# the UIPC examples and the CCD envelope script, with the arguments of a short run
UIPC_SCRIPTS = {
    "examples/libuipc_samples/hello_uipc_torch.py": ["--steps", "1"],
    "examples/libuipc_samples/floating_cube_torch.py": ["--steps", "1"],
    "examples/libuipc_samples/periodically_pressed_tetrahedron_torch.py": ["--steps", "1"],
    "examples/falling_gel_cubes_torch.py": ["--steps", "1"],
    "examples/single_uipc_attachment_torch.py": ["--steps", "1"],
    "examples/grasp_lift_torch.py": ["--steps", "0"],  # its coupled world built; a step costs ~5 s here
    "scripts/benchmarking/ccd_envelope_torch.py": ["--dts", "0.1", "--velocities", "1.0"],
    # the affine-body samples built, not stepped, and the ABD pile benchmark one step of one Newton iteration
    "examples/libuipc_samples/ramp_sliding_torch.py": ["--steps", "0"],
    "examples/libuipc_samples/walking_cube_torch.py": ["--steps", "0"],
    "examples/libuipc_samples/wrecking_balls_torch.py": ["--steps", "0"],
    "examples/libuipc_samples/screw_and_nut_torch.py": ["--steps", "0"],
    "scripts/benchmarking/benchmark_abd_pile_torch.py": ["--envs", "1", "--steps", "1", "--solver", "cg",
                                                         "--newton_iters", "1"],
    # the cloth scenes built (the standalone ShellModel; the union of the coupled world), not stepped
    "examples/libuipc_samples/bunny_cloth_torch.py": ["--steps", "0"],
    "examples/cloth_trampoline_torch.py": ["--steps", "0"],
}
# the coupled-world benchmarking scripts, with the arguments of a run that raises at once without a card
COUPLED_SCRIPTS = {
    "scripts/benchmarking/benchmark_grasp_lift_torch.py": ["--envs", "1", "--steps", "0"],
    "scripts/benchmarking/embed_accuracy_torch.py": ["--envs", "1", "--steps", "2"],
    "scripts/benchmarking/embed_accuracy_grasp_torch.py": ["--steps", "1"],
    "scripts/benchmarking/profile_coupled_torch.py": ["--envs", "1", "--steps", "1"],
    "scripts/benchmarking/sweep_grasp_lift_scale_torch.py": [],
}
# the slice's scripts, under scripts/
TOOL_SCRIPTS = [
    "train_torch.py",
    "play_torch.py",
    "list_envs_torch.py",
    "demos/check_taxim_sim_torch.py",
    "demos/check_fots_sim_torch.py",
    "demos/run_shape_touch_torch.py",
    "demos/follow_goal_torch.py",
    "demos/check_mani_skill_marker_torch.py",
    "demos/pick_up/pick_up_rigid_torch.py",
    "demos/pick_up/pick_up_uipc_torch.py",
    "benchmarking/benchmark_non_rl_example_torch.py",
    "benchmarking/benchmark_embedded_gel_torch.py",
]
# a meta-path finder that makes importing any of these packages raise
BLOCKER = (
    "import sys\n"
    "class _Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tacex_tpu', 'PIL', 'matplotlib'):\n"
    "            raise ImportError(f'{name} is blocked')\n"
    "sys.meta_path.insert(0, _Block())\n"
)
COUPLED_IDS = (
    "TacEx-Grasp-Lift-Uipc-v0",
    "TacEx-Grasp-Lift-Uipc-Depth-v0",
    "TacEx-Grasp-Lift-Uipc-Tactile-v0",
    "TacEx-Factory-PegInsert-Uipc-v0",
    "TacEx-Factory-PegInsert-Uipc-Depth-v0",
)


RESULTS_TAG = "@@sections@@"


def _python(code: str, timeout: float = 120) -> subprocess.CompletedProcess:
    """Run ``code`` in a fresh interpreter at the repo root. Its PyTorch takes
    two threads, as the test processes do (``_torch_bins.setup_torch``): with
    one a core it would crowd the other test workers' cores."""
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)


def _sections(sections: dict[str, str], prefix: str = "") -> dict[str, dict]:
    """Run each named block of code in turn in ONE fresh interpreter (after
    ``prefix``), each in a namespace of its own with its stdout captured ->
    {name: {"ok", "stdout", "error"}}. One interpreter serves several
    tests: each test reads and asserts its own block's result."""
    code = prefix + (
        "import contextlib, io, json, traceback\n"
        f"results = {{}}\n"
        f"for name, block in {list(sections.items())!r}:\n"
        "    buf = io.StringIO()\n"
        "    try:\n"
        "        with contextlib.redirect_stdout(buf):\n"
        "            exec(compile(block, name, 'exec'), {'__name__': '__section__'})\n"
        "        results[name] = {'ok': True, 'stdout': buf.getvalue(), 'error': ''}\n"
        "    except BaseException as e:\n"
        "        ok = isinstance(e, SystemExit) and e.code in (0, None)\n"
        "        results[name] = {'ok': ok, 'stdout': buf.getvalue(), 'error': traceback.format_exc()}\n"
        f"print({RESULTS_TAG!r} + json.dumps(results))\n"
    )
    out = _python(code, timeout=120 * len(sections))
    tagged = [line for line in out.stdout.splitlines() if line.startswith(RESULTS_TAG)]
    assert out.returncode == 0 and tagged, out.stderr
    return json.loads(tagged[-1][len(RESULTS_TAG):])


def _section_ok(results: dict, name: str) -> str:
    """The block's stdout, after asserting that it ran to its end."""
    r = results[name]
    assert r["ok"], r["error"]
    return r["stdout"]


# Each kind of check runs its blocks in one interpreter (``_sections``),
# shared by the module's tests: with jax free to import (each block asserts
# that nothing loaded it), and with the BLOCKER installed.
def _import_block() -> str:
    return (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from tacex_tpu_torch import envs\n"
        "for env_id in ('TacEx-Ball-Rolling-Taxim-Fots-v0', 'TacEx-Factory-PegInsert-Direct-v0', "
        "'TacEx-Pole-Balancing-Base-v0', 'TacEx-Ball-Rolling-Tactile-RGB-Uipc-v0', "
        f"'TacEx-Ball-Rolling-Uipc-Textured-v0') + {COUPLED_IDS!r}:\n"
        "    envs.make(env_id, num_envs=2, device='cpu')\n"
        "assert len(envs.base._REGISTRY) == 17\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tacex_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )


def _coupled_step_block() -> str:
    return (
        "import sys, torch\n"
        "from tacex_tpu_torch import envs\n"
        "for env_id, a in (('TacEx-Grasp-Lift-Uipc-Tactile-v0', 2), ('TacEx-Factory-PegInsert-Uipc-v0', 4)):\n"
        "    env = envs.make(env_id, num_envs=2, newton_iters=1, cg_iters=1, device='cpu')\n"
        "    st, obs = env.reset_all(env.init_state())\n"
        "    st, obs, rew, term, trunc, info = env.step(st, torch.ones((2, a)))\n"
        "    assert bool(torch.isfinite(rew).all()) and 'Metric/missed_barriers' in info['log']\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tacex_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )


def _train_block(tmp_path) -> str:
    return (
        "import runpy, sys\n"
        f"sys.argv = ['train_torch.py', '--task', 'TacEx-Ball-Rolling-Privileged-v0', '--num_envs', '4', "
        f"'--iterations', '2', '--rollouts', '4', '--device', 'cpu', '--checkpoint_dir', {str(tmp_path)!r}, "
        "'--checkpoint_interval', '1', '--agent_cfg', 'hidden=(16,)']\n"
        "runpy.run_path('scripts/train_torch.py', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'tacex_tpu'))\n"
        "assert not bad, bad\n"
    )


def _harness_block(out_file) -> str:
    return (
        "import runpy, sys\n"
        "sys.argv = ['run_ball_rolling_experiment_torch.py', '--env', 'uipc', '--num_envs', '2', '--steps', '2', "
        f"'--device', 'cpu', '--out', {str(out_file)!r}]\n"
        "runpy.run_path('scripts/benchmarking/run_ball_rolling_experiment_torch.py', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'tacex_tpu'))\n"
        "assert not bad, bad\n"
    )


def _tools_block(tmp_path) -> str:
    return (
        "import contextlib, importlib, io, runpy\n"
        f"for m in {TOOL_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        f"for script in {TOOL_SCRIPTS!r}:\n"
        "    buf = io.StringIO()\n"
        "    with contextlib.redirect_stdout(buf):\n"
        "        try:\n"
        "            runpy.run_path('scripts/' + script)['main'](['--help'])\n"
        "        except SystemExit as e:\n"
        "            assert e.code == 0, (script, e.code)\n"
        "    assert '--device' in buf.getvalue(), script\n"
        "runpy.run_path('scripts/demos/check_taxim_sim_torch.py')['main']("
        f"['--res', '24', '32', '--device', 'cpu', '--out', {str(tmp_path / 'shapes.png')!r}])\n"
        "from tacex_tpu_torch.utils import LiveVisualizer\n"
        f"v = LiveVisualizer({str(tmp_path / 'viz')!r})\n"
        "v.add_scalars(0, {'a': 1.0}); v.add_scalars(1, {'a': 2.0}); v.add_frame('f', [[0.5]])\n"
        "v.save_plots(); v.save_frame_strip('f')\n"
        "print('ok')\n"
    )


def _uipc_scripts_block() -> str:
    return (
        "import contextlib, importlib, inspect, io, runpy, torch\n"
        f"for m in {UIPC_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from tacex_tpu_torch import uipc\n"
        "for entry in (uipc.UipcSim, uipc.UipcInteractiveScene):\n"
        "    assert inspect.signature(entry).parameters['device'].default == 'cuda', entry\n"
        "card = torch.cuda.is_available()\n"
        f"for script, argv in {UIPC_SCRIPTS!r}.items():\n"
        "    main = runpy.run_path(script)['main']\n"
        "    buf = io.StringIO()\n"
        "    with contextlib.redirect_stdout(buf):\n"
        "        try:\n"
        "            main(['--help'])\n"
        "        except SystemExit as e:\n"
        "            assert e.code == 0, (script, e.code)\n"
        "    assert '--device' in buf.getvalue(), script\n"
        "    assert \"'--device', default='cuda'\" in open(script).read().replace('\"', \"'\"), script\n"
        "    if not card:\n"
        "        try:\n"
        "            main(argv)\n"
        "            raise AssertionError(script + ' ran without a card')\n"
        "        except RuntimeError as e:\n"
        "            assert 'no CUDA device' in str(e), (script, e)\n"
        "    with contextlib.redirect_stdout(io.StringIO()):\n"
        "        out = main(argv + ['--device', 'cpu'])\n"
        "    assert out, script\n"
        "if not card:\n"
        "    for make in (lambda: uipc.UipcSim(uipc.UipcSimCfg()),\n"
        "                 lambda: uipc.UipcInteractiveScene(uipc.UipcInteractiveSceneCfg(), {})):\n"
        "        try:\n"
        "            make()\n"
        "            raise AssertionError('built without a card')\n"
        "        except RuntimeError as e:\n"
        "            assert 'no CUDA device' in str(e), e\n"
        "print('ok')\n"
    )


def _coupled_scripts_block() -> str:
    return (
        "import contextlib, importlib, io, json, runpy, torch\n"
        f"for m in {SHELL_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "card = torch.cuda.is_available()\n"
        f"for script, argv in {COUPLED_SCRIPTS!r}.items():\n"
        "    main = runpy.run_path(script)['main']\n"
        "    buf = io.StringIO()\n"
        "    with contextlib.redirect_stdout(buf):\n"
        "        try:\n"
        "            main(['--help'])\n"
        "        except SystemExit as e:\n"
        "            assert e.code == 0, (script, e.code)\n"
        "    assert '--device' in buf.getvalue(), script\n"
        "    assert \"'--device', default='cuda'\" in open(script).read().replace('\"', \"'\"), script\n"
        "    if card:\n"
        "        continue\n"
        "    buf = io.StringIO()\n"
        "    with contextlib.redirect_stdout(buf):\n"
        "        try:\n"
        "            main(argv)\n"
        "            ran = True\n"
        "        except RuntimeError as e:\n"
        "            assert 'no CUDA device' in str(e), (script, e)\n"
        "            ran = False\n"
        "    if 'sweep' in script:\n"
        "        rows = [json.loads(line) for line in buf.getvalue().splitlines()]\n"
        "        assert len(rows) == 7 and all('no CUDA device' in r['error'] for r in rows), rows\n"
        "    else:\n"
        "        assert not ran, script + ' ran without a card'\n"
        "print('ok')\n"
    )


def _gradients_block() -> str:
    return (
        "import numpy as np, torch\n"
        "from tacex_tpu_torch.ops import pyramid\n"
        "from tacex_tpu_torch.physics.soft import ipc, mesh\n"
        "from tacex_tpu_torch.sensors.gelsight.taxim import calib, optical\n"
        "cal = calib.load_calib().at_resolution((24, 32))\n"
        "yy, xx = np.meshgrid(np.arange(24.0), np.arange(32.0), indexing='ij')\n"
        "hm = torch.from_numpy((0.01 * ((yy - 12.0) ** 2 + (xx - 16.0) ** 2) - 0.5).astype(np.float32))[None]\n"
        "hm.requires_grad_(True)\n"
        "(g,) = torch.autograd.grad(optical.render(cal, hm, interp='bilinear').sum(), hm)\n"
        "assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0\n"
        "mask = hm.detach() < -0.3\n"
        "gp = pyramid.deformation_pyramid_backward(torch.ones_like(g), mask, ((2.0, 2.0), (1.0, 1.0)))\n"
        "assert gp.shape == g.shape and pyramid.deformation_pyramid.backward_launches == 0\n"
        "m = mesh.box_tet_mesh((0.01, 0.01, 0.004), (2, 2, 1))\n"
        "model = ipc.SoftBodyModel(m, cfg=ipc.IpcSolverCfg(newton_max_iter=2, cg_iters=2), device='cpu')\n"
        "s0 = ipc.SoftBodyState.init(1, m.points, device='cpu')\n"
        "v = s0.v.clone().requires_grad_(True)\n"
        "st = model.step(ipc.SoftBodyState(x=s0.x, v=v), ipc.RigidSdfScene.empty(1, device='cpu'))\n"
        "(gv,) = torch.autograd.grad(st.x.sum(), v)\n"
        "assert bool(torch.isfinite(gv).all()) and float(gv.abs().max()) > 0\n"
        "print('ok')\n"
    )


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    """(tmp dir, results) of the blocks run with jax importable."""
    tmp = tmp_path_factory.mktemp("no_jax")
    (tmp / "train").mkdir()
    blocks = {"import": _import_block(), "coupled_step": _coupled_step_block(),
              "train": _train_block(tmp / "train"), "harness": _harness_block(tmp / "report.json")}
    return tmp, _sections(blocks)


@pytest.fixture(scope="module")
def blocked(tmp_path_factory):
    """(tmp dir, results) of the blocks run with jax, the JAX package, PIL and
    matplotlib made to raise on import."""
    tmp = tmp_path_factory.mktemp("blocked")
    blocks = {"tools": _tools_block(tmp), "uipc_scripts": _uipc_scripts_block(),
              "coupled_scripts": _coupled_scripts_block(), "gradients": _gradients_block()}
    return tmp, _sections(blocks, prefix=BLOCKER)


def test_import_loads_no_jax(loaded):
    assert _section_ok(loaded[1], "import").strip() == "ok"


def test_coupled_step_loads_no_jax(loaded):
    """A step of the tactile Grasp-Lift id (the coupled solve, the sensor on
    both pads) and of the Factory-UIPC id at 2 envs, with one Newton and one
    CG iteration, loads neither jax nor the JAX package."""
    assert _section_ok(loaded[1], "coupled_step").strip() == "ok"


def test_train_script_loads_no_jax(loaded):
    """``scripts/train_torch.py`` trains two iterations on the CPU, writes its
    run folder, and loads neither jax nor the JAX package."""
    stdout = _section_ok(loaded[1], "train")
    tmp_path = loaded[0] / "train"
    lines = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
    assert [line["iter"] for line in lines] == [0, 1] and lines[-1]["env_steps"] == 2 * 4 * 4
    assert {"steps_per_sec", "loss", "reward_per_step", "lr", "full_reward"} <= set(lines[0])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt_0.pt", "ckpt_1.pt", "config.json", "metrics.jsonl"]
    assert len((tmp_path / "metrics.jsonl").read_text().splitlines()) == 2


def test_experiment_harness_loads_no_jax(loaded):
    """``scripts/benchmarking/run_ball_rolling_experiment_torch.py`` runs the
    UIPC env for two steps on the CPU, writes its report with the physics /
    tactile split, and loads neither jax nor the JAX package."""
    _section_ok(loaded[1], "harness")
    report = json.loads((loaded[0] / "report.json").read_text())
    assert report["env_id"] == "TacEx-Ball-Rolling-Tactile-RGB-Uipc-v0" and report["total_frames"] == 4
    # the two timings are separate runs of the same physics: on a CPU either may be the longer
    assert report["avg_ms_per_step"] > 0.0 and report["avg_physics_ms_per_step"] > 0.0
    assert report["avg_tactile_ms_per_step"] >= 0.0 and report["system"]["device"] == "cpu"


def test_tools_run_with_jax_pil_and_matplotlib_blocked(blocked):
    """With importing jax, the JAX package, PIL and matplotlib made to raise:
    the new modules import, every script of the slice prints its ``--help``,
    and the Taxim demo and the dashboard write their PNGs on the CPU."""
    tmp_path, results = blocked
    assert _section_ok(results, "tools").strip().splitlines()[-1] == "ok"
    assert sorted(p.name for p in tmp_path.rglob("*.png")) == ["f_strip.png", "metrics.png", "shapes.png"]


def test_uipc_scripts_run_with_jax_blocked(blocked):
    """With importing jax and the JAX package made to raise: the UIPC modules
    import, each new script prints its ``--help`` with ``--device``, runs
    one step on the CPU when asked, and without a card its default device
    (``cuda``) raises, as do ``UipcSim`` and ``UipcInteractiveScene``."""
    assert _section_ok(blocked[1], "uipc_scripts").strip().splitlines()[-1] == "ok"


def test_coupled_scripts_run_with_jax_blocked(blocked):
    """With importing jax and the JAX package made to raise: the shell
    modules import, each coupled-world benchmarking script prints its
    ``--help`` with ``--device`` (default ``cuda``), without a card its
    default device raises (the sweep records the error in each of its
    lines and goes on, as the JAX sweep does). Their CPU runs are
    ``tests/test_torch_scripts_coupled.py``'s."""
    assert _section_ok(blocked[1], "coupled_scripts").strip().splitlines()[-1] == "ok"


def test_gradients_run_with_jax_blocked(blocked):
    """With jax and the JAX package made to raise: ``render``'s height-map
    gradient (through the pyramid's plain adjoint on the CPU), the CPU
    wrapper of K1's backward, and a differentiable ``SoftBodyModel.step``."""
    assert _section_ok(blocked[1], "gradients").strip() == "ok"


def test_parallel_dryrun_runs_with_jax_blocked_in_every_rank(tmp_path):
    """``python -m tacex_tpu_torch.parallel.dryrun --nproc 2 --device cpu``
    exits 0 with importing jax and the JAX package made to raise in the
    launcher and in both spawned ranks (a ``sitecustomize`` on
    ``PYTHONPATH`` installs the blocker in every interpreter)."""
    (tmp_path / "sitecustomize.py").write_text(BLOCKER)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep.join([str(tmp_path), str(REPO)])}
    out = subprocess.run([sys.executable, "-m", "tacex_tpu_torch.parallel.dryrun", "--nproc", "2", "--device", "cpu"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("dryrun OK on 2 ranks (gloo, cpu): full PPO train step ran"), out.stdout


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "kernels").exists()


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = _build.library_path()
    (csrc / "a.cu").write_text("// two\n")
    assert _build.library_path() != first
    assert first.parent == _build.BUILD_DIR and first.name.startswith("libtacex_kernels_")


def test_build_compiles_each_source_then_links(monkeypatch, tmp_path):
    """One nvcc per source with -c, then one -shared link of the objects."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text(f"// {name}\n")
    calls = tmp_path / "calls.txt"
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        f"open({str(calls)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('obj')\n"
        "print('ptxas info : Used 8 registers')\n"
    )
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    lib = _build.build()
    assert lib.is_file() and lib.parent == tmp_path / "kernels"
    lines = calls.read_text().splitlines()
    compiles = [line for line in lines if " -c " in line]
    assert len(compiles) == 2 and all("sm_90a" in line for line in compiles)
    assert len(lines) == 3 and "-shared" in lines[-1] and lines[-1].count(".o") == 2
    assert "a.cu" in lib.with_suffix(".log").read_text() and "Used 8 registers" in lib.with_suffix(".log").read_text()
    assert sorted(p.name for p in (tmp_path / "kernels").iterdir()) == sorted([lib.name, lib.with_suffix(".log").name])
