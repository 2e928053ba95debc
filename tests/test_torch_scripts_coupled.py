"""The port's cloth scenes and the five coupled-world benchmarking scripts,
in-process through ``main(argv)`` on the CPU.

  * ``examples/libuipc_samples/bunny_cloth_torch.py`` and
    ``examples/cloth_trampoline_torch.py`` at 2 steps, their solves cut to
    2 Newton x 6 CG x 4 line-search iterations (``UipcSimCfg`` patched): the
    routes (the standalone ``ShellModel``; the union of the coupled world),
    finite positions, a cloth that moved down, the broad-phase report.
    Their end-of-run checks need the full length (120 and 80 steps) and run
    on the card; the pieces are held to the JAX package in
    ``test_torch_shell*.py``.
  * ``scripts/benchmarking/{benchmark_grasp_lift,embed_accuracy,
    embed_accuracy_grasp,profile_coupled,sweep_grasp_lift_scale}_torch.py``
    at 1 env and 2 steps, the Grasp-Lift solve cut to 1 Newton x 2 CG
    (``GraspLiftEnv`` patched; the sweep's configurations patched to one):
    each prints lines whose keys are the JAX script's (``JAX_KEYS``, read
    from the JAX scripts' row literals) and whose numbers are finite.
"""

import json
import math
import runpy

import numpy as np
import pytest

from _torch_bins import setup_torch
from tacex_tpu_torch.envs.grasp_lift import env as grasp_env
from tacex_tpu_torch.uipc.sim import UipcSimCfg

setup_torch()

BENCH = "scripts/benchmarking/"
# the keys of each JAX script's printed lines (the dict literals of its rows), in print order
JAX_KEYS = {
    "benchmark_grasp_lift": [["metric", "num_envs", "env_steps_per_s", "ms_per_step", "compile_s", "device"]],
    "embed_accuracy": [["pad_resolution", "env_steps_per_s", "ms_per_step", "device"]] * 3
    + [["metric", "ref", "(2, 4, 4)", "(2, 8, 8)"]],
    "embed_accuracy_grasp": [["metric", "steps", "A_coarse_embed32", "C_coarse_raw", "truth_peak_compression_mm",
                              "B_s_per_step", "B_cube_z_final_mm"]],
    "profile_coupled": [["envs", "ms_per_step"]] + [["envs", "ms_per_step", k] for k in (
        "newton_iters", "newton_iters", "cg_iters", "cg_iters", "coupling_k", "coupling_k", "decimation")],
    "sweep_grasp_lift_scale": [["metric", "num_envs", "overrides", "env_steps_per_s", "ms_per_step", "compile_s",
                                "device"]],
}
ARGS = {
    "benchmark_grasp_lift": ["--envs", "1", "--steps", "2"],
    "embed_accuracy": ["--envs", "1", "--steps", "2"],
    "embed_accuracy_grasp": ["--steps", "2"],
    "profile_coupled": ["--envs", "1", "--steps", "2"],
    "sweep_grasp_lift_scale": [],
}


@pytest.fixture
def cut_solves(monkeypatch):
    """Cut the UIPC scenes' and the Grasp-Lift env's solver iterations."""
    post = UipcSimCfg.__post_init__

    def cut_sim(self):
        post(self)
        self.newton.max_iter = min(self.newton.max_iter, 2)
        self.linear_system.max_iter = min(self.linear_system.max_iter, 6)
        self.line_search.max_iter = min(self.line_search.max_iter, 4)

    init = grasp_env.GraspLiftEnv.__init__

    def cut_env(self, cfg=None, device="cuda"):
        cfg = cfg or grasp_env.GraspLiftEnvCfg()
        init(self, cfg.replace(newton_iters=min(cfg.newton_iters, 1), cg_iters=min(cfg.cg_iters, 2)), device=device)

    monkeypatch.setattr(UipcSimCfg, "__post_init__", cut_sim)
    monkeypatch.setattr(grasp_env.GraspLiftEnv, "__init__", cut_env)


def test_bunny_cloth_runs(cut_solves):
    r = runpy.run_path("examples/libuipc_samples/bunny_cloth_torch.py")["main"](["--steps", "2", "--device", "cpu"])
    assert r["x"].shape == (1, 256, 3) and np.isfinite(r["x"]).all()
    assert r["z_top"] < 0.3 and r["clearance"] > 0.09 and r["overflow"] == {}  # the standalone ShellModel


def test_cloth_trampoline_runs(cut_solves):
    r = runpy.run_path("examples/cloth_trampoline_torch.py")["main"](["--steps", "2", "--device", "cpu"])
    assert r["x"].shape == (1, 49, 3) and np.isfinite(r["x"]).all() and np.isfinite(r["q"]).all()
    assert r["body_z"] < 0.045 and r["cloth_centre_z"] < 0.03  # both fell in the coupled world


@pytest.mark.parametrize("name", list(JAX_KEYS))
def test_benchmarking_script_rows_keep_the_jax_keys(name, cut_solves, monkeypatch, capsys):
    mod = runpy.run_path(f"{BENCH}{name}_torch.py")
    if name == "sweep_grasp_lift_scale":
        monkeypatch.setitem(mod["main"].__globals__, "CONFIGS", [(1, (2, 4, 4), 2)])
    mod["main"](ARGS[name] + ["--device", "cpu"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert [list(r) for r in rows] == JAX_KEYS[name]

    def numbers(x):
        if isinstance(x, dict):
            return [v for y in x.values() for v in numbers(y)]
        return [x] if isinstance(x, (int, float)) and not isinstance(x, bool) else []

    assert all(math.isfinite(v) for r in rows for v in numbers(r))
    assert all(r.get("device", "cpu") == "cpu" for r in rows)
