"""The ``ramp_sliding`` sample of the UIPC scene API on the port against its
JAX scenes (one for each friction ratio, 0.0, 0.2 and 0.9), for 2 steps on
the CPU (``_torch_abd_examples``), positions within
``_torch_uipc_api.ATOL`` (1.5e-5 m; the two sides agree to ~1e-8 here);
and ``benchmark_abd_pile_torch.main`` at 2 envs, 1 step of 1 Newton
iteration: its three JSON lines.
"""

import json
import runpy

import numpy as np

import _torch_abd_examples as ex
from _torch_bins import setup_torch
from _torch_uipc_api import ATOL

setup_torch()


def test_ramp_sliding_matches_jax_scenes():
    out = ex.port("ramp_sliding")
    assert sorted(out["x"]) == [0.0, 0.2, 0.9]
    for mu, x in out["x"].items():
        x_j = ex.jax_ramp(mu)
        assert x.shape == x_j.shape == (1, 8, 3)
        np.testing.assert_allclose(x, x_j, atol=ATOL, rtol=0, err_msg=f"friction {mu}")
    assert all(np.isfinite(v) for v in out["travel"].values()) and out["ms_per_step"] > 0



def test_pile_benchmark_prints_three_lines(capsys):
    lines = runpy.run_path("scripts/benchmarking/benchmark_abd_pile_torch.py")["main"](
        ["--envs", "2", "--steps", "1", "--newton_iters", "1", "--device", "cpu"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == lines
    assert [(d["metric"], d["num_envs"]) for d in lines] == [
        ("abd_pile_8body_dense", 1), ("abd_pile_8body_dense", 2), ("abd_pile_8body_cg", 2)]
    assert all(d["device"] == "cpu" and d["ms_per_step"] > 0 and d["env_steps_per_s"] > 0 for d in lines)
