"""The port's user-facing scripts run in-process through ``main(argv)`` with
``--device cpu`` at small sizes, and print and write what the JAX scripts'
tests (``tests/test_scripts.py``) look for: the launcher's dashboard, a
checkpoint played back, the registry listing, the benchmarks' KPIs and the
sensor-only demos' images."""

import json
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_bins import setup_torch
from tacex_tpu import envs as jenvs
from tacex_tpu_torch import envs

setup_torch()

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
VISION_ID = "TacEx-Ball-Rolling-Taxim-Fots-v0"
STATE_ID = "TacEx-Ball-Rolling-Privileged-v0"


def _main(rel: str):
    return runpy.run_path(str(SCRIPTS / rel))["main"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two PPO iterations of the tactile task at 4 envs through
    ``train_torch.py`` with the dashboard and a checkpoint each iteration."""
    root = tmp_path_factory.mktemp("run")
    trainer = _main("train_torch.py")([
        "--task", VISION_ID, "--num_envs", "4", "--iterations", "2", "--rollouts", "2", "--device", "cpu",
        "--agent_cfg", "learning_epochs=1", "--agent_cfg", "mini_batches=2",
        "--viz_dir", str(root / "viz"), "--viz_interval", "1",
        "--checkpoint_dir", str(root / "ckpt"), "--checkpoint_interval", "1",
    ])
    return trainer, root


def test_train_writes_the_dashboard(trained):
    trainer, root = trained
    viz = root / "viz"
    lines = (viz / "metrics.jsonl").read_text().strip().splitlines()
    assert len(lines) == 2
    rec = json.loads(lines[-1])
    assert rec["iter"] == 1 and "loss" in rec and rec["env_steps"] == trainer.steps == 2 * 4 * 2
    with Image.open(viz / "metrics.png") as im:
        assert im.mode == "RGB" and im.size[0] == 3 * 240
    panels = [line.split()[2] for line in (viz / "metrics_panels.txt").read_text().splitlines()]
    assert panels == [k for k in rec if k not in ("iter", "env_steps", "steps_per_sec")]
    with Image.open(viz / "tactile_obs_strip.png") as im:
        assert im.size == (2 * 32, 24)  # two refreshes of env 0's 24x32 image
    assert sorted(p.name for p in (root / "ckpt").iterdir()) == ["ckpt_0.pt", "ckpt_1.pt"]
    assert (viz / "config.json").is_file()


def test_play_restores_the_trained_policy(trained, tmp_path, capsys):
    trainer, root = trained
    res = _main("play_torch.py")(["--task", VISION_ID, "--num_envs", "4", "--steps", "2", "--device", "cpu",
                                  "--checkpoint_dir", str(root / "ckpt"), "--save_frames", str(tmp_path / "frames")])
    out = capsys.readouterr().out
    assert "restored checkpoint step 1" in out and "mean episode return over 2 steps:" in out
    assert "Metric/obj_goal_error (mean over rollout):" in out
    assert res["checkpoint"].name == "ckpt_1.pt" and np.isfinite(res["mean_return"])
    with torch.no_grad():
        mean, _, _ = trainer.net(res["first_obs"])
    np.testing.assert_allclose(res["first_action"].numpy(), mean.numpy(), atol=1e-6, rtol=0)
    frames = sorted((tmp_path / "frames").iterdir())
    assert [f.name for f in frames] == ["frame_0000.png", "frame_0001.png"]
    with Image.open(frames[0]) as im:
        assert im.mode == "RGB" and im.size == (32 * 8, 24 * 8)


def test_play_refuses_a_sac_checkpoint(tmp_path):
    from tacex_tpu_torch.rl.sac import GaussianPolicy

    torch.save(GaussianPolicy(14, 6, (8,), device="cpu").state_dict(), tmp_path / "ckpt_3.pt")
    with pytest.raises(ValueError, match="SAC actor"):
        _main("play_torch.py")(["--task", STATE_ID, "--num_envs", "2", "--steps", "1", "--device", "cpu",
                                "--checkpoint_dir", str(tmp_path)])


@pytest.mark.parametrize("env_id,staggers", [("TacEx-Grasp-Lift-Uipc-v0", True),
                                             ("TacEx-Factory-PegInsert-Uipc-v0", True), (STATE_ID, False)])
def test_play_turns_staggering_off_where_the_cfg_has_it(monkeypatch, env_id, staggers):
    made = {}

    class Made(Exception):
        pass

    def make(task, **kwargs):
        made.update(kwargs)
        raise Made

    monkeypatch.setattr(envs, "make", make)
    with pytest.raises(Made):
        _main("play_torch.py")(["--task", env_id, "--device", "cpu", "--env_cfg", "episode_length_s=3.0"])
    assert made.get("stagger_initial_episodes", True) is not staggers and made["episode_length_s"] == 3.0


def test_list_envs_prints_the_jax_ids(capsys):
    ids = _main("list_envs_torch.py")(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert ids == jenvs.registered_envs() == envs.registered_envs() and len(ids) == 17
    assert [line.split()[0] for line in out[1:]] == ids
    assert "TacEx-Ball-Rolling-Taxim-Fots-v0" in ids and "TacEx-Factory-PegInsert-Direct-v0" in ids


def test_benchmark_non_rl_prints_its_kpis(capsys):
    kpi = _main("benchmarking/benchmark_non_rl_example_torch.py")(["--num_envs", "4", "--num_frames", "5",
                                                                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert '"per_frame_ms"' in out and json.loads(out) == kpi
    assert list(kpi) == ["task", "num_envs", "num_frames", "startup_s", "first_step_s", "per_frame_ms",
                         "frames_per_sec", "device"]
    assert kpi["device"] == "cpu" and kpi["per_frame_ms"] > 0 and kpi["num_envs"] == 4


def test_benchmark_embedded_gel_prints_a_line_a_config(capsys):
    lines = _main("benchmarking/benchmark_embedded_gel_torch.py")(["--envs", "2", "--steps", "1", "--skip_dense",
                                                                   "--device", "cpu"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == lines and [(r["gel_resolution"], r["gel_embed_surface"]) for r in lines] == [
        ("low", None), ("low", "extremely_high")]
    assert all(r["metric"] == "uipc_env_steps_per_s" and r["ms_per_step"] > 0 for r in lines)


def test_check_taxim_sim_writes_the_montage(tmp_path, capsys):
    out = tmp_path / "shapes.png"
    imgs = _main("demos/check_taxim_sim_torch.py")(["--res", "24", "32", "--out", str(out), "--device", "cpu"])
    assert "26 shapes rendered" in capsys.readouterr().out and imgs.shape == (26, 24, 32, 3)
    with Image.open(out) as im:
        assert im.size == (6 * 32, 5 * 24)
        np.testing.assert_array_equal(np.asarray(im)[:24, 32:64], (imgs[1] * 255).astype(np.uint8))


def test_check_fots_sim_prints_each_case(tmp_path, capsys):
    out = tmp_path / "fots.png"
    cases = _main("demos/check_fots_sim_torch.py")(["--out", str(out), "--device", "cpu"])
    text = capsys.readouterr().out
    for name in ("press", "shear", "twist", "shear+twist"):
        assert f"{name}: max marker displacement" in text
    assert sorted(cases) == sorted(["press", "shear", "twist", "shear+twist"])
    with Image.open(out) as im:
        assert im.size == (4 * 320, 240)


@pytest.mark.parametrize("mesh", [False, True], ids=["library", "mesh"])
def test_run_shape_touch_writes_a_strip_a_shape(tmp_path, capsys, mesh):
    argv = ["--res", "24", "32", "--depths", "0.5", "1.0", "--out_dir", str(tmp_path), "--device", "cpu"]
    written = _main("demos/run_shape_touch_torch.py")(argv + (["--mesh", "--shapes", "sphere"] if mesh else []))
    assert list(written) == (["sphere"] if mesh else ["sphere_medium", "cube_edge", "cross"])
    assert "pressed [0.5, 1.0] mm" in capsys.readouterr().out
    for path in written.values():
        with Image.open(path) as im:
            assert im.size == (2 * 32, 24)
