"""The port stands alone: it loads neither jax nor the JAX package, and its
kernel build refuses to run without nvcc instead of falling back."""

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
    "tacex_tpu_torch.physics.rigid.franka",
    "tacex_tpu_torch.physics.rigid.contact",
    "tacex_tpu_torch.envs.base",
    "tacex_tpu_torch.envs.ball_rolling.env",
    "tacex_tpu_torch.envs.ball_rolling.convert",
    "tacex_tpu_torch.envs",
    "tacex_tpu_torch.rl.networks",
]


def test_import_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from tacex_tpu_torch import envs\n"
        "envs.make('TacEx-Ball-Rolling-Taxim-Fots-v0', num_envs=2)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'tacex_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


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
