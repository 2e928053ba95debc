"""The port's follow-goal and ManiSkill-marker demos in-process through
``main(argv)`` with ``--device cpu``, at the sizes ``tests/test_scripts.py``
runs the JAX ones, held to what those print (the JAX demos print a mean
tracking error of 0.07 mm at 40 steps, and marker displacements of 3.09 px
(press) and 1.95 px (shear) at 4 steps)."""

import re
import runpy
from pathlib import Path

import numpy as np

from _torch_bins import setup_torch

setup_torch()

DEMOS = Path(__file__).resolve().parents[1] / "scripts" / "demos"


def test_follow_goal_tracks_the_goal(tmp_path, capsys):
    r = runpy.run_path(str(DEMOS / "follow_goal_torch.py"))["main"](
        ["--steps", "40", "--out", str(tmp_path / "fg.png"), "--device", "cpu"])
    out = capsys.readouterr().out
    m = re.search(r"tracking error: mean ([\d.]+) mm, final ([\d.]+) mm", out)
    assert m and float(m.group(1)) <= 0.2 and float(m.group(2)) <= 0.2
    assert r["errors"].shape == (40,) and np.isfinite(r["indentation"]).all()
    assert "in-contact tactile frames recorded: 0" in out  # the press dip starts at step 40


def test_mani_skill_marker_moves_the_markers(tmp_path, capsys):
    r = runpy.run_path(str(DEMOS / "check_mani_skill_marker_torch.py"))["main"](
        ["--steps", "4", "--out", str(tmp_path / "msm.png"), "--device", "cpu"])
    out = capsys.readouterr().out
    m = re.search(r"mean marker displacement \(px\): press=([\d.]+) shear=([\d.]+)", out)
    assert m and float(m.group(1)) > 0.5 and float(m.group(2)) > 0.5
    assert r["flow"].shape == (2, 2, 128, 2) and (tmp_path / "msm.png").is_file()
