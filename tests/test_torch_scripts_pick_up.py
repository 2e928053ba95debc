"""The port's pick-up demos in-process through ``main(argv)`` with
``--device cpu``. The rigid one at ``tests/test_scripts.py``'s 120 steps a
phase must lift the ball at least 5 cm (the JAX demo lifts it 6.8 cm; its
script asserts 3 cm). The FEM-gel one runs 2 steps a phase: too few to
grasp, so its script's own check raises after it printed finite numbers;
its full lift is checked on the card (``chip_smoke.py``)."""

import re
import runpy
from pathlib import Path

import numpy as np
import pytest

from _torch_bins import setup_torch

setup_torch()

PICK_UP = Path(__file__).resolve().parents[1] / "scripts" / "demos" / "pick_up"
NUMBER = r"-?\d+\.\d+"


def test_rigid_pads_lift_the_ball(tmp_path, capsys):
    r = runpy.run_path(str(PICK_UP / "pick_up_rigid_torch.py"))["main"](
        ["--steps_per_phase", "120", "--out", str(tmp_path / "pur.png"), "--device", "cpu"])
    out = capsys.readouterr().out
    m = re.search(rf"ball lifted ({NUMBER}) cm", out)
    assert m and float(m.group(1)) >= 5.0 and r["lifted"] >= 0.05
    assert [e["phase"] for e in r["log"]] == ["approach", "descend", "close", "lift"]
    assert r["log"][2]["grip"] > 0.1 and (r["log"][3]["indent"] > 0.5).all()


def test_fem_gels_run_and_print_finite_numbers(tmp_path, capsys):
    main = runpy.run_path(str(PICK_UP / "pick_up_uipc_torch.py"))["main"]
    with pytest.raises(AssertionError, match="grasp failed"):
        main(["--steps_per_phase", "2", "--out", str(tmp_path / "puu.png"), "--device", "cpu"])
    out = capsys.readouterr().out
    lines = [line for line in out.splitlines() if line.split(":")[0].strip() in ("approach", "descend", "close", "lift")]
    assert len(lines) == 4
    numbers = [float(x) for line in lines for x in re.findall(NUMBER, line)]
    assert len(numbers) >= 4 * 10 and np.isfinite(numbers).all()
    assert re.search(rf"ball lifted {NUMBER} cm \(FEM gels\)", out) and (tmp_path / "puu.png").is_file()
