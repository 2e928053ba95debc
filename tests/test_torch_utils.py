"""The port's tools for its scripts: the ``Timer`` and ``LiveVisualizer``
cases of the JAX package's ``tests/test_utils.py``, the PNG writer read back
through PIL, the dashboard's panels, and a profiler trace on the CPU."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_bins import setup_torch
from tacex_tpu_torch.utils import LiveVisualizer, Timer, device_label, synchronize, trace, write_png
from tacex_tpu_torch.utils.png import to_uint8

setup_torch()


class TestTimer:
    def test_nested_scopes_report(self):
        t = Timer()
        with t.scope("step"):
            with t.scope("physics"):
                x = torch.ones((64, 64)) @ torch.ones((64, 64))
            with t.scope("tactile", fence=x):
                pass
        rep = t.report(as_json=True)
        assert "step" in rep and "step/physics" in rep and "step/tactile" in rep
        assert rep["step"]["total_ms"] >= rep["step/physics"]["total_ms"]
        assert isinstance(t.report(), str)

    def test_reset(self):
        t = Timer()
        with t.scope("a"):
            pass
        t.reset()
        assert t.report(as_json=True) == {}

    def test_report_counts_and_indents(self):
        t = Timer()
        for _ in range(3):
            with t.scope("outer", fence={"a": [torch.zeros(2)]}):
                with t.scope("inner"):
                    pass
        rep = t.report(as_json=True)
        assert rep["outer"]["count"] == rep["outer/inner"]["count"] == 3
        assert t.report().splitlines()[1].startswith("  inner: ")


class TestVisualizer:
    def test_scalars_and_frames(self, tmp_path):
        v = LiveVisualizer(tmp_path)
        for i in range(5):
            v.add_scalars(i, {"reward": i * 0.5, "loss": 1.0 / (i + 1)})
            v.add_frame("tactile", np.random.rand(24, 32, 3))
        p1 = v.save_plots()
        p2 = v.save_frame_strip("tactile")
        assert p1.exists() and p2.exists()

    def test_panels_follow_the_series_order(self, tmp_path):
        v = LiveVisualizer(tmp_path)
        for i in range(6):
            v.add_scalars(i, {"b": float(i), "a": -float(i), "c": 2.0, "d": float(i % 2)})
        img = np.asarray(Image.open(v.save_plots()))
        assert img.shape == (2 * 160, 3 * 240, 3) and img.dtype == np.uint8
        lines = (tmp_path / "metrics_panels.txt").read_text().splitlines()
        assert [line.split()[:3] for line in lines] == [["0", "0", "b"], ["0", "1", "a"], ["0", "2", "c"],
                                                          ["1", "0", "d"]]
        assert lines[0].endswith("min=0 max=5 n=6")
        # each drawn panel holds line pixels; the empty sixth holds none
        line_px = np.all(img == (31, 119, 180), axis=-1)
        assert all(line_px[r * 160:(r + 1) * 160, c * 240:(c + 1) * 240].sum() > 50
                   for r, c in ((0, 0), (0, 1), (0, 2), (1, 0)))
        assert line_px[160:, 480:].sum() == 0
        # a rising series ends top right, a falling one bottom right
        b, a = line_px[:160, :240], line_px[:160, 240:480]
        assert np.argwhere(b[:, -20:]).min(0)[0] < 40 and np.argwhere(a[:, -20:]).max(0)[0] > 120

    def test_strip_equals_the_frames(self, tmp_path):
        v = LiveVisualizer(tmp_path)
        frames = [np.random.default_rng(i).random((6, 5, 3)) for i in range(3)] + [np.full((6, 5), 2.0)]
        for f in frames:
            v.add_frame("obs", f, keep_last=3)
        strip = np.asarray(Image.open(v.save_frame_strip("obs")))
        expect = np.concatenate([np.clip(f, 0, 1) for f in frames[1:3]] + [np.ones((6, 5, 3))], axis=1)
        np.testing.assert_array_equal(strip, (expect.astype(np.float32) * 255).astype(np.uint8))
        assert v.save_frame_strip("missing") is None and LiveVisualizer(tmp_path).save_plots() is None


@pytest.mark.parametrize("shape", [(7, 13), (9, 4, 3), (1, 1), (64, 300, 3)], ids=["gray", "rgb", "pixel", "wide"])
def test_write_png_reads_back_through_pil(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    path = write_png(tmp_path / "x.png", img)
    with Image.open(path) as im:
        assert im.mode == ("L" if len(shape) == 2 else "RGB") and im.size == (shape[1], shape[0])
        np.testing.assert_array_equal(np.asarray(im), img)


def test_write_png_refuses_other_arrays(tmp_path):
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 4), np.uint8), np.zeros((4,), np.uint8)):
        with pytest.raises(ValueError, match="uint8"):
            write_png(tmp_path / "x.png", bad)


def test_to_uint8_truncates_as_the_jax_scripts():
    x = np.array([-0.5, 0.0, 0.5, 0.999, 1.0, 3.0], np.float32)
    np.testing.assert_array_equal(to_uint8(x), (np.clip(x, 0, 1) * 255).astype(np.uint8))


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with trace(tmp_path / "tr", device="cpu") as prof:
        torch.ones((32, 32)) @ torch.ones((32, 32))
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events) and prof is not None


def test_device_helpers_on_the_cpu():
    synchronize("cpu")
    assert device_label("cpu") == "cpu"
