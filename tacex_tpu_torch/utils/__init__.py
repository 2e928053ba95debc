"""Timing, profiling, dashboards and PNG output for the port's scripts."""

from .png import write_png  # noqa: F401
from .profiling import Timer, device_label, synchronize, trace  # noqa: F401
from .visualizer import LiveVisualizer  # noqa: F401
