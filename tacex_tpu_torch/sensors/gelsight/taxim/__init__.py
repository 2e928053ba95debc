from . import optical  # noqa: F401
from .calib import TaximCalib, default_calib_folder, load_calib  # noqa: F401
from .optical import compute_gel_deformation, generate_normals, render, shade, shift_height_map  # noqa: F401
from .params import SensorParams, SimParams, load_params  # noqa: F401
