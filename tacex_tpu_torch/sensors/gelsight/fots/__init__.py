from . import marker_motion  # noqa: F401
from .marker_motion import FOTSMarkerCfg, draw_marker_image, init_marker_grid, marker_flow  # noqa: F401
