from . import fots, taxim  # noqa: F401
from .sensor import GelSightSensor, GelSightSensorState  # noqa: F401
from .sensor_cfg import GelSightSensorCfg, gelsight_mini_cfg  # noqa: F401
