from . import maths  # noqa: F401
from .config import MISSING, configclass, is_configclass_instance, update_recursive  # noqa: F401
