from . import gelsight  # noqa: F401
