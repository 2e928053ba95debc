from . import blur, lut_shade, pyramid, resize  # noqa: F401
