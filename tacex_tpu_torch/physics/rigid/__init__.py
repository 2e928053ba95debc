from . import contact, franka  # noqa: F401
