from . import rigid  # noqa: F401
