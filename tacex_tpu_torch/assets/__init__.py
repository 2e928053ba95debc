"""Asset libraries (numpy copies of the JAX package's): procedural triangle
meshes, the analytic indenter shapes and the robot presets."""

from . import meshes, robots, shapes  # noqa: F401
