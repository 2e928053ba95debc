from .depth_camera import SdfScene, render_depth, render_depth_batch  # noqa: F401
