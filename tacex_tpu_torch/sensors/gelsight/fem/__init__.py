from .marker_flow import FemMarkerFlow, ManiSkillSimulatorCfg, surface_to_camera_frame  # noqa: F401
