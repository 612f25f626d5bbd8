"""Camera models.  Only the perspective model is ported so far."""
from .base import SetupType, camera_to_config, make_camera_from_config
from .perspective import Perspective

__all__ = ["SetupType", "Perspective", "camera_to_config", "make_camera_from_config"]
