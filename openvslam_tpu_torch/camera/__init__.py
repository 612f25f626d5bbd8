"""Camera models: perspective, fisheye (equidistant) and equirectangular."""
from .base import ModelType, SetupType, camera_to_config, make_camera_from_config
from .equirectangular import Equirectangular
from .fisheye import Fisheye
from .perspective import Perspective

__all__ = ["ModelType", "SetupType", "Perspective", "Fisheye", "Equirectangular",
           "camera_to_config", "make_camera_from_config"]
