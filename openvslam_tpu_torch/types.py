"""Static capacity constants and the per-run ``Limits`` (counterpart of
``openvslam_tpu/types.py``, without its JAX dtype aliases: the port's
dtypes are ``torch.float32`` / ``torch.int32`` and friends at each call).
"""
from __future__ import annotations

import dataclasses

MAX_KEYPTS = 2048        # per frame across all pyramid levels
NUM_LEVELS = 8           # ORB pyramid levels (reference default)
SCALE_FACTOR = 1.2       # ORB pyramid scale (reference default)
DESC_BITS = 256          # rBRIEF bits
DESC_WORDS = DESC_BITS // 32   # packed u32 words per descriptor

MAX_LOCAL_KFS = 64       # local-map keyframe window cap (ref caps ~60)
MAX_LOCAL_LMS = 16384    # local-map landmark cap

# Bundle-adjustment problem buckets
BA_MAX_CAMS = 64
BA_MAX_LMS = 8192
BA_MAX_OBS = 32768

# chi^2 thresholds at 95% (reference values)
CHI2_2D = 5.991
CHI2_3D = 7.815


@dataclasses.dataclass(frozen=True)
class Limits:
    """Per-run capacity overrides (a Config owns one)."""
    max_keypts: int = MAX_KEYPTS
    num_levels: int = NUM_LEVELS
    scale_factor: float = SCALE_FACTOR
    max_local_kfs: int = MAX_LOCAL_KFS
    max_local_lms: int = MAX_LOCAL_LMS
    ba_max_cams: int = BA_MAX_CAMS
    ba_max_lms: int = BA_MAX_LMS
    ba_max_obs: int = BA_MAX_OBS
