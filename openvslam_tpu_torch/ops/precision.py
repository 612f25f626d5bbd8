"""Float32 precision for the whole package, set once at import.

The JAX package pins HIGHEST matmul/conv precision on its geometry code and
on the IC-moment convolutions (``openvslam_tpu/ops/precision.py``,
``openvslam_tpu/ops/orb.py``): a TPU's default f32 contraction rounds its
operands to bf16, which turned two-view initialisation and the IC angles
into platform noise.

The GPU's counterpart is TF32.  PyTorch runs f32 matrix products in full
f32 by default, but cuDNN convolutions in TF32 (about three decimal
digits).  The port has no use for either rounding: its pyramid, moments
and descriptor tests are exact integer arithmetic, and its pose solves are
normal equations summed over thousands of rows.  So both switches are
turned off here, and the package imports this module first.
"""
from __future__ import annotations

import torch


def pin_float32() -> None:
    """Disable TF32 for matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


pin_float32()
