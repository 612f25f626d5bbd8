"""PyTorch/CUDA port of the per-frame tracking step of ``openvslam_tpu``.

The package mirrors the JAX package's layout (``ops/``, ``camera/``,
``optimize/``, ``models/``, ``utils/``) and function names.  Its three
hand-written Hopper kernels live in ``csrc/`` and are built on first use by
``kernels.py``.  Every entry point takes ``device=`` (default ``"cuda"``)
and raises when that device is missing; a kernel wrapper runs its plain
PyTorch version only for tensors that lie on the CPU.
"""
from .ops import precision as _precision  # noqa: F401  (TF32 off, first)
