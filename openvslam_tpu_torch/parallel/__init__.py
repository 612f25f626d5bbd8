"""Many streams and many sessions (counterpart of ``openvslam_tpu/parallel``):
device lists, stream-parallel tracking, the landmark-sharded distributed
BA in one process or across ``torch.distributed`` processes, and the
multi-session runners that pool their maps into it."""
from .mesh import make_mesh
from .distributed_ba import make_distributed_ba, ShardedBAProblem
from .multi_session import MultiSessionRunner

__all__ = [
    "make_mesh", "make_distributed_ba", "ShardedBAProblem",
    "MultiSessionRunner",
]
