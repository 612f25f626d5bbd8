"""Host map data: the per-frame container and the map database (numpy SoA
with integer ids; device mirrors are built by the modules that use them)."""
from .frame import Frame
from .map_database import MapDatabase

__all__ = ["Frame", "MapDatabase"]
