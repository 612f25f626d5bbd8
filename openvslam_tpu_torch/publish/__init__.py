from .publishers import FramePublisher, MapPublisher
from .socket_viewer import SocketViewer

__all__ = ["FramePublisher", "MapPublisher", "SocketViewer"]
