"""Map and trajectory IO: the native columnar map schema, the reference's
map schema, the MessagePack codec both are written with, and the TUM and
KITTI trajectory formats."""
