"""Per-frame models: the ORB front end, FrameStep and the mono TrackStep."""
