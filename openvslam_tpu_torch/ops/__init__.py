"""Tensor operations: geometry, pyramid, FAST, ORB, matching, pose LM."""
