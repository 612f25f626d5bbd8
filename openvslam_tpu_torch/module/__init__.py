"""Tracking and mapping modules (mono, synchronous mapping)."""
