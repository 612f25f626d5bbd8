"""Pose-only optimisation."""
