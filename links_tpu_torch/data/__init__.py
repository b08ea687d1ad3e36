"""Pose datasets: the reference pickle loader and the synthetic generator."""
