"""Skeleton index maps, 2D normalizers and NN primitives."""
