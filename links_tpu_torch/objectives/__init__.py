"""Lifting objectives (the eval forwards of the serving slice)."""
