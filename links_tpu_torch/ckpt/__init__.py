"""Checkpoint import/export (reference ``.pt`` layout)."""
