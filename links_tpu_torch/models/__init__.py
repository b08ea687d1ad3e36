"""Lifter models."""
