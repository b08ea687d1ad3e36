"""Lifter and completer models."""
