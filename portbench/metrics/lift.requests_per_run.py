"""Requests per device run of serve's dispatcher (lr-lift-sat): ``readers.requests_per_run``."""

from portbench.readers import requests_per_run as read  # noqa: F401

LAYER = "dispatcher (cli/serve.py:Coalescer)"
UNIT = "count"
SOURCE = "program_counter"
MOVES = "lift_poses_per_s"
