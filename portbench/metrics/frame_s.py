"""Seconds a frame: the window over the frames completed in it."""

from portbench.harness import per_unit_s as read  # noqa: F401
