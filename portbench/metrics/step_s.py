"""Seconds a train step: the window over the steps completed in it."""

from portbench.harness import per_unit_s as read  # noqa: F401
