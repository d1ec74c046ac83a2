"""The 90th percentile of the window's frame latencies."""

from portbench.harness import p90_s as read  # noqa: F401
