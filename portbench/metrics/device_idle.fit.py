"""The share of the traced window of train steps in which no operation ran
on the device."""

from portbench.harness import idle_share as read  # noqa: F401
