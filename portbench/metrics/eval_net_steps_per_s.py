"""Nets x training steps completed in the window over its whole wall time."""

from portbench.harness.readers import rate as read  # noqa: F401
