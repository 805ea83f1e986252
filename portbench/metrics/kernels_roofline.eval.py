"""The port's nine kernels: launches x byte-bound time over their device
time in the traced part (%)."""

from portbench.harness.readers import kernels_roofline as read  # noqa: F401
