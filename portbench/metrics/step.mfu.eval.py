"""The model FLOPs of the traced steps over the traced time at the card's
dense peak for the configuration's precision (%)."""

from portbench.harness.readers import mfu as read  # noqa: F401
