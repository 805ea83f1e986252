"""The phase trio's scatter (``phase_scatter_kernel``) into the four
phases, counted at the trio's bytes."""

from portbench.roofline import shapes

PATTERN = r"phase_scatter"


def bound(s, config, peaks) -> float:
    """Seconds: the launch's bytes at the card's memory bandwidth."""
    return shapes.phase_trio(s) / peaks["bytes_per_s"]
