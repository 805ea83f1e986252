"""The phase trio's select (``phase_select_kernel``), a gather by the
winners' index, counted at the trio's bytes."""

from portbench.roofline import shapes

PATTERN = r"phase_select"


def bound(s, config, peaks) -> float:
    """Seconds: the launch's bytes at the card's memory bandwidth."""
    return shapes.phase_trio(s) / peaks["bytes_per_s"]
