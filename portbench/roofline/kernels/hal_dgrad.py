"""The hallucinator's input gradient (``hal_dgrad_kernel``): it reads the
videos' cotangent and writes the motion's (the static memory is frozen)."""

from portbench.roofline import shapes

PATTERN = r"hal_dgrad"


def bound(s, config, peaks) -> float:
    """Seconds: the launch's bytes at the card's memory bandwidth."""
    return shapes.hal_dgrad(s) / peaks["bytes_per_s"]
