"""The hallucinator's weight gradient (``hal_wgrad_*`` kernels): it reads
the stills, the motion and the videos' cotangent."""

from portbench.roofline import shapes

PATTERN = r"hal_wgrad"


def bound(s, config, peaks) -> float:
    """Seconds: the launch's bytes at the card's memory bandwidth."""
    return shapes.hal_wgrad(s) / peaks["bytes_per_s"]
