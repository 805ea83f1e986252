"""The hallucinator's forward (``hal_fwd_kernel``), one launch for all the
composed clips: it reads the stills and the motion and writes the videos."""

from portbench.roofline import shapes

PATTERN = r"hal_fwd"


def bound(s, config, peaks) -> float:
    """Seconds: the launch's bytes at the card's memory bandwidth."""
    return shapes.hal_fwd(s) / peaks["bytes_per_s"]
