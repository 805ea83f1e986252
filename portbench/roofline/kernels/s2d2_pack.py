"""The first stage's space-to-depth pack (``s2d2_pack_kernel``): it reads
the clips and writes their packed view."""

from portbench.roofline import shapes

PATTERN = r"s2d2_pack"


def bound(s, config, peaks) -> float:
    """Seconds: the launch's bytes at the card's memory bandwidth."""
    return shapes.s2d2_move(s) / peaks["bytes_per_s"]
