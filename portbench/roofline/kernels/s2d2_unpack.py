"""The pack's adjoint (``s2d2_unpack_kernel``): it reads the packed
gradient and writes the clips'."""

from portbench.roofline import shapes

PATTERN = r"s2d2_unpack"


def bound(s, config, peaks) -> float:
    """Seconds: the launch's bytes at the card's memory bandwidth."""
    return shapes.s2d2_move(s) / peaks["bytes_per_s"]
