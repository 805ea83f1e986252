"""ConvNet3D's first-stage phase max (``phase_argmax_kernel``): it reads
the GEMM's four pool phases and writes the winners and their index."""

from portbench.roofline import shapes

PATTERN = r"phase_argmax"


def bound(s, config, peaks) -> float:
    """Seconds: the launch's bytes at the card's memory bandwidth."""
    return shapes.phase_trio(s) / peaks["bytes_per_s"]
