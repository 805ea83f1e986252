"""The evaluation's fused no-grad hallucinator (``hal_fused_kernel``), one
launch a training step for all nets: the forward's bytes."""

from portbench.roofline import shapes

PATTERN = r"hal_fused"


def bound(s, config, peaks) -> float:
    """Seconds: the launch's bytes at the card's memory bandwidth."""
    return shapes.hal_fwd(s) / peaks["bytes_per_s"]
