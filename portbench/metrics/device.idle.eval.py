"""The share of the traced time in which no kernel, copy or fill runs (%)."""

from portbench.harness.readers import idle as read  # noqa: F401
