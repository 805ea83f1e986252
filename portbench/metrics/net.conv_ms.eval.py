"""Device ms of the kernels under aten::convolution and
aten::convolution_backward, per net's training step."""

from portbench.harness.readers import conv_ms as read  # noqa: F401
