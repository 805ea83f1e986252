"""The benchmark of the PyTorch / H100 port (``video_distillation_torch``)."""
