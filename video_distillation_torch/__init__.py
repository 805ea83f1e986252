"""video_distillation_torch — the PyTorch / CUDA (NVIDIA H100) port of
``video_distillation_tpu``.

A package of its own: it imports ``torch`` and never ``jax``, and nothing of
the JAX package, whose module names it keeps so each file's counterpart is
easy to find. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; they never fall back to the CPU on their own. Every
Pallas kernel on a ported path is a hand-written Hopper kernel under
``csrc/`` with a plain PyTorch version beside it, which only CPU tensors
take.

Ported so far: the S2D-MTT distillation slice
(``python -m video_distillation_torch.drivers.distill_s2d``).
"""

__version__ = "0.1.0"
