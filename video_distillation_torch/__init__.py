"""video_distillation_torch — the PyTorch / CUDA (NVIDIA H100) port of
``video_distillation_tpu``.

A package of its own: it imports ``torch`` and never ``jax``, and nothing of
the JAX package, whose module names it keeps so each file's counterpart is
easy to find. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; they never fall back to the CPU on their own. Every
Pallas kernel on a ported path is a hand-written Hopper kernel under
``csrc/`` with a plain PyTorch version beside it, which only CPU tensors
take.

Ported so far: the paper's S2D-MTT pipeline, from offline packing
(``python -m video_distillation_torch.drivers.pack``) and static learning
(``python -m video_distillation_torch.drivers.distill_static``) to expert
buffers (``python -m video_distillation_torch.drivers.buffer``),
distillation and the multi-static evaluation
(``python -m video_distillation_torch.drivers.distill_s2d``), with all
nine of the JAX package's Pallas kernels; the baselines, FRePo, the video
models, the converter, and the image side (image datasets, ZCA, EMA, every
image net of the JAX ``create_model``).
"""

__version__ = "0.1.0"
