"""What a loop's ``stand_in`` puts in the program's place to set the limits
of ``correct`` (``portbench/calibrate.py``): the reference computed one
precision step down, or with a fault planted. The benchmark's own runs
never use this. A stand-in is named by ``who``:

* the control, the reference in the precision below the configuration's:
  for bf16 ``fp8`` (e4m3) or ``int8``, each at a per-tensor scale on every
  convolution's operands and on the gradients of its backward; for fp32
  ``tf32`` (the loop turns TF32 on for any name not a fault's);
* ``half_batch``: every inner batch's mean taken over its first half;
* ``perturbed``: the fp32 reference on a static memory perturbed by a
  relative 1e-7 (what a rounding of the inputs alone does to each number).
"""

from __future__ import annotations

import torch

from . import inputs

PERTURB = 1e-7
FAULTS = ("half_batch", "perturbed")


def round_fp8(t):
    """t rounded to float8 e4m3 at a per-tensor scale (its largest
    magnitude to e4m3's 448)."""
    scale = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def round_int8(t):
    """t rounded to int8 at a symmetric per-tensor scale (its largest
    magnitude to 127)."""
    scale = t.abs().amax().clamp_min(1e-30) / 127.0
    return torch.round(t / scale).clamp(-127, 127) * scale


class Quant:
    """Every convolution of the reference in a lower precision: operands,
    and the gradients of its backward, rounded by ``fn`` (differentiable to
    any order: each backward is the rounding again)."""

    def __init__(self, fn):
        class Operand(torch.autograd.Function):
            @staticmethod
            def forward(ctx, t):
                return fn(t)

            @staticmethod
            def backward(ctx, g):
                return Operand.apply(g)

        class Result(torch.autograd.Function):
            @staticmethod
            def forward(ctx, t):
                return t.view_as(t)

            @staticmethod
            def backward(ctx, g):
                return Operand.apply(g)

        self.operand, self.result = Operand.apply, Result.apply


QUANTS = {"fp8": Quant(round_fp8), "int8": Quant(round_int8)}


def start(state, seed, device, who):
    """The S2D state the stand-in starts from: the static memory perturbed
    for ``perturbed``, else ``state`` itself."""
    if who != "perturbed":
        return state
    g = inputs.generator(seed, 9, device)
    noise = torch.randn(state["static"].shape, generator=g, device=device)
    return dict(state, static=state["static"] * (1 + PERTURB * noise))
