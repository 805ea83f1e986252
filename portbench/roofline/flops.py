"""Model FLOPs of one step, counted over the plain reference.

``torch.utils.flop_counter.FlopCounterMode`` counts the convolutions and
matrix products of one reference step on ``meta`` tensors at a cell's
shapes: an S2D-MTT outer step (the composition, the ``syn_steps``-deep
unroll with its inner gradients, the outer backward through them), or one
net's evaluation training step (forward, and the backward into the
parameters). ``net`` is the student net's reference (its file under
``reference/nets``) and ``m`` the configuration's ``model``. Nothing is
recomputed in the reference, so nothing is counted twice. The counts are
stored in each configuration's file, where no change to the program can
move them; a test counts them again.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference.hallucinator import hallucinate
from ..reference.ops import masked_ce, num_params


def _keep(net, m: dict, batch: int):
    shape = net.keep_mask_shape(m)
    return None if shape is None else torch.ones(
        (batch,) + shape, dtype=torch.bool, device="meta")


def outer_step_flops(net, m: dict, syn_steps: int, batch_syn: int) -> int:
    dev = "meta"
    b, im, frames = syn_steps * batch_syn, m["im_size"], m["frames"]
    theta0 = torch.zeros(num_params(net.leaves(m)), device=dev)
    theta1 = torch.zeros_like(theta0)
    static = torch.zeros((b, im, im, 3), device=dev)
    dynamic = torch.zeros((b, frames, im, im, 1), device=dev,
                          requires_grad=True)
    hal_w = torch.zeros((3, 4, 3, 3, 3), device=dev, requires_grad=True)
    hal_b = torch.zeros(3, device=dev, requires_grad=True)
    lr = torch.zeros((), device=dev, requires_grad=True)
    y = torch.zeros(batch_syn, dtype=torch.long, device=dev)
    w = torch.ones(batch_syn, device=dev)
    keep = _keep(net, m, batch_syn)
    with FlopCounterMode(display=False) as counter:
        videos = hallucinate(hal_w, hal_b, static, dynamic)
        x = videos.reshape((syn_steps, batch_syn) + videos.shape[1:])
        theta = theta0.requires_grad_(True)
        for s in range(syn_steps):
            logits = net.forward(net.unflatten(theta, m), x[s], m, keep)
            ce = masked_ce(logits, y, w, w.sum())
            (g,) = torch.autograd.grad(ce, theta, create_graph=True)
            theta = theta - lr * g
        loss = ((theta - theta1) ** 2).sum() / ((theta0 - theta1) ** 2).sum()
        torch.autograd.grad(loss, (dynamic, hal_w, hal_b, lr))
    return int(counter.get_total_flops())


def eval_step_flops(net, m: dict, batch: int) -> int:
    """One net's training step on a batch of ``batch`` composed clips: the
    composition, the forward and the backward into the parameters."""
    dev = "meta"
    im, frames = m["im_size"], m["frames"]
    theta = torch.zeros(num_params(net.leaves(m)), device=dev,
                        requires_grad=True)
    static = torch.zeros((batch, im, im, 3), device=dev)
    dynamic = torch.zeros((batch, frames, im, im, 1), device=dev)
    hal_w = torch.zeros((3, 4, 3, 3, 3), device=dev)
    hal_b = torch.zeros(3, device=dev)
    y = torch.zeros(batch, dtype=torch.long, device=dev)
    w = torch.ones(batch, device=dev)
    keep = _keep(net, m, batch)
    with FlopCounterMode(display=False) as counter:
        x = net.prepare(hallucinate(hal_w, hal_b, static, dynamic), m)
        logits = net.forward(net.unflatten(theta, m), x, m, keep)
        torch.autograd.grad(masked_ce(logits, y, w, w.sum()), theta)
    return int(counter.get_total_flops())
