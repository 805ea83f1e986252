"""Model FLOPs of one step, counted over the plain reference.

``torch.utils.flop_counter.FlopCounterMode`` counts the convolutions and
matrix products of one reference step on ``meta`` tensors at a cell's
shapes: an S2D-MTT outer step (the composition, the ``syn_steps``-deep
unroll with its inner gradients, the outer backward through them), or one
net's evaluation training step (forward, and the backward into the
parameters). Nothing is recomputed in the reference, so nothing is
counted twice. The counts are stored in each configuration's file, where
no change to the program can move them; a test counts them again.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import convnet3d as net


def outer_step_flops(num_classes: int, channel: int, im_size: int,
                     frames: int, syn_steps: int, batch_syn: int) -> int:
    dev = "meta"
    b = syn_steps * batch_syn
    theta0 = torch.zeros(net.num_params(channel, num_classes), device=dev)
    theta1 = torch.zeros_like(theta0)
    static = torch.zeros((b, im_size, im_size, 3), device=dev)
    dynamic = torch.zeros((b, frames, im_size, im_size, 1), device=dev,
                          requires_grad=True)
    hal_w = torch.zeros((3, 4, 3, 3, 3), device=dev, requires_grad=True)
    hal_b = torch.zeros(3, device=dev, requires_grad=True)
    lr = torch.zeros((), device=dev, requires_grad=True)
    y = torch.zeros(batch_syn, dtype=torch.long, device=dev)
    w = torch.ones(batch_syn, device=dev)
    keep = torch.ones((batch_syn,) + net.keep_mask_shape(frames, im_size),
                      dtype=torch.bool, device=dev)
    with FlopCounterMode(display=False) as counter:
        videos = net.hallucinate(hal_w, hal_b, static, dynamic)
        x = videos.reshape((syn_steps, batch_syn) + videos.shape[1:])
        theta = theta0.requires_grad_(True)
        for s in range(syn_steps):
            logits = net.forward(net.unflatten(theta, channel, num_classes),
                                 x[s], im_size, keep)
            ce = net.masked_ce(logits, y, w, w.sum())
            (g,) = torch.autograd.grad(ce, theta, create_graph=True)
            theta = theta - lr * g
        loss = ((theta - theta1) ** 2).sum() / ((theta0 - theta1) ** 2).sum()
        torch.autograd.grad(loss, (dynamic, hal_w, hal_b, lr))
    return int(counter.get_total_flops())


def eval_step_flops(num_classes: int, channel: int, im_size: int,
                    frames: int, batch: int) -> int:
    """One net's training step on a batch of ``batch`` composed clips: the
    composition, the forward and the backward into the parameters."""
    dev = "meta"
    theta = torch.zeros(net.num_params(channel, num_classes), device=dev,
                        requires_grad=True)
    static = torch.zeros((batch, im_size, im_size, 3), device=dev)
    dynamic = torch.zeros((batch, frames, im_size, im_size, 1), device=dev)
    hal_w = torch.zeros((3, 4, 3, 3, 3), device=dev)
    hal_b = torch.zeros(3, device=dev)
    y = torch.zeros(batch, dtype=torch.long, device=dev)
    w = torch.ones(batch, device=dev)
    keep = torch.ones((batch,) + net.keep_mask_shape(frames, im_size),
                      dtype=torch.bool, device=dev)
    with FlopCounterMode(display=False) as counter:
        x = net.hallucinate(hal_w, hal_b, static, dynamic)
        logits = net.forward(net.unflatten(theta, channel, num_classes), x,
                             im_size, keep)
        torch.autograd.grad(net.masked_ce(logits, y, w, w.sum()), theta)
    return int(counter.get_total_flops())
