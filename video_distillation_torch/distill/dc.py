"""DC — Dataset Condensation with gradient matching (static learning).

Port of ``video_distillation_tpu/distill/dc.py``. The reference directs
static-memory learning to the DC algorithm over single-frame datasets; its
loss machinery is ``utils.py:634-709`` (``distance_wb`` / ``match_loss`` /
``get_loops``), wired into the canonical DC loop:

    per iteration: fresh net; for each outer step: per-class
    ``match_loss(∂CE(syn_c)/∂θ, stopgrad(∂CE(real_c)/∂θ))`` summed over
    classes -> SGD(momentum 0.5) on the synthetic images; then
    ``inner_loop`` SGD steps training the net on the synthetic set.

A class's loss depends only on its own synthetic images, so each class
takes its own backward right after its forward, which frees that class's
second-order graph: the same gradient as the JAX package's ``lax.map`` +
``jax.checkpoint``, with one class's graph alive at a time.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..data.store import ClipStore
from ..models.registry import path_model
from ..ops.losses import cross_entropy, match_loss

Params = Dict[str, torch.Tensor]


def get_loops(ipc: int) -> Tuple[int, int]:
    """(outer_loop, inner_loop) by images per class (utils.py:691-709)."""
    table = {1: (1, 1), 5: (1, 1), 10: (10, 50), 20: (20, 25),
             30: (30, 20), 40: (40, 15), 50: (50, 10)}
    if ipc not in table:
        raise ValueError(f"loop hyper-parameters not defined for {ipc} ipc")
    return table[ipc]


class DCTrainer:
    """DC over an image ClipStore (clips shaped (N, H, W, C)), on ``device``.

    ``trainer(generator, syn_images, syn_labels, mom, np_rng)`` runs one
    iteration and returns ``(syn_images, mom, mean matching loss)``, as the
    JAX trainer does; the fresh net comes from ``fresh_net(generator)`` and
    the real batches from ``store.sample_per_class(np_rng, batch_real)``,
    in the JAX package's order."""

    def __init__(self, store: ClipStore, model_name: str, ipc: int,
                 batch_real: int, lr_img: float, lr_net: float,
                 dis_metric: str = "ours", device="cuda"):
        meta = store.meta
        self.store = store
        self.outer_loop, self.inner_loop = get_loops(ipc)
        self.num_classes, self.ipc, self.batch_real = (meta.num_classes, ipc,
                                                       batch_real)
        self.lr_img, self.lr_net, self.dis_metric = lr_img, lr_net, dis_metric
        self.device = torch.device(device)
        self.model = path_model(model_name, meta.channel, meta.num_classes,
                                tuple(meta.im_size), 1, device=self.device)
        self.model.requires_grad_(False)
        self.clips = store.device_clips(self.device)

    def fresh_net(self, generator: torch.Generator) -> Params:
        """A freshly initialised net's parameters, drawn from ``generator``
        (tests replace this to hand in the JAX package's net)."""
        self.model.reset_parameters(generator)
        return {k: v.detach().clone() for k, v in self.model.named_parameters()}

    def ce(self, params: Params, x, y):
        return cross_entropy(functional_call(self.model, params, (x,)), y)

    def match_step(self, params: Params, syn_images, mom, real_idx):
        """One gradient-matching step (dc.py:60-88) against the current net:
        returns (syn_images, mom, loss summed over classes). ``real_idx``
        is (C, batch_real); the real batches take the synthetic images'
        dtype. The net is not changed."""
        ipc = self.ipc
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        leaves = list(p.values())
        grads = torch.empty_like(syn_images)
        loss = syn_images.new_zeros(())
        for c in range(self.num_classes):
            real = self.store.normalize(self.store.gather_clips(
                self.clips, real_idx[c])).to(syn_images.dtype)
            y_real = torch.full((real.shape[0],), c, device=self.device)
            gw_real = torch.autograd.grad(self.ce(p, real, y_real), leaves)
            syn_c = syn_images[c * ipc:(c + 1) * ipc].detach().requires_grad_(True)
            y_syn = torch.full((ipc,), c, device=self.device)
            gw_syn = torch.autograd.grad(self.ce(p, syn_c, y_syn), leaves,
                                         create_graph=True)
            loss_c = match_loss(gw_syn, gw_real, self.dis_metric)
            (grads[c * ipc:(c + 1) * ipc],) = torch.autograd.grad(loss_c, syn_c)
            loss += loss_c.detach()
        mom = 0.5 * mom + grads
        return syn_images - self.lr_img * mom, mom, loss

    def inner_train(self, params: Params, net_mom: Params, syn_images,
                    syn_labels) -> Tuple[Params, Params]:
        """``inner_loop`` SGD steps training the net on the synthetic set,
        momentum 0.5 at ``lr_net`` (dc.py:90-103, DC's ``epoch()``)."""
        for _ in range(self.inner_loop):
            p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            g = torch.autograd.grad(self.ce(p, syn_images, syn_labels),
                                    list(p.values()))
            with torch.no_grad():
                net_mom = {k: 0.5 * net_mom[k] + gk for k, gk in zip(p, g)}
                params = {k: params[k] - self.lr_net * net_mom[k] for k in p}
        return params, net_mom

    def __call__(self, generator: torch.Generator, syn_images, syn_labels,
                 mom, np_rng: np.random.Generator):
        # ONE fresh net per iteration; it persists across the outer_loop
        # steps and is trained on the synthetic set between them (not after
        # the last: the canonical DC schedule)
        params = self.fresh_net(generator)
        net_mom = {k: torch.zeros_like(v) for k, v in params.items()}
        loss_total = 0.0
        for ol in range(self.outer_loop):
            idx = torch.as_tensor(
                self.store.sample_per_class(np_rng, self.batch_real),
                device=self.device)
            syn_images, mom, loss = self.match_step(params, syn_images, mom,
                                                    idx)
            loss_total += float(loss)
            if self.inner_loop > 0 and ol < self.outer_loop - 1:
                params, net_mom = self.inner_train(params, net_mom,
                                                   syn_images, syn_labels)
        return syn_images, mom, loss_total / max(1, self.outer_loop)


def make_dc_trainer(store: ClipStore, model_name: str, ipc: int,
                    batch_real: int, lr_img: float, lr_net: float,
                    dis_metric: str = "ours", device="cuda") -> DCTrainer:
    """DC trainer over an image ClipStore (dc.py:108-139)."""
    return DCTrainer(store, model_name, ipc, batch_real, lr_img, lr_net,
                     dis_metric, device)
