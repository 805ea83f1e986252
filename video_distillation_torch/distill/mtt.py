"""MTT — Matching Training Trajectories, on raw tensors and for S2D.

Port of ``video_distillation_tpu/distill/mtt.py`` (the reference's MTT
branches, distill_s2d_ms.py:113-310): sample an expert trajectory segment
(θ_start = traj[e], θ_target = traj[e + expert_epochs]); run ``syn_steps``
SGD steps ``θ ← θ − syn_lr·∇ce`` on synthetic batches from θ_start; the
grand loss ‖θ_K − θ*‖²/‖θ_0 − θ*‖² is differentiated through the whole
unroll into the synthetic parameters. Raw synthetic images and their
learnable ``syn_lr`` use SGD with momentum 0.5 (``MTTStep``); S2D memories
and the hallucinator use momentum 0.95 and the learnable ``syn_lr`` 0.9
(``S2DMTTStep``); ``syn_lr`` is clipped at 0.001 after each update.

The second order comes from ``torch.autograd.grad(..., create_graph=True)``
on each inner step, the reference's own method: every inner step's graph
stays in memory until the outer backward (the JAX package's ``'full'``
mode), which is mathematically what its ``'rof'`` custom VJP computes.

θ is the JAX package's flat fp32 vector (``distill/params.py``), so both
packages read the same ``replay_buffer_{n}.npz``. Each inner step casts θ
to the compute dtype; for bfloat16 the ConvNet3D head stage runs in fp32
(see ``models/convnet3d.py``).

Batch plan semantics: the reference pops permutation chunks from the END
of a per-iteration chunk list (distill_baseline.py:231-241), refilling
when empty; ragged remainder chunks are padded with -1 and masked in the
CE mean.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..models.registry import path_model
from .params import layout_for
from .s2d import (S2DConfig, distill_slots, grad_leaves, hallucinate,
                  momentum_sgd, state_grads)

# float64 is for references only (chip_smoke.py's parity phase)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float64": torch.float64}


def make_batch_plan(rng: np.random.Generator, n: int, batch_syn: int,
                    syn_steps: int, leftover: Optional[list] = None):
    """(syn_steps, batch_syn) int32 plan with -1 padding, reproducing the
    reference's pop-from-end chunking. ``leftover`` (mutated) carries
    unconsumed chunks across outer iterations within one buffer epoch —
    the reference resets it each iteration, so callers pass None."""
    chunks = list(leftover) if leftover else []
    plan = np.full((syn_steps, batch_syn), -1, np.int32)
    for s in range(syn_steps):
        if not chunks:
            perm = rng.permutation(n)
            chunks = [perm[i:i + batch_syn]
                      for i in range(0, n, batch_syn)]
        chunk = chunks.pop()
        plan[s, :len(chunk)] = chunk
    return plan


def take_rows(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather; its backward is autograd's index_add (the JAX package
    needs a one-hot matmul there, torch does not)."""
    return mat[idx]


def masked_ce(logits: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
    """Mean cross entropy over the rows with weight 1 (plan padding has 0),
    in fp32 for bf16 or fp32 logits (mtt.py:171-185), in fp64 for fp64."""
    logp = F.log_softmax(logits.to(torch.promote_types(logits.dtype,
                                                       torch.float32)), dim=-1)
    pick = -logp.gather(1, y[:, None])[:, 0]
    return (pick * w).sum() / w.sum().clamp_min(1.0)


class MTTCore:
    """The inner unroll: (composed batches, θ_start, syn_lr) -> grand loss
    (``_build_mtt_core``, mtt.py:127-289), with gradients to second order
    through ``create_graph``."""

    def __init__(self, model_name: str, channel: int, num_classes: int,
                 im_size: Tuple[int, int], frames: int, syn_steps: int,
                 compute_dtype: str, device):
        self.model = path_model(model_name, channel, num_classes,
                                tuple(im_size), frames, device=device)
        self.model.requires_grad_(False)
        self.layout = layout_for(self.model)
        self.syn_steps = syn_steps
        self.cdt = _DTYPES[compute_dtype]
        # the JAX package's all-bf16 second-order pass goes non-finite at
        # 112x112x16 without an fp32 head stage (mtt.py:194-203)
        self.fp32_stages = ("head",) if self.cdt == torch.bfloat16 else ()

    def ce(self, theta, x, y, w, keep_mask=None, generator=None):
        params = {k: v.to(self.cdt)
                  for k, v in self.layout.unflatten(theta).items()}
        logits = functional_call(
            self.model, params, (x.to(self.cdt),),
            dict(train=True, keep_mask=keep_mask, generator=generator,
                 fp32_stages=self.fp32_stages))
        return masked_ce(logits, y, w)

    def unroll(self, theta_start, theta_target, syn_lr, batches_x, batches_y,
               batches_w, keep_masks=None, generator=None):
        """batches_x: (S, B, F, H, W, C), already in normalised space.
        ``keep_masks``: optional per-step dropout keep-masks (S, ...) in
        the JAX layout. Returns (grand_loss, param_loss, param_dist)."""
        theta = theta_start.detach().requires_grad_(True)
        for s in range(self.syn_steps):
            km = None if keep_masks is None else keep_masks[s]
            ce = self.ce(theta, batches_x[s], batches_y[s], batches_w[s], km,
                         generator)
            (g,) = torch.autograd.grad(ce, theta, create_graph=True)
            theta = theta - syn_lr * g
        param_loss = ((theta - theta_target) ** 2).sum()
        param_dist = ((theta_start - theta_target) ** 2).sum()
        return param_loss / param_dist, param_loss, param_dist


class MTTStep:
    """One MTT outer step on a raw synthetic tensor (``_build_mtt_step``,
    mtt.py:292-331).

    ``step(generator, syn_images, syn_labels, syn_lr, mom_img, mom_lr,
    theta_start, theta_target, plan)`` returns ``(syn_images, syn_lr,
    mom_img, mom_lr, loss, param_loss, param_dist)`` as the JAX step does,
    plus the outer gradients (``{'images', 'syn_lr'}``). The plan's rows of
    ``syn_images`` are gathered in the compute dtype; the images and the
    learnable lr both take SGD with momentum 0.5 (distill_baseline.py:
    107-108; S2D's lr takes 0.9). The inputs are not modified."""

    def __init__(self, model_name: str, channel: int, num_classes: int,
                 im_size, frames: int, syn_steps: int, lr_img: float,
                 lr_lr: float, train_lr: bool, compute_dtype: str, device):
        self.core = MTTCore(model_name, channel, num_classes, tuple(im_size),
                            frames, syn_steps, compute_dtype, device)
        self.lr_img, self.lr_lr, self.train_lr = lr_img, lr_lr, train_lr

    def loss(self, syn_images, syn_labels, syn_lr, theta_start, theta_target,
             plan, generator=None, keep_masks=None):
        """Grand loss (and its two terms) as a differentiable function of
        the synthetic images and syn_lr."""
        w = (plan >= 0).float()
        safe = plan.clamp_min(0).long()
        syn2d = syn_images.to(self.core.cdt).reshape(syn_images.shape[0], -1)
        batches_x = take_rows(syn2d, safe.reshape(-1)).reshape(
            tuple(safe.shape) + tuple(syn_images.shape[1:]))
        return self.core.unroll(theta_start, theta_target, syn_lr, batches_x,
                                syn_labels[safe], w, keep_masks, generator)

    def __call__(self, generator, syn_images, syn_labels, syn_lr, mom_img,
                 mom_lr, theta_start, theta_target, plan, keep_masks=None):
        syn = syn_images.detach().requires_grad_(True)
        lr = torch.as_tensor(syn_lr, dtype=torch.float32,
                             device=syn.device).detach().requires_grad_(True)
        loss, ploss, pdist = self.loss(syn, syn_labels, lr, theta_start,
                                       theta_target, plan, generator,
                                       keep_masks)
        g_img, g_lr = torch.autograd.grad(loss, (syn, lr))
        with torch.no_grad():
            mom_img = 0.5 * mom_img + g_img
            new_syn = syn_images - self.lr_img * mom_img
        new_lr, mom_lr = _syn_lr_update(syn_lr, mom_lr, g_lr, self.train_lr,
                                        self.lr_lr, 0.5)
        return (new_syn, new_lr, mom_img, mom_lr, loss.detach(),
                ploss.detach(), pdist.detach(),
                {"images": g_img, "syn_lr": g_lr})


def s2d_slot_draws(plan: torch.Tensor, s2d_cfg: S2DConfig,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Sequence] = None):
    """Per-inner-step slot draws for a (S, B) plan (mtt.py:352-362):
    (labels, static_idx, dynamic_idx), each (S, B). ``draws`` =
    (dynamic bits, static bits), each U{0,1} of the plan's shape."""
    safe = plan.clamp_min(0).long()
    return distill_slots(s2d_cfg.num_classes, s2d_cfg.spc, s2d_cfg.vpc, safe,
                         generator, draws)


@dataclasses.dataclass
class S2DHyper:
    lr_static: float
    lr_dynamic: float
    lr_hal: float
    lr_lr: float
    train_static: bool
    train_lr: bool


class S2DMTTStep:
    """One S2D-MTT outer step (``_build_s2d_mtt_step``, mtt.py:335-413).

    ``step(generator, state, syn_lr, moms, mom_lr, theta_start,
    theta_target, plan)`` returns ``(new_state, syn_lr, new_moms, mom_lr,
    loss, param_loss, param_dist)`` as the JAX step does, plus the outer
    gradients (a dict with the state's structure and ``syn_lr``). The
    inputs are not modified."""

    def __init__(self, model_name: str, channel: int, num_classes: int,
                 im_size, frames: int, syn_steps: int, s2d_cfg: S2DConfig,
                 hyper: S2DHyper, compute_dtype: str, device):
        self.core = MTTCore(model_name, channel, num_classes, tuple(im_size),
                            frames, syn_steps, compute_dtype, device)
        self.s2d_cfg = s2d_cfg
        self.hyper = hyper
        self.syn_steps = syn_steps

    def loss(self, state, syn_lr, theta_start, theta_target, plan,
             generator=None, draws=None, keep_masks=None):
        """Grand loss (and its two terms) as a differentiable function of
        the S2D state and syn_lr."""
        cfg = self.s2d_cfg
        w = (plan >= 0).float()
        labels, s_idx, d_idx = s2d_slot_draws(plan, cfg, generator, draws)
        st = state["static"]
        if not self.hyper.train_static:
            # frozen static: cut its whole backward chain (dgrad of the
            # static input and the gather's index_add)
            st = st.detach()
        static = take_rows(st, s_idx.reshape(-1))
        dy = state["dynamic"]
        flat_idx = labels.reshape(-1) * dy.shape[1] + d_idx.reshape(-1)
        dynamic = take_rows(dy.reshape((-1,) + dy.shape[2:]), flat_idx)
        # compose + stage the unroll batches in the compute dtype
        videos = hallucinate(state["hals"][0], static, dynamic, cfg.hal_mode,
                             dtype=self.core.cdt)
        batches_x = videos.reshape((self.syn_steps, -1) + videos.shape[1:])
        return self.core.unroll(theta_start, theta_target, syn_lr, batches_x,
                                labels, w, keep_masks, generator)

    def __call__(self, generator, state, syn_lr, moms, mom_lr, theta_start,
                 theta_target, plan, draws=None, keep_masks=None):
        hp = self.hyper
        leaf = grad_leaves(state, hp.train_static)
        lr = torch.as_tensor(syn_lr, dtype=torch.float32,
                             device=leaf["dynamic"].device).detach().requires_grad_(True)
        loss, ploss, pdist = self.loss(leaf, lr, theta_start, theta_target,
                                       plan, generator, draws, keep_masks)
        g, (g_lr,) = state_grads(loss, leaf, hp.train_static, extra=(lr,))
        g["syn_lr"] = g_lr
        new_state, new_moms = momentum_sgd(
            state, moms, g, {"static": hp.lr_static, "dynamic": hp.lr_dynamic,
                             "hals": hp.lr_hal},
            {"static": hp.train_static, "dynamic": True, "hals": True}, 0.95)
        new_lr, mom_lr = _syn_lr_update(syn_lr, mom_lr, g_lr, hp.train_lr,
                                        hp.lr_lr, 0.9)
        return (new_state, new_lr, new_moms, mom_lr, loss.detach(),
                ploss.detach(), pdist.detach(), g)


@torch.no_grad()
def _syn_lr_update(syn_lr, mom_lr, g_lr, train_lr: bool, lr_lr: float,
                   mu: float):
    """The learnable lr's SGD step with momentum ``mu``, clipped at 0.001
    (distill_baseline.py:283); unchanged unless ``train_lr``. Returns
    (syn_lr, mom_lr)."""
    new_lr = torch.as_tensor(syn_lr, dtype=torch.float32, device=g_lr.device)
    if train_lr:
        mom_lr = mu * mom_lr + g_lr
        new_lr = torch.clamp(new_lr - lr_lr * mom_lr, min=0.001)
    return new_lr, mom_lr


@dataclasses.dataclass
class TrajectoryBuffer:
    """Expert trajectories as stacked flat-param arrays: each expert is a
    dense (E+1, P) float32 array in the JAX package's flat order, stored
    as ``trajectories`` in a compressed ``.npz`` (mtt.py:417-444)."""

    trajectories: np.ndarray  # (num_experts, E+1, P)

    def __len__(self):
        return self.trajectories.shape[0]

    @property
    def num_epochs(self):
        return self.trajectories.shape[1]

    def segment(self, expert: int, start_epoch: int, expert_epochs: int):
        t = self.trajectories[expert]
        return t[start_epoch], t[start_epoch + expert_epochs]

    def save(self, path: str):
        np.savez_compressed(path, trajectories=self.trajectories)

    @staticmethod
    def load(path: str) -> "TrajectoryBuffer":
        with np.load(path) as z:
            return TrajectoryBuffer(z["trajectories"])


class ExpertSampler:
    """Reference expert-iteration order (distill_baseline.py:122-135,
    :203-211): shuffle the buffer files, walk experts sequentially,
    reshuffle on wrap; start epoch ~ U[0, max_start_epoch)."""

    def __init__(self, buffers, rng: np.random.Generator):
        self.buffers = list(buffers)
        self.rng = rng
        self.rng.shuffle(self.buffers)
        self.file_idx = 0
        self.expert_idx = 0
        self._order = None
        self._reshuffle()

    def _reshuffle(self):
        n = len(self.buffers[self.file_idx])
        self._order = self.rng.permutation(n)

    def next_trajectory(self):
        buf = self.buffers[self.file_idx]
        traj_i = int(self._order[self.expert_idx])
        self.expert_idx += 1
        if self.expert_idx == len(buf):
            self.expert_idx = 0
            self.file_idx += 1
            if self.file_idx == len(self.buffers):
                self.file_idx = 0
                self.rng.shuffle(self.buffers)
            self._reshuffle()
        return buf, traj_i

    def sample_segment(self, max_start_epoch: int, expert_epochs: int):
        buf, traj_i = self.next_trajectory()
        start_epoch = int(self.rng.integers(0, max_start_epoch))
        theta_start, theta_target = buf.segment(traj_i, start_epoch,
                                                expert_epochs)
        return theta_start, theta_target, start_epoch


def flat_param_template(model_name: str, channel: int, num_classes: int,
                        im_size, frames: int,
                        generator: Optional[torch.Generator] = None,
                        device=None) -> Tuple[torch.nn.Module, torch.Tensor]:
    """(model, θ) — a freshly initialised model and its flat vector in the
    JAX package's order (the counterpart of mtt.py:88-100)."""
    model = path_model(model_name, channel, num_classes, tuple(im_size),
                       frames, generator=generator, device=device)
    layout = layout_for(model)
    return model, layout.flatten(dict(model.named_parameters())).detach()

