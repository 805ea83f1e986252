"""Distribution Matching (DM), on raw synthetic tensors and for S2D.

Port of ``video_distillation_tpu/distill/dm.py`` (the reference's DM
branches, ``distill_baseline.py:292-361`` and ``distill_s2d_ms.py:
312-445``): each iteration draws a fresh random frozen net, embeds
``batch_real`` real clips and the synthetic clips of every class, and
descends ``sum_c ||mean(embed(real_c)) - mean(embed(syn_c))||^2`` into the
synthetic parameters: the raw tensor with SGD(momentum 0.5), or the S2D
state (static, dynamic, hallucinators) with SGD(momentum 0.95), each group
at its own learning rate.

The real clips are gathered on the device from the uint8 clip store and
embedded without gradient, in chunks (``real_features``); the
per-class index plan is drawn on the host with numpy, the JAX package's
draw (``ClipStore.sample_per_class``). The synthetic embed runs with
gradient into the synthetic tensor (or, through ``hallucinate``, into the
S2D state), so its first stage runs the s2d2 unpack kernel.

Data parallelism (``parallel/dist.py``): the real embed is split over
whichever axis of the (C, batch_real) index the world size divides
(``dist.split_divisible``: classes, else the clips of each class), still in
chunks, and the per-class feature sums are all-reduced; the synthetic side
is replicated, and its gradient is rank 0's on every rank (broadcast), so
the replicas take the same update. With ``shard_store``
each rank holds ceil(N/n) rows of the clip store and the gathers of the
real clips are collectives.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from ..data.store import ClipStore
from ..models.registry import path_model
from ..ops.losses import dm_loss
from ..parallel import dist
from .mtt import _DTYPES
from .s2d import (S2DConfig, distill_slots, grad_leaves, grad_tensors,
                  hallucinate, momentum_sgd, state_grads)

# Real clips embedded per forward. The fused first stage's GEMM output is
# clips x 16 x 28 x 28 rows x 256 channels at 112x112x16: 320 clips give
# 1.03e9 elements (4.1 GB in fp32), under half of 2^31, where the phase
# trio's row index and cuDNN's 32-bit index math stop; the JAX package's
# 640 would be 96% of it.
REAL_CHUNK = 320
# That budget for any model: a forward keeps its widest activation under
# half of 2^31 elements (ROADMAP C.15). A model with a wider activation a
# clip (a VideoConvNet's first conv at full resolution over every frame)
# embeds fewer clips a chunk, and batched evaluation groups its nets by it.
FOLD_ELEMENTS = 2 ** 30


def real_chunk(model, frames: int, im_size, chunk: Optional[int] = None) -> int:
    """Clips a forward of ``model``: ``chunk`` (``REAL_CHUNK`` by default),
    or fewer where that many clips' widest activation would pass
    ``FOLD_ELEMENTS``."""
    return max(1, min(chunk or REAL_CHUNK, FOLD_ELEMENTS
                      // model.clip_elements(frames, *im_size)))


def init_synthetic_raw(generator: Optional[torch.Generator],
                       store: ClipStore, ipc: int, frames: int,
                       init: str = "real",
                       rng: Optional[np.random.Generator] = None,
                       device="cuda"):
    """(C*ipc, F, H, W, 3) float32 synthetic tensor in normalised space +
    labels [0,0,...,1,1,...] (distill_baseline.py:92-101). 'real' draws
    ``ipc`` distinct clips per class from ``rng`` (the JAX package's draw);
    'noise' draws N(0, 1) from ``generator``."""
    meta = store.meta
    C = meta.num_classes
    shape = (C * ipc, frames, meta.im_size[0], meta.im_size[1], meta.channel)
    labels = torch.as_tensor(np.repeat(np.arange(C), ipc), dtype=torch.int64,
                             device=device)
    if init == "real":
        rng = rng or np.random.default_rng(0)
        idx = store.sample_per_class(rng, ipc).reshape(-1)
        imgs = torch.as_tensor(np.asarray(store.clips[idx]), device=device)
        syn = store.normalize(imgs).reshape(shape)
    else:
        syn = torch.randn(shape, generator=generator, device=device)
    return syn, labels


def norm_stats(meta, device):
    """The dataset's channel mean and std times 255, fp32 on ``device``."""
    return (torch.tensor(meta.mean, dtype=torch.float32, device=device) * 255.0,
            torch.tensor(meta.std, dtype=torch.float32, device=device) * 255.0)


def standardize(r_u8, norm_mean, norm_std, cdt):
    """uint8 clips -> standardised clips in the compute dtype (dm.py:57-70).

    In fp32, ``(u8 - mean) / std``. In bf16 the whole chain runs in bf16,
    ``(u8 - bf16(mean)) * bf16(1 / std)`` rounded after each op, as the JAX
    package computes it (u8 values are exact in bf16)."""
    if cdt == torch.bfloat16:
        inv = (1.0 / norm_std).to(cdt)
        return (r_u8.to(cdt) - norm_mean.to(cdt)) * inv
    return ((r_u8.float() - norm_mean) / norm_std).to(cdt)


def embed(model, params, x):
    """The frozen net's features of ``x`` (``output='feat'``, train mode:
    the features come before the head's dropout), in fp32 (fp64 for fp64)."""
    feat = functional_call(model, params, (x,), dict(train=True, output="feat"))
    return feat.to(torch.promote_types(feat.dtype, torch.float32))


@torch.no_grad()
def real_features(model, params, store: ClipStore, clips2d, idx, norm_mean,
                  norm_std, cdt, chunk: int = REAL_CHUNK):
    """(len(idx), D) fp32 features of the clips ``idx`` (a 1-D index on
    the device of the store's ``clips2d``), standardised and embedded
    ``chunk`` clips at a time, without gradient. No path runs a model with
    batch statistics (``path_model`` refuses the BatchNorm nets, ROADMAP
    C.17; the other norms are per sample), so the chunking does not change
    the function: the JAX package's raw DM step (640-clip chunks), its
    S2D-DM step (one piece) and its coreset embed (64) compute the same
    features."""
    return torch.cat([embed(model, params, standardize(
        store.gather_clips(clips2d, idx[i:i + chunk]), norm_mean, norm_std,
        cdt)) for i in range(0, idx.numel(), chunk)])


class _DMTrainerBase:
    """What the raw and the S2D DM trainers share: the frozen net, the
    device clip store, the host draw of the real clips and their embed.

    ``fresh_net(generator)`` returns a freshly initialised net's fp32
    parameters (tests replace it to hand in the JAX package's net); each
    step casts them to the compute dtype (dm.py:91-96)."""

    def __init__(self, store: ClipStore, model_name: str, batch_real: int,
                 frames: int, compute_dtype: str, shard_store: bool, device):
        meta = store.meta
        self.store, self.batch_real = store, batch_real
        self.num_classes = meta.num_classes
        self.device = torch.device(device)
        self.cdt = _DTYPES[compute_dtype]
        self.clips = store.device_clips(self.device, sharded=shard_store)
        self.model = path_model(model_name, meta.channel, meta.num_classes,
                                tuple(meta.im_size), frames,
                                device=self.device)
        self.model.requires_grad_(False)
        self.chunk = real_chunk(self.model, frames, meta.im_size)
        self.norm_mean, self.norm_std = norm_stats(meta, self.device)

    def fresh_net(self, generator: Optional[torch.Generator]):
        self.model.reset_parameters(generator)
        return {k: v.detach().clone() for k, v in self.model.named_parameters()}

    def real_idx(self, np_rng: np.random.Generator) -> torch.Tensor:
        return torch.as_tensor(self.store.sample_per_class(np_rng,
                                                           self.batch_real),
                               device=self.device)

    def real_feats(self, params, real_idx):
        """(c, b, D) fp32 features of the real clips ``real_idx`` (c, b)."""
        feats = real_features(self.model, params, self.store, self.clips,
                              real_idx.reshape(-1), self.norm_mean,
                              self.norm_std, self.cdt, self.chunk)
        return feats.view(real_idx.shape[0], real_idx.shape[1], -1)

    def real_mean(self, params, real_idx):
        """(C, D) class means of the features of the real clips
        ``real_idx`` (C, batch_real): this rank embeds its share of the
        index (``dist.split_divisible``) and the per-class sums are summed
        over the ranks."""
        axis, mine = dist.split_divisible(real_idx)
        sums = self.real_feats(params, mine).sum(dim=1)
        if axis == 0:  # this rank's classes, in place among all
            full = sums.new_zeros((real_idx.shape[0], sums.shape[1]))
            full[dist.rank() * len(sums):][:len(sums)] = sums
            sums = full
        if axis is not None:
            dist.all_reduce_(sums)
        return sums / real_idx.shape[1]

    def loss(self, params, mean_real, x, per_class: int):
        """sum_c ||mean real_c - mean syn_c||^2 in fp32 (dm.py:127-131) of
        the synthetic clips ``x``, ``per_class`` a class in class order."""
        feat_syn = embed(self.model, params, x.to(self.cdt))
        return dm_loss(mean_real, feat_syn.view(self.num_classes, per_class,
                                                -1))

    def cast(self, params):
        return {k: v.to(self.cdt) for k, v in params.items()}


@dataclasses.dataclass
class DMState:
    syn_images: torch.Tensor
    labels: torch.Tensor
    momentum: torch.Tensor


class DMTrainer(_DMTrainerBase):
    """DM on a raw synthetic tensor (``_build_dm_step``, dm.py:73-180).

    ``trainer(generator, state, np_rng)`` returns ``(state, loss)``, as the
    JAX trainer does: a fresh net from ``generator``, the real clips from
    ``store.sample_per_class(np_rng, batch_real)``."""

    def __init__(self, store: ClipStore, model_name: str, ipc: int,
                 batch_real: int, lr_img: float, frames: int,
                 compute_dtype: str = "float32", shard_store: bool = False,
                 device="cuda"):
        super().__init__(store, model_name, batch_real, frames, compute_dtype,
                         shard_store, device)
        self.ipc, self.lr_img = ipc, lr_img

    def step(self, params, syn_images, mom, real_idx):
        """One DM update against the net ``params`` (fp32) and the real
        clips ``real_idx`` (C, batch_real): returns (syn_images, mom,
        loss). The inputs are not modified."""
        p = self.cast(params)
        mean_real = self.real_mean(p, real_idx)
        syn = syn_images.detach().requires_grad_(True)
        loss = self.loss(p, mean_real, syn, self.ipc)
        (g,) = torch.autograd.grad(loss, syn)
        dist.broadcast_tensors_([g])
        with torch.no_grad():
            mom = 0.5 * mom + g
            return syn_images - self.lr_img * mom, mom, loss.detach()

    def __call__(self, generator, state: DMState, np_rng):
        params = self.fresh_net(generator)
        syn, mom, loss = self.step(params, state.syn_images, state.momentum,
                                   self.real_idx(np_rng))
        return DMState(syn, state.labels, mom), loss


def make_dm_trainer(store: ClipStore, model_name: str, ipc: int,
                    batch_real: int, lr_img: float, frames: int,
                    compute_dtype: str = "float32", shard_store: bool = False,
                    device="cuda") -> DMTrainer:
    """The raw DM trainer (``make_dm_trainer``, dm.py:150-180)."""
    return DMTrainer(store, model_name, ipc, batch_real, lr_img, frames,
                     compute_dtype, shard_store, device)


class S2DDMTrainer(_DMTrainerBase):
    """S2D-DM (``_build_s2d_dm_step``, dm.py:187-282).

    ``trainer(generator, state, moms, np_rng)`` returns ``(state, moms,
    loss)``. The generator draws the fresh net, then the slots of the whole
    synthetic set (``distill_slots`` over ``arange(C*vpc)``), unless
    ``draws`` hands in the slot bits. The videos are composed in fp32
    (``hallucinate`` without a dtype, as dm.py:230) and cast to the compute
    dtype for the net. A frozen static gets no gradient and no update."""

    def __init__(self, store: ClipStore, model_name: str, s2d_cfg: S2DConfig,
                 batch_real: int, lr_static: float, lr_dynamic: float,
                 lr_hal: float, train_static: bool, frames: int,
                 compute_dtype: str = "float32", shard_store: bool = False,
                 device="cuda"):
        super().__init__(store, model_name, batch_real, frames, compute_dtype,
                         shard_store, device)
        self.s2d_cfg = s2d_cfg
        self.lrs = {"static": lr_static, "dynamic": lr_dynamic, "hals": lr_hal}
        self.train_static = train_static

    def compose(self, state, generator=None, draws: Optional[Sequence] = None):
        """The distillation-time videos of the whole set, fp32, and their
        labels (dm.py:217-230)."""
        cfg = self.s2d_cfg
        n = cfg.num_classes * cfg.vpc
        label, s_idx, d_idx = distill_slots(
            cfg.num_classes, cfg.spc, cfg.vpc,
            torch.arange(n, device=self.device), generator, draws)
        dy = state["dynamic"]
        dynamic = dy.reshape((-1,) + dy.shape[2:])[label * dy.shape[1] + d_idx]
        videos = hallucinate(state["hals"][0], state["static"][s_idx],
                             dynamic, cfg.hal_mode)
        return videos, label

    def step(self, params, state, moms, real_idx, generator=None,
             draws: Optional[Sequence] = None):
        """One S2D-DM update against the net ``params`` (fp32): returns
        (state, moms, loss). The inputs are not modified."""
        p = self.cast(params)
        mean_real = self.real_mean(p, real_idx)
        leaf = grad_leaves(state, self.train_static)
        videos, _ = self.compose(leaf, generator, draws)
        loss = self.loss(p, mean_real, videos, self.s2d_cfg.vpc)
        g, _ = state_grads(loss, leaf, self.train_static)
        dist.broadcast_tensors_(grad_tensors(g))
        trained = {"static": self.train_static, "dynamic": True, "hals": True}
        new_state, new_moms = momentum_sgd(state, moms, g, self.lrs, trained,
                                           0.95)
        return new_state, new_moms, loss.detach()

    def __call__(self, generator, state, moms, np_rng,
                 draws: Optional[Sequence] = None):
        params = self.fresh_net(generator)
        return self.step(params, state, moms, self.real_idx(np_rng),
                         generator, draws)


def make_s2d_dm_trainer(store: ClipStore, model_name: str,
                        s2d_cfg: S2DConfig, batch_real: int,
                        lr_static: float, lr_dynamic: float, lr_hal: float,
                        train_static: bool, frames: int,
                        compute_dtype: str = "float32",
                        shard_store: bool = False,
                        device="cuda") -> S2DDMTrainer:
    """The S2D-DM trainer (``make_s2d_dm_trainer``, dm.py:257-282)."""
    return S2DDMTrainer(store, model_name, s2d_cfg, batch_real, lr_static,
                        lr_dynamic, lr_hal, train_static, frames,
                        compute_dtype, shard_store, device)
