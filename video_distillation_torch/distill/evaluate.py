"""Synthetic-set evaluation: train fresh nets on the synthetic set, test them.

Port of ``video_distillation_tpu/distill/evaluate.py`` (parity with the
reference's ``evaluate_synset`` + ``epoch``, utils.py:752-886), the root
protocol only:

* a fresh randomly initialised net per evaluation, from an explicit
  ``torch.Generator``;
* SGD(lr, momentum 0.9, weight_decay 5e-4); LR x0.1 for the epochs strictly
  after ``epoch_eval_train//2 + 1``, with the momentum buffer reset on the
  first step of the first reduced epoch (the reference recreates the
  optimizer once that epoch has trained, utils.py:848,871-874);
* ``epoch_eval_train + 1`` epochs over per-epoch permutations padded with
  -1 (padded rows weigh 0 in every sum);
* per-batch standardisation with scalar statistics over the valid rows
  (utils.py:770, :799), on top of the dataset normalisation;
* 'Video*' models see a 24:-24 centre crop (utils.py:768-769);
* image models train on (N, H, W, C) sets (an image store's coreset) or on
  the raw drivers' (N, 1, H, W, C) ones (``models.layers.ImageModel``,
  ROADMAP C.18), and are tested on the 1-frame test split without its
  frame axis (evaluate.py:364-365);
* mode 'multi-static' composes each batch from the frozen S2D state with
  fresh slot draws (utils.py:483-488) through ``hallucinate_frozen`` (the
  fused kernel on CUDA); mode 'none' trains on raw synthetic tensors;
* the test pass runs the test split ``test_repeats`` times with fresh random
  temporal crops, in batches of 64, counting top-1/3/5 and per-class hits.

FRePo's protocol (FRePo/lib_torch/utils.py:561-603, JAX evaluate.py:
112-133, :240-342) is three fields, each of which the JAX package also takes
alone: ``optimizer='adamw'`` (torch AdamW, weight decay 5e-4, a linear
warm-up over ``max(1, int(0.1 epochs))`` epochs times a cosine to 1%, per
epoch), ``loss='mse'`` (soft (N, C) labels; accuracy is the argmax against
the argmax), ``ema_decay`` > 0 (the trained θ is the EMA of the steps,
debiased by ``1 - decay^steps``). ``standardize=False`` skips the training
batches' standardisation; the test pass standardises every batch whatever
it says, as the JAX package's does (ROADMAP C.16).

Everything runs in fp32. The net's parameters are one flat vector θ in the
JAX package's order (``distill/params.py``), as in MTT.

``evaluate_many(..., vmap_eval=True)`` (the JAX package's default,
``_evaluate_many_vmapped``, evaluate.py:520-576) trains the ``num_eval``
nets as one batched computation a step: θ stacked (E, P), per-net
permutations, slot draws, dropout keep-masks and batch statistics, one
shared lr schedule, through ``torch.func.vmap(grad_and_value(...))`` over
``functional_call``. The port's kernels take the nets folded into their
sample axis (the ``vmap`` rules of ``ops/``), so each launches once a
batched step; the multi-static composition is folded by hand, one
``hal_fused`` launch for all nets. Randomness is drawn outside the mapped
region. The test pass is shared: one forward of all nets a test batch.
Where nets x clips would pass ``dm.FOLD_ELEMENTS`` in the widest
activation (ROADMAP C.15), the nets go in groups (``net_groups``).

The randomness can be injected (``draws``, ``keep_masks``; for
``evaluate_many`` one of each per net), so a test hands both packages the
same initial parameters, permutations, slot draws and dropout masks.

Data parallelism (``parallel/dist.py``; JAX evaluate.py:225-238, 420-426):
each training step's batch is padded with -1 to a multiple of the world
size and split; every rank draws the slots and keep-masks of the whole
batch, composes its own columns, standardises them with statistics summed
over the ranks, divides its loss by the whole batch's weight, and sums
each net's gradient over the ranks. The test batches of 64 are split when
the world size divides 64, and the hit counts summed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from ..data.store import VideoData, normalize_u8
from ..models.registry import is_video_model
from ..ops.metrics import per_class_correct, topk_correct
from ..parallel import dist
from ..utils.profiling import span, to_host
from . import dm
from .frepo import bias_correction
from .mtt import draw_keep_mask, flat_param_template, masked_ce, plan_denoms
from .params import layout_for
from .s2d import S2DConfig, eval_slot_draw, hallucinate_frozen

TEST_BATCH = 64  # reference testloader batch size (utils.py:459)


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    model: str = "ConvNet3D"
    epoch_eval_train: int = 500
    lr_net: float = 0.01
    batch_train: int = 256
    eval_mode: str = "SS"
    test_repeats: int = 3
    # synthetic-set parameterization: 'none' (raw tensor) or 'multi-static'
    mode: str = "none"
    # FRePo's protocol: 'adamw', 'mse', standardize=False, ema_decay 0.995
    optimizer: str = "sgd_momentum"   # 'sgd_momentum' | 'adamw'
    loss: str = "ce"                  # 'ce' | 'mse'
    standardize: bool = True
    ema_decay: float = 0.0


@dataclasses.dataclass
class EvalDraws:
    """Injected randomness for one ``evaluate_synset`` run: the initial
    flat parameters θ (JAX order), the per-epoch permutations
    (epochs, n_syn), and for mode 'multi-static' the per-step slot draws
    (each a (static, dynamic, hallucinator) triple of (batch,) arrays)."""

    theta: Any
    perms: Any
    slots: Optional[Sequence] = None


@dataclasses.dataclass
class EvalResult:
    acc_train: float
    acc_test: Any
    acc_per_class: np.ndarray
    top1: float
    top3: float
    top5: float
    params: Any = None  # the trained θ, flat in the JAX order


def _cdiv(a, b):
    return -(-a // b)


def fresh_net(model_name: str, meta, frames: int, generator, device,
              theta=None, im_size=None):
    """(model, θ, layout): a freshly initialised net for ``im_size`` input
    (the dataset's by default), its parameters as one flat fp32 vector in
    the JAX order (taken from ``theta`` if given; an fp64 ``theta``, for a
    reference run on the CPU, stays fp64 and the evaluation runs in fp64),
    and the layout that maps θ onto the model."""
    model, init = flat_param_template(model_name, meta.channel,
                                      meta.num_classes,
                                      tuple(im_size or meta.im_size),
                                      frames, generator, device)
    model.requires_grad_(False)
    if theta is not None:
        theta = np.asarray(theta)
        init = torch.tensor(theta.astype(np.promote_types(theta.dtype,
                                                          np.float32)),
                            device=device).reshape(-1)
    return model, init, layout_for(model)


def _video_crop(x, model_name):
    if model_name.startswith("VideoConvNet"):
        return x[..., 24:-24, 24:-24, :]
    return x


def _eval_im_size(model_name, im_size):
    """The input size the evaluation's nets see (after ``_video_crop``)."""
    h, w = im_size
    return (h - 48, w - 48) if model_name.startswith("VideoConvNet") else (h, w)


def net_groups(nets: int, clips: int, clip_elements: int):
    """Consecutive groups of nets whose folded batch of ``clips`` clips each
    keeps the widest activation (``clip_elements`` a clip) within
    ``dm.FOLD_ELEMENTS``, at least one net a group: the phase trio and the
    movers refuse 2^31 rows or more (ROADMAP C.15). 5 nets x 64 test clips
    of 112x112x16 make 1.03e9 in ConvNet3D's first stage; 6 go in two."""
    per = max(1, dm.FOLD_ELEMENTS // max(1, clips * clip_elements))
    return [slice(i, min(i + per, nets)) for i in range(0, nets, per)]


def _batch_standardize(x, weights, across_ranks: bool = False):
    """(x - mean)/std with scalar statistics over the valid rows only:
    ``weights`` (..., B) weighs the rows of ``x`` (..., B, *item), one pair
    of statistics per leading index (per net of a batched evaluation).
    ``across_ranks``: x holds this rank's rows of a batch split over the
    ranks, and the sums are summed over them."""
    lead = weights.dim() - 1
    dims = tuple(range(lead, x.dim()))
    w = weights.reshape(weights.shape + (1,) * (x.dim() - weights.dim()))
    sums = torch.stack([(x * w).sum(dims), weights.sum(-1)])
    if across_ranks:
        dist.all_reduce_(sums)
    expand = (1,) * (x.dim() - lead)
    n = sums[1] * float(np.prod(x.shape[weights.dim():]))
    mean = (sums[0] / n).reshape(n.shape + expand)
    sq = (((x - mean) ** 2) * w).sum(dims)
    if across_ranks:
        dist.all_reduce_(sq)
    var = (sq / n).reshape(n.shape + expand)
    return (x - mean) / torch.sqrt(var + 1e-12)


def _torch_sgd(theta, grad, mom, lr, momentum, weight_decay, reset: bool):
    """torch.optim.SGD with weight decay folded into the gradient; a reset
    step starts the momentum buffer afresh (a recreated optimizer). In
    place on θ, the gradient and the buffer, the caller's own tensors (3
    nets of VideoConvNetLSTM hold 6.4 GB a copy), in the order of
    ``g + wd p``, ``mu m + d``, ``p - lr m``."""
    d = grad.add_(weight_decay * theta)
    mom = d if reset else mom.mul_(momentum).add_(d)
    return theta.sub_(lr * mom), mom


def _torch_adamw(theta, grad, m, v, lr, t: int, weight_decay,
                 b1=0.9, b2=0.999, eps=1e-8):
    """torch AdamW (decoupled weight decay, bias-corrected) at step t >= 1,
    in the JAX package's operation order."""
    m = b1 * m + (1 - b1) * grad
    v = b2 * v + (1 - b2) * grad * grad
    m_hat = m / bias_correction(b1, t, theta.device)
    v_hat = v / bias_correction(b2, t, theta.device)
    theta = theta * (1 - lr * weight_decay)
    return theta - lr * m_hat / (torch.sqrt(v_hat) + eps), m, v


def _adamw_lrs(lr_net: float, epochs: int, nb: int, device):
    """Per-step learning rates of FRePo's schedule (evaluate.py:240-250),
    fp32 as the JAX package computes them: LinearLR 0.01 -> 1 over
    ``max(1, int(0.1 epochs))`` epochs times a cosine to 1% over ``epochs``,
    stepped per epoch."""
    epoch = (torch.arange(epochs * nb, device=device) // nb).float()
    warm = torch.clamp(0.01 + (1.0 - 0.01) * epoch / max(1, int(epochs * 0.1)),
                       max=1.0)
    cos = 0.01 + 0.5 * (1 - 0.01) * (1 + torch.cos(np.pi * epoch / epochs))
    return torch.tensor(lr_net, dtype=torch.float32, device=device) * warm * cos


def _check_protocol(cfg: EvalConfig):
    if cfg.optimizer not in ("sgd_momentum", "adamw"):
        raise ValueError(f"unknown evaluation optimizer: {cfg.optimizer}")
    if cfg.loss not in ("ce", "mse"):
        raise ValueError(f"unknown evaluation loss: {cfg.loss}")
    if cfg.mode not in ("none", "multi-static"):
        raise ValueError(f"unknown evaluation mode: {cfg.mode}")


def _n_syn(cfg: EvalConfig, syn_images, s2d_cfg: Optional[S2DConfig]) -> int:
    if cfg.mode == "multi-static":
        if s2d_cfg is None:
            raise ValueError("mode 'multi-static' needs s2d_cfg and s2d_state")
        return s2d_cfg.num_classes * (5 if s2d_cfg.spc == 10 else 1)
    return int(syn_images.shape[0])


def _syn_device(cfg: EvalConfig, syn_images, s2d_state) -> torch.device:
    """The device the synthetic set lives on, where evaluation runs."""
    return (s2d_state["dynamic"] if cfg.mode == "multi-static"
            else syn_images).device


class _Trainer:
    """What one evaluation training run needs, shared by the sequential
    (one net) and the batched (E nets) paths: the schedule, the batch
    index plan and the composition of a batch."""

    def __init__(self, cfg: EvalConfig, syn_images, syn_labels, meta,
                 s2d_cfg, s2d_state):
        _check_protocol(cfg)
        self.cfg, self.meta = cfg, meta
        self.s2d_cfg, self.s2d_state = s2d_cfg, s2d_state
        self.device = _syn_device(cfg, syn_images, s2d_state)
        self.n_syn = _n_syn(cfg, syn_images, s2d_cfg)
        self.epochs = cfg.epoch_eval_train + 1
        self.bt = min(cfg.batch_train, self.n_syn)
        self.nb = _cdiv(self.n_syn, self.bt)
        self.steps = self.epochs * self.nb
        self.drop_epoch = cfg.epoch_eval_train // 2 + 1
        self.im_size = _eval_im_size(cfg.model, meta.im_size)
        if cfg.mode == "none":
            self.item_shape = tuple(syn_images.shape[1:])
            self.syn2d = syn_images.reshape(self.n_syn, -1)
            labels = torch.as_tensor(syn_labels, device=self.device)
            self.labels = labels.float() if cfg.loss == "mse" else labels.long()
        if cfg.optimizer == "adamw":
            self.adam_lrs = _adamw_lrs(cfg.lr_net, self.epochs, self.nb,
                                       self.device)

    def fresh(self, generator, theta=None):
        return fresh_net(self.cfg.model, self.meta, self.meta.frames,
                         generator, self.device, theta, self.im_size)

    def batch_plan(self, generator, perms=None):
        """(steps, bt) dataset indices, -1 where an epoch's last batch is
        short, from per-epoch permutations (drawn if not given)."""
        if perms is not None:
            perms = torch.tensor(np.asarray(perms), device=self.device).long()
        else:
            perms = torch.stack([torch.randperm(self.n_syn, generator=generator,
                                                device=self.device)
                                 for _ in range(self.epochs)])
        pad = self.nb * self.bt - self.n_syn
        if pad:
            perms = torch.cat([perms, perms.new_full((self.epochs, pad), -1)],
                              dim=1)
        return perms.reshape(self.steps, self.bt)

    def schedule(self, step):
        """(lr, momentum reset) of SGD at ``step``: LR x0.1 for the epochs
        after drop_epoch, the buffer reset on the first of them."""
        epoch = step // self.nb
        lr = self.cfg.lr_net * 0.1 if epoch > self.drop_epoch else self.cfg.lr_net
        return lr, epoch == self.drop_epoch + 1 and step % self.nb == 0

    def batch(self, idx, generator, slot=None):
        """(x, y, w) of this rank's columns of the dataset indices ``idx``
        (..., bt), -1 where a batch is short: the multi-static videos
        composed from fresh slot draws (made for the whole batch) in one
        ``hallucinate_frozen`` call (one ``hal_fused`` launch for all of
        them), or the raw synthetic rows; w weighs the rows."""
        w = dist.split_columns((idx >= 0).float())
        safe = idx.clamp_min(0)
        if self.cfg.mode == "multi-static":
            c = self.s2d_cfg
            draws = [dist.split_columns(t) for t in eval_slot_draw(
                safe, c.spc, c.dpc, c.n_hal, generator, slot)]
            lead = tuple(draws[0].shape)
            label, s_idx, d_idx, h_idx = (t.reshape(-1) for t in draws)
            static = self.s2d_state["static"][s_idx]
            dynamic = self.s2d_state["dynamic"][label, d_idx]
            hals = self.s2d_state["hals"]
            if c.n_hal == 1:
                x = hallucinate_frozen(hals[0], static, dynamic, c.hal_mode)
            else:
                outs = torch.stack([hallucinate_frozen(p, static, dynamic,
                                                       c.hal_mode)
                                    for p in hals])
                x = outs[h_idx, torch.arange(h_idx.numel(), device=self.device)]
            return (x.reshape(lead + tuple(x.shape[1:])), label.reshape(lead),
                    w)
        safe = dist.split_columns(safe)
        x = self.syn2d[safe.reshape(-1)].reshape(tuple(safe.shape)
                                                 + self.item_shape)
        return x, self.labels[safe], w

    def keep_mask(self, model, generator, nets: Optional[int] = None):
        """This rank's columns of a dropout keep-mask drawn for the whole
        batch: for one net the draw the forward would make, for ``nets``
        the batched evaluation's (``_keep_masks``); None without dropout."""
        if nets is None:
            km = draw_keep_mask(model, generator, self.bt, self.meta.frames,
                                *self.im_size, self.device)
        else:
            km = _keep_masks(model, nets, self.bt, self.meta.frames,
                             self.im_size, generator, self.device)
        return self.split_mask(km, 0 if nets is None else 1)

    @staticmethod
    def split_mask(km, axis: int):
        return None if km is None else dist.split_columns(km, axis, fill=True)

    def prepare(self, x, w, dtype):
        """The nets' input in their dtype: the 'Video*' crop, then (unless
        the protocol skips it) the batch standardisation over the whole
        batch."""
        x = _video_crop(x, self.cfg.model).to(dtype)
        if self.cfg.standardize:
            x = _batch_standardize(x, w.to(dtype), across_ranks=True)
        return x

    def loss(self, model, params, x, y, w, denom, keep_mask=None,
             generator=None):
        """(loss, hits): one net's training loss on its rows of a batch
        (prepared) whose weight sum is ``denom``, and its weighted count of
        correct predictions."""
        cfg = self.cfg
        logits = functional_call(
            model, params, (x,),
            dict(train=True, generator=generator, keep_mask=keep_mask))
        if cfg.loss == "mse":
            # soft labels y (B, C); torch MSELoss's mean over the classes
            per = torch.mean((logits - y) ** 2, dim=-1)
            loss = (per * w).sum() / denom
            hit = logits.argmax(-1) == y.argmax(-1)
        else:
            loss = masked_ce(logits, y, w, denom)
            hit = logits.argmax(-1) == y
        return loss, (hit.float() * w).sum()

    def buffers(self, theta):
        """Zero (momentum or Adam's m, Adam's v, EMA) for θ; None for what
        the protocol does not use."""
        cfg = self.cfg
        return (torch.zeros_like(theta),
                torch.zeros_like(theta) if cfg.optimizer == "adamw" else None,
                torch.zeros_like(theta) if cfg.ema_decay > 0 else None)

    def update(self, step, theta, grad, mom, adam_v, ema):
        """The optimizer's step (and the EMA) on θ of any leading shape."""
        cfg = self.cfg
        if cfg.optimizer == "adamw":
            theta, mom, adam_v = _torch_adamw(theta, grad, mom, adam_v,
                                              self.adam_lrs[step], step + 1,
                                              5e-4)
        else:
            lr, reset = self.schedule(step)
            theta, mom = _torch_sgd(theta, grad, mom, lr, 0.9, 5e-4, reset)
        if cfg.ema_decay > 0:
            ema = cfg.ema_decay * ema + (1 - cfg.ema_decay) * theta
        return theta, mom, adam_v, ema

    def final(self, theta, ema):
        if self.cfg.ema_decay > 0:
            # the debiased average (EMA(debias=True), evaluate.py:336-339)
            return ema / (1.0 - self.cfg.ema_decay ** self.steps)
        return theta


def train_synset(generator, syn_images, syn_labels, meta, cfg: EvalConfig,
                 s2d_cfg: Optional[S2DConfig] = None, s2d_state=None,
                 draws: Optional[EvalDraws] = None, keep_masks=None):
    """Train one fresh net on the synthetic set (``_build_train_fn_cached``,
    evaluate.py:178-345). Returns (θ, model, final-epoch train accuracy).

    ``syn_images`` live in normalised space; for mode 'multi-static' pass
    ``s2d_cfg`` and ``s2d_state`` instead. ``keep_masks[step]``, if given,
    is that step's dropout keep-mask in the JAX layout. It runs on the
    synthetic set's device."""
    tr = _Trainer(cfg, syn_images, syn_labels, meta, s2d_cfg, s2d_state)
    model, theta, layout = tr.fresh(generator,
                                    None if draws is None else draws.theta)
    mom, adam_v, ema = tr.buffers(theta)
    batch_idx = tr.batch_plan(generator, None if draws is None else draws.perms)
    corrects, counts = [], []
    for step in range(tr.steps):
        idx = batch_idx[step]
        with span("eval.batch"):
            x, y, w = tr.batch(idx, generator,
                               None if draws is None or draws.slots is None
                               else draws.slots[step])
            km = (tr.keep_mask(model, generator) if keep_masks is None else
                  tr.split_mask(torch.as_tensor(keep_masks[step],
                                                device=tr.device), 0))
            x = tr.prepare(x, w, theta.dtype)
        theta.requires_grad_(True)
        denom = plan_denoms(idx)
        loss, hits = tr.loss(model, layout.unflatten(theta), x, y, w, denom,
                             km, generator)
        (grad,) = torch.autograd.grad(loss, theta)
        dist.all_reduce_(grad)
        with torch.no_grad():
            with span("eval.update"):
                theta, mom, adam_v, ema = tr.update(step, theta.detach(),
                                                    grad, mom, adam_v, ema)
            if step >= tr.steps - tr.nb:
                corrects.append(hits.detach())
                counts.append((idx >= 0).sum())
    theta = tr.final(theta, ema)
    correct = dist.all_reduce_(torch.stack(corrects).sum())
    acc_train = to_host(correct / torch.stack(counts).sum())
    return theta, model, acc_train


def _keep_masks(model, nets: int, bt: int, frames: int, im_size, generator,
                device):
    """(nets, bt, T', H', W', C) dropout keep-masks in the JAX layout, drawn
    outside the mapped region (a draw from a generator has no vmap rule);
    None for a model without dropout."""
    rate = getattr(model, "dropout_rate", 0.0)
    if rate <= 0:
        return None
    shape = (nets, bt) + model.keep_mask_shape(frames, *im_size)
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def train_synsets(generator, num_nets: int, syn_images, syn_labels, meta,
                  cfg: EvalConfig, s2d_cfg: Optional[S2DConfig] = None,
                  s2d_state=None, draws: Optional[Sequence[EvalDraws]] = None,
                  keep_masks=None):
    """Train ``num_nets`` fresh nets on the synthetic set as one batched
    computation a step (the JAX package's ``jax.vmap(train_fn)``,
    evaluate.py:520-545). Returns (θ (E, P), model, per-net final-epoch
    train accuracies).

    Each net has its own initial θ, permutations, slot draws, dropout
    keep-masks and batch statistics; the lr schedule, momentum reset,
    AdamW schedule and EMA are shared. ``draws`` and ``keep_masks``, if
    given, hold one ``EvalDraws`` and one per-step mask sequence per net.
    The step is ``vmap(grad_and_value(loss))`` over the stacked θ, with the
    randomness drawn outside it; the nets go in ``net_groups``. The
    gradient is taken with respect to the unflattened parameters (views of
    θ) and flattened once: a gradient with respect to θ itself would
    assemble a zero-filled (E, P) tensor for every parameter tensor."""
    tr = _Trainer(cfg, syn_images, syn_labels, meta, s2d_cfg, s2d_state)
    nets = [tr.fresh(generator, None if draws is None else draws[e].theta)
            for e in range(num_nets)]
    model, layout = nets[0][0], nets[0][2]
    theta = torch.stack([t for _, t, _ in nets])
    mom, adam_v, ema = tr.buffers(theta)
    batch_idx = torch.stack([tr.batch_plan(generator, None if draws is None
                                           else draws[e].perms)
                             for e in range(num_nets)], dim=1)  # (S, E, bt)
    groups = net_groups(num_nets, tr.bt,
                        model.clip_elements(tr.meta.frames, *tr.im_size))

    def net_loss(params, x, y, w, denom, km):
        return tr.loss(model, params, x, y, w, denom, km)

    unflatten = torch.func.vmap(layout.unflatten)
    flatten = torch.func.vmap(layout.flatten)
    corrects = torch.zeros(num_nets, device=tr.device)
    counts = torch.zeros(num_nets, device=tr.device)
    for step in range(tr.steps):
        idx = batch_idx[step]
        slot = None if draws is None or draws[0].slots is None else [
            np.stack([np.asarray(d.slots[step][k]) for d in draws])
            for k in range(3)]
        with span("eval.batch"):
            x, y, w = tr.batch(idx, generator, slot)
            if keep_masks is not None:
                km = tr.split_mask(torch.stack([
                    torch.as_tensor(m[step], device=tr.device)
                    for m in keep_masks]), 1)
            else:
                km = tr.keep_mask(model, generator, num_nets)
            x = tr.prepare(x, w, theta.dtype)
        denom = plan_denoms(idx)
        hits = []
        for g in groups:
            # the update is elementwise, so each group's nets take theirs
            # at once: one group's gradient is alive at a time (3
            # VideoConvNetLSTMs hold 6.4 GB a copy of θ)
            per_param, (_, hit) = torch.func.vmap(
                torch.func.grad_and_value(net_loss, has_aux=True),
                in_dims=(0, 0, 0, 0, 0, None if km is None else 0))(
                unflatten(theta[g]), x[g], y[g], w[g], denom[g],
                None if km is None else km[g])
            grad = flatten(per_param)
            del per_param
            dist.all_reduce_(grad)
            with torch.no_grad(), span("eval.update"):
                bufs = (theta, mom, adam_v, ema)
                new = tr.update(step, theta[g], grad,
                                *(None if b is None else b[g] for b in bufs[1:]))
                for b, v in zip(bufs, new):
                    if b is not None:
                        b[g] = v
            del grad, new
            hits.append(hit)
        if step >= tr.steps - tr.nb:
            corrects += torch.cat(hits)
            counts += (idx >= 0).sum(1)
    theta = tr.final(theta, ema)
    dist.all_reduce_(corrects)
    return theta, model, to_host(corrects / counts)


def _stack_test_batches(clips: np.ndarray, labels: np.ndarray,
                        batch: int = TEST_BATCH):
    """(clips (nb, batch, ...), labels (nb, batch), weights (nb, batch)),
    the last batch zero-padded with weight 0."""
    n = clips.shape[0]
    nb = _cdiv(n, batch)
    pad = nb * batch - n
    if pad:
        clips = np.concatenate([clips, np.zeros((pad,) + clips.shape[1:],
                                                clips.dtype)])
        labels = np.concatenate([labels, np.zeros(pad, labels.dtype)])
    weights = np.ones(nb * batch, np.float32)
    if pad:
        weights[-pad:] = 0.0
    return (clips.reshape((nb, batch) + clips.shape[1:]),
            labels.reshape(nb, batch).astype(np.int32),
            weights.reshape(nb, batch))


def _split_tests() -> bool:
    """Whether the test batches are split over the ranks: when the world
    size divides ``TEST_BATCH`` (JAX evaluate.py:424)."""
    n = dist.world_size()
    return n > 1 and TEST_BATCH % n == 0


def sample_test_batches(data: VideoData, cfg: EvalConfig,
                        test_rng: np.random.Generator, device) -> List:
    """Draw ``test_repeats`` sets of random temporal crops as uint8 batch
    tensors on ``device``, shared by every net of one evaluation point
    (evaluate.py:413-435); this rank's rows of each batch when they are
    split over the ranks."""
    batches = []
    for _ in range(cfg.test_repeats):
        clips = data.test.sample_clips(test_rng, flip=data.meta.frames > 1)
        cb, lb, wb = _stack_test_batches(clips, data.test.labels)
        if _split_tests():
            cb, lb, wb = (dist.split_columns(a, 1) for a in (cb, lb, wb))
        batches.append((torch.from_numpy(cb).to(device),
                        torch.from_numpy(lb).to(device).long(),
                        torch.from_numpy(wb).to(device)))
    return batches


@torch.no_grad()
def run_test_pass(model, theta, meta, cfg: EvalConfig, test_batches):
    """The test pass (``_build_test_fn``, evaluate.py:351-382): uint8 ->
    normalise -> standardise -> logits; an image model's (B, 1, H, W, C)
    test batch (an image store's 1-frame test split) loses its frame
    axis. Returns (top1, top3, top5, per-class accuracy with NaN for
    classes without test clips); for a
    stack of nets θ (E, P) a list of those, one per net, each test batch one
    batched forward of all nets (``vtest``, evaluate.py:553-561), in
    ``net_groups``."""
    layout = layout_for(model)
    split = _split_tests()
    image_net = not is_video_model(cfg.model)
    batched = theta.dim() == 2
    thetas = theta if batched else theta[None]
    nets, dev = thetas.shape[0], theta.device
    h, w = _eval_im_size(cfg.model, meta.im_size)
    groups = net_groups(nets, TEST_BATCH, model.clip_elements(meta.frames, h, w))

    def logits_of(th, x):
        return functional_call(model, layout.unflatten(th), (x,),
                               dict(train=False))

    tot = torch.zeros(nets, 4, device=dev)
    pc_corr = torch.zeros(nets, meta.num_classes, device=dev)
    pc_cnt = torch.zeros(nets, meta.num_classes, device=dev)
    for clips, labels, weights in test_batches:
        for x_u8, y, wt in zip(clips, labels, weights):
            x = normalize_u8(x_u8, meta.mean, meta.std).to(thetas.dtype)
            if image_net and x.dim() == 5:
                x = x[:, 0]  # image models: drop the singleton frame axis
            x = _video_crop(x, cfg.model)
            x = _batch_standardize(x, wt, across_ranks=split)
            if batched:
                logits = torch.cat([torch.func.vmap(logits_of, in_dims=(0, None))(
                    thetas[g], x) for g in groups])
            else:
                logits = logits_of(theta, x)[None]
            for e in range(nets):
                hits = topk_correct(logits[e], y, (1, 3, 5), wt)
                tot[e] += torch.stack([hits[1], hits[3], hits[5], wt.sum()])
                c, n = per_class_correct(logits[e], y, meta.num_classes, wt)
                pc_corr[e] += c
                pc_cnt[e] += n
    if split:
        dist.all_reduce_tensors_([tot, pc_corr, pc_cnt])
    tot, pc_corr, pc_cnt = (t.double().cpu().numpy()
                            for t in (tot, pc_corr, pc_cnt))
    out = [(float(tot[e, 0] / tot[e, 3]), float(tot[e, 1] / tot[e, 3]),
            float(tot[e, 2] / tot[e, 3]),
            np.where(pc_cnt[e] > 0, pc_corr[e] / np.maximum(pc_cnt[e], 1),
                     np.nan))
           for e in range(nets)]
    return out if batched else out[0]


def _result(cfg: EvalConfig, acc_train, tested, theta) -> EvalResult:
    top1, top3, top5, acc_per_class = tested
    acc_test = [top1, top1, top3, top5] if cfg.eval_mode == "top5" else top1
    return EvalResult(acc_train=acc_train, acc_test=acc_test,
                      acc_per_class=acc_per_class, top1=top1, top3=top3,
                      top5=top5, params=theta)


def evaluate_synset(generator, syn_images, syn_labels, data: VideoData,
                    cfg: EvalConfig, test_rng: np.random.Generator,
                    s2d_cfg: Optional[S2DConfig] = None, s2d_state=None,
                    test_batches=None, draws: Optional[EvalDraws] = None,
                    keep_masks=None) -> EvalResult:
    """Train one fresh net on the synthetic set and test it."""
    meta = data.meta
    theta, model, acc_train = train_synset(
        generator, syn_images, syn_labels, meta, cfg, s2d_cfg, s2d_state,
        draws, keep_masks)
    if test_batches is None:
        test_batches = sample_test_batches(data, cfg, test_rng, theta.device)
    return _result(cfg, acc_train,
                   run_test_pass(model, theta, meta, cfg, test_batches), theta)


def evaluate_many(generator, num_eval: int, syn_images, syn_labels,
                  data: VideoData, cfg: EvalConfig,
                  test_rng: np.random.Generator,
                  s2d_cfg: Optional[S2DConfig] = None, s2d_state=None,
                  vmap_eval: bool = False,
                  draws: Optional[Sequence[EvalDraws]] = None,
                  keep_masks=None):
    """The reference's num_eval loop (distill_baseline.py:154-162): fresh
    nets tested on one shared draw of test crops, one after the other, or
    with ``vmap_eval`` all trained as one batched computation and tested
    together (``_evaluate_many_vmapped``). ``draws`` and ``keep_masks``, if
    given, hold one per net. Returns (results, mean accuracy, std)."""
    test_batches = sample_test_batches(
        data, cfg, test_rng, _syn_device(cfg, syn_images, s2d_state))
    if vmap_eval:
        thetas, model, acc_train = train_synsets(
            generator, num_eval, syn_images, syn_labels, data.meta, cfg,
            s2d_cfg, s2d_state, draws, keep_masks)
        tested = run_test_pass(model, thetas, data.meta, cfg, test_batches)
        results = [_result(cfg, a, t, th)
                   for a, t, th in zip(acc_train, tested, thetas)]
    else:
        results = [evaluate_synset(
            generator, syn_images, syn_labels, data, cfg, test_rng, s2d_cfg,
            s2d_state, test_batches=test_batches,
            draws=None if draws is None else draws[i],
            keep_masks=None if keep_masks is None else keep_masks[i])
            for i in range(num_eval)]
    accs = np.array([r.top5 if cfg.eval_mode == "top5" else r.top1
                     for r in results])
    return results, float(accs.mean()), float(accs.std())
