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
JAX package's order (``distill/params.py``), as in MTT. Training the
``num_eval`` nets as one batched model (``vmap_eval``) is ROADMAP A.7b and
raises.

The randomness can be injected (``draws``, ``keep_masks``), so a test
hands both packages the same initial parameters, permutations, slot draws
and dropout masks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from ..data.store import VideoData, normalize_u8
from ..ops.metrics import per_class_correct, topk_correct
from .frepo import bias_correction
from .mtt import flat_param_template, masked_ce
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
              theta=None):
    """(model, θ, layout): a freshly initialised net, its parameters as one
    flat fp32 vector in the JAX order (taken from ``theta`` if given), and
    the layout that maps θ onto the model."""
    model, init = flat_param_template(model_name, meta.channel,
                                      meta.num_classes, tuple(meta.im_size),
                                      frames, generator, device)
    model.requires_grad_(False)
    if theta is not None:
        init = torch.tensor(np.asarray(theta, np.float32),
                            device=device).reshape(-1)
    return model, init, layout_for(model)


def _video_crop(x, model_name):
    if model_name.startswith("VideoConvNet"):
        return x[:, :, 24:-24, 24:-24, :]
    return x


def _batch_standardize(x, weights):
    """(x - mean)/std with scalar statistics over the valid rows only."""
    w = weights.reshape((-1,) + (1,) * (x.dim() - 1))
    n = weights.sum() * float(np.prod(x.shape[1:]))
    mean = (x * w).sum() / n
    var = (((x - mean) ** 2) * w).sum() / n
    return (x - mean) / torch.sqrt(var + 1e-12)


def _torch_sgd(theta, grad, mom, lr, momentum, weight_decay, reset: bool):
    """torch.optim.SGD with weight decay folded into the gradient; a reset
    step starts the momentum buffer afresh (a recreated optimizer)."""
    d = grad + weight_decay * theta
    mom = d if reset else momentum * mom + d
    return theta - lr * mom, mom


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


def train_synset(generator, syn_images, syn_labels, meta, cfg: EvalConfig,
                 s2d_cfg: Optional[S2DConfig] = None, s2d_state=None,
                 draws: Optional[EvalDraws] = None, keep_masks=None):
    """Train one fresh net on the synthetic set (``_build_train_fn_cached``,
    evaluate.py:178-345). Returns (θ, model, final-epoch train accuracy).

    ``syn_images`` live in normalised space; for mode 'multi-static' pass
    ``s2d_cfg`` and ``s2d_state`` instead. ``keep_masks[step]``, if given,
    is that step's dropout keep-mask in the JAX layout. It runs on the
    synthetic set's device."""
    _check_protocol(cfg)
    device = _syn_device(cfg, syn_images, s2d_state)
    n_syn = _n_syn(cfg, syn_images, s2d_cfg)
    model, theta, layout = fresh_net(cfg.model, meta, meta.frames, generator,
                                     device, None if draws is None else draws.theta)
    mom = torch.zeros_like(theta)
    adam_v = torch.zeros_like(theta)
    ema = torch.zeros_like(theta)

    epochs = cfg.epoch_eval_train + 1
    bt = min(cfg.batch_train, n_syn)
    nb = _cdiv(n_syn, bt)
    drop_epoch = cfg.epoch_eval_train // 2 + 1
    if draws is not None:
        perms = torch.tensor(np.asarray(draws.perms), device=device).long()
    else:
        perms = torch.stack([torch.randperm(n_syn, generator=generator,
                                            device=device)
                             for _ in range(epochs)])
    pad = nb * bt - n_syn
    if pad:
        perms = torch.cat([perms, perms.new_full((epochs, pad), -1)], dim=1)
    batch_idx = perms.reshape(epochs * nb, bt)

    if cfg.mode == "none":
        item_shape = tuple(syn_images.shape[1:])
        syn2d = syn_images.reshape(n_syn, -1)
        labels = torch.as_tensor(syn_labels, device=device)
        labels = labels.float() if cfg.loss == "mse" else labels.long()
    steps = epochs * nb
    if cfg.optimizer == "adamw":
        adam_lrs = _adamw_lrs(cfg.lr_net, epochs, nb, device)
    corrects, counts = [], []
    for step in range(steps):
        epoch = step // nb
        lr = cfg.lr_net * 0.1 if epoch > drop_epoch else cfg.lr_net
        reset = epoch == drop_epoch + 1 and step % nb == 0
        idx = batch_idx[step]
        w = (idx >= 0).float()
        safe = idx.clamp_min(0)
        if cfg.mode == "multi-static":
            slot = None if draws is None else draws.slots[step]
            label, s_idx, d_idx, h_idx = eval_slot_draw(
                safe, s2d_cfg.spc, s2d_cfg.dpc, s2d_cfg.n_hal, generator, slot)
            static = s2d_state["static"][s_idx]
            dynamic = s2d_state["dynamic"][label, d_idx]
            hals = s2d_state["hals"]
            if s2d_cfg.n_hal == 1:
                x = hallucinate_frozen(hals[0], static, dynamic, s2d_cfg.hal_mode)
            else:
                outs = torch.stack([hallucinate_frozen(p, static, dynamic,
                                                       s2d_cfg.hal_mode)
                                    for p in hals])
                x = outs[h_idx, torch.arange(bt, device=device)]
            y = label
        else:
            x = syn2d[safe].reshape((bt,) + item_shape)
            y = labels[safe]
        x = _video_crop(x, cfg.model)
        if cfg.standardize:
            x = _batch_standardize(x, w)
        theta.requires_grad_(True)
        logits = functional_call(
            model, layout.unflatten(theta), (x,),
            dict(train=True, generator=generator,
                 keep_mask=None if keep_masks is None else keep_masks[step]))
        if cfg.loss == "mse":
            # soft labels y (B, C); torch MSELoss's mean over the classes
            per = torch.mean((logits - y) ** 2, dim=-1)
            loss = (per * w).sum() / w.sum().clamp_min(1.0)
            hit = logits.argmax(-1) == y.argmax(-1)
        else:
            loss = masked_ce(logits, y, w)
            hit = logits.argmax(-1) == y
        (grad,) = torch.autograd.grad(loss, theta)
        with torch.no_grad():
            if cfg.optimizer == "adamw":
                theta, mom, adam_v = _torch_adamw(theta.detach(), grad, mom,
                                                  adam_v, adam_lrs[step],
                                                  step + 1, 5e-4)
            else:
                theta, mom = _torch_sgd(theta.detach(), grad, mom, lr, 0.9,
                                        5e-4, reset)
            if cfg.ema_decay > 0:
                ema = cfg.ema_decay * ema + (1 - cfg.ema_decay) * theta
            if epoch == epochs - 1:
                corrects.append((hit.float() * w).sum())
                counts.append(w.sum())
    if cfg.ema_decay > 0:
        # the debiased average (EMA(debias=True), evaluate.py:336-339)
        theta = ema / (1.0 - cfg.ema_decay ** steps)
    acc_train = float(torch.stack(corrects).sum() / torch.stack(counts).sum())
    return theta, model, acc_train


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


def sample_test_batches(data: VideoData, cfg: EvalConfig,
                        test_rng: np.random.Generator, device) -> List:
    """Draw ``test_repeats`` sets of random temporal crops as uint8 batch
    tensors on ``device``, shared by every net of one evaluation point
    (evaluate.py:413-435)."""
    batches = []
    for _ in range(cfg.test_repeats):
        clips = data.test.sample_clips(test_rng, flip=data.meta.frames > 1)
        cb, lb, wb = _stack_test_batches(clips, data.test.labels)
        batches.append((torch.from_numpy(cb).to(device),
                        torch.from_numpy(lb).to(device).long(),
                        torch.from_numpy(wb).to(device)))
    return batches


@torch.no_grad()
def run_test_pass(model, theta, meta, cfg: EvalConfig, test_batches):
    """The test pass (``_build_test_fn``, evaluate.py:351-382): uint8 ->
    normalise -> standardise -> logits. Returns (top1, top3, top5,
    per-class accuracy with NaN for classes without test clips)."""
    params = layout_for(model).unflatten(theta)
    dev = theta.device
    tot = torch.zeros(4, device=dev)
    pc_corr = torch.zeros(meta.num_classes, device=dev)
    pc_cnt = torch.zeros(meta.num_classes, device=dev)
    for clips, labels, weights in test_batches:
        for x_u8, y, w in zip(clips, labels, weights):
            x = _video_crop(normalize_u8(x_u8, meta.mean, meta.std), cfg.model)
            x = _batch_standardize(x, w)
            logits = functional_call(model, params, (x,), dict(train=False))
            hits = topk_correct(logits, y, (1, 3, 5), w)
            tot += torch.stack([hits[1], hits[3], hits[5], w.sum()])
            c, n = per_class_correct(logits, y, meta.num_classes, w)
            pc_corr += c
            pc_cnt += n
    tot, pc_corr, pc_cnt = (t.double().cpu().numpy()
                            for t in (tot, pc_corr, pc_cnt))
    acc_per_class = np.where(pc_cnt > 0, pc_corr / np.maximum(pc_cnt, 1),
                             np.nan)
    return (float(tot[0] / tot[3]), float(tot[1] / tot[3]),
            float(tot[2] / tot[3]), acc_per_class)


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
    top1, top3, top5, acc_per_class = run_test_pass(model, theta, meta, cfg,
                                                  test_batches)
    acc_test = [top1, top1, top3, top5] if cfg.eval_mode == "top5" else top1
    return EvalResult(acc_train=acc_train, acc_test=acc_test,
                      acc_per_class=acc_per_class, top1=top1, top3=top3,
                      top5=top5, params=theta)


def evaluate_many(generator, num_eval: int, syn_images, syn_labels,
                  data: VideoData, cfg: EvalConfig,
                  test_rng: np.random.Generator,
                  s2d_cfg: Optional[S2DConfig] = None, s2d_state=None,
                  vmap_eval: bool = False):
    """The reference's num_eval loop (distill_baseline.py:154-162): fresh
    nets, one after the other, tested on one shared draw of test crops.
    Returns (results, mean accuracy, std)."""
    if vmap_eval:
        raise NotImplementedError(
            "vmap_eval: training the num_eval nets as one batched model is "
            "not ported yet (ROADMAP A.7b); pass vmap_eval=False "
            "(--vmap_eval false)")
    test_batches = sample_test_batches(
        data, cfg, test_rng, _syn_device(cfg, syn_images, s2d_state))
    results = [evaluate_synset(generator, syn_images, syn_labels, data, cfg,
                               test_rng, s2d_cfg, s2d_state,
                               test_batches=test_batches)
               for _ in range(num_eval)]
    accs = np.array([r.top5 if cfg.eval_mode == "top5" else r.top1
                     for r in results])
    return results, float(accs.mean()), float(accs.std())
