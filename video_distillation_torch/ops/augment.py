"""DSA differentiable augmentation and the DC (host) augment.

Port of ``video_distillation_tpu/ops/augment.py`` (the reference's
``ParamDiffAug``, ``DiffAugment``, ``AUGMENT_FNS`` and the DC ``augment``,
``get_daparam``):

* strategy strings such as 'color_crop_cutout' with aug_mode 'S' (one
  strategy, chosen on the host, per call) or 'M' (all, in order);
* "siamese": every sample takes row 0's parameters;
* scale and rotate resample through ``F.affine_grid`` + ``F.grid_sample``
  (bilinear, zero padding, align_corners=False), which the JAX package
  reproduces by hand.

Every random op is a ``RandOp``: ``draw(generator, x, param)`` makes its
random values on x's device from an explicit ``torch.Generator``, and
``apply(x, draws, param, siamese)`` is a pure function of x and the draws,
differentiable in x. The draws are what the JAX op's ``jax.random`` calls
return (uniforms in [0, 1), integers), so a test can hand the port JAX's.
``Aug`` binds a whole transform: ``aug(generator, x, draws=None)``.

Layout: ``(B, H, W, C)`` images, as the JAX functions and the stores.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass
class ParamDiffAug:
    aug_mode: str = "S"
    prob_flip: float = 0.5
    ratio_scale: float = 1.2
    ratio_rotate: float = 15.0
    ratio_crop_pad: float = 0.125
    ratio_cutout: float = 0.5
    brightness: float = 1.0
    saturation: float = 2.0
    contrast: float = 0.5


class RandOp(NamedTuple):
    """A DSA op: ``draw(generator, x, param)`` -> draws;
    ``apply(x, draws, param, siamese)`` -> augmented x."""
    draw: Callable
    apply: Callable


class Aug:
    """A bound random transform: ``draw(generator, x)`` -> draws,
    ``apply(x, draws)`` -> augmented x; calling it does both, or applies
    the draws it is handed (moved to x's device)."""

    def __init__(self, draw: Callable, apply: Callable):
        self.draw, self.apply = draw, apply

    def __call__(self, generator, x, draws=None):
        if draws is None:
            draws = self.draw(generator, x)
        return self.apply(x, on_device(x, draws))


def on_device(x, draws):
    """Draws as tensors on x's device; Python numbers, None and the
    nesting of tuples and lists stay."""
    if draws is None or isinstance(draws, (bool, int, float)):
        return draws
    if isinstance(draws, (tuple, list)):
        return type(draws)(on_device(x, d) for d in draws)
    return torch.as_tensor(draws, device=x.device)


def uniform(generator, x, *shape):
    """U[0, 1) of shape (B, *shape) on x's device."""
    return torch.rand((x.shape[0],) + shape, generator=generator,
                      device=x.device)


def _maybe_siamese(v, siamese):
    return v[:1].expand_as(v) if siamese else v


def affine_grid_sample(x, theta):
    """torch's affine grid + bilinear zero-padded grid sample
    (align_corners=False) for NHWC x and theta (B, 2, 3)."""
    xc = x.permute(0, 3, 1, 2)
    grid = F.affine_grid(theta.to(x.dtype), list(xc.shape),
                         align_corners=False)
    out = F.grid_sample(xc, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out.permute(0, 2, 3, 1)


def _per_sample(generator, x, p):
    return uniform(generator, x, 1, 1, 1)


def _two_uniforms(generator, x, p):
    return uniform(generator, x), uniform(generator, x)


def _scale(x, d, p: ParamDiffAug, siamese):
    ratio = p.ratio_scale
    sx, sy = (_maybe_siamese(u * (ratio - 1.0 / ratio) + 1.0 / ratio,
                             siamese) for u in d)
    zeros = torch.zeros_like(sx)
    theta = torch.stack([torch.stack([sx, zeros, zeros], -1),
                         torch.stack([zeros, sy, zeros], -1)], 1)
    return affine_grid_sample(x, theta)


def _rotate(x, u, p: ParamDiffAug, siamese):
    a = _maybe_siamese((u - 0.5) * 2 * p.ratio_rotate / 180 * np.pi, siamese)
    cos, sin = torch.cos(a), torch.sin(a)
    zeros = torch.zeros_like(cos)
    theta = torch.stack([torch.stack([cos, -sin, zeros], -1),
                         torch.stack([sin, cos, zeros], -1)], 1)
    return affine_grid_sample(x, theta)


def _flip(x, u, p: ParamDiffAug, siamese):
    return torch.where(_maybe_siamese(u, siamese) < p.prob_flip, x.flip(2), x)


def _brightness(x, u, p: ParamDiffAug, siamese):
    return x + (_maybe_siamese(u, siamese) - 0.5) * p.brightness


def _saturation(x, u, p: ParamDiffAug, siamese):
    mean = x.mean(dim=-1, keepdim=True)
    return (x - mean) * (_maybe_siamese(u, siamese) * p.saturation) + mean


def _contrast(x, u, p: ParamDiffAug, siamese):
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean) * (_maybe_siamese(u, siamese) + p.contrast) + mean


def _crop_shifts(x, p: ParamDiffAug):
    _, h, w, _ = x.shape
    return int(h * p.ratio_crop_pad + 0.5), int(w * p.ratio_crop_pad + 0.5)


def _draw_crop(generator, x, p: ParamDiffAug):
    """(ty, tx): integer shifts in [-shift, shift], each (B, 1, 1)."""
    b = x.shape[0]
    return tuple(torch.randint(-s, s + 1, (b, 1, 1), generator=generator,
                               device=x.device) for s in _crop_shifts(x, p))


def _crop(x, d, p: ParamDiffAug, siamese):
    """Shift-crop with a 1 px zero pad (utils.py:1122-1142)."""
    b, h, w, _ = x.shape
    ty, tx = (_maybe_siamese(t.long(), siamese) for t in d)
    dev = x.device
    gy = (torch.arange(h, device=dev)[None, :, None] + ty + 1).clamp(0, h + 1)
    gx = (torch.arange(w, device=dev)[None, None, :] + tx + 1).clamp(0, w + 1)
    x_pad = F.pad(x, (0, 0, 1, 1, 1, 1))
    return x_pad[torch.arange(b, device=dev)[:, None, None], gy, gx]


def _cutout_size(x, p: ParamDiffAug):
    _, h, w, _ = x.shape
    return int(h * p.ratio_cutout + 0.5), int(w * p.ratio_cutout + 0.5)


def _draw_cutout(generator, x, p: ParamDiffAug):
    """(oy, ox): the holes' centres, each (B, 1, 1)."""
    b, h, w, _ = x.shape
    ch, cw = _cutout_size(x, p)
    return tuple(torch.randint(0, n + (1 - c % 2), (b, 1, 1),
                               generator=generator, device=x.device)
                 for n, c in ((h, ch), (w, cw)))


def _cutout(x, d, p: ParamDiffAug, siamese):
    _, h, w, _ = x.shape
    ch, cw = _cutout_size(x, p)
    oy, ox = (_maybe_siamese(t.long(), siamese) for t in d)
    gy = torch.arange(h, device=x.device)[None, :, None]
    gx = torch.arange(w, device=x.device)[None, None, :]
    in_y = (gy >= oy - ch // 2) & (gy < oy - ch // 2 + ch)
    in_x = (gx >= ox - cw // 2) & (gx < ox - cw // 2 + cw)
    mask = 1.0 - (in_y & in_x).to(x.dtype)
    return x * mask[..., None]


rand_scale = RandOp(_two_uniforms, _scale)
rand_rotate = RandOp(lambda g, x, p: uniform(g, x), _rotate)
rand_flip = RandOp(_per_sample, _flip)
rand_brightness = RandOp(_per_sample, _brightness)
rand_saturation = RandOp(_per_sample, _saturation)
rand_contrast = RandOp(_per_sample, _contrast)
rand_crop = RandOp(_draw_crop, _crop)
rand_cutout = RandOp(_draw_cutout, _cutout)

AUGMENT_FNS = {
    "color": [rand_brightness, rand_saturation, rand_contrast],
    "crop": [rand_crop],
    "cutout": [rand_cutout],
    "flip": [rand_flip],
    "scale": [rand_scale],
    "rotate": [rand_rotate],
}


def host_choice(generator, x, n: int) -> int:
    """One of n, drawn on x's device and read on the host."""
    return int(torch.randint(0, n, (), generator=generator, device=x.device))


def make_diff_augment(strategy: str, param: ParamDiffAug | None = None,
                      siamese: bool = False) -> Aug:
    """DiffAugment (utils.py:1020-1045) as an ``Aug``. Its draws are
    ``(choice, ops)``: in mode 'M' choice is None and ops holds every op's
    draws in the order they apply; in mode 'S' choice is the strategy's
    index and ops the draws of that strategy's ops."""
    param = param or ParamDiffAug()
    if strategy in ("None", "none", ""):
        return Aug(lambda generator, x: None, lambda x, draws: x)
    if param.aug_mode not in ("M", "S"):
        raise ValueError(f"unknown augmentation mode: {param.aug_mode}")
    names = strategy.split("_")

    def ops(choice):
        picked = names if choice is None else [names[choice]]
        return [op for name in picked for op in AUGMENT_FNS[name]]

    def draw(generator, x):
        choice = (None if param.aug_mode == "M"
                  else host_choice(generator, x, len(names)))
        return choice, [op.draw(generator, x, param) for op in ops(choice)]

    def apply(x, draws):
        choice, op_draws = draws
        for op, d in zip(ops(choice), op_draws, strict=True):
            x = op.apply(x, d, param, siamese)
        return x

    return Aug(draw, apply)


def diff_augment(x, strategy: str, generator=None,
                 param: ParamDiffAug | None = None, siamese: bool = False,
                 draws=None):
    """DiffAugment over NHWC images; ``siamese=True`` shares one draw
    across the batch."""
    return make_diff_augment(strategy, param, siamese)(generator, x, draws)


# ---------------------------------------------------------------------------
# DC (non-differentiable) augmentation — utils.py:890-970, numpy on the host
# ---------------------------------------------------------------------------

def get_daparam(dataset: str, model: str, model_eval: str, ipc: int) -> dict:
    """utils.py:953-970."""
    p = {"crop": 4, "scale": 0.2, "rotate": 45, "noise": 0.001,
         "strategy": "none"}
    if dataset == "MNIST":
        p["strategy"] = "crop_scale_rotate"
    if model_eval in ("ConvNetBN",):
        p["strategy"] = "crop_noise"
    return p


def dc_augment(images: np.ndarray, dc_aug_param: dict,
               rng: np.random.Generator) -> np.ndarray:
    """Host-side DC augmentation: one random op (crop/scale/rotate/noise)
    per image (utils.py:890-949). NHWC numpy."""
    if dc_aug_param is None or dc_aug_param["strategy"] == "none":
        return images
    from scipy.ndimage import rotate as scipyrotate

    images = images.copy()
    n, h, w, c = images.shape
    crop, scale = dc_aug_param["crop"], dc_aug_param["scale"]
    rot, noise = dc_aug_param["rotate"], dc_aug_param["noise"]
    mean = images.mean(axis=(0, 1, 2))
    augs = dc_aug_param["strategy"].split("_")

    for i in range(n):
        choice = augs[rng.integers(0, len(augs))]
        if choice == "crop":
            im_ = np.zeros((h + crop * 2, w + crop * 2, c), images.dtype)
            im_[:, :] = mean
            im_[crop:crop + h, crop:crop + w] = images[i]
            r = int(rng.integers(0, crop * 2))
            s = int(rng.integers(0, crop * 2))
            images[i] = im_[r:r + h, s:s + w]
        elif choice == "scale":
            sh = int(rng.uniform(1 - scale, 1 + scale) * h)
            sw = int(rng.uniform(1 - scale, 1 + scale) * h)
            yi = np.clip((np.arange(sh) * (h / sh)).astype(int), 0, h - 1)
            xi = np.clip((np.arange(sw) * (w / sw)).astype(int), 0, w - 1)
            tmp = images[i][yi][:, xi]
            mhw = max(sh, sw, h, w)
            im_ = np.zeros((mhw, mhw, c), images.dtype)
            r, s = (mhw - sh) // 2, (mhw - sw) // 2
            im_[r:r + sh, s:s + sw] = tmp
            r, s = (mhw - h) // 2, (mhw - w) // 2
            images[i] = im_[r:r + h, s:s + w]
        elif choice == "rotate":
            im_ = scipyrotate(images[i], angle=float(rng.integers(-rot, rot)),
                              axes=(0, 1), cval=float(np.mean(mean)))
            r = (im_.shape[0] - h) // 2
            s = (im_.shape[1] - w) // 2
            images[i] = im_[r:r + h, s:s + w]
        elif choice == "noise":
            images[i] = images[i] + noise * rng.standard_normal((h, w, c))
    return images
