"""Extra augmentation ops and the chain builder (the augmax-equivalent
layer).

Port of ``video_distillation_tpu/ops/augment_extra.py``: image-level ops
(GridShuffle, Gaussian blur) and ``get_aug_by_name(strategy, res)``, the
reference augmax's ``export.get_aug_by_name`` (one strategy of the chain,
chosen at random, per call). The draws and the ``RandOp``/``Aug`` split
are ``ops/augment.py``'s.
"""

from __future__ import annotations

import torch

from .augment import (AUGMENT_FNS, Aug, ParamDiffAug, RandOp, host_choice,
                      uniform)


def draw_grid_shuffle(generator, x, grid: int = 4):
    """Per-sample permutations of the grid's patches, (B, grid**2)."""
    return torch.argsort(uniform(generator, x, grid * grid), dim=1)


def grid_shuffle(x, perms, grid: int = 4):
    """Permute a grid of patches (augmax imagelevel.GridShuffle) by
    ``perms`` (B, grid**2). x: (B, H, W, C), H and W divisible by grid."""
    b, h, w, c = x.shape
    gh, gw = h // grid, w // grid
    patches = x.reshape(b, grid, gh, grid, gw, c).permute(
        0, 1, 3, 2, 4, 5).reshape(b, grid * grid, gh, gw, c)
    idx = perms.long()[:, :, None, None, None].expand_as(patches)
    return patches.gather(1, idx).reshape(b, grid, grid, gh, gw, c).permute(
        0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def _gauss(sigma, r: int, device):
    coords = torch.arange(-r, r + 1, dtype=torch.float32, device=device)
    g = torch.exp(-(coords ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _blur(x, g, r: int, taps: int):
    """Separable blur with edge padding, over H then W: sum of ``taps``
    shifted copies weighted by g, as the JAX loop sums them."""
    out = x
    for axis in (1, 2):
        n = out.shape[axis]
        idx = torch.arange(-r, n + r, device=x.device).clamp(0, n - 1)
        padded = out.index_select(axis, idx)
        acc = torch.zeros_like(out)
        for i in range(taps):
            acc = acc + g[i] * padded.narrow(axis, i, n)
        out = acc
    return out


def gaussian_blur(x, sigma: float = 1.0, kernel_size: int = 5):
    """Separable Gaussian blur (augmax imagelevel blur), SAME size."""
    r = kernel_size // 2
    return _blur(x, _gauss(torch.tensor(sigma), r, x.device), r, kernel_size)


def _rand_blur(x, u, param, siamese):
    """sigma = 0.25 + 1.5 u for the whole batch, a 5-tap kernel."""
    return _blur(x, _gauss(u * 1.5 + 0.25, 2, x.device), 2, 5)


rand_grid_shuffle = RandOp(lambda g, x, p: draw_grid_shuffle(g, x),
                           lambda x, d, p, s: grid_shuffle(x, d))
rand_blur = RandOp(lambda g, x, p: torch.rand((), generator=g,
                                              device=x.device), _rand_blur)

EXTRA_FNS = {
    "gridshuffle": [rand_grid_shuffle],
    "blur": [rand_blur],
}


def get_aug_by_name(strategy: str, res: int = 32,
                    param: ParamDiffAug | None = None) -> Aug:
    """augmax/export.py:21-39: ONE random strategy of the chain per call,
    with per-sample draws. color=NormalizedColorJitter(0.25, 0.25, 0.25,
    p=1), crop=RandomSizedCrop(res, zoom (0.8, 1.25)),
    translate=RandomTranslate(0.125), cutout=Cutout(1, res//4, res//4),
    flip=HorizontalFlip(0.5), rotate=Rotate(+-15); other names (scale,
    gridshuffle, blur) go through the DSA table, not siamese. Its draws are
    ``(index, draws of that strategy)``; a DSA strategy's are a list, one
    per op."""
    param = param or ParamDiffAug()
    if strategy in ("None", "none", ""):
        return Aug(lambda generator, x: None, lambda x, draws: x)
    from . import augmax_ops as am

    augmax_table = {
        "color": am.normalized_color_jitter(0.25, 0.25, 0.25, p=1.0),
        "crop": am.random_sized_crop(res, res, zoom_range=(0.8, 1.25)),
        "translate": am.random_translate(0.125),
        "cutout": am.cutout(1, res // 4, res // 4, 0.0, p=1.0),
        "flip": am.horizontal_flip(0.5),
        "rotate": am.rotate((-15, 15), p=1.0),
    }
    names = strategy.split("_")
    dsa_table = {**AUGMENT_FNS, **EXTRA_FNS}

    def draw(generator, x):
        idx = host_choice(generator, x, len(names))
        name = names[idx]
        if name in augmax_table:
            return idx, augmax_table[name].draw(generator, x)
        return idx, [op.draw(generator, x, param) for op in dsa_table[name]]

    def apply(x, draws):
        idx, d = draws
        name = names[idx]
        if name in augmax_table:
            return augmax_table[name].apply(x, d)
        for op, od in zip(dsa_table[name], d, strict=True):
            x = op.apply(x, od, param, False)
        return x

    return Aug(draw, apply)
