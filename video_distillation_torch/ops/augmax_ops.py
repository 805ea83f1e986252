"""augmax-equivalent augmentation surface (geometric warps, colorspace,
image-level), batched NHWC, differentiable in x.

Port of ``video_distillation_tpu/ops/augmax_ops.py``, the reference's
vendored augmax (``FRePo/lib/dataset/augmax/``): geometric ops (flips,
Rotate90, Rotate, Translate/RandomTranslate, Center/Random/RandomSizedCrop,
Resize, Warp), colorspace ops (ByteToFloat, Normalize, ChannelShuffle,
RandomGamma, RandomBrightness, RandomContrast, ColorJitter,
RandomGrayscale, Solarization) and image-level ops (Cutout,
NormalizedColorJitter; GridShuffle and blur are in ``augment_extra``).

Every op is a factory returning an ``Aug`` (``ops/augment.py``): its
``draw(generator, x)`` makes per-sample draws on x's device, its
``apply(x, draws)`` is a pure function of x and the draws. The draws are
the values the JAX op's ``jax.random`` calls return (``bernoulli`` as a
bool, ``uniform`` already scaled to its range, ``log_uniform`` after its
exp, ``permutation`` as an index row), in the order the JAX op makes
them. Where the JAX op draws two values from one key (bernoulli and
uniform share their bits), the port's draw derives both from one uniform.
Geometric ops compose a per-sample affine (or a dense offset field) and
resample bilinearly.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from .augment import Aug, uniform


def _rand(generator, x, shape, lo=0.0, hi=1.0):
    """U[lo, hi) of shape (B, *shape) on x's device, as JAX scales it."""
    return uniform(generator, x, *shape) * (hi - lo) + lo


def log_uniform(generator, x, shape, minval, maxval):
    """exp(U(log min, log max)), (B, *shape) — augmax utils.log_uniform."""
    return torch.exp(_rand(generator, x, shape, math.log(minval),
                           math.log(maxval)))


def _bernoulli(generator, x, p):
    return uniform(generator, x, 1, 1, 1) < p


def _permutations(generator, x, n):
    return torch.argsort(uniform(generator, x, n), dim=1)


# ---------------------------------------------------------------------------
# geometric core: batched bilinear warp
# ---------------------------------------------------------------------------

def warp_bilinear(x, iy, ix, fill: float = 0.0):
    """Sample x (B,H,W,C) at float input coords iy/ix (B,Ho,Wo); bilinear,
    out-of-range reads ``fill``."""
    b, h, w, c = x.shape
    y0, x0 = torch.floor(iy), torch.floor(ix)
    wy1, wx1 = iy - y0, ix - x0
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    flat = x.reshape(b, h * w, c)

    def gather(yi, xi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        yc = yi.clamp(0, h - 1).long()
        xc = xi.clamp(0, w - 1).long()
        idx = (yc * w + xc).reshape(b, -1, 1).expand(-1, -1, c)
        vals = flat.gather(1, idx).reshape(yi.shape + (c,))
        return torch.where(inside[..., None], vals, fill)

    return (gather(y0, x0) * (wy0 * wx0)[..., None] +
            gather(y0, x0 + 1) * (wy0 * wx1)[..., None] +
            gather(y0 + 1, x0) * (wy1 * wx0)[..., None] +
            gather(y0 + 1, x0 + 1) * (wy1 * wx1)[..., None])


def affine_warp(x, mats, out_size: Tuple[int, int] = None,
                fill: float = 0.0):
    """Apply per-sample 2x3 output->input pixel-coordinate affines (around
    the image center) and resample."""
    b, h, w, _ = x.shape
    ho, wo = out_size or (h, w)
    yy, xx = torch.meshgrid(
        torch.arange(ho, dtype=torch.float32, device=x.device),
        torch.arange(wo, dtype=torch.float32, device=x.device), indexing="ij")
    yc = yy - (ho - 1) / 2.0
    xc = xx - (wo - 1) / 2.0
    base = torch.stack([yc, xc, torch.ones_like(yc)], dim=-1)  # (Ho, Wo, 3)
    coords = torch.einsum("hwk,bjk->bhwj", base, mats.float())  # [y, x]
    iy = coords[..., 0] + (h - 1) / 2.0
    ix = coords[..., 1] + (w - 1) / 2.0
    return warp_bilinear(x, iy, ix, fill)


def _mats(a, b_, ty, tx):
    """Stack per-sample [[a, b, ty], [-b, a, tx]] rows into (B, 2, 3)."""
    return torch.stack([torch.stack([a, b_, ty], -1),
                        torch.stack([-b_, a, tx], -1)], dim=1)


def _diag(sy, sx, ty, tx):
    """Per-sample [[sy, 0, ty], [0, sx, tx]] into (B, 2, 3)."""
    zero = torch.zeros_like(sy)
    return torch.stack([torch.stack([sy, zero, ty], -1),
                        torch.stack([zero, sx, tx], -1)], dim=1)


def _fixed(x, *values):
    """Per-sample constants (B,) on x's device."""
    return [torch.full((x.shape[0],), float(v), device=x.device)
            for v in values]


def _no_draws(generator, x):
    return None


# ---------------------------------------------------------------------------
# geometric ops (factories)
# ---------------------------------------------------------------------------

def horizontal_flip(p: float = 0.5):
    return Aug(lambda g, x: _bernoulli(g, x, p),
               lambda x, do: torch.where(do, x.flip(2), x))


def vertical_flip(p: float = 0.5):
    return Aug(lambda g, x: _bernoulli(g, x, p),
               lambda x, do: torch.where(do, x.flip(1), x))


def random_flip(p: float = 0.5):
    """Flip horizontally or vertically at random (augmax RandomFlip);
    draws (do, horizontal)."""
    def apply(x, d):
        do, horiz = d
        return torch.where(do, torch.where(horiz, x.flip(2), x.flip(1)), x)
    return Aug(lambda g, x: (_bernoulli(g, x, p), _bernoulli(g, x, 0.5)),
               apply)


def rotate90():
    """Random k*90-degree rotation per sample (augmax Rotate90); draws k
    (B,) in [0, 4)."""
    def apply(x, ks):
        rots = torch.stack([torch.rot90(x, k, dims=(1, 2)) for k in range(4)])
        return rots[ks.long(), torch.arange(x.shape[0], device=x.device)]
    return Aug(lambda g, x: torch.randint(0, 4, (x.shape[0],), generator=g,
                                          device=x.device), apply)


def rotate(angle_range: Tuple[float, float] = (-30, 30), p: float = 1.0):
    """Draws (degrees (B,), do)."""
    def apply(x, d):
        deg, do = d
        rad = deg * np.pi / 180.0
        zero = torch.zeros_like(rad)
        out = affine_warp(x, _mats(torch.cos(rad), torch.sin(rad), zero,
                                   zero))
        return torch.where(do, out, x)
    return Aug(lambda g, x: (_rand(g, x, (), *angle_range),
                             _bernoulli(g, x, p)), apply)


def translate(dx: float, dy: float):
    """Fixed pixel translation (augmax Translate)."""
    def apply(x, d):
        one, zero, ty, tx = _fixed(x, 1.0, 0.0, -dy, -dx)
        return affine_warp(x, _mats(one, zero, ty, tx))
    return Aug(_no_draws, apply)


def random_translate(ratio: float = 0.125):
    """Random shift up to +-ratio of the size per axis (augmax
    RandomTranslate); draws (ty, tx), each (B,)."""
    def draw(g, x):
        _, h, w, _ = x.shape
        return (_rand(g, x, (), -ratio * h, ratio * h),
                _rand(g, x, (), -ratio * w, ratio * w))

    def apply(x, d):
        one, zero = _fixed(x, 1.0, 0.0)
        return affine_warp(x, _mats(one, zero, *d))
    return Aug(draw, apply)


def center_crop(height: int, width: int):
    def apply(x, d):
        one, zero = _fixed(x, 1.0, 0.0)
        return affine_warp(x, _mats(one, zero, zero, zero),
                           out_size=(height, width))
    return Aug(_no_draws, apply)


def crop(x0: float, y0: float, width: int, height: int):
    """Corner crop at (x0, y0) with the given size (augmax Crop,
    geometric.py:369-408)."""
    def apply(x, d):
        _, h, w, _ = x.shape
        one, zero, ty, tx = _fixed(x, 1.0, 0.0, y0 + height / 2.0 - h / 2.0,
                                   x0 + width / 2.0 - w / 2.0)
        return affine_warp(x, _mats(one, zero, ty, tx),
                           out_size=(height, width))
    return Aug(_no_draws, apply)


def random_crop(height: int, width: int):
    """Draws (ty, tx), each (B,)."""
    def draw(g, x):
        _, h, w, _ = x.shape
        my, mx = (h - height) / 2.0, (w - width) / 2.0
        return _rand(g, x, (), -my, my), _rand(g, x, (), -mx, mx)

    def apply(x, d):
        one, zero = _fixed(x, 1.0, 0.0)
        return affine_warp(x, _mats(one, zero, *d), out_size=(height, width))
    return Aug(draw, apply)


def resize(height: int, width: int):
    def apply(x, d):
        _, h, w, _ = x.shape
        sy, sx, zero = _fixed(x, h / height, w / width, 0.0)
        return affine_warp(x, _diag(sy, sx, zero, zero),
                           out_size=(height, width))
    return Aug(_no_draws, apply)


def random_sized_crop(width: int, height: int = None,
                      zoom_range: Tuple[float, float] = (0.5, 2.0),
                      prevent_underzoom: bool = True):
    """Random zoom (log-uniform) + random center, rescaled to (height,
    width) — augmax RandomSizedCrop (geometric.py:508-571). Draws (zoom,
    uy, ux), each (B,), uy and ux in [-1, 1)."""
    height = height or width

    def draw(g, x):
        _, h, w, _ = x.shape
        lo, hi = zoom_range
        if prevent_underzoom:
            lo = max(lo, height / h, width / w)
            hi = max(hi, lo)
        return (log_uniform(g, x, (), lo, hi), _rand(g, x, (), -1.0, 1.0),
                _rand(g, x, (), -1.0, 1.0))

    def apply(x, d):
        _, h, w, _ = x.shape
        zoom, uy, ux = d
        limit_y = torch.abs((h * zoom - height) / 2) / zoom
        limit_x = torch.abs((w * zoom - width) / 2) / zoom
        inv = 1.0 / zoom
        return affine_warp(x, _diag(inv, inv, uy * limit_y, ux * limit_x),
                           out_size=(height, width))
    return Aug(draw, apply)


def _keys_cubic(t):
    """Keys' cubic convolution kernel with a = -0.5, at |t|."""
    out = ((1.5 * t - 2.5) * t) * t + 1.0
    out = torch.where(t >= 1.0, ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0, out)
    return torch.where(t >= 2.0, torch.zeros_like(t), out)


def cubic_weights(n_in: int, n_out: int, device=None):
    """(n_in, n_out) weights of ``jax.image.resize(method='bicubic')``
    along one axis (antialiased, as its default): Keys' a = -0.5 kernel at
    the output's sample points, each column renormalised to sum to 1 (so
    the border taps that fall outside the input are dropped, not clamped),
    zero where the sample point lies outside the input."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
              * inv_scale - 0.5)
    t = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                        device=device)[:, None]).abs()
    wts = _keys_cubic(t / kernel_scale)
    total = wts.sum(dim=0, keepdim=True)
    wts = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                      wts / torch.where(total != 0, total, 1.0),
                      torch.zeros_like(wts))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], wts, torch.zeros_like(wts))


def bicubic_resize(x, height: int, width: int):
    """Resize the last two axes of x as ``jax.image.resize(...,
    method='bicubic')`` does: separable weight matrices applied by
    matmul. An axis whose size stays is left as it is."""
    h, w = x.shape[-2:]
    if h != height:
        x = torch.einsum("...hw,hk->...kw", x,
                         cubic_weights(h, height, x.device).to(x.dtype))
    if w != width:
        x = torch.einsum("...hw,wk->...hk", x,
                         cubic_weights(w, width, x.device).to(x.dtype))
    return x


def warp(strength: float = 5.0, coarseness: int = 32):
    """Elastic-style warp: a coarse Gaussian offset field, bicubic-upsampled
    to dense per-pixel offsets (augmax Warp, geometric.py:573-602). Draws
    the field's standard normals, (B, 2, H // coarseness, W //
    coarseness) (at least 1 x 1)."""
    def draw(g, x):
        b, h, w, _ = x.shape
        return torch.randn((b, 2, max(1, h // coarseness),
                            max(1, w // coarseness)), generator=g,
                           device=x.device)

    def apply(x, normals):
        _, h, w, _ = x.shape
        off = bicubic_resize(strength * normals, h, w)
        yy, xx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=x.device),
            torch.arange(w, dtype=torch.float32, device=x.device),
            indexing="ij")
        return warp_bilinear(x, yy[None] + off[:, 0], xx[None] + off[:, 1])
    return Aug(draw, apply)


# ---------------------------------------------------------------------------
# colorspace ops
# ---------------------------------------------------------------------------

def byte_to_float():
    return Aug(_no_draws, lambda x, d: x.float() / 255.0)


def normalize(mean: Sequence[float], std: Sequence[float]):
    def apply(x, d):
        m = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
        s = torch.as_tensor(std, dtype=torch.float32, device=x.device)
        return (x - m) / s
    return Aug(_no_draws, apply)


def channel_shuffle(p: float = 0.5):
    """Draws (perms (B, C), do)."""
    def apply(x, d):
        perms, do = d
        idx = perms.long()[:, None, None, :].expand_as(x)
        return torch.where(do, x.gather(-1, idx), x)
    return Aug(lambda g, x: (_permutations(g, x, x.shape[-1]),
                             _bernoulli(g, x, p)), apply)


def random_gamma(gamma_range: Tuple[float, float] = (0.75, 1.33),
                 p: float = 1.0):
    """x ** gamma on [0,1] images (augmax RandomGamma); draws (gamma
    (B,1,1,1), do)."""
    def apply(x, d):
        gamma, do = d
        return torch.where(do, x.clamp(1e-6, 1.0) ** gamma, x)
    return Aug(lambda g, x: (log_uniform(g, x, (1, 1, 1), *gamma_range),
                             _bernoulli(g, x, p)), apply)


def random_brightness(strength: float = 0.5, p: float = 1.0):
    """Draws (amount (B,1,1,1), do)."""
    def apply(x, d):
        amt, do = d
        return torch.where(do, x + amt, x)
    return Aug(lambda g, x: (_rand(g, x, (1, 1, 1), -strength, strength),
                             _bernoulli(g, x, p)), apply)


def random_contrast(strength: float = 0.5, p: float = 1.0):
    """Draws (factor (B,1,1,1), do)."""
    def apply(x, d):
        amt, do = d
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        return torch.where(do, (x - mean) * amt + mean, x)
    lo, hi = 1.0 / (1.0 + strength), 1.0 + strength
    return Aug(lambda g, x: (log_uniform(g, x, (1, 1, 1), lo, hi),
                             _bernoulli(g, x, p)), apply)


def rgb_to_hsv(x):
    """(..., 3) RGB in [0,1] -> (h, s, v), each (...)."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = x.amax(dim=-1)
    d = v - x.amin(dim=-1)
    s = torch.where(v > 0, d / v.clamp_min(1e-12), 0.0)
    safe_d = d.clamp_min(1e-12)
    hr = torch.remainder((g - b) / safe_d, 6.0)
    hg = (b - r) / safe_d + 2.0
    hb = (r - g) / safe_d + 4.0
    h = torch.where(v == r, hr, torch.where(v == g, hg, hb)) / 6.0
    return torch.where(d == 0, 0.0, h), s, v


def _select(i, choices):
    """choices[i] elementwise (jnp.select over i == 0..5)."""
    out = choices[-1]
    for k in range(len(choices) - 2, -1, -1):
        out = torch.where(i == k, choices[k], out)
    return out


def hsv_to_rgb(h, s, v):
    h6 = torch.remainder(h, 1.0) * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    return torch.stack([_select(i, [v, q, p, p, t, v]),
                        _select(i, [t, v, v, q, p, p]),
                        _select(i, [p, p, t, v, v, q])], dim=-1)


def color_jitter(brightness: float = 0.8, contrast: float = 0.8,
                 saturation: float = 0.8, hue: float = 0.2, p: float = 0.5):
    """HSV-space jitter on [0,1] RGB (augmax ColorJitter,
    colorspace.py:244-322; BYOL-style). Draws (brightness, contrast, hue,
    saturation, do): the first four (B,1,1), None where that strength is
    0; do (B,1,1,1)."""
    def draw(g, x):
        return (_rand(g, x, (1, 1), -brightness, brightness)
                if brightness > 0 else None,
                _rand(g, x, (1, 1), -contrast, contrast)
                if contrast > 0 else None,
                _rand(g, x, (1, 1), -hue, hue) if hue > 0 else None,
                log_uniform(g, x, (1, 1), 1.0 / (1.0 + saturation),
                            1.0 + saturation) if saturation > 0 else None,
                _bernoulli(g, x, p))

    def apply(x, d):
        a_b, a_c, a_h, a_s, do = d
        h, s, v = rgb_to_hsv(x)
        if brightness > 0:
            v = (v + a_b).clamp(0.0, 1.0)
        if contrast > 0:
            mean = v.mean(dim=(1, 2), keepdim=True)
            v = ((v - mean) * (1 + a_c) + mean).clamp(0.0, 1.0)
        if hue > 0:
            h = torch.remainder(h + a_h, 1.0)
        if saturation > 0:
            s = (s * a_s).clamp(0.0, 1.0)
        return torch.where(do, hsv_to_rgb(h, s, v), x)
    return Aug(draw, apply)


def random_grayscale(p: float = 0.5):
    def apply(x, do):
        lum = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
        return torch.where(do, lum[..., None].expand(x.shape), x)
    return Aug(lambda g, x: _bernoulli(g, x, p), apply)


def solarize(threshold: float = 0.5, p: float = 0.5):
    return Aug(lambda g, x: _bernoulli(g, x, p),
               lambda x, do: torch.where((x > threshold) & do, 1.0 - x, x))


# ---------------------------------------------------------------------------
# image-level ops
# ---------------------------------------------------------------------------

def cutout(num_holes: int = 1, max_h_size: int = 8, max_w_size: int = 8,
           fill_value: float = 0.0, p: float = 0.5):
    """Zero out random rectangles (augmax Cutout, imagelevel.py:146-206).
    Draws (do, holes): holes a list of (cy, cx), each (B,1,1), cy in
    [0, H) and cx in [0, W)."""
    def draw(g, x):
        b, h, w, _ = x.shape
        do = _bernoulli(g, x, p)
        return do, [tuple(torch.randint(0, n, (b, 1, 1), generator=g,
                                        device=x.device) for n in (h, w))
                    for _ in range(num_holes)]

    def apply(x, d):
        do, holes = d
        _, h, w, _ = x.shape
        gy = torch.arange(h, device=x.device)[None, :, None]
        gx = torch.arange(w, device=x.device)[None, None, :]
        mask = torch.ones((x.shape[0], h, w), dtype=torch.bool,
                          device=x.device)
        for cy, cx in holes:
            in_y = (gy >= cy - max_h_size // 2) & \
                   (gy < cy - max_h_size // 2 + max_h_size)
            in_x = (gx >= cx - max_w_size // 2) & \
                   (gx < cx - max_w_size // 2 + max_w_size)
            mask = mask & ~(in_y & in_x)
        out = torch.where(mask[..., None], x, fill_value)
        return torch.where(do, out, x)
    return Aug(draw, apply)


def normalized_color_jitter(brightness: float = 0.5, contrast: float = 1.0,
                            saturation: float = 0.5, p: float = 0.5):
    """DC-style jitter for NORMALIZED images (augmax NormalizedColorJitter,
    imagelevel.py:209-271): brightness add, contrast/saturation log-uniform
    scaling around the mean; contrast/saturation strengths are exp()'d.
    Draws (amount, do) for brightness, contrast and saturation, each pair
    None where that strength is 0. JAX draws each pair from one key, so
    amount and do share their uniform; the port's draw does too."""
    c_str = math.exp(contrast) if contrast > 0 else 0.0
    s_str = math.exp(saturation) if saturation > 0 else 0.0

    def pair(g, x, lo, hi, log):
        u = uniform(g, x, 1, 1, 1)
        if log:
            return torch.exp(u * (math.log(hi) - math.log(lo))
                             + math.log(lo)), u < p
        return u * (hi - lo) + lo, u < p

    def draw(g, x):
        return (pair(g, x, -brightness, brightness, False)
                if brightness > 0 else None,
                pair(g, x, 1.0 / c_str, c_str, True) if c_str > 0 else None,
                pair(g, x, 1.0 / s_str, s_str, True) if s_str > 0 else None)

    def apply(x, d):
        d_b, d_c, d_s = d
        if d_b is not None:
            amt, do = d_b
            x = torch.where(do, x + amt, x)
        if d_c is not None:
            amt, do = d_c
            mean = x.mean(dim=(1, 2, 3), keepdim=True)
            x = torch.where(do, (x - mean) * amt + mean, x)
        if d_s is not None:
            amt, do = d_s
            mean = x.mean(dim=-1, keepdim=True)
            x = torch.where(do, (x - mean) * amt + mean, x)
        return x
    return Aug(draw, apply)
