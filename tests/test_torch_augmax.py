"""The port's augmax ops (``ops/augmax_ops.py``) and ``get_aug_by_name``
against the JAX package's.

Each factory's JAX op draws from a key; the test makes the same
``jax.random`` calls on the same key and hands the results to the port's
``apply``: output within 1e-5 and, where the op is differentiable, the
gradient into x (``jax.vjp`` against autograd) within 1e-5. ``warp``'s
bicubic resize is held against ``jax.image.resize`` itself.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_distillation_tpu.ops import augment_extra as jx
from video_distillation_tpu.ops import augmax_ops as jam
from video_distillation_torch.ops import augment_extra as tx
from video_distillation_torch.ops import augmax_ops as tam
from test_torch_augment import DSA, _np, compare
from torch_threads import one_torch_thread  # noqa: F401

B, H, W = 4, 16, 16
U = jax.random.uniform
BERN = jax.random.bernoulli


def unit_images(seed=0, b=B, h=H, w=W):
    """RGB in (0.02, 0.98): away from the clips at 0 and 1."""
    return np.random.default_rng(seed).uniform(0.02, 0.98, size=(b, h, w, 3)
                                               ).astype(np.float32)


def _split(k, n=2):
    return jax.random.split(k, n)


def _perms(k, b, n):
    return jax.vmap(lambda kk: jax.random.permutation(kk, n))(
        jax.random.split(k, b))


def _sized_crop_draws(k, x, res, zoom_range):
    k1, k2, k3 = _split(k, 3)
    b, h, w, _ = x.shape
    lo = max(zoom_range[0], res / h, res / w)
    hi = max(zoom_range[1], lo)
    return (jam.log_uniform(k1, (b,), lo, hi), U(k2, (b,), minval=-1.0,
                                                 maxval=1.0),
            U(k3, (b,), minval=-1.0, maxval=1.0))


def _cutout_draws(k, x, holes):
    b, h, w, _ = x.shape
    kp, key = _split(k)
    out = []
    for _ in range(holes):
        key, k1, k2 = _split(key, 3)
        out.append((jax.random.randint(k1, (b, 1, 1), 0, h),
                    jax.random.randint(k2, (b, 1, 1), 0, w)))
    return BERN(kp, 0.5, (b, 1, 1, 1)), out


def _color_jitter_draws(k, x, br, co, sa, hu, p):
    kb, kc, kh, ks, kp = _split(k, 5)
    b = x.shape[0]
    return (U(kb, (b, 1, 1), minval=-br, maxval=br),
            U(kc, (b, 1, 1), minval=-co, maxval=co),
            U(kh, (b, 1, 1), minval=-hu, maxval=hu),
            jam.log_uniform(ks, (b, 1, 1), 1.0 / (1.0 + sa), 1.0 + sa),
            BERN(kp, p, (b, 1, 1, 1)))


def _ncj_draws(k, x, br, co, sa, p):
    """Each pair from one key, as the JAX op draws them."""
    kb, kc, ks = _split(k, 3)
    b = x.shape[0]
    cs, ss = math.exp(co), math.exp(sa)
    return ((U(kb, (b, 1, 1, 1), minval=-br, maxval=br),
             BERN(kb, p, (b, 1, 1, 1))),
            (jam.log_uniform(kc, (b, 1, 1, 1), 1.0 / cs, cs),
             BERN(kc, p, (b, 1, 1, 1))),
            (jam.log_uniform(ks, (b, 1, 1, 1), 1.0 / ss, ss),
             BERN(ks, p, (b, 1, 1, 1))))


def _do(p):
    return lambda k, x: BERN(k, p, (x.shape[0], 1, 1, 1))


# name: (factory arguments, JAX draws from (key, x), differentiable)
CASES = {
    "horizontal_flip": ((0.5,), _do(0.5), True),
    "vertical_flip": ((0.5,), _do(0.5), True),
    "random_flip": ((0.7,), lambda k, x: (
        BERN(_split(k, 3)[0], 0.7, (x.shape[0], 1, 1, 1)),
        BERN(_split(k, 3)[1], 0.5, (x.shape[0], 1, 1, 1))), True),
    "rotate90": ((), lambda k, x: jax.random.randint(k, (x.shape[0],), 0, 4),
                 True),
    "rotate": (((-30, 30), 0.7), lambda k, x: (
        U(_split(k)[0], (x.shape[0],), minval=-30, maxval=30),
        BERN(_split(k)[1], 0.7, (x.shape[0], 1, 1, 1))), True),
    "translate": ((2.5, -1.25), lambda k, x: None, True),
    "random_translate": ((0.125,), lambda k, x: (
        U(_split(k)[0], (x.shape[0],), minval=-0.125 * H, maxval=0.125 * H),
        U(_split(k)[1], (x.shape[0],), minval=-0.125 * W, maxval=0.125 * W)),
        True),
    "center_crop": ((10, 12), lambda k, x: None, True),
    "crop": ((3.0, 2.0, 9, 11), lambda k, x: None, True),
    "random_crop": ((10, 12), lambda k, x: (
        U(_split(k)[0], (x.shape[0],), minval=-3.0, maxval=3.0),
        U(_split(k)[1], (x.shape[0],), minval=-2.0, maxval=2.0)), True),
    "resize": ((24, 10), lambda k, x: None, True),
    "random_sized_crop": ((12, 10, (0.5, 2.0)),
                          lambda k, x: _sized_crop_draws(k, x, 12,
                                                         (0.5, 2.0)), True),
    "warp": ((3.0, 4), lambda k, x: jax.random.normal(
        k, (x.shape[0], 2, H // 4, W // 4)), True),
    "normalize": (((0.4, 0.5, 0.6), (0.2, 0.3, 0.25)), lambda k, x: None,
                  True),
    "channel_shuffle": ((0.7,), lambda k, x: (
        _perms(_split(k)[0], x.shape[0], 3),
        BERN(_split(k)[1], 0.7, (x.shape[0], 1, 1, 1))), True),
    "random_gamma": (((0.75, 1.33), 0.7), lambda k, x: (
        jam.log_uniform(_split(k)[0], (x.shape[0], 1, 1, 1), 0.75, 1.33),
        BERN(_split(k)[1], 0.7, (x.shape[0], 1, 1, 1))), True),
    "random_brightness": ((0.5, 0.7), lambda k, x: (
        U(_split(k)[0], (x.shape[0], 1, 1, 1), minval=-0.5, maxval=0.5),
        BERN(_split(k)[1], 0.7, (x.shape[0], 1, 1, 1))), True),
    "random_contrast": ((0.5, 0.7), lambda k, x: (
        jam.log_uniform(_split(k)[0], (x.shape[0], 1, 1, 1), 1 / 1.5, 1.5),
        BERN(_split(k)[1], 0.7, (x.shape[0], 1, 1, 1))), True),
    "color_jitter": ((0.4, 0.4, 0.4, 0.1, 0.7),
                     lambda k, x: _color_jitter_draws(k, x, 0.4, 0.4, 0.4,
                                                      0.1, 0.7), True),
    "random_grayscale": ((0.5,), _do(0.5), True),
    "solarize": ((0.5, 0.7), _do(0.7), True),
    "cutout": ((2, 6, 5, 0.25, 0.5), lambda k, x: _cutout_draws(k, x, 2),
               True),
    "normalized_color_jitter": ((0.5, 1.0, 0.5, 0.7),
                                lambda k, x: _ncj_draws(k, x, 0.5, 1.0, 0.5,
                                                        0.7), True),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(CASES))
def test_factory_matches_jax(name, seed):
    args, jdraw, grad = CASES[name]
    x = unit_images(seed)
    key = jax.random.PRNGKey(10 + seed)
    jfn = getattr(jam, name)(*args)
    aug = getattr(tam, name)(*args)
    draws = _np(jdraw(key, x))
    compare(lambda v: jfn(key, v), lambda v: aug(None, v, draws), x, grad)
    # the port's own draws have the JAX draws' structure and shapes
    own = aug.draw(torch.Generator().manual_seed(seed), torch.from_numpy(x))
    assert jax.tree.structure(own) == jax.tree.structure(draws)
    assert [np.shape(a) for a in jax.tree.leaves(own)] == \
        [np.shape(a) for a in jax.tree.leaves(draws)]


def test_byte_to_float_matches_jax():
    x = np.random.default_rng(0).integers(0, 256, (B, H, W, 3), np.uint8)
    a = jam.byte_to_float()(None, jnp.asarray(x))
    b = tam.byte_to_float()(None, torch.from_numpy(x))
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("shape,out", [((B, 2, 4, 4), (16, 16)),
                                       ((B, 2, 3, 3), (112, 112)),
                                       ((B, 2, 1, 1), (8, 8)),
                                       ((B, 2, 3, 5), (7, 11)),
                                       ((B, 2, 12, 9), (5, 6))])
def test_bicubic_resize_matches_jax_image_resize(shape, out):
    """Keys' a = -0.5 with the border weights renormalised, up and down
    (antialiased) — ``F.interpolate``'s bicubic is another function."""
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32) * 2.6
    compare(lambda v: jax.image.resize(v, shape[:2] + out, method="bicubic"),
            lambda v: tam.bicubic_resize(v, *out), x)


def test_hsv_round_trips_and_matches_jax():
    x = unit_images(3)
    jh = jam.rgb_to_hsv(jnp.asarray(x))
    th = tam.rgb_to_hsv(torch.from_numpy(x))
    for a, b in zip(th, jh):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    np.testing.assert_allclose(tam.hsv_to_rgb(*th).numpy(), x, atol=1e-5)
    # hues past [0, 1) wrap by floor modulo, as JAX's %
    rng = np.random.default_rng(4)
    h = rng.uniform(-2.5, 2.5, (B, H, W)).astype(np.float32)
    s, v = (rng.uniform(0, 1, (B, H, W)).astype(np.float32) for _ in "sv")
    np.testing.assert_allclose(
        tam.hsv_to_rgb(*map(torch.from_numpy, (h, s, v))).numpy(),
        np.asarray(jam.hsv_to_rgb(*map(jnp.asarray, (h, s, v)))), atol=1e-5)
    compare(lambda v: jam.hsv_to_rgb(*jam.rgb_to_hsv(v)),
            lambda v: tam.hsv_to_rgb(*tam.rgb_to_hsv(v)), x)


CHAIN = "color_crop_translate_cutout_flip_rotate_scale_gridshuffle_blur"
AUGMAX_BRANCH = {
    "color": lambda k, x: _ncj_draws(k, x, 0.25, 0.25, 0.25, 1.0),
    "crop": lambda k, x: _sized_crop_draws(k, x, H, (0.8, 1.25)),
    "translate": CASES["random_translate"][1],
    "cutout": lambda k, x: (BERN(_split(k)[0], 1.0, (x.shape[0], 1, 1, 1)),
                            _cutout_draws(k, x, 1)[1]),
    "flip": _do(0.5),
    "rotate": lambda k, x: (U(_split(k)[0], (x.shape[0],), minval=-15,
                              maxval=15),
                            BERN(_split(k)[1], 1.0, (x.shape[0], 1, 1, 1))),
}


def test_get_aug_by_name_every_branch_matches_jax():
    """Keys until every strategy of the chain has been picked; each pick
    against the port with JAX's index and draws."""
    from video_distillation_tpu.ops import augment as ja
    names = CHAIN.split("_")
    jfn = jx.get_aug_by_name(CHAIN, res=H)
    aug = tx.get_aug_by_name(CHAIN, res=H)
    x = unit_images(5)
    seen = set()
    for s in range(200):
        kc, key = _split(jax.random.PRNGKey(s))
        idx = int(jax.random.randint(kc, (), 0, len(names)))
        if idx in seen:
            continue
        seen.add(idx)
        name = names[idx]
        if name in AUGMAX_BRANCH:
            d = _np(AUGMAX_BRANCH[name](key, x))
        else:
            d, k = [], key
            for f in {**ja.AUGMENT_FNS, **jx.EXTRA_FNS}[name]:
                k, kk = _split(k)
                d.append(_np(DSA[f][1](kk, x, ja.ParamDiffAug())))
        np.testing.assert_allclose(
            aug(None, torch.from_numpy(x), (idx, d)).numpy(),
            np.asarray(jfn(jax.random.PRNGKey(s), jnp.asarray(x))),
            rtol=1e-5, atol=1e-5, err_msg=name)
        if len(seen) == len(names):
            break
    assert len(seen) == len(names)
    out = aug(torch.Generator().manual_seed(0), torch.from_numpy(x))
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert tx.get_aug_by_name("none")(None, torch.from_numpy(x)).shape == \
        x.shape
