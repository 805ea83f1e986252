"""The port's DSA, DC augment, extras and profiling hooks against the JAX
package's ``ops/augment.py``, ``ops/augment_extra.py`` and
``utils/profiling.py``.

The JAX ops draw from a key; the port's apply halves take the draws. Each
test makes JAX's draws with the same ``jax.random`` calls on the same key
as the JAX op and hands them to the port: outputs within 1e-5, and
gradients into x (a random cotangent, ``jax.vjp`` against autograd) within
1e-5. ``dc_augment`` is numpy on the host and bit-equal for the same
``np.random.Generator``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_distillation_tpu.ops import augment as ja
from video_distillation_tpu.ops import augment_extra as jx
from video_distillation_torch.ops import augment as ta
from video_distillation_torch.ops import augment_extra as tx
from video_distillation_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
STRATEGY = "color_crop_cutout_flip_scale_rotate"


def images(b=4, h=16, w=16, c=3, seed=0):
    return np.random.default_rng(seed).normal(size=(b, h, w, c)).astype(
        np.float32)


def compare(jfn, tfn, x, grad=True):
    """jfn(x) against tfn(x) within TOL, and their VJPs into x."""
    jout, vjp = jax.vjp(jfn, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=grad)
    tout = tfn(xt)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=TOL, atol=TOL)
    if grad:
        ct = np.random.default_rng(9).normal(size=jout.shape).astype(
            np.float32)
        (jg,) = vjp(jnp.asarray(ct))
        (tg,) = torch.autograd.grad(tout, xt, torch.from_numpy(ct))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=TOL,
                                   atol=TOL)


def _np(tree):
    return jax.tree.map(np.array, tree)


def _jax_crop(k, x, p):
    b, h, w, _ = x.shape
    sy, sx = int(h * p.ratio_crop_pad + 0.5), int(w * p.ratio_crop_pad + 0.5)
    k1, k2 = jax.random.split(k)
    return (jax.random.randint(k1, (b, 1, 1), -sy, sy + 1),
            jax.random.randint(k2, (b, 1, 1), -sx, sx + 1))


def _jax_cutout(k, x, p):
    b, h, w, _ = x.shape
    ch, cw = int(h * p.ratio_cutout + 0.5), int(w * p.ratio_cutout + 0.5)
    k1, k2 = jax.random.split(k)
    return (jax.random.randint(k1, (b, 1, 1), 0, h + (1 - ch % 2)),
            jax.random.randint(k2, (b, 1, 1), 0, w + (1 - cw % 2)))


def _jax_two(k, x, p):
    k1, k2 = jax.random.split(k)
    return (jax.random.uniform(k1, (x.shape[0],)),
            jax.random.uniform(k2, (x.shape[0],)))


def _jax_per_sample(k, x, p):
    return jax.random.uniform(k, (x.shape[0], 1, 1, 1))


# each JAX op: (its port, the draws it makes from its key)
DSA = {
    ja.rand_scale: (ta.rand_scale, _jax_two),
    ja.rand_rotate: (ta.rand_rotate,
                     lambda k, x, p: jax.random.uniform(k, (x.shape[0],))),
    ja.rand_flip: (ta.rand_flip, _jax_per_sample),
    ja.rand_brightness: (ta.rand_brightness, _jax_per_sample),
    ja.rand_saturation: (ta.rand_saturation, _jax_per_sample),
    ja.rand_contrast: (ta.rand_contrast, _jax_per_sample),
    ja.rand_crop: (ta.rand_crop, _jax_crop),
    ja.rand_cutout: (ta.rand_cutout, _jax_cutout),
    jx.rand_grid_shuffle: (tx.rand_grid_shuffle, lambda k, x, p: jax.vmap(
        lambda kk: jax.random.permutation(kk, 16))(
            jax.random.split(k, x.shape[0]))),
    jx.rand_blur: (tx.rand_blur, lambda k, x, p: jax.random.uniform(k, ())),
}


@pytest.mark.parametrize("siamese", [False, True])
@pytest.mark.parametrize("jop", list(DSA), ids=lambda f: f.__name__)
def test_dsa_op_matches_jax(jop, siamese):
    top, jdraw = DSA[jop]
    p = ja.ParamDiffAug()
    x = images()
    key = jax.random.PRNGKey(3)
    draws = ta.on_device(torch.zeros(()), _np(jdraw(key, x, p)))
    compare(lambda v: jop(v, key, p, jnp.asarray(siamese)),
            lambda v: top.apply(v, draws, ta.ParamDiffAug(), siamese), x)


def _jax_op_draws(key, x, p, fns):
    """The draws of a sequence of JAX ops that split ``key`` once per op,
    as ``diff_augment`` and a ``make_diff_augment`` branch do."""
    out = []
    for f in fns:
        key, k = jax.random.split(key)
        out.append(_np(DSA[f][1](k, x, p)))
    return out


def _jax_diff_augment_draws(key, x, p):
    names = STRATEGY.split("_")
    if p.aug_mode == "M":
        return None, _jax_op_draws(key, x, p, [f for n in names
                                               for f in ja.AUGMENT_FNS[n]])
    key, kc = jax.random.split(key)
    choice = int(jax.random.randint(kc, (), 0, len(names)))
    return choice, _jax_op_draws(key, x, p, ja.AUGMENT_FNS[names[choice]])


def _jax_make_diff_augment_draws(key, x, p):
    names = STRATEGY.split("_")
    if p.aug_mode == "M":
        ops = []
        for n in names:
            key, k = jax.random.split(key)
            ops += _jax_op_draws(k, x, p, ja.AUGMENT_FNS[n])
        return None, ops
    kc, key = jax.random.split(key)
    choice = int(jax.random.randint(kc, (), 0, len(names)))
    return choice, _jax_op_draws(key, x, p, ja.AUGMENT_FNS[names[choice]])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("siamese", [False, True])
@pytest.mark.parametrize("mode", ["M", "S"])
def test_diff_augment_matches_jax(mode, siamese, seed):
    x = images(seed=seed)
    key = jax.random.PRNGKey(seed)
    jp, tp = ja.ParamDiffAug(aug_mode=mode), ta.ParamDiffAug(aug_mode=mode)
    draws = _jax_diff_augment_draws(key, x, jp)
    compare(lambda v: ja.diff_augment(v, STRATEGY, key, jp, siamese),
            lambda v: ta.diff_augment(v, STRATEGY, None, tp, siamese, draws),
            x)
    jfn = ja.make_diff_augment(STRATEGY, jp, siamese)
    draws = _jax_make_diff_augment_draws(key, x, jp)
    compare(lambda v: jfn(key, v),
            lambda v: ta.make_diff_augment(STRATEGY, tp, siamese)(None, v,
                                                                   draws), x)


def test_diff_augment_draws_and_modes():
    """The port's own draws: 'M' draws every op, 'S' one strategy's; the
    same generator seed gives the same result; 'none' is the identity; an
    unknown mode raises."""
    x = torch.from_numpy(images())
    aug = ta.make_diff_augment(STRATEGY, ta.ParamDiffAug(aug_mode="M"))
    choice, ops = aug.draw(torch.Generator().manual_seed(0), x)
    assert choice is None and len(ops) == 8
    aug = ta.make_diff_augment(STRATEGY, ta.ParamDiffAug(aug_mode="S"))
    choice, ops = aug.draw(torch.Generator().manual_seed(0), x)
    assert len(ops) == len(ta.AUGMENT_FNS[STRATEGY.split("_")[choice]])
    a, b = (aug(torch.Generator().manual_seed(5), x) for _ in range(2))
    assert torch.equal(a, b)
    assert ta.diff_augment(x, "none") is x
    with pytest.raises(ValueError, match="unknown augmentation mode"):
        ta.make_diff_augment(STRATEGY, ta.ParamDiffAug(aug_mode="Q"))


def test_siamese_shares_row_zero():
    x = torch.from_numpy(images())
    out = ta.diff_augment(x[:1].expand(4, -1, -1, -1), "scale_rotate",
                          torch.Generator().manual_seed(0),
                          ta.ParamDiffAug(aug_mode="M"), siamese=True)
    for i in range(1, 4):
        torch.testing.assert_close(out[i], out[0])


def test_affine_grid_sample_matches_jax_outside_the_image():
    """Scales, shears and shifts that send samples past every border."""
    x = images(b=6, h=12, w=20)
    theta = np.random.default_rng(1).uniform(-1.6, 1.6, size=(6, 2, 3)).astype(
        np.float32)
    compare(lambda v: ja.affine_grid_sample(v, jnp.asarray(theta)),
            lambda v: ta.affine_grid_sample(v, torch.from_numpy(theta)), x)


@pytest.mark.parametrize("args", [("CIFAR10", "ConvNet", "ConvNet", 10),
                                  ("MNIST", "ConvNet", "ConvNet", 1),
                                  ("CIFAR10", "ConvNet", "ConvNetBN", 50),
                                  ("MNIST", "ConvNet", "ConvNetBN", 1)])
def test_get_daparam_equal(args):
    assert ta.get_daparam(*args) == ja.get_daparam(*args)


@pytest.mark.parametrize("strategy", ["crop", "scale", "rotate", "noise",
                                      "crop_scale_rotate", "crop_noise",
                                      "none"])
def test_dc_augment_bit_equal(strategy):
    x = images(b=6, h=16, w=16)
    param = dict(ja.get_daparam("CIFAR10", "ConvNet", "ConvNet", 1),
                 strategy=strategy)
    a = ja.dc_augment(x, param, np.random.default_rng(7))
    b = ta.dc_augment(x, param, np.random.default_rng(7))
    assert a.dtype == b.dtype and np.array_equal(a, b)
    if strategy != "none":
        assert not np.array_equal(b, x)


def test_grid_shuffle_matches_jax():
    x = images()
    key = jax.random.PRNGKey(4)
    perms = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, 16))(
        jax.random.split(key, 4)))
    compare(lambda v: jx.grid_shuffle(v, key), lambda v: tx.grid_shuffle(
        v, torch.from_numpy(perms)), x)
    p = tx.draw_grid_shuffle(torch.Generator().manual_seed(0),
                             torch.from_numpy(x))
    assert torch.equal(p.sort(dim=1).values, torch.arange(16).expand(4, 16))


@pytest.mark.parametrize("sigma,size", [(1.0, 5), (0.6, 3), (2.0, 4)])
def test_gaussian_blur_matches_jax(sigma, size):
    compare(lambda v: jx.gaussian_blur(v, None, sigma, size),
            lambda v: tx.gaussian_blur(v, sigma, size), images())


def test_profiling_hooks(tmp_path):
    """``trace`` writes a Chrome trace holding the ``span``."""
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.span("augment_span"):
            ta.diff_augment(torch.from_numpy(images()), STRATEGY,
                            torch.Generator().manual_seed(0))
    path = tmp_path / "prof" / "trace.json"
    assert path.exists() and "augment_span" in path.read_text()
