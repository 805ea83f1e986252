"""The port's ZCA whitening (``ops/zca.py``) and EMA/AVG tracking
(``ops/ema.py``) against the JAX package's, on the CPU.

Inputs from a numpy seed. ``fit_zca`` is the same numpy in both packages:
its state must be equal bit for bit. ``apply_zca`` and ``invert_zca``: fp32
matmuls summed in other orders, within 1e-5 of the largest |value|; the
round trip within 1e-3 (JAX ``tests/test_ops_extra.py:14-23``). EMA and
AVG: within 1e-6 relative after a few updates.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_distillation_tpu.ops import ema as jema
from video_distillation_tpu.ops import zca as jzca
from video_distillation_torch.ops import ema, zca


def _images(n=300, seed=0):
    """Correlated 2-channel 4x4 images (the JAX test's recipe)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, 4, 4, 1))
    return np.concatenate([base, base * 0.9 + 0.1 * rng.normal(
        size=base.shape)], axis=-1).astype(np.float32)


def rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("reg", [0.001, 0.1])
def test_zca_matches_jax(reg):
    x = _images()
    st = zca.fit_zca(x, reg=reg, batch=128)
    ref = jzca.fit_zca(x, reg=reg, batch=128)
    for k in ("mean", "whiten", "dewhiten"):
        np.testing.assert_array_equal(getattr(st, k), getattr(ref, k))
    assert st.shape == ref.shape == (4, 4, 2)
    w = zca.apply_zca(st, torch.from_numpy(x))
    jw = jzca.apply_zca(ref, jnp.asarray(x))
    assert w.dtype == torch.float32 and w.shape == x.shape
    assert rel(w.numpy(), jw) <= 1e-5
    back = zca.invert_zca(st, w)
    assert rel(back.numpy(), jzca.invert_zca(ref, jw)) <= 1e-5
    assert np.allclose(back.numpy(), x, atol=1e-3)


def test_zca_whitens():
    x = _images()
    w = zca.apply_zca(zca.fit_zca(x, reg=0.001), torch.from_numpy(x))
    cov = np.cov(w.numpy().reshape(len(x), -1).T)
    raw = np.cov(x.reshape(len(x), -1).T)
    off = lambda c: np.abs(c - np.diag(np.diag(c))).max()  # noqa: E731
    assert off(cov) < 0.2 * off(raw)


def _param_steps(n=5, seed=1):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(size=(3, 4)).astype(np.float32),
             "b": rng.normal(size=(4,)).astype(np.float32)} for _ in range(n)]


@pytest.mark.parametrize("debias", [True, False])
def test_ema_matches_jax(debias):
    steps = _param_steps()
    st = ema.EMAState.init({k: torch.from_numpy(v) for k, v in steps[0].items()},
                           decay=0.9, debias=debias)
    ref = jema.EMAState.init({k: jnp.asarray(v) for k, v in steps[0].items()},
                             decay=0.9, debias=debias)
    assert st.value()["w"].abs().max() == 0  # count 0: the raw average
    for p in steps:
        st = st.update({k: torch.from_numpy(v) for k, v in p.items()})
        ref = ref.update({k: jnp.asarray(v) for k, v in p.items()})
    assert st.count == ref.count == len(steps)
    for k in steps[0]:
        assert rel(st.value()[k].numpy(), ref.value()[k]) <= 1e-6
        assert rel(st.average[k].numpy(), ref.average[k]) <= 1e-6


def test_ema_of_a_constant_is_the_constant():
    p = {"w": torch.ones(3)}
    st = ema.EMAState.init(p, decay=0.9)
    for _ in range(5):
        st = st.update(p)
    torch.testing.assert_close(st.value()["w"], torch.ones(3))


def test_avg_matches_jax():
    steps = _param_steps(seed=2)
    st = ema.AVGState.init({k: torch.from_numpy(v) for k, v in steps[0].items()})
    ref = jema.AVGState.init({k: jnp.asarray(v) for k, v in steps[0].items()})
    for p in steps:
        st = st.update({k: torch.from_numpy(v) for k, v in p.items()})
        ref = ref.update({k: jnp.asarray(v) for k, v in p.items()})
    for k in steps[0]:
        assert rel(st.value()[k].numpy(), ref.value()[k]) <= 1e-6
        assert rel(st.value()[k].numpy(),
                   np.mean([s[k] for s in steps], axis=0)) <= 1e-6
