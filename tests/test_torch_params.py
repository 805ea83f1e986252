"""The port's parameter bridge against the JAX package's flat vector.

Both packages read the same ``replay_buffer_{n}.npz``, so the port's split
of a JAX flat vector must equal the flax tree leaf for leaf. Every check
here is exact: the bridge only reshapes and transposes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from video_distillation_tpu.distill.mtt import \
    flat_param_template as jax_template
from video_distillation_tpu.models.hallucinator import \
    Hallucinator as JaxHallucinator
from video_distillation_torch.distill.params import (from_jax_params,
                                                     layout_for, to_jax_flat)
from video_distillation_torch.models.convnet3d import ConvNet3D
from video_distillation_torch.models.hallucinator import Hallucinator
from video_distillation_torch.models.registry import create_model
from torch_threads import one_torch_thread  # noqa: F401


def _torch_layout(a):
    a = np.asarray(a)
    return a.transpose(4, 3, 0, 1, 2) if a.ndim == 5 else a


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


@pytest.fixture(scope="module")
def jax_full_width():
    """The JAX flat vector of ConvNet3D at the S2D-MTT width."""
    _, params, flat, _ = jax_template("ConvNet3D", 3, 50, (112, 112), 16,
                                      seed=0)
    return params, np.asarray(flat)


def test_flat_size_and_order_match_jax(jax_full_width):
    params, flat = jax_full_width
    model = create_model("ConvNet3D", 3, 50, (112, 112), 16, device="cpu")
    layout = layout_for(model)
    assert layout.size == flat.size == 3_647_666
    # bias before kernel, layers in flax's sorted order
    assert [e[0] for e in layout.entries] == [p for p, _ in _leaves(params)]


def test_split_of_jax_flat_equals_flax_tree(jax_full_width):
    params, flat = jax_full_width
    model = create_model("ConvNet3D", 3, 50, (112, 112), 16, device="cpu")
    from_flat = from_jax_params(model, flat)
    from_tree = from_jax_params(model, params)
    names = {e[0]: e[1] for e in layout_for(model).entries}
    for path, leaf in _leaves(params):
        want = _torch_layout(leaf)
        assert np.array_equal(from_flat[names[path]].numpy(), want), path
        assert np.array_equal(from_tree[names[path]].numpy(), want), path


def test_module_flat_roundtrip_is_exact():
    gen = torch.Generator().manual_seed(3)
    model = ConvNet3D(num_classes=5, im_size=(64, 64), frames=8,
                      generator=gen)
    flat = to_jax_flat(model)
    back = from_jax_params(model, flat)
    for name, p in model.named_parameters():
        assert torch.equal(back[name], p.detach()), name
    assert np.array_equal(to_jax_flat(back, model), flat)


def test_port_flat_runs_the_jax_model():
    """A port-initialised flat vector, unravelled by JAX, gives the JAX
    model the port's weights: identical logits up to fp32 conv rounding."""
    gen = torch.Generator().manual_seed(4)
    model = ConvNet3D(num_classes=3, im_size=(64, 64), frames=8,
                      generator=gen)
    model_def, _, _, unravel = jax_template("ConvNet3D", 3, 3, (64, 64), 8)
    x = np.random.default_rng(0).normal(size=(2, 8, 64, 64, 3)).astype(
        np.float32)
    ref = model_def.apply({"params": unravel(jnp.asarray(to_jax_flat(model)))},
                          jnp.asarray(x), train=False)
    out = model(torch.from_numpy(x))
    # fp32 convs summed in different orders: 1e-4 relative to the largest
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("mode,cin", [("concat", 4), ("add", 3)])
def test_hallucinator_params_convert_exactly(mode, cin):
    hal = JaxHallucinator(mode=mode)
    s = jnp.zeros((1, 8, 8, 3))
    d = jnp.zeros((1, 4, 8, 8, 1))
    params = hal.init(jax.random.PRNGKey(0), s, d)["params"]
    port = Hallucinator(mode)
    got = from_jax_params(port, params)
    assert got["weight"].shape == (3, cin, 3, 3, 3)
    assert np.array_equal(got["weight"].numpy(),
                          _torch_layout(params["kernel"]))
    assert np.array_equal(got["bias"].numpy(), np.asarray(params["bias"]))
    flat, _ = ravel_pytree(params)
    assert np.array_equal(to_jax_flat(got, port), np.asarray(flat))
