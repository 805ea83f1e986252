"""The port's image nets (``models/classic.py``, ``models/frepo_nets.py``,
the BatchNorm ConvNets) against the JAX package's, on the CPU in fp32.

Every net is a fresh port net whose parameters go to the JAX package as
the flax tree (``to_jax_tree``, ``batch_stats_to_jax``), which must have
the JAX ``init``'s structure and shapes, and come back through
``from_jax_params`` and ``batch_stats_from_jax`` unchanged; the inputs come
from a numpy seed (2 images, 32x32, 3 classes unless said). Tolerances, as a bound
on max |port - jax| / max |jax|:

* logits and features: 1e-5, or, where the JAX net's own fp32 rounding is
  larger (the instance norms over 2x2 maps deep in VGG, ResNet_AP), 3x the
  JAX output's distance from the port run in fp64 (measured: VGG16's JAX
  features 4.2e-5 from fp64, the port's 2.8e-5);
* BatchNorm: the train-mode output, the updated running statistics
  (``apply(..., mutable=['batch_stats'])``) and the eval-mode output on the
  updated statistics, each within 1e-5 (of the largest |value| of each
  statistic), at flax momentum 0.9 (the DC nets) and 0.1 (FRePo's nets);
* gradients of a cross entropy: 1e-4, the input's and the flat θ's (a
  conv bias before a norm has a gradient of rounding noise alone).

Then the registry (every name of the JAX ``create_model``, the aliases) and
ROADMAP C.17: a BatchNorm net in ``evaluate_many`` raises in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.errors import ScopeCollectionNotFound
from flax.traverse_util import flatten_dict

from video_distillation_tpu.distill import evaluate as jeval
from video_distillation_tpu.models import frepo_nets as jfrepo
from video_distillation_tpu.models.registry import create_model as jax_create
from video_distillation_torch.distill import evaluate as teval
from video_distillation_torch.distill.params import (batch_stats_from_jax,
                                                     batch_stats_to_jax,
                                                     from_jax_params,
                                                     layout_for, to_jax_tree)
from video_distillation_torch.models import frepo_nets
from video_distillation_torch.models.registry import (create_model,
                                                      has_batch_stats,
                                                      path_model)

from torch_threads import one_torch_thread  # noqa: F401
from test_torch_image_data import image_data  # tests/ is on sys.path

NC, IM, B = 3, 32, 2
# every image name of tests/test_models.py, and the rest of the JAX
# create_model's image names
NAMES = [
    "MLP", "ConvNet", "LeNet", "AlexNet", "AlexNetBN", "VGG11", "VGG11BN",
    "ResNet18", "ResNet18BN", "ResNet18BN_AP",
    "ConvNetD1", "ConvNetD2", "ConvNetD4", "ConvNetW32", "ConvNetW256",
    "ConvNetAS", "ConvNetAL", "ConvNetASwish", "ConvNetASwishBN",
    "ConvNetNN", "ConvNetBN", "ConvNetLN", "ConvNetIN", "ConvNetGN",
    "ConvNetNP", "ConvNetMP", "ConvNetAP",
    "Conv", "KIP_ConvNet", "DC_ConvNet", "VGG13", "VGG16", "VGG19",
    "VGG13BN", "VGG16BN", "VGG19BN", "ResNet18_AP"]
BN_NAMES = [n for n in NAMES if "BN" in n]


def rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


def _inputs(channel=3, im=IM, seed=0):
    return np.random.default_rng(seed).normal(
        size=(B, im, im, channel)).astype(np.float32)


def _jax_net(jm, x, port, seed=1):
    """The port net's fresh parameters (from a seed) as the JAX net's
    variables: the tree ``to_jax_tree`` writes must have the JAX init's
    structure and shapes (``eval_shape``: traced, not run). BatchNorm
    running statistics are moved away from their init, so eval mode reads
    them."""
    with torch.no_grad():
        port.reset_parameters(torch.Generator().manual_seed(seed))
        for name, buf in port.named_buffers():
            buf.add_(0.1 * torch.arange(buf.numel()) / buf.numel())
    key = jax.random.PRNGKey(seed)
    shapes = jax.eval_shape(lambda: jm.init({"params": key, "dropout": key},
                                            jnp.asarray(x[:1]), train=False))
    v = {"params": to_jax_tree(layout_for(port),
                               dict(port.named_parameters()))}
    if has_batch_stats(port):
        v["batch_stats"] = batch_stats_to_jax(port)
    assert sorted(v) == sorted(shapes)
    for k in v:
        want = {p: a.shape for p, a in flatten_dict(shapes[k]).items()}
        assert {p: a.shape for p, a in flatten_dict(v[k]).items()} == want
    return v


def _port_net(port, v):
    """The port's parameters carried from the JAX variables (the round
    trip of ``_jax_net``'s tree, which must give them back)."""
    params = from_jax_params(port, v["params"])
    for k, t in port.named_parameters():
        assert torch.equal(params[k], t), k
    if "batch_stats" in v:
        batch_stats_from_jax(port, v["batch_stats"])
    return params


def _japply(jm, v, x, **kw):
    """The JAX net's ``apply`` as one jitted call (one compile a net, where
    an eager apply compiles op by op)."""
    return jax.jit(lambda v, x: jm.apply(v, x, **kw))(v, jnp.asarray(x))


def _call(port, params, x, **kw):
    return torch.func.functional_call(port, params, (torch.from_numpy(x),),
                                      kw)


def _fp64_output(port, params, x, **kw):
    port64 = port.double()
    try:
        return torch.func.functional_call(
            port64, {k: v.double() for k, v in params.items()},
            (torch.from_numpy(x).double(),), kw).detach().numpy()
    finally:
        port.float()


def check_close(port, params, x, got, ref, stats=None, **kw):
    """``got`` within 1e-5 of the JAX output ``ref``, or within 3x of the
    JAX output's distance from the port run in fp64 (``stats``: the running
    statistics to run it from)."""
    err = rel(got, ref)
    if err <= 1e-5:
        return
    if stats is not None:
        batch_stats_from_jax(port, stats)
    yard = rel(ref, _fp64_output(port, params, x, **kw))
    assert err <= 3 * yard, f"{err} > 3 x {yard} (JAX from fp64)"


@pytest.mark.parametrize("name", NAMES)
def test_image_net_matches_jax(name):
    x = _inputs()
    jm = jax_create(name, 3, NC, (IM, IM), 1)
    port = create_model(name, 3, NC, (IM, IM), 1, device="cpu")
    v = _jax_net(jm, x, port)
    params = _port_net(port, v)
    assert has_batch_stats(port) == ("BN" in name)
    if "batch_stats" not in v:
        refs = _japply(jm, v, x, train=True, output="both")
        gots = _call(port, params, x, train=True, output="both")
        for output, got, ref in zip(("logits", "feat"), gots, refs):
            assert got.shape == ref.shape
            check_close(port, params, x, got.detach().numpy(), ref,
                        train=True, output=output)
        return
    # BatchNorm: train mode (batch statistics, running update), then eval
    # mode on the updated running statistics
    (ref, ref_feat), new = _japply(jm, v, x, train=True, output="both",
                                   mutable=["batch_stats"])
    got, feat = _call(port, params, x, train=True, output="both")
    check_close(port, params, x, got.detach().numpy(), ref, v["batch_stats"],
                train=True)
    check_close(port, params, x, feat.detach().numpy(), ref_feat,
                v["batch_stats"], train=True, output="feat")
    batch_stats_from_jax(port, v["batch_stats"])
    _call(port, params, x, train=True)
    for a, b in zip(jax.tree.leaves(batch_stats_to_jax(port)),
                    jax.tree.leaves(new["batch_stats"])):
        assert rel(a, b) <= 1e-5
    ref_eval = _japply(jm, {"params": v["params"], **new}, x, train=False)
    got_eval = _call(port, params, x, train=False)
    check_close(port, params, x, got_eval.detach().numpy(), ref_eval,
                new["batch_stats"], train=False)


@pytest.mark.parametrize("name", ["MLP", "ConvNet", "LeNet", "AlexNet",
                                  "VGG11", "ResNet18", "Conv", "KIP_ConvNet"])
def test_one_channel_inputs_match_jax(name):
    """MNIST's 28x28x1: LeNet's, AlexNet's, VGG's, ConvNet's and Conv's
    first layers pad more for 1-channel input (classic.py:54, :89, :127,
    frepo_nets.py:101-103)."""
    x = _inputs(channel=1, im=28)
    jm = jax_create(name, 1, NC, (28, 28), 1)
    port = create_model(name, 1, NC, (28, 28), 1, device="cpu")
    v = _jax_net(jm, x, port)
    params = _port_net(port, v)
    ref = _japply(jm, v, x, train=True, output="feat")
    got = _call(port, params, x, train=True, output="feat")
    check_close(port, params, x, got.detach().numpy(), ref, train=True,
                output="feat")


@pytest.mark.parametrize("name,channel,im", [
    *((n, 3, 32) for n in ("MLP", "ConvNet", "LeNet", "AlexNet", "VGG11",
                           "ResNet18", "ResNet18_AP", "Conv", "KIP_ConvNet")),
    *((n, 1, 28) for n in ("ConvNet", "LeNet", "AlexNet", "VGG11", "Conv"))])
def test_clip_elements_is_the_jax_nets_widest_activation(name, channel, im):
    """``clip_elements`` (which sizes ``net_groups`` and ``real_chunk``) is
    the widest activation of the JAX net on 2 frames: its input or the
    largest output of a submodule (flax ``capture_intermediates``, shapes
    only), of the features without the head."""
    jm = jax_create(name, channel, NC, (im, im), 1)
    x = jnp.zeros((1, im, im, channel))
    shapes = jax.eval_shape(lambda: jm.apply(
        jm.init({"params": jax.random.PRNGKey(0)}, x, train=False), x,
        train=False, output="feat", capture_intermediates=True)[1])
    widest = max([x.size] + [a.size for a in
                             jax.tree_util.tree_leaves(shapes)])
    port = create_model(name, channel, NC, (im, im), 1, device="cpu")
    assert port.clip_elements(2, im, im) == 2 * widest


def _ce(logits, y):
    return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(B), y])


@pytest.mark.parametrize("name", ["ConvNet", "AlexNetBN", "KIP_ConvNet"])
def test_gradients_match_jax(name):
    """One net of each family (the 2-D ConvNet, the classic nets with a
    BatchNorm, FRePo's): the parameter and input gradients of a cross
    entropy in train mode, within 1e-4."""
    x = _inputs()
    y = np.array([0, 2])
    jm = jax_create(name, 3, NC, (IM, IM), 1)
    port = create_model(name, 3, NC, (IM, IM), 1, device="cpu")
    v = _jax_net(jm, x, port)
    extra = {k: t for k, t in v.items() if k != "params"}

    def jloss(p, xx):
        if extra:
            return _ce(jm.apply({"params": p, **extra}, xx, train=True,
                                mutable=list(extra))[0], y)
        return _ce(jm.apply({"params": p}, xx, train=True), y)

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(v["params"],
                                                          jnp.asarray(x))
    params = {k: t.requires_grad_(True) for k, t in _port_net(port, v).items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    logits = torch.func.functional_call(port, params, (xt,), dict(train=True))
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
    gx, *gp = torch.autograd.grad(loss, [xt, *params.values()])
    assert rel(gx.numpy(), jgx) <= 1e-4
    # over the flat θ: a conv bias before a norm has a gradient of rounding
    # noise alone (the norm's mean cancels it)
    layout = layout_for(port)
    assert rel(layout.flatten(dict(zip(params, gp))).numpy(),
               layout.flatten(layout.from_jax(jgp)).numpy()) <= 1e-4


@pytest.mark.parametrize("norm", ["batch", "layer", "group", "group1",
                                  "instance"])
@pytest.mark.parametrize("net", ["KIPConvNet", "FRePoConv"])
def test_frepo_nets_norms_match_jax(net, norm):
    """FRePo's nets with each of FRePo's norms; 'batch' is flax momentum
    0.1 (frepo_nets.py:23-25): the running value keeps 10% of its past."""
    x = _inputs()
    jm = getattr(jfrepo, net)(num_classes=NC, normalization=norm)
    port = getattr(frepo_nets, net)(3, NC, normalization=norm, device="cpu")
    v = _jax_net(jm, x, port)
    params = _port_net(port, v)
    if "batch_stats" not in v:
        ref = _japply(jm, v, x, train=True)
        check_close(port, params, x, _call(port, params, x).detach().numpy(),
                    ref, train=True)
        return
    assert {m.momentum for m in port.modules()
            if hasattr(m, "momentum")} == {0.1}
    ref, new = _japply(jm, v, x, train=True, mutable=["batch_stats"])
    got = _call(port, params, x, train=True)
    check_close(port, params, x, got.detach().numpy(), ref, v["batch_stats"],
                train=True)
    for a, b in zip(jax.tree.leaves(batch_stats_to_jax(port)),
                    jax.tree.leaves(new["batch_stats"])):
        assert rel(a, b) <= 1e-5


@pytest.mark.parametrize("alias,name", [("kipconv", "KIP_ConvNet"),
                                        ("conv", "Conv"),
                                        ("dcconv", "DC_ConvNet"),
                                        ("DC_ConvNet", "ConvNetNN")])
def test_registry_aliases(alias, name):
    a = create_model(alias, 3, NC, (IM, IM), 1, device="cpu")
    b = create_model(name, 3, NC, (IM, IM), 1, device="cpu")
    assert type(a) is type(b)
    assert layout_for(a).entries == layout_for(b).entries
    with pytest.raises(ValueError, match="unknown model"):
        create_model("ConvNetXY", 3, NC)


def test_fresh_nets_follow_the_generator():
    """A fresh net is a function of its generator; KIP_ConvNet's head bias
    is N(0, 0.1), its other biases 0 (frepo_nets.py:53-54)."""
    for name in ("ResNet18BN", "KIP_ConvNet", "VGG11"):
        a, b, c = (create_model(name, 3, NC, (IM, IM), 1, device="cpu",
                                generator=torch.Generator().manual_seed(s))
                   for s in (4, 4, 5))
        pa, pb, pc = (dict(m.named_parameters()) for m in (a, b, c))
        assert all(torch.equal(pa[k], pb[k]) for k in pa)
        assert any(not torch.equal(pa[k], pc[k]) for k in pa)
    kip = create_model("KIP_ConvNet", 3, 100, (IM, IM), 1, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    assert 0.07 < float(kip.head.bias.detach().std()) < 0.13
    assert float(kip.convs[0].bias.abs().max()) == 0.0


@pytest.mark.parametrize("name", ["ConvNetBN", "ResNet18BN"])
def test_batchnorm_nets_raise_in_evaluation_in_both_packages(name):
    """ROADMAP C.17: every JAX path applies ``{"params": p}`` alone, so
    flax raises for the BatchNorm nets' missing ``batch_stats``; the port's
    paths refuse them naming C.17."""
    jdata, tdata = image_data()
    syn = np.random.default_rng(0).normal(size=(NC, IM, IM, 3)).astype(
        np.float32)
    labels = np.arange(NC)
    kw = dict(model=name, epoch_eval_train=0, batch_train=4)
    with pytest.raises(ScopeCollectionNotFound):
        jeval.evaluate_many(jax.random.PRNGKey(0), 1, jnp.asarray(syn),
                            jnp.asarray(labels), jdata,
                            jeval.EvalConfig(**kw), np.random.default_rng(0))
    for vmap_eval in (False, True):
        with pytest.raises(ValueError, match="C.17"):
            teval.evaluate_many(torch.Generator().manual_seed(0), 2,
                                torch.from_numpy(syn),
                                torch.from_numpy(labels), tdata,
                                teval.EvalConfig(**kw),
                                np.random.default_rng(0), vmap_eval=vmap_eval)
    with pytest.raises(ValueError, match="C.17"):
        path_model(name, 3, NC, (IM, IM), 1, device="cpu")
