"""The image path of the port against the JAX package's, on the CPU in
fp32: the raw DM and raw FRePo steps on an image store (3 classes,
32x32x3, ``from_arrays`` -> ``save_packed`` -> ``load_data``), batched
evaluation of the image nets, and ROADMAP C.18. The coreset driver on the
same store is ``test_torch_image_coreset.py``.

* The raw DM step (ConvNet, ipc 2, the ``(N, 1, H, W, C)`` set that
  ``init_synthetic_raw`` makes of an image store): loss within 1e-5,
  momentum and images within 1e-5 relative norm.
* Batched evaluation of each pool net and of FRePo's nets: the same θ as
  the sequential runs from the same draws, within 1e-5 relative norm
  (ResNet18 1e-4: fp32 rounding through its instance norms; in fp64 the
  batched gradient equals the sequential one to 1e-12), the same
  accuracies.
* C.18: a net with a max-pool refuses a ``(B, 1, H, W, C)`` input, as the
  JAX package fails on it; the others give their images' function.
* Raw FRePo (``s2d=False``, ``frames=1``) runs on the image store with
  ConvNet and Conv, and its proto step (the JAX trainer's own jitted
  ``proto_step``, from the same carry, real batch and pool net) matches
  JAX's with ``tests/test_torch_frepo.py``'s tolerances: the loss within
  5e-5 relative, Adam's first moments within 1e-4 and the updated
  prototypes within 3e-3 relative norm, the labels untouched; the
  initial prototypes (real images drawn by ``default_rng(0)``) within
  1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.errors import ScopeParamShapeError

from video_distillation_tpu.distill import dm as jdm
from video_distillation_tpu.models.registry import create_model as jax_create
from video_distillation_tpu.parallel import mesh as jmesh
from video_distillation_torch.data.store import save_packed
from video_distillation_torch.distill import dm
from video_distillation_torch.distill import evaluate as teval
from video_distillation_torch.distill.frepo import FRePoConfig, FRePoTrainer
from video_distillation_torch.distill.params import (frepo_carry_from_jax,
                                                     from_jax_params)
from video_distillation_torch.drivers import distill_baseline
from video_distillation_torch.models.registry import create_model
from video_distillation_torch.utils.logging import MetricLogger

from torch_threads import one_torch_thread  # noqa: F401
from test_torch_frepo import _check_proto_step, _jax_run, _port, _proto_step
from test_torch_image_data import NC, IM, TINY, image_data

POOL_M = ["MLP", "ConvNet", "LeNet", "AlexNet", "VGG11", "ResNet18"]


def rel_norm(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(a - ref) / np.linalg.norm(ref)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """(data path of the packed store, JAX data, port data)."""
    jdata, tdata = image_data()
    root = tmp_path_factory.mktemp("images")
    save_packed(str(root / f"{TINY}_packed"), tdata)
    return str(root), jdata, tdata


def test_raw_dm_step_on_an_image_store_matches_jax(store):
    _, jdata, tdata = store
    key = jax.random.PRNGKey(3)
    jsyn, jlab = jdm.init_synthetic_raw(key, jdata.train, 2, 1, "real",
                                        np.random.default_rng(1))
    syn, lab = dm.init_synthetic_raw(None, tdata.train, 2, 1, "real",
                                     np.random.default_rng(1), device="cpu")
    assert syn.shape == (NC * 2, 1, IM, IM, 3)  # the JAX frame axis (C.18)
    np.testing.assert_array_equal(syn.numpy(), np.asarray(jsyn))
    params = jax_create("ConvNet", 3, NC, (IM, IM), 1).init(
        {"params": jax.random.fold_in(key, 0),
         "dropout": jax.random.fold_in(key, 0)}, jsyn[:1],
        train=False)["params"]
    jtr = jdm.make_dm_trainer(jdata.train, "ConvNet", 2, 4, 1.0, 1)
    jstate, jloss = jtr(key, jdm.DMState(jsyn, jlab, jnp.zeros(jsyn.shape)),
                        np.random.default_rng(2))
    tr = dm.make_dm_trainer(tdata.train, "ConvNet", 2, 4, 1.0, 1,
                            device="cpu")
    tr.fresh_net = lambda generator: from_jax_params(tr.model, params)
    state, loss = tr(None, dm.DMState(syn, lab, torch.zeros(syn.shape)),
                     np.random.default_rng(2))
    assert abs(float(loss) / float(jloss) - 1) <= 1e-5
    assert rel_norm(state.momentum, jstate.momentum) <= 1e-5
    assert rel_norm(state.syn_images, jstate.syn_images) <= 1e-5


# batched against sequential θ after one step: ResNet18's fp32 gradient
# strays 1e-3 (relative norm) between torch's batched (grouped) and plain
# convolutions through its instance norms over 4x4 maps, which moves θ by
# 1.6e-5; both agree to 1e-14 in fp64
# (test_batched_gradients_agree_in_fp64)
BATCHED_TOL = {"ResNet18": 1e-4}


@pytest.mark.parametrize("model", POOL_M + ["Conv", "KIP_ConvNet"])
def test_batched_evaluation_of_image_nets(store, model):
    """``vmap_eval=True`` (the default of the distillation drivers) runs
    every image net the JAX package runs batched, and gives the sequential
    runs' θ from the same draws (one step), within 1e-5 relative norm
    (``BATCHED_TOL``), and their accuracies."""
    _, _, tdata = store
    rng = np.random.default_rng(4)
    syn = torch.from_numpy(rng.normal(size=(NC * 2, IM, IM, 3)).astype(
        np.float32))
    labels = torch.arange(NC).repeat_interleave(2)
    cfg = teval.EvalConfig(model=model, epoch_eval_train=0, batch_train=6)
    gen = torch.Generator().manual_seed(0)
    draws = []
    for _ in range(2):
        _, theta, _ = teval.fresh_net(model, tdata.meta, 1, gen, "cpu")
        draws.append(teval.EvalDraws(theta.numpy(),
                                     rng.permutation(NC * 2)[None]))
    batched, seq = (teval.evaluate_many(None, 2, syn, labels, tdata, cfg,
                                        np.random.default_rng(5),
                                        vmap_eval=v, draws=draws)[0]
                    for v in (True, False))
    for got, ref in zip(batched, seq):
        assert rel_norm(got.params.numpy(),
                        ref.params.numpy()) <= BATCHED_TOL.get(model, 1e-5)
        assert got.acc_train == ref.acc_train and got.top1 == ref.top1


@pytest.mark.parametrize("model", ["ResNet18", "VGG11"])
def test_batched_gradients_agree_in_fp64(model):
    """The batched step's gradient (``vmap(grad)`` over 2 nets, as
    ``train_synsets`` takes it) against each net's own, in fp64: equal to
    1e-12, so the fp32 gap is rounding."""
    from torch.func import functional_call, grad, vmap

    from video_distillation_torch.distill.params import layout_for

    nets = [create_model(model, 3, NC, (IM, IM), 1, device="cpu",
                         generator=torch.Generator().manual_seed(s)).double()
            for s in (0, 1)]
    layout = layout_for(nets[0])
    theta = torch.stack([layout.flatten(dict(n.named_parameters())).detach()
                         for n in nets])
    x = torch.randn(2, 4, IM, IM, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    y = torch.tensor([[0, 1, 2, 0], [1, 2, 0, 1]])

    def loss(p, x, y):
        return torch.nn.functional.cross_entropy(
            functional_call(nets[0], p, (x,)), y)

    batched = vmap(layout.flatten)(vmap(grad(loss))(
        vmap(layout.unflatten)(theta), x, y))
    each = torch.stack([layout.flatten(grad(loss)(layout.unflatten(theta[e]),
                                                  x[e], y[e]))
                        for e in range(2)])
    assert float((batched - each).norm() / each.norm()) <= 1e-12


@pytest.mark.parametrize("model", ["LeNet", "AlexNet", "VGG11", "ConvNetMP"])
def test_max_pool_nets_refuse_a_frame_axis_as_jax_fails(model):
    """ROADMAP C.18. The JAX package's pairwise max-pool halves axis 1,
    which is the frame axis of a (B, 1, H, W, C) input: its init there
    makes no features (LeNet: a dense kernel of 0 rows against 400), and
    the evaluation's test pass, which drops the axis, then fails on the
    parameters' shapes. The port refuses the input, naming C.18."""
    x = np.random.default_rng(0).normal(size=(2, 1, IM, IM, 3)).astype(
        np.float32)
    jm = jax_create(model, 3, NC, (IM, IM), 1)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jm.init({"params": key}, x[:1],
                                            train=False))["params"]
    feats = shapes["TorchDense_0"]["Dense_0"]["kernel"].shape[0]
    four_d = jax.eval_shape(lambda: jm.init({"params": key}, x[:1, 0],
                                            train=False))["params"]
    assert feats != four_d["TorchDense_0"]["Dense_0"]["kernel"].shape[0]
    if model == "LeNet":
        assert feats == 0
        params = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), shapes)
        with pytest.raises(ScopeParamShapeError):
            jax.eval_shape(lambda: jm.apply({"params": params}, x[:, 0],
                                            train=False))
    port = create_model(model, 3, NC, (IM, IM), 1, device="cpu")
    with pytest.raises(ValueError, match="C.18"):
        port(torch.from_numpy(x))


@pytest.mark.parametrize("model", ["MLP", "ConvNet", "ResNet18", "Conv",
                                  "KIP_ConvNet"])
def test_other_nets_take_a_frame_axis_as_jax_does(model):
    x = np.random.default_rng(0).normal(size=(2, 1, IM, IM, 3)).astype(
        np.float32)
    port = create_model(model, 3, NC, (IM, IM), 1, device="cpu")
    with torch.no_grad():
        torch.testing.assert_close(port(torch.from_numpy(x), output="feat"),
                                   port(torch.from_numpy(x[:, 0]),
                                        output="feat"), rtol=0, atol=0)
    jm = jax_create(model, 3, NC, (IM, IM), 1)
    key = jax.random.PRNGKey(0)
    shapes = [jax.tree.map(lambda a: a.shape, jax.eval_shape(
        lambda s=s: jm.init({"params": key}, s, train=False)))
              for s in (x[:1], x[:1, 0])]
    assert shapes[0] == shapes[1]


def test_raw_dm_driver_refuses_lenet_on_an_image_store(store, tmp_path):
    data_path = store[0]
    with pytest.raises(ValueError, match="C.18"):
        distill_baseline.main(
            ["--preset", "DM", "--dataset", TINY, "--data_path", data_path,
             "--model", "LeNet", "--ipc", "1", "--batch_real", "2",
             "--Iteration", "0", "--eval_mode", "SS", "--num_eval", "1",
             "--epoch_eval_train", "0", "--save_path", str(tmp_path),
             "--device", "cpu"], logger=MetricLogger(quiet=True))


# the JAX package's test_image_store_and_raw_frepo case, ppc == dpc (the
# port refuses ppc != dpc, as the JAX trainer's prototypes assume it)
FREPO_IMAGES = dict(num_classes=NC, ppc=2, dpc=2, frames=1, im_size=(IM, IM),
                    num_nn_state=2, max_online_updates=5, Iteration=10,
                    batch_real=8, lr_d=1.0, lr_h=1e-3, lr_net=1e-3,
                    s2d=False)


@pytest.mark.parametrize("model", ["ConvNet", "Conv"])
def test_raw_frepo_on_an_image_store(store, model):
    """Raw FRePo (``s2d=False``, ``frames=1``), the JAX package's
    ``test_image_store_and_raw_frepo`` case, with ConvNet and Conv: three
    steps of finite loss, prototypes that moved, of the store's shape."""
    _, _, tdata = store
    cfg = FRePoConfig(**FREPO_IMAGES)
    tr = FRePoTrainer(tdata.train, model, cfg, torch.Generator().manual_seed(0),
                      device="cpu")
    before = tr.compose_eval().clone()
    np_rng = np.random.default_rng(0)
    for it in range(3):
        assert np.isfinite(tr.step(torch.Generator().manual_seed(it),
                                   np_rng)["loss"])
    after = tr.compose_eval()
    assert after.shape == (NC * 2, IM, IM, 3)
    assert not torch.equal(after, before)


@pytest.mark.parametrize("model", ["ConvNet", "Conv"])
def test_raw_frepo_proto_step_on_an_image_store_matches_jax(store, model):
    """One raw FRePo proto step on the image store against the JAX
    trainer's: the 2-D net's features, the KRR loss and Adam on the
    (N, H, W, C) prototypes. The JAX trainer runs on one device: on the
    tests' 8-device CPU mesh its sharded masked mean adds fp32 rounding
    (``test_raw_frepo_conv_gradient_is_nearer_fp64_than_jax_on_the_mesh``
    prints it)."""
    stores = store[1:]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmesh, "_MESH", jmesh.make_mesh(1))
        ref = _jax_run(stores, None, None, model=model, base=FREPO_IMAGES)
    tr = FRePoTrainer(stores[1].train, model, FRePoConfig(**FREPO_IMAGES),
                      None, None, "cpu")
    np.testing.assert_allclose(tr.state["x_proto"].numpy(),
                               ref["state0"]["x_proto"], rtol=0, atol=1e-6)
    assert ref["state0"]["x_proto"].shape == (NC * 2, IM, IM, 3)
    tr = _port(stores, None, ref, model=model, base=FREPO_IMAGES)
    loss, _, _, _ = _proto_step(tr, ref)
    _check_proto_step(tr, ref, loss)


def test_raw_frepo_conv_gradient_is_nearer_fp64_than_jax_on_the_mesh(store):
    """The proto step's gradient with Conv, the JAX trainer on the tests'
    8-device CPU mesh: the port's fp32 gradient is nearer the fp64 step
    (the port's trainer in fp64 from the same carry) than JAX's, whose
    sharded masked mean adds fp32 rounding (printed: 2.9e-5 against
    9.4e-5, and 1.2e-4 between the two)."""
    stores = store[1:]
    ref = _jax_run(stores, None, None, model="Conv", base=FREPO_IMAGES)
    tr = _port(stores, None, ref, model="Conv", base=FREPO_IMAGES)
    _proto_step(tr, ref)
    t64 = FRePoTrainer(stores[1].train, "Conv", FRePoConfig(**FREPO_IMAGES),
                       None, None, "cpu", dtype=torch.float64)
    t64.load_state_dict(frepo_carry_from_jax(t64.model, ref["state0"],
                                             ref["pool0"]))
    _, _, _, g64 = _proto_step(t64, ref)
    # Adam's first moment after one step from zero moments is 0.1 g
    port = tr.opt["m"]["x_proto"].numpy() / 0.1
    jax_g = ref["moments"][0]["x_proto"] / 0.1
    d_port = rel_norm(port, g64["x_proto"])
    d_jax = rel_norm(jax_g, g64["x_proto"])
    print("from fp64: port", d_port, "JAX on 8 devices", d_jax,
          "port from JAX", rel_norm(port, jax_g))
    assert d_port <= d_jax

