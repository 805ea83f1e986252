"""The port's static learning (ConvNet2D, ``match_loss``, DC) against the
JAX package's, same inputs and parameters, on the CPU in fp32.

Inputs come from numpy seeds; every net is a JAX init carried across with
``from_jax_params``, and the real batches are drawn from numpy generators
of the same seed, in the JAX order. Tolerances, each a bound on
max |port - jax| / max |jax| (or on the relative difference of a scalar):

* ConvNet2D logits and features: 1e-5 (fp32 convolutions and norms
  summed in other orders);
* ``match_loss``: 1e-5;
* one DC matching step: loss 1e-5, updated images and momentum 1e-4 (a
  second-order gradient through the per-class cosine);
* one ``inner_train`` (50 SGD steps) and one trainer iteration at spc=10
  are chaotic at width 8: each within 3x (relative norm) of the distance
  by which the JAX run itself moves when its net is perturbed by 1e-7
  relative, fp32 rounding's size (see the tests);
* one trainer iteration at spc=1: 1e-4.

Then ``get_loops``' missing row for spc=2 (ROADMAP C.11), the single-frame
store and the 'real' initialisation (byte-equal), and the chain: the
port's static driver on the CPU writes a static memory that the port's S2D
driver reads through ``--path_static``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from video_distillation_tpu.data import \
    make_synthetic_video_data as jax_synthetic
from video_distillation_tpu.distill import dc as jdc
from video_distillation_tpu.distill.dm import \
    init_synthetic_raw as jax_init_raw
from video_distillation_tpu.drivers.distill_static import \
    to_single_frame_store as jax_single
from video_distillation_tpu.models.registry import \
    create_model as jax_create
from video_distillation_tpu.ops import losses as jlosses
from video_distillation_torch.data.synthetic import make_synthetic_video_data
from video_distillation_torch.distill import dc
from video_distillation_torch.distill.dm import init_synthetic_raw
from video_distillation_torch.distill.params import (from_jax_params,
                                                     layout_for, to_jax_flat,
                                                     to_jax_tree)
from video_distillation_torch.drivers.distill_static import \
    to_single_frame_store
from video_distillation_torch.models.registry import create_model
from video_distillation_torch.ops import losses

NC, IM, B = 3, 32, 4
# the nets of the multi-step cases: XLA's CPU convolution gradients take
# about 3.5 s a step at width 128 and 32x32, 0.012 s at width 8
NARROW = "ConvNetW8"
NORMS = {"instancenorm": "ConvNet", "layernorm": "ConvNetLN",
         "groupnorm": "ConvNetGN", "none": "ConvNetNN"}


def close(a, ref, rel):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    err, scale = np.abs(a - ref).max(), np.abs(ref).max()
    assert err <= rel * scale, f"max error {err} > {rel} * {scale}"


def jax_net(name, seed=0, im=IM, nc=NC):
    model_def = jax_create(name, 3, nc, (im, im), 1)
    params = model_def.init({"params": jax.random.PRNGKey(seed)},
                            jnp.zeros((1, im, im, 3)), train=False)["params"]
    return model_def, params


def port_net(name, params, im=IM, nc=NC):
    port = create_model(name, 3, nc, (im, im), 1, device="cpu")
    port.load_state_dict(from_jax_params(port, params))
    return port


def port_params(port, params):
    return {k: v.clone() for k, v in from_jax_params(port, params).items()}


@pytest.mark.parametrize("norm", sorted(NORMS))
@pytest.mark.parametrize("output", ["logits", "feat"])
def test_convnet2d_matches_jax(norm, output):
    model_def, params = jax_net(NORMS[norm])
    port = port_net(NORMS[norm], params)
    x = np.random.default_rng(0).normal(size=(B, IM, IM, 3)).astype(np.float32)
    ref = model_def.apply({"params": params}, jnp.asarray(x), train=True,
                          output=output)
    out = port(torch.from_numpy(x), output=output)
    close(out.detach().numpy(), ref, 1e-5)


@pytest.mark.parametrize("name", ["ConvNet", "ConvNetLN", "ConvNetNN",
                                  "ConvNetD1", "ConvNetW32"])
def test_parameter_bridge_round_trip(name):
    _, params = jax_net(name, seed=3)
    port = port_net(name, params)
    tree = to_jax_tree(layout_for(port), dict(port.named_parameters()))
    assert jax.tree.structure(tree) == jax.tree.structure(
        jax.tree.map(np.asarray, params))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(to_jax_flat(port),
                                  np.asarray(ravel_pytree(params)[0]))


def test_convnet2d_full_width_layout():
    """The static phase's net: 50 classes at 112x112."""
    _, params = jax_net("ConvNet", im=112, nc=50)
    port = create_model("ConvNet", 3, 50, (112, 112), 1, device="cpu")
    assert layout_for(port).size == ravel_pytree(params)[0].size == 1553970


def _grad_trees(seed):
    """Two gradient-shaped trees in the JAX layout, one row of each conv
    kernel zero (the safe norm's case)."""
    _, params = jax_net("ConvNet", seed=0)
    rng = np.random.default_rng(seed)
    trees = []
    for _ in range(2):
        t = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32),
                         params)
        t["TorchConv_1"]["Conv_0"]["kernel"][..., 5] = 0.0
        trees.append(t)
    return trees


@pytest.mark.parametrize("metric", ["ours", "mse", "cos"])
def test_match_loss_matches_jax(metric):
    g_syn, g_real = _grad_trees(1)
    ref = jlosses.match_loss(jax.tree.map(jnp.asarray, g_syn),
                             jax.tree.map(jnp.asarray, g_real), metric)
    port = create_model("ConvNet", 3, NC, (IM, IM), 1, device="cpu")
    ts, tr = (from_jax_params(port, g) for g in (g_syn, g_real))
    out = losses.match_loss(ts, tr, metric)
    close(float(out), float(ref), 1e-5)
    with pytest.raises(ValueError, match="unknown distance function"):
        losses.match_loss(ts, tr, "l1")


def _stores(clips_per_class=12, seed=0):
    kw = dict(num_classes=NC, clips_per_class=clips_per_class, frames=2,
              im_size=(IM, IM), name="dc-parity")
    jdata, pdata = jax_synthetic(**kw), make_synthetic_video_data(**kw)
    jst = jax_single(jdata.train, np.random.default_rng(seed))
    pst = to_single_frame_store(pdata.train, np.random.default_rng(seed))
    return jst, pst


def test_single_frame_store_and_real_init_are_jax_bytes():
    jst, pst = _stores()
    np.testing.assert_array_equal(pst.clips, jst.clips)
    np.testing.assert_array_equal(pst.labels, jst.labels)
    assert pst.meta.name == jst.meta.name and pst.meta.frames == 1
    jsyn, jlab = jax_init_raw(jax.random.PRNGKey(0), jst, 10, 1, "real",
                              np.random.default_rng(5))
    syn, lab = init_synthetic_raw(None, pst, 10, 1, "real",
                                  np.random.default_rng(5), device="cpu")
    assert syn.dtype == torch.float32
    np.testing.assert_array_equal(syn.numpy(), np.asarray(jsyn))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    noise, _ = init_synthetic_raw(torch.Generator().manual_seed(0), pst, 2, 1,
                                  "noise", device="cpu")
    assert noise.shape == (NC * 2, 1, IM, IM, 3)


def test_get_loops_has_no_row_for_two():
    assert dc.get_loops(10) == jdc.get_loops(10) == (10, 50)
    for get_loops in (dc.get_loops, jdc.get_loops):
        with pytest.raises(ValueError,
                           match="loop hyper-parameters not defined for 2 ipc"):
            get_loops(2)


def _dc_case(model, ipc, batch_real=B, seed=0):
    """JAX step functions and the port's trainer on one store, with a JAX
    net and synthetic images drawn from a seed."""
    jst, pst = _stores()
    outer, inner = dc.get_loops(ipc)
    jfns = jdc._build_dc_step(model, 3, NC, (IM, IM), ipc, batch_real, 0.1,
                              0.01, inner, "ours")
    trainer = dc.make_dc_trainer(pst, model, ipc, batch_real, 0.1, 0.01,
                                 device="cpu")
    rng = np.random.default_rng(seed)
    syn = rng.normal(size=(NC * ipc, IM, IM, 3)).astype(np.float32)
    mom = rng.normal(size=syn.shape).astype(np.float32) * 0.1
    labels = np.repeat(np.arange(NC), ipc).astype(np.int32)
    return jst, jfns, trainer, syn, mom, labels


def test_match_step_matches_jax():
    jst, (init_fn, match_fn, _), trainer, syn, mom, _ = _dc_case("ConvNet", 1)
    params, _ = init_fn(jax.random.PRNGKey(7), jnp.asarray(syn[:1]))
    idx = jst.sample_per_class(np.random.default_rng(1), B)
    meta = jst.meta
    jsyn, jmom, jloss = match_fn(
        params, jnp.asarray(syn), None, jnp.asarray(mom),
        jnp.asarray(jst.clips), jnp.asarray(idx),
        jnp.asarray(meta.mean, jnp.float32) * 255.0,
        jnp.asarray(meta.std, jnp.float32) * 255.0)
    p = port_params(trainer.model, params)
    psyn, pmom, ploss = trainer.match_step(p, torch.from_numpy(syn),
                                           torch.from_numpy(mom),
                                           torch.from_numpy(idx))
    close(float(ploss), float(jloss), 1e-5)
    close(pmom.numpy(), jmom, 1e-4)
    close(psyn.numpy(), jsyn, 1e-4)
    assert not np.allclose(psyn.numpy(), syn)


def _perturbed(params, eps=1e-7):
    """``params`` times (1 + eps N(0, 1)), elementwise: a perturbation of
    fp32 rounding's size (2^-23 = 1.2e-7)."""
    flat, unravel = ravel_pytree(params)
    noise = np.random.default_rng(0).normal(size=flat.shape).astype(np.float32)
    return unravel(flat * (1 + eps * noise))


def _rel_norm(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))


def within_own_spread(port, ref, own, factor=3.0):
    """Each port value no farther from the JAX value (relative norm) than
    ``factor`` times the JAX run from a perturbed net is."""
    for name, a in port.items():
        got, yard = _rel_norm(a, ref[name]), _rel_norm(own[name], ref[name])
        assert 0 < yard and got <= factor * yard, \
            f"{name}: {got} > {factor} x {yard}"


def test_inner_train_matches_jax():
    """50 SGD steps of a width-8 net, which are chaotic: the JAX run from a
    net perturbed by 1e-7 relative moves 7e-4 of the largest parameter
    away. The port's parameters and momentum (flat vectors) must be within
    3x of that run's distance from JAX's (measured: 0.4x)."""
    _, (init_fn, _, inner_fn), trainer, syn, _, labels = _dc_case(NARROW, 10)
    params, _ = init_fn(jax.random.PRNGKey(8), jnp.asarray(syn[:1]))
    p = port_params(trainer.model, params)
    zeros = lambda t: jax.tree.map(jnp.zeros_like, t)
    x, y = jnp.asarray(syn), jnp.asarray(labels)
    own = inner_fn(_perturbed(params), zeros(params), x, y)
    ref = inner_fn(params, zeros(params), x, y)  # donates params
    pp, pm = trainer.inner_train(p, {k: torch.zeros_like(v) for k, v in p.items()},
                                 torch.from_numpy(syn),
                                 torch.from_numpy(labels).long())
    flat = lambda t: {"params": ravel_pytree(t[0])[0],
                      "momentum": ravel_pytree(t[1])[0]}
    within_own_spread({"params": to_jax_flat(pp, trainer.model),
                       "momentum": to_jax_flat(pm, trainer.model)},
                      flat(ref), flat(own))


def _jax_iteration(jst, ipc, key, syn, mom, labels, net=None):
    """The JAX trainer's iteration; ``net`` replaces its fresh net."""
    build = jdc._build_dc_step
    with pytest.MonkeyPatch.context() as mp:
        if net is not None:
            def with_net(*args):
                _, match_fn, inner_fn = build(*args)
                return ((lambda k, x: (net, jax.tree.map(jnp.zeros_like, net))),
                        match_fn, inner_fn)
            mp.setattr(jdc, "_build_dc_step", with_net)
        trainer = jdc.make_dc_trainer(jst, NARROW, ipc, B, 0.1, 0.01)
        out = trainer(key, jnp.asarray(syn), jnp.asarray(labels),
                      jnp.asarray(mom), np.random.default_rng(2))
    return np.asarray(out[0]) - syn, np.asarray(out[1]), out[2]


@pytest.mark.parametrize("ipc", [1, 10])
def test_trainer_iteration_matches_jax(ipc):
    """One DC iteration, the port handed the JAX trainer's fresh net (its
    ``init_fn(fold_in(key, 0))``). At spc=1 (one matching step) within
    1e-4. At spc=10 the iteration is chaotic: the cosine of small gradient
    rows turns the 1e-5 relative difference that fp32 rounding leaves in the
    net after 50 SGD steps into a few percent of the next image gradient.
    So the yardstick there is the JAX iteration's own distance from a run
    whose fresh net is perturbed by 1e-7 relative (fp32 rounding's size):
    the port must be within 3x of it in the image step, the momentum and
    the mean loss (measured: 1.04x, 0.92x and 1.86x)."""
    jst, (init_fn, _, _), trainer, syn, mom, labels = _dc_case(NARROW, ipc)
    key = jax.random.PRNGKey(11)
    params, _ = init_fn(jax.random.fold_in(key, 0), jnp.asarray(syn[:1]))
    trainer.fresh_net = lambda generator: port_params(trainer.model, params)
    psyn, pmom, ploss = trainer(None, torch.from_numpy(syn),
                                torch.from_numpy(labels).long(),
                                torch.from_numpy(mom), np.random.default_rng(2))
    port = (psyn.numpy() - syn, pmom.numpy(), ploss)
    ref = _jax_iteration(jst, ipc, key, syn, mom, labels)
    if ipc == 1:
        close(port[0], ref[0], 1e-4)
        close(port[1], ref[1], 1e-4)
        close(port[2], ref[2], 1e-5)
        return
    own = _jax_iteration(jst, ipc, key, syn, mom, labels, _perturbed(params))
    names = ("image step", "momentum", "loss")
    within_own_spread(dict(zip(names, port)), dict(zip(names, ref)),
                      dict(zip(names, own)))


def test_fresh_net_is_a_function_of_the_generator():
    _, pst = _stores()
    trainer = dc.make_dc_trainer(pst, "ConvNet", 1, B, 0.1, 0.01, device="cpu")
    a, b, c = (trainer.fresh_net(torch.Generator().manual_seed(s))
               for s in (4, 4, 5))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a["convs.0.weight"], c["convs.0.weight"])
    assert torch.equal(a["norms.0.weight"], torch.ones(128))


def test_static_driver_feeds_the_s2d_driver(tmp_path):
    """Static learning on the CPU at toy size writes
    static_<dataset>_spc10.npy; the S2D driver (the s2d_MTT_ms_5 preset,
    spc=10) takes one outer step with it as the frozen static. S2D draws
    two static slots per video (``distill_slots``), so it needs spc >= 2,
    and ``get_loops`` has no row for 2: spc=10 is the pair that runs."""
    from video_distillation_torch.distill.mtt import (TrajectoryBuffer,
                                                      flat_param_template)
    from video_distillation_torch.drivers import distill_static
    from video_distillation_torch.drivers.common import (load_data,
                                                         parse_config_args)
    from video_distillation_torch.drivers.distill_s2d import run
    from video_distillation_torch.utils.logging import MetricLogger

    ds, f, im = "synthetic_c3_n10_t1_f8_im64", 8, 64
    path = distill_static.main([
        "--dataset", ds, "--model", NARROW, "--spc", "10", "--batch_real",
        "2", "--Iteration", "0", "--save_path", str(tmp_path / "static"),
        "--device", "cpu"], logger=MetricLogger(quiet=True))
    assert path == str(tmp_path / "static" / f"static_{ds}_spc10.npy")
    static = np.load(path)
    assert static.shape == (30, im, im, 3) and static.dtype == np.float32
    assert np.isfinite(static).all()

    thetas = [flat_param_template("ConvNet3D", 3, 3, (im, im), f,
                                  torch.Generator().manual_seed(s), "cpu")[1]
              for s in (0, 1)]
    TrajectoryBuffer(torch.stack(thetas).numpy()[None]).save(
        str(tmp_path / "replay_buffer_0.npz"))
    cfg = parse_config_args("s2d", [
        "--dataset", ds, "--path_static", path, "--buffer_path",
        str(tmp_path), "--save_path", str(tmp_path / "out"), "--syn_steps",
        "2", "--Iteration", "0", "--max_start_epoch", "1", "--startIt", "1",
        "--device", "cpu"], default_preset="s2d_MTT_ms_5")
    cfg.s2d = True
    seen = []
    holder = run(cfg, load_data(cfg), MetricLogger(quiet=True),
                 step_hook=lambda it, out: seen.append(float(out[4])))
    assert len(seen) == 1 and np.isfinite(seen[0])
    np.testing.assert_array_equal(holder["state"]["static"].numpy(), static)
