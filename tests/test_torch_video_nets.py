"""The port's VideoConvNet family against the JAX package's, on the CPU.

Each head (mean, MLP, LSTM, RNN, GRU) with the JAX model's weights carried
across (``from_jax_params``): logits and features within 1e-5 of the
largest |value| (fp32 convolutions and recurrences summed in other
orders; measured 3e-7 to 1.5e-6), the flat vector bit-equal to JAX's
``ravel_pytree``, and gradients within 1e-5 of fp64 (and 1e-3 of JAX's,
whose norms round more; ``test_gradients_match_flax``). 3 classes, 8 frames at 16x16,
what the evaluation's 24:-24 crop leaves of 64x64 clips.

Then VideoConvNetLSTM through two paths against JAX: one evaluation
(``evaluate_synset`` on a raw set of 64x64x8 clips, 2 epochs, the JAX
run's draws; θ within 1e-4 relative norm, accuracies exactly, as
``test_torch_evaluate.py``) and one raw MTT outer step to second order
(16x16x8 clips, syn_steps=2; the loss within 1e-5 relative and the
images' gradient within 1e-4 relative norm). The recurrences are plain
tensor ops, so ``create_graph`` differentiates them twice.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from video_distillation_tpu.data.synthetic import \
    make_synthetic_video_data as jax_synthetic
from video_distillation_tpu.distill import evaluate as jeval
from video_distillation_tpu.distill import mtt as jmtt
from video_distillation_tpu.models import registry as jreg
from video_distillation_torch.data.synthetic import \
    make_synthetic_video_data as torch_synthetic
from video_distillation_torch.distill import evaluate as teval
from video_distillation_torch.distill import mtt as tmtt
from video_distillation_torch.distill.params import (from_jax_params,
                                                     layout_for, to_jax_flat)
from video_distillation_torch.models import registry as treg

from test_torch_evaluate import DATA, _jax_draws
from test_torch_mtt import rel_norm

NC, F, S = 3, 8, 16  # S: the cropped side
HEADS = ["Mean", "MLP", "LSTM", "RNN", "GRU"]


def close(a, ref, rel=1e-5):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape
    err, scale = np.abs(a - ref).max(), np.abs(ref).max()
    assert err <= rel * scale, f"max error {err} > {rel} * {scale}"


@pytest.fixture(scope="module", params=HEADS)
def pair(request):
    name = "VideoConvNet" + request.param
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, F, S, S, 3)).astype(np.float32)
    jm = jreg.create_model(name, 3, NC, (S, S), F)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False)["params"]
    tm = treg.create_model(name, 3, NC, (S, S), F, device="cpu")
    tm.load_state_dict(from_jax_params(tm, params))
    return jm, params, tm, x


def test_flat_vector_is_jax_ravel_order(pair):
    _, params, tm, _ = pair
    flat = np.asarray(ravel_pytree(params)[0])
    assert layout_for(tm).size == flat.size == sum(
        p.numel() for p in tm.parameters())
    np.testing.assert_array_equal(to_jax_flat(tm), flat)


@pytest.mark.parametrize("output", ["logits", "feat"])
def test_outputs_match_flax(pair, output):
    jm, params, tm, x = pair
    ref = jm.apply({"params": params}, jnp.asarray(x), train=True,
                   output=output)
    close(tm(torch.from_numpy(x), output=output).detach(), ref)


def _port_grads(tm, x, cot, dtype):
    model = copy.deepcopy(tm).to(dtype)
    layout = layout_for(model)
    theta = layout.flatten(dict(model.named_parameters())).detach() \
        .requires_grad_(True)
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    out = torch.func.functional_call(model, layout.unflatten(theta), (xt,))
    return [g.numpy() for g in torch.autograd.grad(
        (out * torch.from_numpy(cot).to(dtype)).sum(), (theta, xt))]


def test_gradients_match_flax(pair):
    """At 2x2 the last norms' one-pass variance (flax's GroupNorm) costs
    JAX's gradients 5e-5 to 1.7e-3 relative norm against fp64 (measured;
    5e-7 at 32x32), where the port's are within 3e-7: the port is held to
    the fp64 gradients at 1e-5, and to JAX's within JAX's own distance from
    fp64 (at most 5e-3) plus 1e-5."""
    jm, params, tm, x = pair
    cot = np.random.default_rng(1).normal(size=(2, NC)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx) * cot)

    gp, gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    g_theta, g_x = _port_grads(tm, x, cot, torch.float32)
    r_theta, r_x = _port_grads(tm, x, cot, torch.float64)
    assert rel_norm(g_theta, r_theta) <= 1e-5
    assert rel_norm(g_x, r_x) <= 1e-5
    for got, ref, jax_g in ((g_theta, r_theta, ravel_pytree(gp)[0]),
                            (g_x, r_x, gx)):
        jax_err = rel_norm(jax_g, ref)
        assert jax_err <= 5e-3
        assert rel_norm(got, jax_g) <= jax_err + 1e-5


def test_registry_builds_the_family():
    assert treg.is_video_model("VideoConvNetGRU") and treg.is_video_model("ConvNet3D")
    assert not treg.is_video_model("ConvNet")
    with pytest.raises(ValueError, match="unknown model"):
        treg.create_model("VideoConvNetTCN", 3, NC, (S, S), F)
    m = treg.create_model("VideoConvNetRNN", 3, NC, (S, S), F)
    # hidden D // 8 for RNN and GRU, D for the LSTM (D = 128 * 2 * 2)
    assert m.recurrent.weight_hh.shape == (64, 64)
    assert treg.create_model("VideoConvNetLSTM", 3, NC, (S, S), F) \
        .recurrent.weight_hh.shape == (2048, 512)


def test_lstm_evaluation_matches_jax():
    rng = np.random.default_rng(2)
    syn = rng.normal(size=(2 * NC, F, 64, 64, 3)).astype(np.float32)
    labels = np.repeat(np.arange(NC), 2).astype(np.int64)
    kw = dict(model="VideoConvNetLSTM", epoch_eval_train=1, lr_net=0.01,
              batch_train=4)
    jdata, tdata = jax_synthetic(**DATA), torch_synthetic(**DATA)
    key = jax.random.PRNGKey(3)
    jcfg = jeval.EvalConfig(**kw)
    jeval._build_train_fn_cached.cache_clear()
    ref = jeval.evaluate_synset(key, jnp.asarray(syn), jnp.asarray(labels),
                                jdata, jcfg, np.random.default_rng(5))
    jeval._build_train_fn_cached.cache_clear()
    draws = _jax_draws(key, len(syn), jcfg)[0]
    got = teval.evaluate_synset(None, torch.from_numpy(syn),
                                torch.from_numpy(labels), tdata,
                                teval.EvalConfig(**kw),
                                np.random.default_rng(5), draws=draws)
    assert rel_norm(got.params.numpy(), ravel_pytree(ref.params)[0]) <= 1e-4
    assert rel_norm(got.params.numpy(), draws.theta) > 1e-4  # it trained
    assert got.acc_train == ref.acc_train
    assert (got.top1, got.top3, got.top5) == (ref.top1, ref.top3, ref.top5)
    np.testing.assert_array_equal(got.acc_per_class, ref.acc_per_class)


def test_lstm_raw_mtt_step_matches_jax():
    steps = 2
    rng = np.random.default_rng(0)
    syn = rng.normal(size=(NC, F, S, S, 3)).astype(np.float32)
    labels = np.arange(NC, dtype=np.int32)
    th0, th1 = (np.asarray(jmtt.flat_param_template(
        "VideoConvNetLSTM", 3, NC, (S, S), F, seed=s)[2]) for s in (0, 1))
    plan = jmtt.make_batch_plan(np.random.default_rng(1), NC, NC, steps)
    lr_img, lr_lr, syn_lr, mom_lr = 100.0, 1e-5, 0.01, 0.0
    jmtt._build_mtt_step.cache_clear()
    jstep = jmtt._build_mtt_step("VideoConvNetLSTM", 3, NC, (S, S), F, steps,
                                 lr_img, lr_lr, True, "float32")
    _, _, j_mom, _, j_loss, _, _ = jstep(
        jax.random.PRNGKey(2), jnp.asarray(syn), jnp.asarray(labels),
        jnp.asarray(syn_lr), jnp.zeros(syn.shape), jnp.asarray(mom_lr),
        jnp.asarray(th0), jnp.asarray(th1), jnp.asarray(plan))
    jmtt._build_mtt_step.cache_clear()
    step = tmtt.MTTStep("VideoConvNetLSTM", 3, NC, (S, S), F, steps, lr_img,
                        lr_lr, True, "float32", "cpu")
    out = step(None, torch.from_numpy(syn), torch.from_numpy(labels).long(),
               torch.tensor(syn_lr), torch.zeros(syn.shape),
               torch.tensor(mom_lr), torch.from_numpy(th0),
               torch.from_numpy(th1), torch.from_numpy(plan))
    t_loss, grads = out[4], out[7]
    assert abs(float(t_loss) / float(j_loss) - 1) <= 1e-5
    assert float(np.abs(np.asarray(j_mom)).max()) > 0
    assert rel_norm(grads["images"], j_mom) <= 1e-4
