"""The port's coreset driver on an image store (3 classes, 32x32x3,
``from_arrays`` -> ``save_packed`` -> ``load_data``) against the JAX
driver, on the CPU in fp32: k-center, ipc 2, ``--eval_mode M`` with 2 nets
of 1 epoch for every net of the pool 'M'.

The port's selection net is the JAX driver's (its ``init`` from
``--seed``), so the chosen images must be the JAX driver's, byte for byte.
Each evaluation gets the JAX run's draws (initial θ and permutations from
the net's key, evaluate.py:198-218): trained θ within 1e-4 relative norm,
train and test accuracies exactly. Most of this file's time is the JAX
driver's compiles: each net's training and test functions, the selection
net, and each net's ``init`` for the draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.flatten_util import ravel_pytree

from video_distillation_tpu.distill import evaluate as jeval
from video_distillation_tpu.drivers import distill_coreset as jdriver
from video_distillation_tpu.models.registry import create_model as jax_create
from video_distillation_torch.distill import evaluate as teval
from video_distillation_torch.distill.params import from_jax_params
from video_distillation_torch.drivers import distill_coreset
from video_distillation_torch.models.registry import create_model
from video_distillation_torch.utils.logging import MetricLogger

from torch_threads import one_torch_thread  # noqa: F401
from test_torch_image_data import NC, IM, TINY
from test_torch_image_path import POOL_M, rel_norm, store  # noqa: F401


def _jax_draws(keys, model, syn, epochs):
    """The initial θ and permutations of JAX evaluation runs
    (evaluate.py:198-218), one from each key (the init jitted once)."""
    jm = jax_create(model, 3, NC, (IM, IM), 1)
    init = jax.jit(lambda k: ravel_pytree(jm.init(
        {"params": k, "dropout": k}, jnp.asarray(syn[:1]),
        train=False)["params"])[0])
    draws = []
    for key in keys:
        k_init, k_perm, _, _ = jax.random.split(key, 4)
        perms = jax.vmap(lambda k: jax.random.permutation(k, len(syn)))(
            jax.random.split(k_perm, epochs))
        draws.append(teval.EvalDraws(np.asarray(init(k_init)),
                                     np.asarray(perms)))
    return draws


@pytest.fixture(scope="module")
def coreset_runs(store):
    """The JAX and the port's coreset drivers on the store, each
    evaluation's results recorded."""
    data_path, _, _ = store
    argv = ["--dataset", TINY, "--data_path", data_path, "--model", "ConvNet",
            "--ipc", "2", "--eval_mode", "M", "--num_eval", "2",
            "--epoch_eval_train", "1", "--seed", "0"]
    seen = {"jax": {}, "port": {}}
    with pytest.MonkeyPatch.context() as mp:
        saved_select = jdriver.select_coreset

        def jax_select_wrapped(*args, **kwargs):
            seen["jax_syn"] = saved_select(*args, **kwargs)
            return seen["jax_syn"]

        def jax_evaluate(key, num_eval, syn, labels, data, ecfg, test_rng):
            out = jeval.evaluate_many(key, num_eval, syn, labels, data, ecfg,
                                      test_rng)
            seen["jax"][ecfg.model] = out[0]
            return out

        mp.setattr(jdriver, "select_coreset", jax_select_wrapped)
        mp.setattr(jdriver, "evaluate_many", jax_evaluate)
        mp.setattr(jdriver, "MetricLogger",
                   lambda **kw: MetricLogger(quiet=True))
        jdriver.main(argv)

    # the JAX selection net: init from PRNGKey(seed) on a (1, 16, H, W, C)
    # sample (coreset.py:71-75; the head it makes is unused by 'feat')
    key = jax.random.PRNGKey(0)
    jnet = jax_create("ConvNet", 3, NC, (IM, IM), 16).init(
        {"params": key, "dropout": key}, jnp.zeros((1, 16, IM, IM, 3)),
        train=False)["params"]
    jnet = dict(jnet, TorchDense_0={"Dense_0": {
        "kernel": np.zeros((128 * (IM // 8) ** 2, NC), np.float32),
        "bias": np.zeros(NC, np.float32)}})
    syn_j = np.asarray(seen["jax_syn"][0])
    saved = (distill_coreset.select_coreset, distill_coreset.evaluate_many)

    def port_select(generator, train, model, *args, **kwargs):
        net = create_model(model, 3, NC, (IM, IM), 1, device="cpu")
        return saved[0](generator, train, model, *args,
                        params=from_jax_params(net, jnet), **kwargs)

    def port_evaluate(gen, num_eval, syn, labels, data, ecfg, test_rng):
        draws = _jax_draws([jax.random.fold_in(key, i)
                            for i in range(num_eval)], ecfg.model, syn_j,
                           ecfg.epoch_eval_train + 1)
        out = saved[1](gen, num_eval, syn, labels, data, ecfg, test_rng,
                       draws=draws)
        seen["port"][ecfg.model] = out[0]
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(distill_coreset, "select_coreset", port_select)
        mp.setattr(distill_coreset, "evaluate_many", port_evaluate)
        syn, labels, accs = distill_coreset.main(
            argv + ["--device", "cpu"], logger=MetricLogger(quiet=True))
    return seen, syn_j, syn, labels, accs


def test_coreset_driver_selects_the_jax_images(coreset_runs):
    seen, syn_j, syn, labels, accs = coreset_runs
    assert syn.shape == syn_j.shape == (NC * 2, IM, IM, 3)
    np.testing.assert_array_equal(syn.numpy(), syn_j)
    assert labels.tolist() == np.asarray(seen["jax_syn"][1]).tolist()
    assert sorted(accs) == sorted(POOL_M)


@pytest.mark.parametrize("model", POOL_M)
def test_coreset_driver_evaluations_match_jax(coreset_runs, model):
    seen = coreset_runs[0]
    for got, ref in zip(seen["port"][model], seen["jax"][model]):
        assert rel_norm(got.params.numpy(),
                        ravel_pytree(ref.params)[0]) <= 1e-4
        assert got.acc_train == pytest.approx(ref.acc_train, abs=1e-9)
        assert got.top1 == pytest.approx(ref.top1, abs=1e-9)
        assert got.top5 == pytest.approx(ref.top5, abs=1e-9)
