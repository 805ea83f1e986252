"""One DC trainer iteration of the port against the JAX package's, on the
CPU in fp32 (split from ``test_torch_dc.py``, whose helpers it uses, so
that the tier-1 run's file-by-file workers take it apart from the rest).

At spc=1 (one matching step) within 1e-4 (loss 1e-5). At spc=10 (10
matching steps and 9 x 50 SGD steps of a width-8 net) the iteration is
chaotic, and the yardstick is the JAX iteration's own distance from a run
whose fresh net is perturbed by 1e-7 relative: the port within 3x of it.

torch runs on one thread here (``tests/torch_threads.py``): the iteration is
hundreds of small ops, which torch's intra-op threads in six worker
processes at once run hundreds of times slower.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_distillation_tpu.distill import dc as jdc

from test_torch_dc import (B, NARROW, _dc_case, _perturbed, close,
                           port_params, within_own_spread)
from torch_threads import one_torch_thread  # noqa: F401


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
