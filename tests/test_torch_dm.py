"""The port's Distribution Matching (``distill/dm.py``) against the JAX
package's ``distill/dm.py``, on the CPU in fp32, at the shapes of
``tests/test_torch_mtt.py`` (3 classes, 64x64x8, ConvNet3D).

Every net is a JAX init carried across with ``from_jax_params``: the JAX
trainer's own ``init(fold_in(key, 0))`` net is handed to the port's
trainer (its ``fresh_net``); the real clips come from numpy generators of
the same seed, drawn in the JAX order; S2D-DM's slot bits are reproduced
from the step's key. Tolerances:

* ``standardize``: bit-equal to the JAX ``_standardize`` in fp32 and in
  bf16 (the same operations, each rounded once);
* the chunked real embed: equal to the one-piece embed within 1e-6 of the
  largest |feature| (the same per-clip convolutions, batched differently);
* one raw DM step and one S2D-DM step: loss within 1e-5 relative; the
  gradients (the momenta after one step from zero) and the updated images,
  dynamic memory and hallucinator within 1e-5 relative norm (fp32
  convolutions and sums in other orders); the frozen static is not
  updated;
* the first-stage kernels' wrappers run their plain versions here; one DM
  step calls each as often as its kernel launches on the card: pack and
  phase_argmax once per synthetic embed and once per real chunk, scatter
  and unpack once (the backward into the synthetic set), select never;
  S2D-DM also calls each hallucinator kernel's wrapper once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_distillation_tpu.data import \
    make_synthetic_video_data as jax_synthetic
from video_distillation_tpu.distill import dm as jdm
from video_distillation_tpu.distill.s2d import S2DConfig as JaxS2DConfig
from video_distillation_tpu.distill.s2d import init_s2d_state as jax_init
from video_distillation_tpu.models.registry import create_model as jax_create
from video_distillation_torch.data.synthetic import make_synthetic_video_data
from video_distillation_torch.distill import dm
from video_distillation_torch.distill.params import from_jax_params
from video_distillation_torch.distill.s2d import S2DConfig, init_s2d_momentum
from video_distillation_torch.models.hallucinator import Hallucinator
from torch_threads import one_torch_thread  # noqa: F401

NC, F, IM, BR = 3, 8, 64, 4
MEAN = np.array([0.485, 0.456, 0.406], np.float32) * 255.0
STD = np.array([0.229, 0.224, 0.225], np.float32) * 255.0


def rel_norm(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(a - ref) / np.linalg.norm(ref)


@pytest.fixture(scope="module")
def stores():
    kw = dict(num_classes=NC, clips_per_class=6, test_per_class=1, frames=F,
              im_size=(IM, IM), name="dm-parity")
    return jax_synthetic(**kw).train, make_synthetic_video_data(**kw).train


def jax_net(key, sample):
    """The JAX trainers' fresh net: ``init`` at ``fold_in(key, 0)``
    (dm.py:91-94), or its first split for S2D-DM (dm.py:200)."""
    model_def = jax_create("ConvNet3D", 3, NC, (IM, IM), F)
    return model_def.init({"params": key, "dropout": key}, sample,
                          train=False)["params"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_standardize_is_bit_equal_to_jax(dtype):
    u8 = np.random.default_rng(0).integers(0, 256, (2, 3, 5, 7, 3), np.uint8)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    ref = jdm._standardize(jnp.asarray(u8), jnp.asarray(MEAN),
                           jnp.asarray(STD), jdt)
    out = dm.standardize(torch.from_numpy(u8), torch.from_numpy(MEAN),
                         torch.from_numpy(STD), getattr(torch, dtype))
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref).astype(np.float32))


def test_chunked_real_embed_equals_one_piece(stores):
    _, pst = stores
    tr = dm.make_dm_trainer(pst, "ConvNet3D", 1, BR, 1.0, F, device="cpu")
    params = tr.fresh_net(torch.Generator().manual_seed(0))
    idx = torch.from_numpy(pst.sample_per_class(np.random.default_rng(0), BR))
    args = (tr.model, params, pst, tr.clips, idx.reshape(-1), tr.norm_mean,
            tr.norm_std, torch.float32)
    whole = dm.real_features(*args, chunk=NC * BR)
    for chunk in (1, 5):
        part = dm.real_features(*args, chunk=chunk)
        err = float((part - whole).abs().max())
        assert err <= 1e-6 * float(whole.abs().max()), (chunk, err)
    # the trainer's features by class: its chunks of REAL_CHUNK, one here
    torch.testing.assert_close(tr.real_feats(params, idx),
                               whole.view(NC, BR, -1), rtol=0, atol=0)


def test_dm_step_matches_jax(stores):
    jst, pst = stores
    key = jax.random.PRNGKey(3)
    rng = np.random.default_rng(1)
    syn = rng.normal(size=(NC, F, IM, IM, 3)).astype(np.float32)
    labels = np.arange(NC, dtype=np.int32)
    params = jax_net(jax.random.fold_in(key, 0), jnp.asarray(syn[:1]))

    jtr = jdm.make_dm_trainer(jst, "ConvNet3D", 1, BR, 1.0, F)
    jstate, jloss = jtr(key, jdm.DMState(jnp.asarray(syn), jnp.asarray(labels),
                                         jnp.zeros(syn.shape)),
                        np.random.default_rng(2))

    tr = dm.make_dm_trainer(pst, "ConvNet3D", 1, BR, 1.0, F, device="cpu")
    tr.fresh_net = lambda generator: from_jax_params(tr.model, params)
    state, loss = tr(None, dm.DMState(torch.from_numpy(syn),
                                      torch.from_numpy(labels).long(),
                                      torch.zeros(syn.shape)),
                     np.random.default_rng(2))
    assert abs(float(loss) / float(jloss) - 1) <= 1e-5
    assert rel_norm(state.momentum, jstate.momentum) <= 1e-5
    assert rel_norm(state.syn_images, jstate.syn_images) <= 1e-5
    assert float(state.momentum.abs().max()) > 0


def _jax_slot_bits(key, n):
    """The S2D-DM draws: split(fold_in(key, 0))[1] -> split -> randint
    (dm.py:200, s2d.py:93-97)."""
    _, k_slots = jax.random.split(jax.random.fold_in(key, 0))
    k1, k2 = jax.random.split(k_slots)
    return (np.array(jax.random.randint(k1, (n,), 0, 2)),
            np.array(jax.random.randint(k2, (n,), 0, 2)))


LRS = dict(lr_static=100.0, lr_dynamic=0.01, lr_hal=0.01)


def test_s2d_dm_step_matches_jax(stores):
    jst, pst = stores
    key = jax.random.PRNGKey(4)
    jcfg = JaxS2DConfig(num_classes=NC, frames=F, im_size=(IM, IM))
    jstate = jax_init(jax.random.PRNGKey(0), jcfg)
    k_init, _ = jax.random.split(jax.random.fold_in(key, 0))
    params = jax_net(k_init, jnp.zeros((1, F, IM, IM, 3)))

    jtr = jdm.make_s2d_dm_trainer(jst, "ConvNet3D", jcfg, BR, *LRS.values(),
                                  False, F)
    # the JAX step donates its state: hand it a copy
    j_state, j_moms, j_loss = jtr(key, jax.tree.map(jnp.copy, jstate),
                                  jdm.init_s2d_momentum(jstate),
                                  np.random.default_rng(2))

    tstate = {"static": torch.tensor(np.asarray(jstate["static"])),
              "dynamic": torch.tensor(np.asarray(jstate["dynamic"])),
              "hals": [from_jax_params(Hallucinator(), p)
                       for p in jstate["hals"]]}
    tr = dm.make_s2d_dm_trainer(
        pst, "ConvNet3D", S2DConfig(num_classes=NC, frames=F, im_size=(IM, IM)),
        BR, *LRS.values(), False, F, device="cpu")
    tr.fresh_net = lambda generator: from_jax_params(tr.model, params)
    t_state, t_moms, t_loss = tr(None, tstate, init_s2d_momentum(tstate),
                                 np.random.default_rng(2),
                                 draws=_jax_slot_bits(key, NC))

    assert abs(float(t_loss) / float(j_loss) - 1) <= 1e-5
    assert rel_norm(t_moms["dynamic"], j_moms["dynamic"]) <= 1e-5
    assert rel_norm(t_state["dynamic"], j_state["dynamic"]) <= 1e-5
    assert not torch.equal(t_state["dynamic"], tstate["dynamic"])
    jhal_mom = from_jax_params(Hallucinator(), j_moms["hals"][0])
    jhal_new = from_jax_params(Hallucinator(), j_state["hals"][0])
    for k in ("weight", "bias"):
        assert rel_norm(t_moms["hals"][0][k], jhal_mom[k]) <= 1e-5, k
        assert rel_norm(t_state["hals"][0][k], jhal_new[k]) <= 1e-5, k
    # the frozen static: neither updated nor given a momentum
    assert t_state["static"] is tstate["static"]
    np.testing.assert_array_equal(np.asarray(j_state["static"]),
                                  tstate["static"].numpy())
    assert not t_moms["static"].any()


def _count_calls(monkeypatch):
    """Calls of each first-stage wrapper's plain version and of each
    hallucinator kernel's wrapper: what runs on the CPU, once per kernel
    launch on the card."""
    from video_distillation_torch.ops import hal_conv, phase_trio, s2d2_move
    counts = {}
    targets = [(s2d2_move, "pack_plain", "pack"),
               (s2d2_move, "unpack_plain", "unpack"),
               (phase_trio, "phase_argmax_plain", "phase_argmax"),
               (phase_trio, "phase_select_plain", "phase_select"),
               (phase_trio, "phase_scatter_plain", "phase_scatter"),
               (hal_conv, "hal_fwd", "hal_fwd"),
               (hal_conv, "hal_dgrad", "hal_dgrad"),
               (hal_conv, "hal_wgrad", "hal_wgrad")]
    for mod, attr, key in targets:
        counts[key] = 0
        fn = getattr(mod, attr)

        def counted(*args, _fn=fn, _key=key):
            counts[_key] += 1
            return _fn(*args)

        monkeypatch.setattr(mod, attr, counted)
    return counts


@pytest.mark.parametrize("s2d", [False, True], ids=["raw", "s2d"])
def test_first_stage_calls_per_dm_step(stores, monkeypatch, s2d):
    _, pst = stores
    monkeypatch.setattr(dm, "REAL_CHUNK", 5)  # 12 real clips: 3 chunks
    chunks = -(-NC * BR // 5)
    gen = torch.Generator().manual_seed(0)
    if s2d:
        cfg = S2DConfig(num_classes=NC, frames=F, im_size=(IM, IM))
        from video_distillation_torch.distill.s2d import init_s2d_state
        state = init_s2d_state(gen, cfg)
        tr = dm.make_s2d_dm_trainer(pst, "ConvNet3D", cfg, BR, *LRS.values(),
                                    False, F, device="cpu")
        counts = _count_calls(monkeypatch)
        tr(gen, state, init_s2d_momentum(state), np.random.default_rng(0))
    else:
        tr = dm.make_dm_trainer(pst, "ConvNet3D", 1, BR, 1.0, F, device="cpu")
        syn = torch.randn(NC, F, IM, IM, 3, generator=gen)
        counts = _count_calls(monkeypatch)
        tr(gen, dm.DMState(syn, torch.arange(NC), torch.zeros_like(syn)),
           np.random.default_rng(0))
    hal = int(s2d)
    assert counts == {"pack": 1 + chunks, "phase_argmax": 1 + chunks,
                      "phase_scatter": 1, "unpack": 1, "phase_select": 0,
                      "hal_fwd": hal, "hal_dgrad": hal, "hal_wgrad": hal}


def test_shard_store_at_world_size_one_equals_the_replicated_store(stores):
    # without a process group the "sharded" store is the whole store on the
    # device, and a DM step with it is the replicated step bit for bit
    _, pst = stores
    whole = pst.device_clips("cpu")
    assert torch.equal(pst.device_clips("cpu", sharded=True), whole)
    syn = torch.from_numpy(np.random.default_rng(1).normal(
        size=(NC, F, IM, IM, 3)).astype(np.float32))
    out = []
    for shard in (False, True):
        tr = dm.make_dm_trainer(pst, "ConvNet3D", 1, BR, 1.0, F,
                                shard_store=shard, device="cpu")
        state, loss = tr(torch.Generator().manual_seed(0),
                         dm.DMState(syn, torch.arange(NC), torch.zeros_like(syn)),
                         np.random.default_rng(2))
        out.append((state.syn_images, loss))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1],
                                                              out[1][1])


def test_init_synthetic_raw_defaults_to_the_card():
    """An entry point runs on the card unless the caller asks for the CPU."""
    import inspect
    sig = inspect.signature(dm.init_synthetic_raw)
    assert sig.parameters["device"].default == "cuda"
