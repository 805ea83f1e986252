"""Every path's step under data parallelism (``parallel/dist.py``), on
spawned CPU ranks of a gloo group, at the port tests' sizes (3 classes,
64x64x8, ConvNet3D, two inner steps).

* Against the port at world size 1, in fp64: at world size 2, S2D-MTT
  ('full' and 'remat', on a plan of 3 columns that the ranks pad to 4),
  raw DM (the real embed split over the clips of each class), S2D-DM with
  the clip store row-sharded, a FRePo proto step and a pool step (6
  prototypes, split), and a sequential and a batched evaluation point (a
  raw set and a multi-static set). Each rank's loss, gradients and
  updated state within 1e-10 (relative, norm) of the step run without a
  group, the accuracies equal. ``test_torch_dist.py`` holds raw MTT, an
  expert epoch and S2D-MTT at world size 4 (where the last rank holds only
  padding) the same way.
* Against the JAX package on a mesh of 2 (``make_mesh(2)``, the plan
  sharded by ``pad_and_shard_plan``): an fp32 S2D-MTT step on 2 ranks from
  JAX's state, expert pair, slot draws and dropout mask, at
  ``test_torch_mtt.py``'s tolerances. ``test_torch_dist.py`` holds the
  sharded DM store and a FRePo proto step against JAX on a mesh; the other
  steps' JAX comparisons are their own files' (the port at world size 1
  against JAX on the tests' 8-device mesh), which the first point extends
  to world size n.
* Only rank 0 writes logs, checkpoints, artifacts and PNGs.

The group of ranks and the world-size-1 references (one more process)
work while this process compiles the JAX step.
"""

import dataclasses
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from video_distillation_tpu.distill import mtt as jmtt
from video_distillation_tpu.distill.s2d import S2DConfig as JaxS2DConfig
from video_distillation_tpu.distill.s2d import init_s2d_state as jax_init
from video_distillation_tpu.parallel import make_mesh, pad_and_shard_plan
from video_distillation_tpu.parallel.mesh import get_mesh, set_mesh
from video_distillation_torch.distill.params import from_jax_params
from video_distillation_torch.models.hallucinator import Hallucinator

import torch_dist_ranks as ranks
from test_torch_mtt import _fixed_dropout, _jax_slot_bits, rel_norm
from torch_threads import one_torch_thread  # noqa: F401

NC, F, IM, STEPS = ranks.NC, ranks.F, ranks.IM, ranks.STEPS
FP64 = 1e-10
# a plan of 3 columns: padded to 4 at world sizes 2 and 4
P3 = jmtt.make_batch_plan(np.random.default_rng(1), NC, NC, STEPS)

CHECKS = [
    ("s2d_full", "s2d_mtt", dict(plan=P3)),
    ("s2d_remat", "s2d_mtt", dict(plan=P3, mode="remat")),
    ("dm", "dm_step", dict()),
    ("s2d_dm", "dm_step", dict(s2d=True, shard_store=True)),
    ("frepo", "frepo_step", dict(ppc=2)),
    ("eval_seq", "eval_point", dict(vmap_eval=False,
                                    model="VideoConvNetMean")),
    ("eval_vmap_ms", "eval_point", dict(vmap_eval=True, mode="multi-static",
                                        nets=2, model="VideoConvNetMean")),
]
# remat equals full in fp64 (test_torch_remat.py): world size 1 runs full
REFERENCE = {"s2d_remat": "s2d_full"}


def _jax_s2d_inputs():
    """The JAX S2D-MTT step's inputs on a mesh of 2: its initial state,
    expert pair, a plan of 2 columns (one of them padding in the second
    step), key, slot draws and dropout mask; and the port's."""
    mask = np.random.default_rng(0).random((2, 1, 1, 1, 128)) < 0.5
    jcfg = JaxS2DConfig(num_classes=NC, frames=F, im_size=(IM, IM))
    jstate = jax_init(jax.random.PRNGKey(0), jcfg)
    _, _, th0, _ = jmtt.flat_param_template("ConvNet3D", 3, NC, (IM, IM), F,
                                            seed=0)
    _, _, th1, _ = jmtt.flat_param_template("ConvNet3D", 3, NC, (IM, IM), F,
                                            seed=1)
    plan = jmtt.make_batch_plan(np.random.default_rng(1), NC, 2, STEPS)
    key = jax.random.PRNGKey(2)
    state = {"static": np.asarray(jstate["static"]),
             "dynamic": np.asarray(jstate["dynamic"]),
             "hals": [{k: v.numpy() for k, v in from_jax_params(
                 Hallucinator(), p).items()} for p in jstate["hals"]]}
    port = dict(plan=plan, dtype="float32", mode="full",
                draws=_jax_slot_bits(key, STEPS, 2),
                keep_masks=np.stack([mask] * STEPS),
                inputs=dict(state=state, t0=np.asarray(th0),
                            t1=np.asarray(th1)))
    return dict(jcfg=jcfg, jstate=jstate, th0=th0, th1=th1, plan=plan,
                key=key, mask=mask), port


def _jax_s2d_step(j):
    """The JAX step on a mesh of 2, the plan sharded over it."""
    old = get_mesh()
    set_mesh(make_mesh(2))
    jmtt._build_s2d_mtt_step.cache_clear()
    jmtt._build_mtt_core.cache_clear()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(flax.linen, "Dropout", _fixed_dropout(j["mask"]))
            jstep = jmtt._build_s2d_mtt_step(
                "ConvNet3D", 3, NC, (IM, IM), F, STEPS,
                tuple(sorted(dataclasses.asdict(j["jcfg"]).items())),
                *ranks.LRS.values(), False, True, "float32")
            state = j["jstate"]
            out = jstep(j["key"], jax.tree.map(jnp.copy, state),
                        jnp.asarray(0.01), jax.tree.map(jnp.zeros_like, state),
                        jnp.zeros(()), j["th0"], j["th1"],
                        pad_and_shard_plan(j["plan"]))
            return jax.tree.map(np.asarray, out)
    finally:
        jmtt._build_s2d_mtt_step.cache_clear()
        jmtt._build_mtt_core.cache_clear()
        set_mesh(old)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The groups of 2 and 4 ranks and the world-size-1 references (one
    more process) start at once and work while this process compiles and
    runs the JAX step."""
    jax_in, port_in = _jax_s2d_inputs()
    writes = str(tmp_path_factory.mktemp("writes"))
    groups = [
        ranks.Ranks(1, [c for c in CHECKS if c[0] not in REFERENCE],
                    group=False),
        ranks.Ranks(2, CHECKS + [
            ("s2d_jax", "s2d_mtt", port_in),
            ("writes", "coordinator_writes", dict(root=writes))]),
    ]
    try:
        jax_out = _jax_s2d_step(jax_in)
        world1, world2 = (g.results() for g in groups)
    finally:
        for g in groups:
            g.close()
    return dict(jax=jax_out, world1=world1[0], world2=world2, writes=writes)


@pytest.mark.parametrize("name", [name for name, _, _ in CHECKS])
def test_world_size_two_equals_world_size_one_in_fp64(runs, name):
    ref = runs["world1"][REFERENCE.get(name, name)]
    for r in range(2):
        ranks.assert_close(runs["world2"][r][name], ref, FP64, f"rank {r}")
    assert runs["world2"][0][name]["collectives"]["all_reduce"] > 0


@pytest.mark.parametrize("name", ["s2d_full", "s2d_remat"])
def test_mtt_all_reduces_each_inner_gradient(runs, name):
    """Per outer step: one all-reduce of each inner gradient forward and
    one in the outer backward (remat: two there, its recompute's forward
    and backward), and one of the outer gradients."""
    per = 3 * STEPS + 1 if name == "s2d_remat" else 2 * STEPS + 1
    for r in range(2):
        assert runs["world2"][r][name]["collectives"]["all_reduce"] == per


def test_no_collective_without_a_group(runs):
    for name, res in runs["world1"].items():
        assert not any(res["collectives"].values()), name


def test_sharded_store_holds_its_share_of_rows(runs):
    n_clips = NC * ranks.STORE["clips_per_class"]
    assert runs["world1"]["s2d_dm"]["store_rows"] == n_clips
    for r in range(2):
        assert runs["world2"][r]["s2d_dm"]["store_rows"] == -(-n_clips // 2)


def test_s2d_mtt_on_two_ranks_matches_jax_on_a_mesh_of_two(runs):
    _, _, j_moms, j_mom_lr, j_loss, _, j_pdist = runs["jax"]
    jhal = from_jax_params(Hallucinator(), j_moms["hals"][0])
    for r in range(2):
        t = runs["world2"][r]["s2d_jax"]
        assert abs(t["loss"] / float(j_loss) - 1) <= 1e-5
        assert abs(t["pdist"] / float(j_pdist) - 1) <= 1e-6
        assert rel_norm(t["grad_dynamic"], j_moms["dynamic"]) <= 1e-5
        for k in ("weight", "bias"):
            assert rel_norm(t[f"grad_hal_{k}"], jhal[k].numpy()) <= 1e-5, k
        assert abs(t["grad_syn_lr"] / float(j_mom_lr) - 1) <= 1e-4


def test_only_the_coordinator_writes(runs):
    root = runs["writes"]
    written = {d: sorted(os.listdir(os.path.join(root, d)))
               for d in os.listdir(root)}
    assert written == {"rank0": ["a.npy", "b.npz", "ckpt", "g.png",
                                 "log.jsonl"]}
