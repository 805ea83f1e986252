"""The port's data-parallel layer (``video_distillation_torch/parallel``)
on the CPU, with spawned ranks of a gloo group (``torch_dist_ranks``).

* ``pad_and_split_plan`` and ``split_divisible`` against the JAX
  ``pad_and_shard_plan`` and ``shard_divisible`` on meshes of 2 and 4: the
  same -1 padding, the same axis, each rank's share the shard of its
  device.
* ``init_distributed`` without ``torchrun``'s environment: False, world
  size 1, rank 0, the coordinator; ``resolve_device('cpu')`` unchanged.
* The double-count trap: a fp64 3-step inner SGD unroll differentiated to
  second order into lr and θ₀, each of 2 ranks taking half of an 8-sample
  batch, equals world size 1 within 1e-12; the same unroll with the full
  loss on every rank through ``torch.distributed.nn``'s all-reduce does
  not.
* The K400-scale sharded store (the JAX ``test_sharded_store_dm_400_classes``):
  400 classes of 3 images, one ConvNet DM step with the store row-sharded
  over 2 ranks, each holding 600 of the 1200 rows and the real embed split
  over the classes: within 1e-6 of world size 1 (fp32, the same features
  batched otherwise) and within ``test_torch_dm.py``'s 1e-5 of the JAX
  trainer on a mesh of 2 from its net.
* A FRePo proto step on 2 ranks (the real batch split) against the JAX
  trainer on a mesh of 2, from its carry and real batch, at the
  tolerances of ``test_torch_frepo.py``. (Its pool step of 3 prototypes is
  not split at 2 ranks; the split pool step is held against world size 1
  in ``test_torch_dist_steps.py``.)
* An expert epoch on 4 ranks at ``batch_train=10`` equals world size 1 at
  ``batch_train=12`` (fp64, 1e-10): the batch is rounded up to a multiple
  of the ranks, 12, which is the batch the JAX ``train_expert`` builds its
  epoch for on a mesh of 4 (read from its epoch builder's arguments).
* S2D-MTT (fp64) on 4 ranks, a plan of 3 columns: the last rank holds
  only padding; within 1e-10 of world size 1.
* The S2D-MTT driver launched by ``torchrun --nproc_per_node 2`` with
  ``--device cpu`` (one outer step): its logged loss and learned lr within
  1e-5 of the same run without a group, and one log line (only rank 0
  writes).

The ranks, the world-size-1 references (one more process) and the
driver's launch work while this process compiles the JAX steps (three
compiles, with ``test_torch_dist_steps.py``'s S2D-MTT step four).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from video_distillation_tpu.config import BufferConfig as JaxBufferConfig
from video_distillation_tpu.data import \
    make_synthetic_video_data as jax_synthetic
from video_distillation_tpu.data.meta import DatasetMeta, register_meta
from video_distillation_tpu.data.store import ClipStore as JaxClipStore
from video_distillation_tpu.distill import buffer as jbuf
from video_distillation_tpu.distill import dm as jdm
from video_distillation_tpu.models import registry as jreg
from video_distillation_tpu.parallel import (make_mesh, pad_and_shard_plan,
                                             shard_divisible)
from video_distillation_tpu.parallel.mesh import get_mesh, set_mesh
from video_distillation_torch import parallel
from video_distillation_torch.data import meta as tmeta
from video_distillation_torch.distill.mtt import (TrajectoryBuffer,
                                                  flat_param_template)
from video_distillation_torch.utils.device import resolve_device

import torch_dist_ranks as ranks
from test_torch_frepo import (BIG_TOL, GRAD_TOL, LOSS_TOL, TOL, _hal,
                              _jax_run)
from test_torch_mtt import rel_norm
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVE_DATASET = "synthetic_c3_n2_t1_f8_im64"
# a plan of 3 columns (two inner steps): padded to 4 at world sizes 2 and 4
P3 = np.array([[2, 0, 1], [1, 2, 0]], np.int32)
# held at world size 2 against world size 1 in fp64, as the steps of
# test_torch_dist_steps.py are (run here to share the two files' time)
FP64_STEPS = [("raw_mtt", "raw_mtt", dict(plan=P3)),
              ("expert_shard", "expert_epoch",
               dict(batch_train=6, shard_store=True))]


def _as_world(monkeypatch, n, r):
    monkeypatch.setattr(parallel.dist, "world_size", lambda: n)
    monkeypatch.setattr(parallel.dist, "rank", lambda: r)


def _shard_of(arr, device):
    (shard,) = [s for s in arr.addressable_shards if s.device == device]
    return np.asarray(shard.data)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("shape", [(2, 5), (3, 8), (7,)])
def test_pad_and_split_plan_matches_jax(monkeypatch, n, shape):
    plan = np.arange(int(np.prod(shape)), dtype=np.int32).reshape(shape)
    mesh = make_mesh(n)
    ref = pad_and_shard_plan(plan, mesh)
    for r in range(n):
        _as_world(monkeypatch, n, r)
        padded, mine = parallel.pad_and_split_plan(plan)
        np.testing.assert_array_equal(padded, np.asarray(ref))
        np.testing.assert_array_equal(mine, _shard_of(ref, mesh.devices[r]))
        # torch tensors split alike
        _, t_mine = parallel.pad_and_split_plan(torch.from_numpy(plan))
        np.testing.assert_array_equal(t_mine.numpy(), mine)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("shape", [(50, 3), (3, 64), (3, 5), (400, 2)])
def test_split_divisible_matches_jax(monkeypatch, n, shape):
    x = np.arange(int(np.prod(shape)), dtype=np.int32).reshape(shape)
    mesh = make_mesh(n)
    set_mesh_old = get_mesh()
    set_mesh(mesh)
    try:
        ref = shard_divisible(x)
    finally:
        set_mesh(set_mesh_old)
    spec = tuple(ref.sharding.spec) + (None,) * (x.ndim - len(
        ref.sharding.spec))
    want_axis = next((a for a, s in enumerate(spec) if s is not None), None)
    for r in range(n):
        _as_world(monkeypatch, n, r)
        axis, mine = parallel.split_divisible(torch.from_numpy(x))
        assert axis == want_axis
        np.testing.assert_array_equal(mine.numpy(),
                                      _shard_of(ref, mesh.devices[r]))


def test_init_distributed_without_a_launcher_is_world_size_one(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert parallel.init_distributed("cpu") is False
    assert parallel.world_size() == 1 and parallel.rank() == 0
    assert parallel.is_coordinator() and not parallel.active()
    assert resolve_device("cpu") == torch.device("cpu")
    # every helper is the identity without a group
    t = torch.arange(5.0)
    assert parallel.all_reduce_(t) is t and parallel.reduced(t) is t
    assert parallel.split_columns(t) is t and parallel.share(t) is t


def test_mesh_shape_other_than_the_launch_raises():
    parallel.check_mesh_shape((1,))
    parallel.check_mesh_shape(None)
    with pytest.raises(ValueError, match="mesh_shape"):
        parallel.check_mesh_shape((2,))


def _dm400():
    """The JAX 400-class store, syn set and net of
    ``test_sharded_store_dm_400_classes``."""
    kw = dict(name="shard-k400", channel=3, im_size=(16, 16),
              num_classes=400, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
              frames=1)
    register_meta(DatasetMeta(**kw))
    # the port's registry holds it too, as in the ranks: the registries
    # stay equal in this process (tests/test_torch_data.py)
    tmeta.register_meta(tmeta.DatasetMeta(**kw))
    rng = np.random.default_rng(0)
    clips = rng.integers(0, 255, (400 * 3, 16, 16, 3), dtype=np.uint8)
    store = JaxClipStore(clips, np.repeat(np.arange(400), 3),
                         DatasetMeta(**kw))
    syn = np.random.default_rng(3).standard_normal((400, 16, 16, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(0)
    params = jreg.create_model("ConvNet", 3, 400, (16, 16), 1).init(
        {"params": jax.random.fold_in(key, 0),
         "dropout": jax.random.fold_in(key, 0)}, jnp.asarray(syn[:1]),
        train=False)["params"]
    return store, syn, key, np.asarray(ravel_pytree(params)[0])


def _jax_dm400(store, syn, key):
    trainer = jdm.make_dm_trainer(store, "ConvNet", ipc=1, batch_real=2,
                                  lr_img=1.0, frames=1, shard_store=True)
    state = jdm.DMState(jnp.asarray(syn), jnp.arange(400, dtype=jnp.int32),
                        jnp.zeros_like(jnp.asarray(syn)))
    state, loss = trainer(key, state, np.random.default_rng(1))
    return {"loss": float(loss), "images": np.asarray(state.syn_images)}


def _jax_expert_batch(n):
    """The batch the JAX ``train_expert`` builds its epoch for at
    ``batch_train=10`` on a mesh of ``n`` (its builder stopped before it
    compiles)."""
    data = dict(num_classes=4, clips_per_class=4, test_per_class=1, frames=8,
                im_size=(64, 64), seed=1, name="synthetic_buffer_parity")
    seen = {}

    class Stop(Exception):
        pass

    def builder(model, channel, num_classes, im_size, frames, batch, *a):
        seen["batch"] = batch
        raise Stop

    old = get_mesh()
    set_mesh(make_mesh(n))
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jbuf, "_build_epoch_fn", builder)
            with pytest.raises(Stop):
                jbuf.train_expert(jax.random.PRNGKey(0),
                                  jax_synthetic(**data).train,
                                  JaxBufferConfig(batch_train=10, frames=8),
                                  np.random.default_rng(7))
    finally:
        set_mesh(old)
    return seen["batch"]


def _jax_frepo():
    data = dict(ranks.STORE)
    static = np.random.default_rng(0).normal(size=(3, 64, 64, 3)).astype(
        np.float32)
    ref = _jax_run((jax_synthetic(**data), None), static, None)
    inputs = {k: ref[k] for k in ("state0", "pool0", "real_idx", "idx")}
    inputs["static"] = static
    return ref, inputs


def _drive_argv(out, buf):
    return ["--device", "cpu", "--preset", "s2d_MTT_ms", "--dataset",
            DRIVE_DATASET, "--frames", "8", "--buffer_path", buf,
            "--save_path", out, "--syn_steps", "2", "--Iteration", "0",
            "--max_start_epoch", "1", "--startIt", "1",
            "--compute_dtype", "float32"]


def _launch_drive(tmp):
    """``torchrun --nproc_per_node 2`` of the S2D-MTT driver, started in
    the background; returns (process, its output dir, the buffer dir)."""
    buf, out = os.path.join(tmp, "buf"), os.path.join(tmp, "world2")
    os.makedirs(buf)
    gen = torch.Generator().manual_seed(0)
    t0, t1 = (flat_param_template("ConvNet3D", 3, 3, (64, 64), 8, gen)[1]
              for _ in range(2))
    TrajectoryBuffer(np.stack([t0.numpy(), t1.numpy()])[None]).save(
        os.path.join(buf, "replay_buffer_0.npz"))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m",
         "video_distillation_torch.drivers.distill_s2d",
         *_drive_argv(out, buf)],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return proc, out, buf


def _log(out):
    path = os.path.join(out, f"s2d_MTT_{DRIVE_DATASET}.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist"))
    store, syn, key, dm_params = _dm400()
    dm400 = ("dm400", "dm_400_classes", dict(syn=syn, params=dm_params))
    trap = ("trap", "double_count_toy", {})
    drive, out2, buf = _launch_drive(tmp)
    out1 = os.path.join(tmp, "world1")
    groups = [
        ranks.Ranks(1, [trap, dm400,
                        ("expert", "expert_epoch", dict(batch_train=12)),
                        ("s2d_full", "s2d_mtt", dict(plan=P3)),
                        *FP64_STEPS,
                        ("drive", "drive_s2d",
                         dict(argv=_drive_argv(out1, buf)))], group=False),
        ranks.Ranks(2, [trap, ("naive", "double_count_toy",
                               dict(naive=True)), dm400, *FP64_STEPS]),
        ranks.Ranks(4, [("expert", "expert_epoch", dict(batch_train=10)),
                        ("s2d_full", "s2d_mtt", dict(plan=P3))]),
    ]
    old = get_mesh()
    try:
        set_mesh(make_mesh(2))
        jax_dm = _jax_dm400(store, syn, key)
        jax_fr, fr_in = _jax_frepo()
        set_mesh(old)
        world2 = groups[1].results()
        groups[1].send([("frepo_jax", "frepo_step",
                         dict(inputs=fr_in, dtype="float32"))])
        frepo2 = groups[1].results()
        world1, world4 = groups[0].results()[0], groups[2].results()
        log, _ = drive.communicate(timeout=300)
    finally:
        set_mesh(old)
        for g in groups:
            g.close()
        if drive.poll() is None:
            drive.kill()
    assert drive.returncode == 0, log[-3000:]
    for r in range(2):
        world2[r].update(frepo2[r])
    return dict(world1=world1, world2=world2, world4=world4, jax_dm=jax_dm,
                jax_fr=jax_fr, out1=out1, out2=out2)


def test_second_order_unroll_has_no_world_size_factor(runs):
    ref = runs["world1"]["trap"]
    for r in range(2):
        got = runs["world2"][r]["trap"]
        assert abs(got["lr"] - ref["lr"]) <= 1e-12 * abs(ref["lr"])
        assert rel_norm(got["theta0"], ref["theta0"]) <= 1e-12
        assert got["loss"] == pytest.approx(ref["loss"], rel=1e-12)
    # the full loss on every rank through a SUM all-reduce whose backward
    # sums again counts the replicated loss's cotangent twice
    naive = runs["world2"][0]["naive"]
    assert abs(naive["lr"] - ref["lr"]) > 1e-6 * abs(ref["lr"])


def test_sharded_store_dm_400_classes_holds_half_the_rows(runs):
    for r in range(2):
        got = runs["world2"][r]["dm400"]
        assert got["store_rows"] == 600
        assert got["store_first_row"] == 600 * r


def test_sharded_store_dm_400_classes_equals_world_size_one(runs):
    ref = runs["world1"]["dm400"]
    assert ref["store_rows"] == 1200
    for r in range(2):
        got = runs["world2"][r]["dm400"]
        assert got["loss"] == pytest.approx(ref["loss"], rel=1e-6)
        assert rel_norm(got["images"], ref["images"]) <= 1e-6


def test_sharded_store_dm_400_classes_matches_jax_on_a_mesh_of_two(runs):
    want = runs["jax_dm"]
    for r in range(2):
        got = runs["world2"][r]["dm400"]
        assert abs(got["loss"] / want["loss"] - 1) <= 1e-5
        assert rel_norm(got["images"], want["images"]) <= 1e-5


def test_frepo_on_two_ranks_matches_jax_on_a_mesh_of_two(runs):
    ref = runs["jax_fr"]
    mu, _ = ref["moments"]
    for r in range(2):
        t = runs["world2"][r]["frepo_jax"]
        assert abs(t["loss"] / ref["loss"] - 1) <= LOSS_TOL
        assert rel_norm(t["m"]["dynamic"], mu["dynamic"]) <= GRAD_TOL
        assert rel_norm(t["state"]["dynamic"],
                        ref["state1"]["dynamic"]) <= BIG_TOL
        for k in ("weight", "bias"):
            assert rel_norm(t["m"]["hals"][0][k],
                            _hal(mu["hals"][0])[k].numpy()) <= GRAD_TOL, k
            assert rel_norm(t["state"]["hals"][0][k],
                            _hal(ref["state1"]["hals"][0])[k].numpy()) <= TOL


def test_expert_epoch_on_four_ranks_rounds_its_batch_as_jax_does(runs):
    ref = runs["world1"]["expert"]["trajectory"]
    for r in range(4):
        traj = runs["world4"][r]["expert"]["trajectory"]
        assert traj.shape == ref.shape
        assert rel_norm(traj, ref) <= 1e-10, r
    assert _jax_expert_batch(4) == 12


@pytest.mark.parametrize("name", [n for n, _, _ in FP64_STEPS])
def test_world_size_two_equals_world_size_one_in_fp64(runs, name):
    """Raw MTT on a plan of 3 columns (padded to 4) and an expert epoch with
    the store row-sharded: every rank within 1e-10 of world size 1."""
    for r in range(2):
        ranks.assert_close(runs["world2"][r][name], runs["world1"][name],
                           1e-10, f"rank {r}")
    per = 2 * 2 + 1 if name == "raw_mtt" else None
    if per:  # each inner gradient forward and backward, the outer gradients
        assert runs["world2"][0][name]["collectives"]["all_reduce"] == per


def test_s2d_mtt_at_world_size_four_equals_world_size_one(runs):
    """A plan of 3 columns over 4 ranks: the last rank holds only padding;
    fp64, within 1e-10."""
    ref = runs["world1"]["s2d_full"]
    for r in range(4):
        got = runs["world4"][r]["s2d_full"]
        assert got["loss"] == pytest.approx(ref["loss"], rel=1e-10)
        for k in ("grad_dynamic", "grad_hal_weight", "grad_hal_bias",
                  "dynamic"):
            assert rel_norm(got[k], ref[k]) <= 1e-10, (r, k)
        assert got["grad_syn_lr"] == pytest.approx(ref["grad_syn_lr"],
                                                   rel=1e-10)


def test_torchrun_drive_equals_world_size_one(runs):
    one, two = _log(runs["out1"]), _log(runs["out2"])
    # one line a logged record: only rank 0 wrote the log
    assert [sorted(r) for r in two] == [sorted(r) for r in one]
    assert len(two) == 1
    for k in ("Grand_Loss", "Synthetic_LR"):
        assert two[0][k] == pytest.approx(one[0][k], rel=1e-5), k
