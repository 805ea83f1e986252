"""Expert training (``distill/buffer.py``), the buffer driver and the clip
store's device side, against the JAX package on the CPU.

* Two epochs of ``train_expert`` in fp32 in both packages (4 classes x 4
  clips, 64x64x8, batches of 8, so 2 steps an epoch; momentum and weight
  decay on), from the same initial parameters, the same numpy permutations,
  JAX's own hflip draws and one fixed dropout keep-mask: every snapshot
  within 1e-4 relative norm (fp32 sums in other orders).
* The port's buffers: every adjacent snapshot pair differs (a snapshot that
  aliased the live parameters would not, ROADMAP C.1), and the JAX
  package's ``load_buffers`` reads what the port's driver wrote.
* ``ClipStore``'s device side agrees with the JAX package's exactly.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from video_distillation_tpu.config import BufferConfig as JaxBufferConfig
from video_distillation_tpu.data.synthetic import \
    make_synthetic_video_data as jax_synthetic
from video_distillation_tpu.distill import buffer as jbuf
from video_distillation_tpu.models import registry as jreg
from video_distillation_torch.config import BufferConfig
from video_distillation_torch.data.synthetic import \
    make_synthetic_video_data as torch_synthetic
from video_distillation_torch.distill import buffer as tbuf
from video_distillation_torch.drivers import buffer as tdriver

from test_torch_mtt import _fixed_dropout  # tests/ is on sys.path
from torch_threads import one_torch_thread  # noqa: F401

NC, F, IM = 4, 8, 64
DATA = dict(num_classes=NC, clips_per_class=4, test_per_class=1, frames=F,
            im_size=(IM, IM), seed=1, name="synthetic_buffer_parity")
TRAIN = dict(model="ConvNet3D", train_epochs=2, lr_teacher=0.01,
             batch_train=8, mom=0.5, l2=1e-3, frames=F,
             compute_dtype="float32")


@pytest.fixture(scope="module")
def experts():
    """(JAX trajectory, port trajectory) of one expert from the same
    inputs."""
    mask = np.random.default_rng(0).random((8, 1, 1, 1, 128)) < 0.5
    key = jax.random.PRNGKey(4)
    jdata, tdata = jax_synthetic(**DATA), torch_synthetic(**DATA)
    jbuf._build_epoch_fn.cache_clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _fixed_dropout(mask))
        ref, _ = jbuf.train_expert(key, jdata.train, JaxBufferConfig(**TRAIN),
                                   np.random.default_rng(7))
    jbuf._build_epoch_fn.cache_clear()

    model_def = jreg.create_model("ConvNet3D", 3, NC, (IM, IM), F)
    params = model_def.init({"params": key, "dropout": key},
                            jnp.zeros((1, F, IM, IM, 3)), train=False)["params"]
    nb = 2
    flips = [[np.array(jax.random.bernoulli(jax.random.fold_in(
        jax.random.fold_in(jax.random.fold_in(key, e + 1), 1), s), 0.5, (8,)))
        for s in range(nb)] for e in range(TRAIN["train_epochs"])]
    draws = tbuf.ExpertDraws(np.asarray(ravel_pytree(params)[0]), flips)
    masks = [[torch.from_numpy(mask)] * nb] * TRAIN["train_epochs"]
    got, acc = tbuf.train_expert(None, tdata.train, BufferConfig(**TRAIN),
                                 np.random.default_rng(7), "cpu", draws, masks)
    assert 0.0 <= acc <= 1.0
    return ref, got


@pytest.mark.parametrize("epoch", [0, 1, 2])
def test_expert_snapshots_match_jax(experts, epoch):
    ref, got = experts
    assert got.shape == ref.shape and got.dtype == np.float32
    a, r = got[epoch].astype(np.float64), ref[epoch].astype(np.float64)
    assert np.linalg.norm(a - r) / np.linalg.norm(r) <= 1e-4
    if epoch:
        assert np.linalg.norm(a - got[epoch - 1]) > 0


def test_driver_buffers_move_and_jax_reads_them(tmp_path):
    paths = tdriver.main([
        "--dataset", "synthetic_c3_n2_t1_f8_im64", "--frames", "8",
        "--num_experts", "2", "--save_interval", "2", "--train_epochs", "3",
        "--buffer_path", str(tmp_path), "--device", "cpu",
        "--compute_dtype", "float32", "--batch_train", "4"])
    assert [p.split("/")[-1] for p in paths] == ["replay_buffer_0.npz"]
    traj = jbuf.load_buffers(str(tmp_path))[0].trajectories
    assert traj.shape[:2] == (2, 4)
    for e in range(2):
        for s in range(3):
            assert np.sum((traj[e, s + 1] - traj[e, s]) ** 2) > 0, (e, s)
    assert not np.array_equal(traj[0, 0], traj[1, 0])  # fresh experts
    np.testing.assert_array_equal(tbuf.load_buffers(str(tmp_path))[0]
                                  .trajectories, traj)


def test_missing_buffer_names_the_ports_driver(tmp_path):
    with pytest.raises(ValueError,
                       match=r"video_distillation_torch\.drivers\.buffer"):
        tbuf.load_buffers("")
    with pytest.raises(FileNotFoundError, match="No buffers detected"):
        tbuf.load_buffers(str(tmp_path))


def test_clip_store_device_side_matches_jax():
    jdata, tdata = jax_synthetic(**DATA), torch_synthetic(**DATA)
    js, ts = jdata.train, tdata.train
    clips2d = ts.device_clips("cpu")
    assert clips2d.dtype == torch.uint8 and clips2d.shape == (len(ts), F * IM * IM * 3)
    assert ts.device_clips("cpu") is clips2d  # cached
    idx = np.array([3, 0, 15, 7])
    x = ts.gather_clips(clips2d, torch.from_numpy(idx))
    np.testing.assert_array_equal(x.numpy(), js.clips[idx])
    np.testing.assert_array_equal(
        ts.normalize(x).numpy(),
        np.asarray(js.normalize(js.gather_clips(js.device_clips(), idx))))
    for a, b in zip(ts.class_table(), js.class_table()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        ts.sample_per_class(np.random.default_rng(3), 3),
        js.sample_per_class(np.random.default_rng(3), 3))
    with pytest.raises(NotImplementedError, match="A.16"):
        ts.device_clips("cpu", sharded=True)
