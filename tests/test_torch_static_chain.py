"""The chain from static learning to S2D distillation on the CPU (split
from ``test_torch_dc.py``, whose helpers it uses, so that the tier-1 run's
file-by-file workers take it apart from the rest): the port's static
driver writes a static memory that the port's S2D driver reads through
``--path_static``. torch runs on one thread here (``tests/torch_threads.py``).
"""

import numpy as np
import torch

from test_torch_dc import NARROW
from torch_threads import one_torch_thread  # noqa: F401


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
