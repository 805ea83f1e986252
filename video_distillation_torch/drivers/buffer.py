"""Expert-buffer generation driver (port of
``video_distillation_tpu/drivers/buffer.py``, the reference's ``buffer.py``
+ ``sh/baseline/buffer.sh``)::

    python -m video_distillation_torch.drivers.buffer --dataset miniUCF101 \\
        --num_experts 30 --train_epochs 50 --buffer_path buffers \\
        [--compute_dtype float32] [--device cpu]

It writes ``replay_buffer_{n}.npz`` files that
``drivers/distill_s2d.py --buffer_path`` (of either package) reads. The run
is on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

from ..config import BufferConfig
from ..distill.buffer import generate_buffers
from ..utils.device import resolve_device, use_exact_fp32
from ..utils.logging import MetricLogger
from .common import load_data, parse_config_args


def main(argv=None):
    cfg = parse_config_args("Expert buffer generation", argv,
                            config_cls=BufferConfig)
    resolve_device(cfg.device)  # fail before loading data if CUDA is missing
    use_exact_fp32()
    data = load_data(cfg)
    logger = MetricLogger(log_dir=cfg.buffer_path,
                          run_name=f"buffer_{cfg.dataset}")

    def progress(it, acc):
        logger.log({"expert": it, "train_acc": acc})

    paths = generate_buffers(data, cfg, progress)
    logger.log({"buffers_written": len(paths)})
    logger.finish()
    return paths


if __name__ == "__main__":
    main()
