"""S2D static/dynamic synthetic parameterization + slot sampling rules.

Port of ``video_distillation_tpu/distill/s2d.py``. Synthetic data is
factored into per-class static RGB stills ``(C*spc, H, W, 3)``, dynamic
1-channel motion volumes ``(C, dpc, F, H, W, 1)`` and a list of tiny
hallucinators (``{'weight', 'bias'}`` dicts) that compose them into videos.

Slot rules (parity with the reference):
* distillation time (distill_s2d_ms.py:240-247, :402-407): flat sample i of
  class ``label = i//vpc`` and ``idx = i%vpc`` takes
  ``dynamic_idx = 2*idx + U{0,1}`` and ``static_idx = spc*label + 2*idx +
  U{0,1}``, hallucinator 0;
* evaluation time (MultiStaticSharedDataset, utils.py:462-496): spc == 10
  uses the same coupled scheme (vpc=5); spc == 2 draws a random static of
  the class and a random dynamic (vpc=1); the hallucinator is uniform.

The random draws come from an explicit ``torch.Generator``, or are passed
in (``draws``) so a test can hand both packages the same ones.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..models.hallucinator import hal_apply, init_hallucinator


@dataclasses.dataclass
class S2DConfig:
    num_classes: int
    spc: int = 2    # statics per class
    dpc: int = 2    # dynamics per class
    vpc: int = 1    # videos per class (synthetic set size / C)
    n_hal: int = 1
    frames: int = 16
    im_size: Tuple[int, int] = (112, 112)
    hal_mode: str = "concat"


def init_s2d_state(generator: Optional[torch.Generator], cfg: S2DConfig,
                   device=None):
    """Random-normal memories + initialised hallucinators
    (distill_s2d_ms.py:89-93)."""
    h, w = cfg.im_size
    static = torch.randn((cfg.num_classes * cfg.spc, h, w, 3),
                         generator=generator, device=device)
    dynamic = torch.randn((cfg.num_classes, cfg.dpc, cfg.frames, h, w, 1),
                          generator=generator, device=device)
    hals = [init_hallucinator(cfg.hal_mode, generator, device)
            for _ in range(cfg.n_hal)]
    return {"static": static, "dynamic": dynamic, "hals": hals}


def init_s2d_momentum(state):
    """Zero momentum buffers with the state's structure."""
    return {"static": torch.zeros_like(state["static"]),
            "dynamic": torch.zeros_like(state["dynamic"]),
            "hals": [{k: torch.zeros_like(v) for k, v in p.items()}
                     for p in state["hals"]]}


def hallucinate(hal_params, static, dynamic, mode: str = "concat",
                dtype: Optional[torch.dtype] = None):
    """Compose videos: static (B,H,W,3) + dynamic (B,F,H,W,1) ->
    (B,F,H,W,3), a view of channel-planar storage.

    ``dtype`` (e.g. bfloat16) casts inputs and parameters for the compose;
    gradients flow back through the casts into the fp32 master state.
    'concat' always goes through ``ops.hal_conv`` (the kernels on CUDA)."""
    if dtype is not None:
        hal_params = {k: v.to(dtype) for k, v in hal_params.items()}
        static = static.to(dtype)
        dynamic = dynamic.to(dtype)
    return hal_apply(hal_params, static, dynamic, mode)


def _bits(draws, i, high, shape, generator, device):
    if draws is not None:
        return torch.as_tensor(draws[i], device=device).long()
    return torch.randint(0, high, shape, generator=generator, device=device)


def distill_slots(num_classes: int, spc: int, vpc: int, sample_idx,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[Sequence] = None):
    """Distillation-time slot sampling for flat sample indices in
    [0, num_classes*vpc). ``draws`` = (dynamic bits, static bits), each
    U{0,1} of sample_idx's shape. Returns (label, static_idx, dynamic_idx);
    the hallucinator is always 0 (distill_s2d_ms.py:247)."""
    sample_idx = torch.as_tensor(sample_idx).long()
    dev = sample_idx.device
    label = sample_idx // vpc
    idx = sample_idx % vpc
    d_bits = _bits(draws, 0, 2, sample_idx.shape, generator, dev)
    s_bits = _bits(draws, 1, 2, sample_idx.shape, generator, dev)
    return label, spc * label + 2 * idx + s_bits, 2 * idx + d_bits


def eval_slots(num_classes: int, spc: int, dpc: int, n_hal: int,
               generator: Optional[torch.Generator] = None,
               draws: Optional[Sequence] = None, device=None):
    """Evaluation-time slot sampling over the whole synthetic set
    (utils.py:469-488). ``draws`` = (static, dynamic, hallucinator) draws.
    Returns (label, static_idx, dynamic_idx, hal_idx), each of length
    num_classes*vpc with vpc = 5 if spc == 10 else 1."""
    if spc == 10:
        vpc = 5
    elif spc == 2:
        vpc = 1
    else:
        raise ValueError(
            "MultiStaticSharedDataset supports spc in {2, 10} "
            f"(got {spc}) — utils.py:471-482")
    n = num_classes * vpc
    i = torch.arange(n, device=device)
    if vpc == 5:
        label, idx = i // 5, i % 5
        static_idx = label * spc + 2 * idx + _bits(draws, 0, 2, (n,), generator, device)
        dynamic_idx = 2 * idx + _bits(draws, 1, 2, (n,), generator, device)
    else:
        label = i
        static_idx = label * spc + _bits(draws, 0, spc, (n,), generator, device)
        dynamic_idx = _bits(draws, 1, dpc, (n,), generator, device)
    hal_idx = _bits(draws, 2, n_hal, (n,), generator, device)
    return label, static_idx, dynamic_idx, hal_idx


def compose_synthetic(state, cfg: S2DConfig, for_eval: bool = True,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[Sequence] = None):
    """Compose the full synthetic set -> (videos (C*vpc,F,H,W,3), labels).

    ``for_eval`` uses the MultiStaticSharedDataset rules; otherwise the
    distillation-time DM rules (distill_s2d_ms.py:402-412)."""
    dev = state["static"].device
    if for_eval:
        label, s_idx, d_idx, h_idx = eval_slots(
            cfg.num_classes, cfg.spc, cfg.dpc, cfg.n_hal, generator, draws, dev)
    else:
        n = cfg.num_classes * cfg.vpc
        label, s_idx, d_idx = distill_slots(
            cfg.num_classes, cfg.spc, cfg.vpc, torch.arange(n, device=dev),
            generator, draws)
        h_idx = torch.zeros(n, dtype=torch.long, device=dev)

    static = state["static"][s_idx]
    dynamic = state["dynamic"][label, d_idx]
    if cfg.n_hal == 1:
        videos = hallucinate(state["hals"][0], static, dynamic, cfg.hal_mode)
    else:
        # compose with each hallucinator, select per sample (tiny nets)
        outs = torch.stack([hallucinate(p, static, dynamic, cfg.hal_mode)
                            for p in state["hals"]])
        videos = outs[h_idx, torch.arange(static.shape[0], device=dev)]
    return videos, label
