"""Inputs made from the seed, on the device, in a few large draws.

The S2D state (a random static memory, a random dynamic memory, a
hallucinator at torch's default init) and the expert trajectories (each
expert a θ drawn U(-b, b) leaf by leaf, b each leaf's init bound from the
student net's reference, then ``snapshots - 1`` epochs of a random walk of
``drift`` times b) come from a ``torch.Generator`` on
the device. The benchmark keeps host copies for the reference and hands
the program the same numbers through the files it reads: the expert
buffer through the driver's own ``load_buffers``, the initial S2D state
through the driver's resume checkpoint.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict

import numpy as np
import torch

# the generator streams of one seed
STATE_STREAM, EXPERT_STREAM, CALL_STREAM = 1, 2, 3


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (seed * 16 + stream) % 2 ** 63)


def s2d_state(seed: int, num_classes: int, spc: int, dpc: int, frames: int,
              im_size: int, device) -> Dict[str, torch.Tensor]:
    """{'static' (C·spc, H, W, 3), 'dynamic' (C, dpc, F, H, W, 1), 'hal_w'
    (3, 4, 3, 3, 3), 'hal_b' (3,)}, fp32 on ``device``."""
    g = generator(seed, STATE_STREAM, device)
    bound = 1.0 / math.sqrt(4 * 27)
    return {
        "static": torch.randn((num_classes * spc, im_size, im_size, 3),
                              generator=g, device=device),
        "dynamic": torch.randn((num_classes, dpc, frames, im_size, im_size, 1),
                               generator=g, device=device),
        "hal_w": (torch.rand((3, 4, 3, 3, 3), generator=g, device=device)
                  * 2 - 1) * bound,
        "hal_b": (torch.rand(3, generator=g, device=device) * 2 - 1) * bound,
    }


def leaf_bounds(net, m: dict, device) -> torch.Tensor:
    """(P,) each θ element's init bound (``net.init_bounds``: 1/sqrt of
    its layer's fan-in for a conv or a linear layer)."""
    sizes = [math.prod(shape) for _, shape in net.leaves(m)]
    return torch.repeat_interleave(
        torch.tensor(net.init_bounds(m), device=device),
        torch.tensor(sizes, device=device))


def trajectories(seed: int, experts: int, snapshots: int, drift: float,
                 net, m: dict, device) -> np.ndarray:
    """(experts, snapshots, P) float32 expert snapshots of the student net
    ``net`` (its reference, widths from the configuration's ``model``
    ``m``), on the host."""
    g = generator(seed, EXPERT_STREAM, device)
    b = leaf_bounds(net, m, device)
    p = b.numel()
    start = (torch.rand((experts, 1, p), generator=g, device=device) * 2 - 1) * b
    steps = torch.randn((experts, snapshots - 1, p), generator=g,
                        device=device) * (b * drift)
    traj = torch.cat([start, start + steps.cumsum(1)], dim=1)
    return traj.cpu().numpy()


def write_buffer(path: str, traj: np.ndarray):
    """``replay_buffer_0.npz`` with the trajectories (uncompressed: the
    driver's loader reads either)."""
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "replay_buffer_0.npz"), trajectories=traj)


def write_resume_point(ckpt_dir: str, state: Dict[str, torch.Tensor],
                       syn_lr: float):
    """The S2D driver's checkpoint of iteration -1 (zero momenta): the run
    resumes from it at iteration 0, with this state, as a fresh run would
    from its own initialisation."""
    os.makedirs(ckpt_dir, exist_ok=True)
    s2d = {"static": state["static"].cpu(), "dynamic": state["dynamic"].cpu(),
           "hals": [{"weight": state["hal_w"].cpu(),
                     "bias": state["hal_b"].cpu()}]}
    zeros = {"static": torch.zeros_like(s2d["static"]),
             "dynamic": torch.zeros_like(s2d["dynamic"]),
             "hals": [{k: torch.zeros_like(v) for k, v in s2d["hals"][0].items()}]}
    torch.save({"state": s2d, "moms": zeros, "syn_lr": torch.tensor(syn_lr),
                "mom_lr": torch.zeros(())},
               os.path.join(ckpt_dir, "step_-1.pt"))
    with open(os.path.join(ckpt_dir, "latest.json"), "w") as f:
        json.dump({"step": -1}, f)
