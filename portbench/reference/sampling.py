"""The draws of an S2D-MTT run and of an evaluation, worked out again.

The benchmark hands the program a seed; the program draws its expert
segments, batch plans, slot bits and dropout keep-masks from it. The
reference repeats those draws, in the program's order, from the same seed:

* host draws (``numpy.random.default_rng(seed)``): the expert order, each
  segment's start epoch and the batch plans, as the reference repository's
  ``distill_baseline.py:122-135, :203-241`` makes them;
* device draws from a ``torch.Generator`` seeded per outer step
  (``seed * 2**32 + it``) or per evaluation call: the slot bits, then the
  keep-masks of the whole plan; for an evaluation, each fresh net's
  parameters, its per-epoch permutations, then per step the slot draws and
  the keep-mask.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch



def step_generator(seed: int, it: int, device) -> torch.Generator:
    """The generator of outer step ``it`` of a run seeded ``seed``."""
    return torch.Generator(device=device).manual_seed(seed * 2 ** 32 + it)


class ExpertOrder:
    """Which expert and start epoch each outer step matches: the buffer
    files shuffled, their experts walked in a permuted order, reshuffled on
    wrap-around; the start epoch U[0, max_start_epoch)."""

    def __init__(self, experts_per_file: Sequence[int],
                 rng: np.random.Generator):
        self.files = list(range(len(experts_per_file)))
        self.sizes = list(experts_per_file)
        self.rng = rng
        self.rng.shuffle(self.files)
        self.file_idx = self.expert_idx = 0
        self._reshuffle()

    def _reshuffle(self):
        self.order = self.rng.permutation(self.sizes[self.files[self.file_idx]])

    def next(self, max_start_epoch: int) -> Tuple[int, int, int]:
        """(file, expert, start epoch) of the next segment."""
        f = self.files[self.file_idx]
        e = int(self.order[self.expert_idx])
        self.expert_idx += 1
        if self.expert_idx == self.sizes[f]:
            self.expert_idx = 0
            self.file_idx += 1
            if self.file_idx == len(self.files):
                self.file_idx = 0
                self.rng.shuffle(self.files)
            self._reshuffle()
        return f, e, int(self.rng.integers(0, max_start_epoch))


def batch_plan(rng: np.random.Generator, n: int, batch: int, steps: int
               ) -> np.ndarray:
    """(steps, batch) sample indices, -1 where a chunk is short: chunks of a
    permutation popped from its end, a new permutation when none is left."""
    chunks: List[np.ndarray] = []
    plan = np.full((steps, batch), -1, np.int64)
    for s in range(steps):
        if not chunks:
            perm = rng.permutation(n)
            chunks = [perm[i:i + batch] for i in range(0, n, batch)]
        chunk = chunks.pop()
        plan[s, :len(chunk)] = chunk
    return plan


def distill_draws(plan: torch.Tensor, net, m: dict,
                  generator: torch.Generator):
    """(dynamic bits, static bits, keep-masks (S, B, C, T', H', W')) of an
    outer step, in the program's order; the keep-masks S Nones for a
    ``net`` without dropout (no draw is made)."""
    d_bits = torch.randint(0, 2, plan.shape, generator=generator,
                           device=plan.device)
    s_bits = torch.randint(0, 2, plan.shape, generator=generator,
                           device=plan.device)
    shape = net.keep_mask_shape(m)
    if shape is None:
        return d_bits, s_bits, [None] * plan.shape[0]
    keeps = torch.stack([
        torch.rand((plan.shape[1],) + shape, generator=generator,
                   device=plan.device) < 1 - m["dropout"]
        for _ in range(plan.shape[0])])
    return d_bits, s_bits, keeps


def eval_net_draws(generator, n_syn: int, epochs: int, device):
    """(epochs, n_syn) per-epoch permutations of one net."""
    return torch.stack([torch.randperm(n_syn, generator=generator,
                                       device=device) for _ in range(epochs)])


def eval_slot_bits(generator, shape, spc: int, dpc: int, n_hal: int, device):
    """(static bits, dynamic bits) of a batch for spc == 2 (a random still
    and a random motion of the class); the hallucinator draw is made and,
    with one hallucinator, unused."""
    if spc != 2:
        raise ValueError("the reference evaluates spc == 2 sets only")
    s = torch.randint(0, spc, shape, generator=generator, device=device)
    d = torch.randint(0, dpc, shape, generator=generator, device=device)
    torch.randint(0, max(1, n_hal), shape, generator=generator, device=device)
    return s, d


def eval_keep(generator, nets: Optional[int], batch: int, net, m: dict,
              device) -> Optional[torch.Tensor]:
    """The evaluation step's keep-mask as (nets, B, C, T', H', W') bool:
    batched training draws it (nets, B, T', H', W', C), one net (B, C, T',
    H', W'); None, with no draw, for a ``net`` without dropout."""
    shape = net.keep_mask_shape(m)
    if shape is None:
        return None
    c, t, h, w = shape
    if nets is None:
        keep = torch.rand((batch, c, t, h, w), generator=generator,
                          device=device) < 1 - m["dropout"]
        return keep[None]
    keep = torch.rand((nets, batch, t, h, w, c), generator=generator,
                      device=device) < 1 - m["dropout"]
    return keep.permute(0, 1, 5, 2, 3, 4)
