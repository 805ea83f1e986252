"""EMA and AVG parameter tracking over dicts of tensors.

Port of ``video_distillation_tpu/ops/ema.py`` (parity with the reference's
``FRePo/lib/training/utils.py:51-169``: an exponential moving average with
debiasing, and a uniform running average). Each ``update`` returns a new
state and leaves its inputs alone, as the JAX pytree transforms do.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class EMAState:
    decay: float
    count: int
    average: Params
    debias: bool = True

    @staticmethod
    def init(params: Params, decay: float = 0.995,
             debias: bool = True) -> "EMAState":
        return EMAState(decay=decay, count=0,
                        average={k: torch.zeros_like(v)
                                 for k, v in params.items()},
                        debias=debias)

    def update(self, params: Params) -> "EMAState":
        d = self.decay
        new_avg = {k: d * a + (1 - d) * params[k]
                   for k, a in self.average.items()}
        return EMAState(decay=d, count=self.count + 1, average=new_avg,
                        debias=self.debias)

    def value(self) -> Params:
        if not self.debias or self.count == 0:
            return self.average
        corr = 1.0 - self.decay ** self.count
        return {k: a / corr for k, a in self.average.items()}


@dataclasses.dataclass
class AVGState:
    count: int
    average: Params

    @staticmethod
    def init(params: Params) -> "AVGState":
        return AVGState(count=0, average={k: torch.zeros_like(v)
                                          for k, v in params.items()})

    def update(self, params: Params) -> "AVGState":
        c = self.count + 1
        new_avg = {k: a + (params[k] - a) / c
                   for k, a in self.average.items()}
        return AVGState(count=c, average=new_avg)

    def value(self) -> Params:
        return self.average
