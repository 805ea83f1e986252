"""The S2D-MTT outer step in plain float32, and the first steps of a run.

One outer step (the paper's Algorithm 1, the reference repository's
``distill_s2d_ms.py:113-310``): draw each planned sample's still and
motion slot, compose the ``syn_steps`` batches through the hallucinator,
unroll ``syn_steps`` SGD steps of the student net (``Setting.net``) from
the expert's θ_start at the learnable rate, and differentiate the grand loss
‖θ_K − θ*‖² / ‖θ_start − θ*‖² to second order (``create_graph``) into the
dynamic memory, the hallucinator and the rate. The memories and the
hallucinator then take SGD with momentum 0.95, the rate (where it is
learnt) SGD with momentum 0.9, clipped at 0.001. The static memory is
frozen.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from .hallucinator import hallucinate
from .ops import masked_ce
from .sampling import ExpertOrder, batch_plan, distill_draws, step_generator


@dataclasses.dataclass(frozen=True)
class Setting:
    """What an outer step depends on, from the configuration's file: the
    student net's reference (``net``, its file under ``reference/nets``)
    and the configuration's ``model``, which gives its widths."""
    net: object
    model: dict
    spc: int
    dpc: int
    vpc: int
    syn_steps: int
    batch_syn: int
    lr_dynamic: float
    lr_hal: float
    lr_lr: float
    max_start_epoch: int
    expert_epochs: int
    train_lr: bool

    @property
    def n_syn(self) -> int:
        return self.model["num_classes"] * self.vpc


def outer_step(st: Setting, state, syn_lr, moms, mom_lr, theta0, theta1,
               plan: torch.Tensor, generator: torch.Generator, quant=None,
               half_batch: bool = False):
    """One outer step from ``state`` ({'static', 'dynamic', 'hal_w', 'hal_b'})
    and its momenta. Returns (state, syn_lr, moms, mom_lr, loss, grads),
    grads keyed as the trained leaves ('dynamic', 'hal_w', 'hal_b',
    'syn_lr'). ``half_batch`` takes each inner batch's mean over its first
    half only (a fault the check has to catch)."""
    S, B = plan.shape
    d_bits, s_bits, keeps = distill_draws(plan, st.net, st.model, generator)
    safe = plan.clamp_min(0).long()
    label, idx = safe // st.vpc, safe % st.vpc
    s_idx = st.spc * label + 2 * idx + s_bits
    d_idx = 2 * idx + d_bits
    w = (plan >= 0).float()
    if half_batch:
        w[:, B // 2:] = 0
    denom = w.sum(-1).clamp_min(1.0)

    dynamic = state["dynamic"].detach().requires_grad_(True)
    hal_w = state["hal_w"].detach().requires_grad_(True)
    hal_b = state["hal_b"].detach().requires_grad_(True)
    lr = torch.as_tensor(syn_lr, dtype=torch.float32).detach().requires_grad_(True)
    dyn_rows = dynamic.reshape((-1,) + dynamic.shape[2:])
    videos = hallucinate(hal_w, hal_b, state["static"][s_idx.reshape(-1)],
                         dyn_rows[(label * st.dpc + d_idx).reshape(-1)], quant)
    x = videos.reshape((S, B) + videos.shape[1:])

    theta = theta0.detach().requires_grad_(True)
    start = theta
    for s in range(S):
        params = st.net.unflatten(theta, st.model)
        logits = st.net.forward(params, x[s], st.model, keeps[s], quant)
        ce = masked_ce(logits, label[s], w[s], denom[s])
        (g,) = torch.autograd.grad(ce, theta, create_graph=True)
        theta = theta - lr * g
    loss = (((theta - theta1) ** 2).sum()
            / ((start.detach() - theta1) ** 2).sum())
    grads = dict(zip(("dynamic", "hal_w", "hal_b", "syn_lr"),
                     torch.autograd.grad(loss, (dynamic, hal_w, hal_b, lr))))
    with torch.no_grad():
        new_moms, new_state = {}, dict(state)
        for k, rate in (("dynamic", st.lr_dynamic), ("hal_w", st.lr_hal),
                        ("hal_b", st.lr_hal)):
            new_moms[k] = 0.95 * moms[k] + grads[k]
            new_state[k] = state[k] - rate * new_moms[k]
        if st.train_lr:
            mom_lr = 0.9 * mom_lr + grads["syn_lr"]
            syn_lr = torch.clamp(syn_lr - st.lr_lr * mom_lr, min=0.001)
    return (new_state, syn_lr, new_moms, mom_lr, loss.detach(),
            {k: v.detach() for k, v in grads.items()})


def first_logits(st: Setting, state, theta0, plan: torch.Tensor,
                 generator: torch.Generator, quant=None):
    """(logits (B, classes), valid rows (B,) bool) of an outer step's first
    inner forward: the student at the expert's θ_start on the first inner
    batch, composed from ``state`` with the step's draws. Nothing in it is
    downstream of an inner update, so it moves with the precision and not
    with a ReLU or max-pool winner that flips."""
    d_bits, s_bits, keeps = distill_draws(plan, st.net, st.model, generator)
    row = plan[0]
    safe = row.clamp_min(0).long()
    label, idx = safe // st.vpc, safe % st.vpc
    dyn_rows = state["dynamic"].reshape((-1,) + state["dynamic"].shape[2:])
    with torch.no_grad():
        x = hallucinate(state["hal_w"], state["hal_b"],
                        state["static"][st.spc * label + 2 * idx + s_bits[0]],
                        dyn_rows[label * st.dpc + 2 * idx + d_bits[0]],
                        quant)
        logits = st.net.forward(st.net.unflatten(theta0, st.model), x,
                                st.model, keeps[0], quant)
    return logits, row >= 0


class Draws:
    """The run's host draws replayed: each outer step's expert segment
    (θ_start, θ*) and batch plan, in the program's order."""

    def __init__(self, st: Setting, seed: int,
                 trajectories: Sequence[np.ndarray], device):
        self.st, self.trajectories, self.device = st, trajectories, device
        self.rng = np.random.default_rng(seed)
        self.order = ExpertOrder([len(t) for t in trajectories], self.rng)
        self.seg = self._segment()

    def _segment(self):
        f, e, start = self.order.next(self.st.max_start_epoch)
        t = self.trajectories[f][e]
        return [torch.as_tensor(p, dtype=torch.float32, device=self.device)
                for p in (t[start], t[start + self.st.expert_epochs])]

    def next(self):
        """(θ_start, θ*, plan) of the next outer step."""
        st = self.st
        plan = torch.as_tensor(batch_plan(self.rng, st.n_syn, st.batch_syn,
                                          st.syn_steps), device=self.device)
        seg, self.seg = self.seg, self._segment()
        return seg[0], seg[1], plan


def step_inputs(st: Setting, seed: int, trajectories: Sequence[np.ndarray],
                k: int, device):
    """(θ_start, θ*, plan) of outer step ``k`` of a run seeded ``seed``."""
    draws = Draws(st, seed, trajectories, device)
    for _ in range(k):
        draws.next()
    return draws.next()


def first_steps(st: Setting, seed: int, state, syn_lr: float,
                trajectories: Sequence[np.ndarray], steps: int, device,
                quant=None, half_batch: bool = False) -> List[Dict]:
    """The run's first ``steps`` outer steps from its initial state, with
    the run's own draws. ``trajectories`` holds each buffer file's
    (experts, epochs, P) snapshots (a host array or a tensor). Returns one
    record a step: 'loss', 'grads', and the state after it ('state',
    'syn_lr', 'moms', 'mom_lr')."""
    draws = Draws(st, seed, trajectories, device)
    moms = {k: torch.zeros_like(state[k]) for k in ("dynamic", "hal_w", "hal_b")}
    lr = torch.tensor(float(syn_lr), device=device)
    mom_lr = torch.zeros((), device=device)
    out = []
    for it in range(steps):
        theta0, theta1, plan = draws.next()
        state, lr, moms, mom_lr, loss, grads = outer_step(
            st, state, lr, moms, mom_lr, theta0, theta1, plan,
            step_generator(seed, it, device), quant, half_batch)
        out.append({"loss": loss, "grads": grads, "state": state,
                    "syn_lr": lr, "moms": moms, "mom_lr": mom_lr})
    return out
