"""The synthetic-set evaluation's training in plain float32.

The reference repository's ``evaluate_synset`` + ``epoch`` (utils.py:
752-886) for a multi-static S2D set of spc == 2: ``nets`` fresh student
nets (the configuration's, its file under ``reference/nets``), each
trained ``epochs`` epochs on the whole synthetic set in batches of
``min(batch_train, n_syn)``: each batch composed afresh from a random still
and a random motion of each sample's class through the hallucinator, given
the net's input (``prepare``: a crop for the ``Video*`` nets), standardised
with scalar statistics over its valid rows, and
stepped by SGD (momentum 0.9, weight decay 5e-4); the rate drops tenfold
for the epochs after ``epoch_eval_train // 2 + 1``, the momentum buffer
restarted on the first of them.

``batched`` follows the draws of nets trained as one computation (all
nets' parameters, then all nets' permutations, then per step every net's
slots and one keep-mask draw for all nets, none for a net without
dropout); otherwise each net in turn makes all of its draws.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from .hallucinator import hallucinate
from .ops import masked_ce
from .sampling import eval_keep, eval_net_draws, eval_slot_bits


@dataclasses.dataclass(frozen=True)
class EvalSetting:
    """What an evaluation depends on, from the configuration's file: the
    student net's reference (``net``) and the configuration's ``model``."""
    net: object
    model: dict
    spc: int
    dpc: int
    n_hal: int
    epoch_eval_train: int
    batch_train: int
    lr_net: float

    @property
    def n_syn(self) -> int:
        return self.model["num_classes"]  # vpc 1 for spc == 2

    @property
    def epochs(self) -> int:
        return self.epoch_eval_train + 1


def _standardize(x, w):
    n = w.sum() * x[0].numel()
    wx = w.reshape((-1,) + (1,) * (x.dim() - 1))
    mean = (x * wx).sum() / n
    var = (((x - mean) ** 2) * wx).sum() / n
    return (x - mean) / torch.sqrt(var + 1e-12)


def _compose(es: EvalSetting, state, idx, s_bits, d_bits, quant):
    label = idx
    static = state["static"][label * es.spc + s_bits]
    dynamic = state["dynamic"][label, d_bits]
    return hallucinate(state["hal_w"], state["hal_b"], static, dynamic, quant)


def train_nets(es: EvalSetting, state, generator: torch.Generator, nets: int,
               batched: bool, device, quant=None, half_batch: bool = False
               ) -> List[dict]:
    """Train ``nets`` fresh nets; returns each net's {'init', 'theta',
    'logits0'}: its initial and trained θ, and the logits of its first
    training step (the fresh net on the first composed batch)."""
    bt = min(es.batch_train, es.n_syn)
    nb = -(-es.n_syn // bt)
    drop = es.epoch_eval_train // 2 + 1

    def plan_of(perms):
        pad = nb * bt - es.n_syn
        if pad:
            perms = torch.cat([perms, perms.new_full((es.epochs, pad), -1)], 1)
        return perms.reshape(es.epochs * nb, bt)

    first, net = [], es.net

    def run(thetas, plans, draw_step):
        moms = [torch.zeros_like(t) for t in thetas]
        for step in range(es.epochs * nb):
            slots, keeps = draw_step()
            epoch = step // nb
            lr = es.lr_net * 0.1 if epoch > drop else es.lr_net
            reset = epoch == drop + 1 and step % nb == 0
            for e in range(len(thetas)):
                idx = plans[e][step]
                w = (idx >= 0).float()
                if half_batch:
                    w[bt // 2:] = 0
                safe = idx.clamp_min(0)
                with torch.no_grad():
                    x = _compose(es, state, safe, slots[0][e], slots[1][e],
                                 quant)
                    x = _standardize(net.prepare(x, es.model), w)
                th = thetas[e].detach().requires_grad_(True)
                logits = net.forward(net.unflatten(th, es.model), x,
                                     es.model, None if keeps is None
                                     else keeps[e], quant)
                if step == 0:
                    first.append(logits.detach())
                loss = masked_ce(logits, safe, w,
                                     (idx >= 0).sum().clamp_min(1).float())
                (g,) = torch.autograd.grad(loss, th)
                with torch.no_grad():
                    d = g + 5e-4 * thetas[e]
                    moms[e] = d if reset else 0.9 * moms[e] + d
                    thetas[e] = thetas[e] - lr * moms[e]
        return thetas

    if batched:
        inits = [net.init_theta(generator, es.model, device)
                 for _ in range(nets)]
        plans = [plan_of(eval_net_draws(generator, es.n_syn, es.epochs,
                                        device)) for _ in range(nets)]

        def draw_step():
            # the nets' batch indices are not needed for the bits' shapes
            s, d = eval_slot_bits(generator, (nets, bt), es.spc, es.dpc,
                                  es.n_hal, device)
            return (s, d), eval_keep(generator, nets, bt, net, es.model,
                                     device)
        final = run(list(inits), plans, draw_step)
        return [{"init": i, "theta": t, "logits0": f}
                for i, t, f in zip(inits, final, first)]

    out = []
    for _ in range(nets):
        init = net.init_theta(generator, es.model, device)
        plan = plan_of(eval_net_draws(generator, es.n_syn, es.epochs, device))

        def draw_step():
            s, d = eval_slot_bits(generator, (bt,), es.spc, es.dpc, es.n_hal,
                                  device)
            return (s[None], d[None]), eval_keep(generator, None, bt, net,
                                                 es.model, device)
        (theta,) = run([init], [plan], draw_step)
        out.append({"init": init, "theta": theta, "logits0": first[-1]})
    return out
