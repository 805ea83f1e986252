"""The numbers that decide ``correct``: the program against the reference.

Training (an S2D-MTT run): the reference follows the run's first three
outer steps from the same initial state and draws. Compared are each
step's grand loss (``loss_gap``: the largest relative gap), the norm of
the first outer gradient as the optimizer got it, read from the momenta
after one step (``grad_gap``), and the norm of each trained leaf's change
after three steps (``change_gap``). A leaf's gap is |program norm −
reference norm| over the larger of the reference's norm of that leaf and
of the median leaf; the number is the worst leaf's. Leaves whose
reference gradient is under a thousandth of the median leaf's are left
out of both (none of this configuration's are).

Evaluation (training fresh nets): for a sample of the window's calls,
each net's change from its init against the reference's from the same
init and draws (``net_change_gap``), leaf by leaf by the same rule; the
worst leaf of the worst net.

Both: the logits of a first forward (``logit_gap``, the relative distance
of the program's from the reference's): in a training cell the first inner
forward of an outer step of the window drawn from the seed, the reference
starting from the program's state before that step; in an evaluation cell
each checked net's first training step. Everything after a first forward
is downstream of a step through ReLU and max-pool, whose winners flip at
any rounding, so those numbers read alike at every precision; a first
forward is continuous in its inputs and reads the precision.
"""

from __future__ import annotations

import statistics
from typing import Dict, Sequence

import torch

NEGLIGIBLE = 1e-3  # a leaf whose reference gradient is under this share of
                   # the median leaf's moves by round-off alone


def norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keep: Sequence[str]) -> float:
    """max over ``keep`` of |‖prog‖ − ‖ref‖| / max(‖ref‖, median ‖ref‖)."""
    pn = {k: float(prog[k].double().norm()) for k in keep}
    rn = {k: float(ref[k].double().norm()) for k in keep}
    med = statistics.median(list(rn.values()))
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keep)


def kept_leaves(ref_grads: Dict[str, torch.Tensor]) -> list:
    norms = {k: float(v.double().norm()) for k, v in ref_grads.items()}
    med = statistics.median(list(norms.values()))
    return [k for k, n in norms.items() if n >= NEGLIGIBLE * med]


def training_numbers(prog: Dict, ref: Sequence[Dict], init: Dict
                     ) -> Dict[str, float]:
    """``prog``: {'losses': [3], 'grads': {leaf: first gradient},
    'state': {leaf: value after three steps}}; ``ref``: the reference's
    three step records; ``init``: each trained leaf's initial value (the
    leaves compared)."""
    keep = kept_leaves({k: ref[0]["grads"][k] for k in init})
    losses = [abs(float(p) - float(r["loss"])) / abs(float(r["loss"]))
              for p, r in zip(prog["losses"], ref)]
    ref_after = dict(ref[2]["state"], syn_lr=ref[2]["syn_lr"])
    change_p = {k: prog["state"][k].double() - init[k].double() for k in keep}
    change_r = {k: ref_after[k].double().to(init[k].device) - init[k].double()
                for k in keep}
    grads_r = {k: v.to(prog["grads"][k].device)
               for k, v in ref[0]["grads"].items()}
    return {"loss_gap": max(losses),
            "grad_gap": norm_gap(prog["grads"], grads_r, keep),
            "change_gap": norm_gap(change_p, change_r, keep)}


def logit_gap(prog: torch.Tensor, ref: torch.Tensor, valid: torch.Tensor
              ) -> float:
    """‖prog − ref‖ / ‖ref‖ over the valid rows of a first forward's logits."""
    p = prog.double()[valid.to(prog.device)]
    r = ref.double().to(prog.device)[valid.to(prog.device)]
    return float((p - r).norm() / r.norm().clamp_min(1e-30))


def net_change_gap(prog_theta: torch.Tensor, ref_theta: torch.Tensor,
                   init: torch.Tensor, split) -> float:
    """One net: the gap of the norms of each leaf's change from θ0, by
    ``norm_gap``'s rule."""
    prog = split(prog_theta.double() - init.double())
    ref = split(ref_theta.double() - init.double())
    return norm_gap(prog, ref, list(ref))
