"""A run whose timed path is broken underneath comes out not correct: a
step that returns its state unchanged, half of each batch left out (the
mean taken over the rest), an answer altered where it is produced. The
toy cells run on the CPU with the card check skipped and the limits of
the benchmark's first cells. (One card: no exchange between chips.)"""

import time

import pytest
import torch

from portbench.harness import bench


def _run(root, workload):
    args = bench.parse(["--workload", workload, "--seed", str(2 ** 31 + 5),
                        "--seconds", "0.2", "--trace", "0"])
    rc, line = bench.run_cell(root, args, time.perf_counter(),
                              device=torch.device("cpu"))
    assert rc == 0
    return line


def _half(masked_ce):
    def half(logits, y, w, denom=None):
        w = w.clone()
        w[w.shape[0] // 2:] = 0
        return masked_ce(logits, y, w, w.sum().clamp_min(1.0))
    return half


def _plant_training(monkeypatch, fault):
    # evaluate binds mtt.masked_ce as it is imported: import it before the
    # patch, so that a later evaluation in this process trains unbroken
    from video_distillation_torch.distill import evaluate  # noqa: F401
    from video_distillation_torch.distill import mtt
    call = mtt.S2DMTTStep.__call__
    if fault == "unchanged":
        def broken(self, gen, state, syn_lr, moms, mom_lr, *a, **k):
            out = call(self, gen, state, syn_lr, moms, mom_lr, *a, **k)
            return (state, syn_lr, moms, mom_lr) + tuple(out[4:])
        monkeypatch.setattr(mtt.S2DMTTStep, "__call__", broken)
    elif fault == "half_batch":
        monkeypatch.setattr(mtt, "masked_ce", _half(mtt.masked_ce))
    elif fault == "altered":
        def altered(self, gen, state, *a, **k):
            # the hallucinator moved twice as far as the step computed
            out = call(self, gen, state, *a, **k)
            hals = [{n: 2 * p[n] - h[n] for n in p}
                    for p, h in zip(out[0]["hals"], state["hals"])]
            return (dict(out[0], hals=hals),) + tuple(out[1:])
        monkeypatch.setattr(mtt.S2DMTTStep, "__call__", altered)


def _plant_eval(monkeypatch, fault):
    from video_distillation_torch.distill import evaluate as ev
    if fault == "unchanged":
        monkeypatch.setattr(ev._Trainer, "update",
                            lambda self, step, theta, grad, mom, v, ema:
                            (theta, mom, v, ema))
    elif fault == "half_batch":
        monkeypatch.setattr(ev, "masked_ce", _half(ev.masked_ce))
    elif fault == "altered":
        final = ev._Trainer.final
        monkeypatch.setattr(ev._Trainer, "final",
                            lambda self, theta, ema: final(self, theta, ema) * 1.01)


@pytest.mark.parametrize("workload", ["toy_distill", "toy_eval_vmap",
                                      "toy_eval_seq"])
def test_a_sound_run_is_correct(toy_root, workload):
    assert _run(toy_root, workload)["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("workload", ["toy_distill", "toy_eval_vmap",
                                      "toy_eval_seq"])
def test_a_broken_run_is_not_correct(toy_root, monkeypatch, workload, fault):
    plant = _plant_training if workload == "toy_distill" else _plant_eval
    plant(monkeypatch, fault)
    line = _run(toy_root, workload)
    assert not line["correct"], line["checks"]
