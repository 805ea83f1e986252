"""FRePo: neural-feature kernel ridge regression with an online model pool.

Port of ``video_distillation_tpu/distill/frepo.py`` (the reference's
``FRePo/script/distill_s2d.py`` and ``FRePo/lib/datadistillation/
frepo.py``). Each outer iteration:

1. draws ``batch_real`` real clips (host numpy, without replacement) and one
   net of the pool, and embeds the clips with it, without gradient, in
   chunks of ``dm.REAL_CHUNK`` (512 clips in one piece would be 77% of 2^31
   elements in the fused first stage's GEMM output);
2. composes every prototype (``static[i]``, ``dynamic[i // dpc, i % dpc]``,
   a random hallucinator per prototype when ``n_hal > 1``) through
   ``s2d.hallucinate`` (the ``hal_conv`` kernels), embeds it with the same
   net, and descends the KRR loss ``||K_tp (K_pp + reg)^-1 y_p - y_t||^2``
   plus the label margin into the dynamic memory and the hallucinators:
   Adam with ``lr_d`` for the dynamic (or the raw ``x_proto``) and ``lr_h``
   for the rest, each on a cosine to the same floor ``0.1 lr_h``;
3. composes the updated prototypes without gradient (``compose_eval``,
   ``s2d.hallucinate_frozen``: the fused evaluation kernel on CUDA; the JAX
   package composes through the differentiable forward, ROADMAP C.7) and
   trains the drawn pool net one Adam step on them (MSE against the
   logits, train mode with dropout). A net is re-initialised after
   ``max_online_updates`` steps.

Adam is written out (``adam_update``) with optax's operation order, count
and ``eps``, as ``evaluate._torch_sgd`` is. A pool net is one flat θ in the
JAX package's order (``distill/params.py``) with its Adam moments, its
optax count (from 0 at every initialisation, which drives the learning
rate) and its ``step`` (staggered at start, which drives the reset).

Randomness: the host ``np.random.Generator`` is consumed in the JAX
order (the real batch, the pool index, the pool batch when the set has
more than 500 prototypes); a ``torch.Generator`` draws the hallucinator
choices, the dropout masks and re-initialised nets; ``proto_step`` and
``ModelPool.train_step`` take them as arguments, so a test gives both
packages the same ones.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..data.store import ClipStore, normalize_u8
from ..models.registry import path_model
from ..ops.losses import lb_margin_th
from .dm import REAL_CHUNK, embed, norm_stats, real_chunk, real_features
from .params import layout_for
from .s2d import S2DConfig, hallucinate, hallucinate_frozen, init_s2d_state

POOL_BATCH = 500  # the pool step's rows at most (distill_s2d.py:150)


def frepo_labels(labels: np.ndarray, num_classes: int,
                 scale: Optional[float] = None) -> np.ndarray:
    """Centred one-hot ``y - 1/C``, divided by ``scale`` if given (the
    synthetic labels use sqrt(C/10); distill_s2d.py:253-263)."""
    y = np.eye(num_classes, dtype=np.float32)[labels] - 1.0 / num_classes
    if scale:
        y = y / scale
    return y


def _krr_dtype(t):
    return torch.promote_types(t.dtype, torch.float32)


def krr_solve(feat_proto, y_proto, reg: float = 1e-6):
    """(K_pp + |reg| tr(K_pp)/n I)^-1 y by Cholesky, at least in fp32. The
    trace term is in the graph, so a gradient flows through it too."""
    dt = _krr_dtype(feat_proto)
    fp = feat_proto.to(dt)
    k_pp = fp @ fp.T
    n = k_pp.shape[0]
    eye = torch.eye(n, dtype=dt, device=fp.device)
    k_pp_reg = k_pp + abs(reg) * torch.trace(k_pp) * eye / n
    return torch.cholesky_solve(y_proto.to(dt), torch.linalg.cholesky(k_pp_reg))


def nfr(feat_target, feat_proto, y_proto, reg: float = 1e-6):
    """The KRR prediction ``K_tp (K_pp + |reg| tr(K_pp)/n I)^-1 y``
    (frepo.py:53-62), at least in fp32."""
    dt = _krr_dtype(feat_proto)
    k_tp = feat_target.to(dt) @ feat_proto.to(dt).T
    return k_tp @ krr_solve(feat_proto, y_proto, reg)


@dataclasses.dataclass
class FRePoConfig:
    num_classes: int
    ppc: int = 1                   # prototypes per class (spc)
    dpc: int = 1
    frames: int = 16
    im_size: Tuple[int, int] = (112, 112)
    n_hal: int = 1
    hal_mode: str = "concat"
    lr_d: float = 1e2
    lr_h: float = 1e-3
    lr_net: float = 3e-4
    num_nn_state: int = 10
    max_online_updates: int = 100
    Iteration: int = 10000
    batch_real: int = 512
    learn_label: bool = False
    reg: float = 1e-6
    s2d: bool = True


def _f32(t, device):
    return torch.tensor(float(t), dtype=torch.float32, device=device)


def pool_lr(lr_net: float, max_online_updates: int, count: int, device=None):
    """The pool's learning rate at optax count ``count``: a linear warm-up
    0.01 -> 1 over 500 counts times a cosine to 1% over
    ``max_online_updates`` (frepo.py:89-98), in fp32 as the JAX schedule."""
    t = _f32(count, device)
    warm = torch.clamp(0.01 + (1.0 - 0.01) * t / 500.0, max=1.0)
    cos = 0.01 + 0.5 * (1 - 0.01) * (1 + torch.cos(
        math.pi * torch.clamp(t, max=max_online_updates) / max_online_updates))
    return lr_net * warm * cos


def proto_lr(lr: float, lr_h: float, iterations: int, count: int, device=None):
    """A synthetic group's learning rate at optax count ``count``: a cosine
    from ``lr`` to the floor ``0.1 lr_h`` shared by both groups over
    ``iterations`` (frepo.py:261-268), in fp32 as the JAX schedule."""
    eta_min = 0.1 * lr_h
    frac = torch.clamp(_f32(count, device), max=iterations) / iterations
    return eta_min + (lr - eta_min) * 0.5 * (1 + torch.cos(math.pi * frac))


@torch.no_grad()
def adam_update(p, g, m, v, count: int, lr, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8):
    """optax.adam's step at count ``count`` (before its increment) with the
    learning rate ``lr``: returns (p, m, v)."""
    m = (1 - b1) * g + b1 * m
    v = (1 - b2) * g ** 2 + b2 * v
    m_hat = m / bias_correction(b1, count + 1, p.device).to(m.dtype)
    v_hat = v / bias_correction(b2, count + 1, p.device).to(v.dtype)
    return p + (-lr).to(p.dtype) * (m_hat / (torch.sqrt(v_hat) + eps)), m, v


def bias_correction(decay: float, t: int, device=None):
    """``1 - decay^t`` in fp32 from the fp32 decay, as optax and the JAX
    evaluation compute it (``1 - 0.999`` is 1.3e-5 off in fp32)."""
    return 1 - _f32(decay, device) ** _f32(t, device)


def _tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, list):
        return [_tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _unflatten_like(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten_like(tree[k], it) for k in tree}
    if isinstance(tree, list):
        return [_unflatten_like(t, it) for t in tree]
    return next(it)


class ModelPool:
    """The online pool (frepo.py:101-162): ``num_nn_state`` nets, each a
    dict of ``params`` (flat θ, JAX order), Adam ``m`` and ``v``, the optax
    ``count`` and the ``step``. ``init_params(generator)`` draws a fresh θ
    (tests replace it to hand in the JAX package's nets)."""

    def __init__(self, model, cfg: FRePoConfig, generator, dtype=torch.float32):
        self.model, self.cfg, self.dtype = model, cfg, dtype
        self.layout = layout_for(model)
        stagger = cfg.max_online_updates // cfg.num_nn_state
        self.elements = [self._fresh(generator, stagger * idx)
                         for idx in range(cfg.num_nn_state)]

    def init_params(self, generator) -> torch.Tensor:
        self.model.reset_parameters(generator)
        return self.layout.flatten(dict(self.model.named_parameters())).detach(
            ).to(self.dtype)

    def _fresh(self, generator, step: int) -> dict:
        theta = self.init_params(generator)
        return {"params": theta, "m": torch.zeros_like(theta),
                "v": torch.zeros_like(theta), "count": 0, "step": step}

    def state_dict(self):
        return [dict(el) for el in self.elements]

    def load_state_dict(self, sd):
        if len(sd) != len(self.elements):
            raise ValueError(f"pool of {len(self.elements)} nets, state of "
                             f"{len(sd)}")
        dev = self.elements[0]["params"].device
        self.elements = [{"params": s["params"].to(dev, self.dtype),
                          "m": s["m"].to(dev, self.dtype),
                          "v": s["v"].to(dev, self.dtype),
                          "count": int(s["count"]), "step": int(s["step"])}
                         for s in sd]

    def sample_idx(self, np_rng: np.random.Generator) -> int:
        return int(np_rng.integers(0, self.cfg.num_nn_state))

    def params(self, idx: int):
        """Torch-layout views of net ``idx``'s θ."""
        return self.layout.unflatten(self.elements[idx]["params"])

    def train_step(self, idx: int, x_syn, y_syn, np_rng, generator=None,
                   keep_mask=None):
        """One Adam step of net ``idx`` on (at most 500 rows of) the
        prototypes, in train mode; resets the net after
        ``max_online_updates`` steps. Returns the MSE loss."""
        cfg, el = self.cfg, self.elements[idx]
        n = x_syn.shape[0]
        if n > POOL_BATCH:
            sel = torch.as_tensor(np_rng.choice(n, size=POOL_BATCH,
                                                replace=False),
                                  device=x_syn.device)
            x_syn, y_syn = x_syn[sel], y_syn[sel]
        theta = el["params"].detach().requires_grad_(True)
        out = functional_call(self.model, self.layout.unflatten(theta),
                              (x_syn.to(self.dtype),),
                              dict(train=True, generator=generator,
                                   keep_mask=keep_mask))
        loss = torch.mean((out - y_syn.to(out.dtype)) ** 2)
        (g,) = torch.autograd.grad(loss, theta)
        lr = pool_lr(cfg.lr_net, cfg.max_online_updates, el["count"],
                     theta.device)
        el["params"], el["m"], el["v"] = adam_update(
            theta.detach(), g, el["m"], el["v"], el["count"], lr)
        el["count"] += 1
        el["step"] += 1
        if el["step"] >= cfg.max_online_updates:
            self.elements[idx] = self._fresh(generator, 0)
        return loss.detach()


class FRePoTrainer:
    """The FRePo trainer (``make_frepo_trainer``, frepo.py:202-380).

    ``state`` holds the learned tensors (S2D: ``dynamic``, ``hals``,
    ``y_syn``; raw: ``x_proto``, ``y_syn``), ``opt`` their Adam moments and
    optax count, ``static`` the frozen stills, ``pool`` the online nets.
    ``step(generator, np_rng)`` runs one outer iteration. ``generator``
    draws the initial state and then the pool's nets; ``dtype`` (fp32, or
    fp64 for a reference run on the CPU) is the whole step's;
    ``shard_store`` raises (ROADMAP A.16)."""

    def __init__(self, store: ClipStore, model_name: str, cfg: FRePoConfig,
                 generator=None, path_static: Optional[np.ndarray] = None,
                 device="cuda", dtype=torch.float32,
                 shard_store: bool = False):
        if cfg.ppc != cfg.dpc:
            raise ValueError(
                f"FRePo needs ppc == dpc (got ppc={cfg.ppc}, dpc={cfg.dpc}): "
                "the synthetic labels have C*ppc rows and the prototypes "
                "C*dpc")
        meta = store.meta
        self.store, self.cfg, self.dtype = store, cfg, dtype
        self.device = torch.device(device)
        self.num_classes = cfg.num_classes
        # row-sharding the store is ROADMAP A.16: this raises naming it
        self.clips = store.device_clips(self.device, sharded=shard_store)
        self.model = path_model(model_name, meta.channel, cfg.num_classes,
                                tuple(meta.im_size), cfg.frames,
                                device=self.device)
        self.model.requires_grad_(False)
        self.norm_mean, self.norm_std = norm_stats(meta, self.device)
        self.y_train = torch.as_tensor(
            frepo_labels(store.labels, cfg.num_classes), device=self.device)
        y_syn = torch.as_tensor(frepo_labels(
            np.repeat(np.arange(cfg.num_classes), cfg.ppc), cfg.num_classes,
            scale=float(np.sqrt(cfg.num_classes / 10.0))), device=self.device)
        h, w = meta.im_size
        self.s2d_cfg = S2DConfig(num_classes=cfg.num_classes, spc=cfg.ppc,
                                 dpc=cfg.dpc, vpc=cfg.ppc, n_hal=cfg.n_hal,
                                 frames=cfg.frames, im_size=(h, w),
                                 hal_mode=cfg.hal_mode)
        if cfg.s2d:
            base = init_s2d_state(generator, self.s2d_cfg, self.device)
            if path_static is not None:
                base["static"] = torch.as_tensor(path_static,
                                                 device=self.device)
            self.static = base["static"].to(dtype)
            state = {"dynamic": base["dynamic"], "hals": base["hals"],
                     "y_syn": y_syn}
        else:
            # ProtoHolder (frepo.py:129-143): real clips per class
            idx = store.sample_per_class(np.random.default_rng(0),
                                         cfg.ppc).reshape(-1)
            self.static = None
            state = {"x_proto": store.normalize(torch.as_tensor(
                np.asarray(store.clips[idx]), device=self.device)),
                     "y_syn": y_syn}
        self.state = _tree_map(lambda t: t.to(dtype), state)
        self.opt = self.init_opt(self.state)
        self.pool = ModelPool(self.model, cfg, generator, dtype)

    @staticmethod
    def init_opt(state):
        zeros = lambda t: torch.zeros_like(t)  # noqa: E731
        return {"count": 0, "m": _tree_map(zeros, state),
                "v": _tree_map(zeros, state)}

    def state_dict(self):
        return {"state": self.state, "opt": self.opt,
                "pool": self.pool.state_dict()}

    def load_state_dict(self, sd):
        on = lambda t: t.to(self.device, self.dtype)  # noqa: E731
        self.state = _tree_map(on, sd["state"])
        self.opt = {"count": int(sd["opt"]["count"]),
                    "m": _tree_map(on, sd["opt"]["m"]),
                    "v": _tree_map(on, sd["opt"]["v"])}
        self.pool.load_state_dict(sd["pool"])

    def _hal_choice(self, generator):
        """A random hallucinator per prototype, or None for one."""
        if self.cfg.n_hal == 1:
            return None
        return torch.randint(0, self.cfg.n_hal,
                             (self.num_classes * self.cfg.dpc,),
                             generator=generator, device=self.device)

    def compose(self, state, hal_choice=None, frozen: bool = False):
        """All C*dpc prototypes (frepo.py:286-300): the raw ``x_proto``, or
        static i with dynamic (i // dpc, i % dpc) through hallucinator
        ``hal_choice[i]``; differentiable through ``hallucinate``, or
        ``frozen`` through ``hallucinate_frozen``."""
        if not self.cfg.s2d:
            return state["x_proto"]
        dy = state["dynamic"]
        dynamic = dy.reshape((-1,) + dy.shape[2:])
        if frozen:  # the evaluation composition is fp32
            outs = [hallucinate_frozen(
                _tree_map(lambda t: t.float(), p), self.static.float(),
                dynamic.float(), self.cfg.hal_mode).to(self.dtype)
                for p in state["hals"]]
        else:
            outs = [hallucinate(p, self.static, dynamic, self.cfg.hal_mode)
                    for p in state["hals"]]
        if self.cfg.n_hal == 1:
            return outs[0]
        return torch.stack(outs)[hal_choice,
                                 torch.arange(dynamic.shape[0],
                                              device=self.device)]

    @torch.no_grad()
    def compose_eval(self, generator=None):
        """The prototypes of the current state, without gradient
        (frepo.py:352-356)."""
        return self.compose(self.state, self._hal_choice(generator),
                            frozen=True)

    def real_feats(self, params, real_idx):
        """(len(real_idx), D) features of the real clips ``real_idx``, no
        gradient, in chunks of ``dm.real_chunk`` (``dm.REAL_CHUNK`` for
        ConvNet3D)."""
        return real_features(self.model, params, self.store, self.clips,
                             real_idx, self.norm_mean, self.norm_std,
                             self.dtype, real_chunk(self.model, self.cfg.frames,
                                                    self.store.meta.im_size,
                                                    REAL_CHUNK))

    def proto_step(self, params, real_idx, hal_choice=None):
        """One Adam step of the synthetic state against the pool net
        ``params`` (torch layout) and the real clips ``real_idx`` (1-D, on
        the device) (frepo.py:302-335). Returns (loss, ln, lb, grads)."""
        cfg = self.cfg
        feat_tar = self.real_feats(params, real_idx)
        y_tar = self.y_train[real_idx]
        trained = [k for k in self.state if k != "y_syn" or cfg.learn_label]
        leaf = {k: _tree_map(lambda t: t.detach().requires_grad_(k in trained),
                             v) for k, v in self.state.items()}
        x_syn = self.compose(leaf, hal_choice)
        feat_syn = embed(self.model, params, x_syn)
        pred = nfr(feat_tar, feat_syn, leaf["y_syn"], cfg.reg)
        ln = torch.sum((pred - y_tar.to(pred.dtype)) ** 2, dim=-1).mean()
        lb = lb_margin_th(leaf["y_syn"]).mean()
        loss = ln + lb
        inputs = [x for k in trained for x in _leaves(leaf[k])]
        got = iter(torch.autograd.grad(loss, inputs))
        grads = {k: (_unflatten_like(leaf[k], got) if k in trained
                     else torch.zeros_like(leaf[k])) for k in leaf}
        count = self.opt["count"]
        new = ([], [], [])  # state, m, v leaves
        for k in self.state:
            lr = proto_lr(cfg.lr_d if k in ("dynamic", "x_proto") else cfg.lr_h,
                          cfg.lr_h, cfg.Iteration, count, self.device)
            for p, g, m, v in zip(*(_leaves(t[k]) for t in (
                    self.state, grads, self.opt["m"], self.opt["v"]))):
                for out, t in zip(new, adam_update(p, g, m, v, count, lr)):
                    out.append(t)
        self.state, m, v = (_unflatten_like(self.state, iter(leaves))
                            for leaves in new)
        self.opt = {"count": count + 1, "m": m, "v": v}
        return loss.detach(), ln.detach(), lb.detach(), grads

    def step(self, generator=None, np_rng: Optional[np.random.Generator] = None):
        """One outer iteration (frepo.py:358-378): the proto step, then one
        pool step on the composed prototypes. Returns the metrics."""
        n = len(self.store)
        real_idx = torch.as_tensor(np_rng.choice(
            n, size=min(self.cfg.batch_real, n), replace=False),
            device=self.device)
        idx = self.pool.sample_idx(np_rng)
        loss, ln, lb, _ = self.proto_step(self.pool.params(idx), real_idx,
                                          self._hal_choice(generator))
        x_syn = self.compose_eval(generator)
        self.pool.train_step(idx, x_syn, self.state["y_syn"].detach(), np_rng,
                             generator)
        return {"loss": float(loss), "ln_loss": float(ln),
                "lb_loss": float(lb)}


@torch.no_grad()
def krr_evaluate(model, params, x_syn, y_syn, test_clips_u8, test_labels,
                 mean, std, reg: float = 1e-6, batch: int = 256) -> float:
    """KRR accuracy (frepo.py:165-199): the synthetic set's features form
    the kernel, each test clip's prediction is ``f_t K_pp^-1 y``. ``params``
    are torch-layout tensors of ``model``; the test clips are uint8 on the
    host, normalised on the device in batches of ``batch``."""
    device = x_syn.device
    feat_syn = embed(model, params, x_syn)
    sol = krr_solve(feat_syn, y_syn, reg)
    feat_syn = feat_syn.to(sol.dtype)
    correct, total = 0, 0
    for i in range(0, test_clips_u8.shape[0], batch):
        xb = torch.as_tensor(np.asarray(test_clips_u8[i:i + batch]),
                             device=device)
        yb = np.asarray(test_labels[i:i + batch])
        ft = embed(model, params, normalize_u8(xb, mean, std).to(x_syn.dtype))
        pred = ft.to(sol.dtype) @ feat_syn.T @ sol
        correct += int((pred.argmax(-1).cpu().numpy() == yb).sum())
        total += len(yb)
    return correct / max(1, total)
