"""Device selection for the port's entry points."""

from __future__ import annotations

import torch

from ..parallel import dist


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises if CUDA is asked for and missing; never falls back.

    Under a process group, ``"cuda"`` is this rank's card,
    ``cuda:LOCAL_RANK``. A group built from the launcher's environment
    must not hold more ranks than there are cards; a group the caller
    built may (two gloo ranks sharing one card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device: {device}")
    if dev.type == "cuda" and dev.index is None and dist.active():
        cards = torch.cuda.device_count()
        if dist.owns_group() and dist.world_size() > cards:
            raise RuntimeError(f"{dist.world_size()} ranks but {cards} CUDA "
                               "device(s): launch at most one rank a card")
        dev = torch.device("cuda", dist.local_rank() % cards)
    return dev


def use_exact_fp32():
    """Make float32 mean IEEE fp32 on the card: cuDNN convolutions default
    to TF32, matmuls do not; both are switched off explicitly."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def step_generator(seed: int, it: int, device) -> torch.Generator:
    """The generator of step ``it`` of a run seeded ``seed``: a function of
    (seed, it) alone, so a resumed run draws what an uninterrupted one
    would (the JAX package's ``fold_in(key, it)``)."""
    return torch.Generator(device=device).manual_seed(seed * 2 ** 32 + it)
