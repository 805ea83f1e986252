"""Peaks of the card, by the part its name gives (NVIDIA's H100 data sheet,
dense rates: the sheet's bf16 figures are with sparsity, half of each)."""

from __future__ import annotations

from typing import Dict


def card_peaks(name: str) -> Dict[str, float]:
    """{'bytes_per_s', 'float32', 'bfloat16'} (FLOP/s; float32 outside the
    tensor cores, bfloat16 dense on them) for an H100 named ``name``."""
    if "PCIe" in name:
        bw, fp32, bf16 = 2.0e12, 51e12, 756e12
    elif "NVL" in name:
        bw, fp32, bf16 = 3.9e12, 60e12, 835e12
    else:  # SXM
        bw, fp32, bf16 = 3.35e12, 67e12, 989e12
    return {"bytes_per_s": bw, "float32": fp32, "bfloat16": bf16}
