"""Published peaks of the card (NVIDIA's H100 SXM data sheet, dense
rates, at the full 700 W power limit); a card set below it runs slower,
so every share of a peak is printed beside the card's power limit."""

from __future__ import annotations

from typing import Dict, Optional

PEAKS = {
    "H100": {
        "tf32_flops": 495e12,  # TF32 tensor cores: the highest rate for float32 inputs
        "bf16_flops": 989e12,
        "fp32_flops": 67e12,  # CUDA cores
        "hbm_bytes_per_s": 3.35e12,
        "memory_bytes": 80e9,
    },
}


def for_device(kind: str) -> Optional[Dict[str, float]]:
    """The peaks of a card named ``kind`` (`torch.cuda.get_device_name`),
    or None for a card the table does not hold."""
    for key, peaks in PEAKS.items():
        if key in kind:
            return peaks
    return None
