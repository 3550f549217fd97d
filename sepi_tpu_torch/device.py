"""Device resolution for the port's entry points.

Entry points take ``device=`` and default to ``"cuda"``.  The CPU is used
only when a caller names it: a CUDA request on a host without a usable
GPU raises instead of quietly running somewhere else.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
