"""Device resolution and fp32 math for the port's entry points.

Entry points take ``device=`` and default to ``"cuda"``.  The CPU is used
only when a caller names it: a CUDA request on a host without a usable
GPU raises instead of quietly running somewhere else.

Every number the port reports against the reference is float32 math.
PyTorch's defaults let cuDNN convolutions run in TF32 (10-bit mantissa
products), so the training, extraction and recipe entry points run inside
`fp32_math`, which turns TF32 off for matmuls and cuDNN and restores the
caller's flags on exit.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Union

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


@contextlib.contextmanager
def fp32_math() -> Iterator[None]:
    """TF32 off for CUDA matmuls and cuDNN inside the block (or the
    function decorated with ``@fp32_math()``); the caller's flags come back
    on exit.  `torch.backends.cudnn.flags` is given the
    current values of everything but TF32, since its own defaults would
    turn cuDNN off."""
    cudnn = torch.backends.cudnn
    keep = dict(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                deterministic=cudnn.deterministic)
    if hasattr(cudnn, "benchmark_limit"):
        keep["benchmark_limit"] = cudnn.benchmark_limit
    prev_matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with cudnn.flags(allow_tf32=False, **keep):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_matmul

