"""Device resolution, fp32 math and the host-device boundary of the port.

Entry points take ``device=`` and default to ``"cuda"``.  The CPU is used
only when a caller names it: a CUDA request on a host without a usable
GPU raises instead of quietly running somewhere else.

Every number the port reports against the reference is float32 math.
PyTorch's defaults let cuDNN convolutions run in TF32 (10-bit mantissa
products), so the training, extraction and recipe entry points run inside
`fp32_math`, which turns TF32 off for matmuls and cuDNN and restores the
caller's flags on exit.

The serving path crosses to the device one way: a caller packs each host
batch in place into `host_buffer`s with `pack_rows`, the captured call
(`graphs.CallGraphs`) makes the one copy, and `readback` brings the
outputs back.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence, Union

import numpy as np
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


def host_buffer(shape, dtype: torch.dtype, device: Optional[DeviceLike]) -> torch.Tensor:
    """An unset host batch buffer for ``device``: for a CUDA device a pinned
    block of torch's caching host allocator, which hands it out again only
    once the copies recorded on it are done; else (None too) a CPU tensor."""
    return torch.empty(shape, dtype=dtype,
                       pin_memory=device is not None and torch.device(device).type == "cuda")


def pack_rows(out: torch.Tensor, rows: Sequence[np.ndarray], lengths: Optional[torch.Tensor] = None,
              mask: Optional[torch.Tensor] = None) -> None:
    """Write each array of ``rows`` at the head of its row of the host
    buffer ``out``, its length into ``lengths`` and True over it into the
    bool ``mask``, zeroing every row's tail and every row past ``rows``: a
    buffer holding a former batch's bytes packs byte-equal to zero padding."""
    o, lens = out.numpy(), np.zeros(out.shape[0], np.int64)
    for b, x in enumerate(rows):
        lens[b] = len(x)
        o[b, :len(x)] = x
    for b, n in enumerate(lens):
        o[b, n:] = 0
    if lengths is not None:
        lengths.numpy()[:] = lens
    if mask is not None:
        mask.numpy()[:] = np.arange(mask.shape[1]) < lens[:, None]


def readback(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Tensors as host numpy arrays; from a CUDA device, views of pinned
    blocks (`host_buffer`) filled before one stream synchronize, which a
    caller copies out to keep."""
    if not tensors[0].is_cuda:
        return [t.cpu().numpy() for t in tensors]
    host = [host_buffer(t.shape, t.dtype, t.device).copy_(t, non_blocking=True) for t in tensors]
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [h.numpy() for h in host]
