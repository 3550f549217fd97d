"""The port's CUDA kernels on the card (marked ``gpu``; skipped without one).

Run on a machine with an NVIDIA Hopper GPU, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``--noconftest`` because tests/conftest.py configures JAX, which the
port's machine need not have.)  Each kernel is compared with its plain
PyTorch version on the same device at small shapes.
"""

import numpy as np
import pytest
import torch

from sepi_tpu_torch.config import FrontendConfig
from sepi_tpu_torch.ops import mfcc_cuda
from sepi_tpu_torch.ops.dither import utt_seeds
from sepi_tpu_torch.ops.framing import num_frames

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU build")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dither", [0.0, 1.0])
@pytest.mark.parametrize("snip", [False, True])
def test_mfcc_kernel_matches_plain(cuda, dither, snip):
    cfg = FrontendConfig(dither=dither, snip_edges=snip)
    rng = np.random.default_rng(int(dither) + 2 * snip)
    n = 3 * 8000 + 123
    x = torch.tensor((rng.normal(size=(3, n)) * 3000).astype(np.float32), device=cuda)
    lengths = torch.tensor([n, int(0.61 * n), 207], dtype=torch.int32, device=cuda)
    seeds = torch.tensor(utt_seeds(["a", "b", "c"]), device=cuda) if dither else None
    tmax = int(num_frames(n, cfg))
    before = mfcc_cuda.mfcc_fused.launches
    got, mask = mfcc_cuda.mfcc_fused(x, lengths, cfg, tmax, seeds)
    ref, mref = mfcc_cuda.mfcc_fused_reference(x, lengths, cfg, tmax, seeds)
    torch.cuda.synchronize()
    assert mfcc_cuda.mfcc_fused.launches == before + 1
    assert torch.equal(mask, mref)
    assert float((got - ref).abs().max()) < 2e-3


def test_mfcc_kernel_wide_config(cuda):
    """16 kHz / 40 mel: two passes over 256 bins, energy off."""
    cfg = FrontendConfig(dither=1.0, sample_rate=16000, num_mel_bins=40, num_ceps=40,
                         low_freq=40.0, high_freq=-200.0, use_energy=False)
    x = torch.randn((2, 40000), device=cuda) * 1000
    lengths = torch.tensor([40000, 12345], dtype=torch.int32, device=cuda)
    seeds = torch.tensor([3, 4], dtype=torch.int32, device=cuda)
    got, _ = mfcc_cuda.mfcc_fused(x, lengths, cfg, 250, seeds)
    ref, _ = mfcc_cuda.mfcc_fused_reference(x, lengths, cfg, 250, seeds)
    assert float((got - ref).abs().max()) < 2e-3


def test_mfcc_wrapper_rejects_bad_input(cuda):
    cfg = FrontendConfig()
    x = torch.zeros((2, 8000), device=cuda, dtype=torch.float64)
    lengths = torch.tensor([8000, 8000], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        mfcc_cuda.mfcc_fused(x, lengths, cfg, 100)
    with pytest.raises(ValueError):
        mfcc_cuda.mfcc_fused(x.float().t(), lengths, cfg, 100)
