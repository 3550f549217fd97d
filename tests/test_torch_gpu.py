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

from sepi_tpu_torch.align import viterbi_cuda
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


SRE8K = {}
HIRES16K = dict(sample_rate=16000, num_mel_bins=40, num_ceps=40, low_freq=40.0,
                high_freq=-200.0, use_energy=False)


@pytest.mark.parametrize("conf", ["sre8k", "hires16k"])
@pytest.mark.parametrize("dither", [0.0, 1.0])
@pytest.mark.parametrize("snip", [False, True])
def test_mfcc_kernel_configs_and_short_utterances(cuda, conf, dither, snip):
    """One launch, no tail-patch launches: utterances shorter than a frame,
    than the tail window, and ending inside and at the edge of a block."""
    cfg = FrontendConfig(dither=dither, snip_edges=snip,
                         **(SRE8K if conf == "sre8k" else HIRES16K))
    flen, shift = cfg.frame_length, cfg.frame_shift
    rng = np.random.default_rng(17 + int(dither) + 2 * snip)
    n = 70 * shift + flen
    lengths = [n, 64 * shift + shift // 2, 5 * shift, flen + 3, flen - 1, shift // 2 + 1, 1]
    x = (rng.normal(size=(len(lengths), n)) * 2000).astype(np.float32)
    for i, ln in enumerate(lengths):
        x[i, ln:] = 0.0
    x = torch.tensor(x, device=cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    seeds = torch.tensor(utt_seeds([f"u{i}" for i in range(len(lengths))]), device=cuda)
    tmax = int(num_frames(n, cfg))
    before = mfcc_cuda.mfcc_fused.launches
    got, mask = mfcc_cuda.mfcc_fused(x, lens, cfg, tmax, seeds if dither else None)
    ref, mref = mfcc_cuda.mfcc_fused_reference(x, lens, cfg, tmax, seeds if dither else None)
    torch.cuda.synchronize()
    assert mfcc_cuda.mfcc_fused.launches == before + 1
    assert torch.equal(mask, mref)
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) < 2e-3


def test_mfcc_wrapper_rejects_bad_input(cuda):
    cfg = FrontendConfig()
    x = torch.zeros((2, 8000), device=cuda, dtype=torch.float64)
    lengths = torch.tensor([8000, 8000], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        mfcc_cuda.mfcc_fused(x, lengths, cfg, 100)
    with pytest.raises(ValueError):
        mfcc_cuda.mfcc_fused(x.float().t(), lengths, cfg, 100)


def _viterbi_inputs(rng, b, t, s, tlen, skip=4, ties=False):
    if ties:
        emit = rng.integers(-3, 1, size=(b, t, s)).astype(np.float32)
        trans = np.full((b, 3, s), -1e30, np.float32)
        trans[:, 0, :] = trans[:, 1, 1:] = -1.0
        trans[:, 2, skip:] = -1.0
    else:
        emit = rng.normal(size=(b, t, s)).astype(np.float32)
        trans = np.full((b, 3, s), -1e30, np.float32)
        trans[:, 0, :] = np.log(0.6)
        trans[:, 1, 1:] = np.log(0.4)
        trans[:, 2, skip:] = np.where(rng.random((b, s - skip)) < 0.3, np.log(0.2), -1e30)
    return emit, np.asarray(tlen, np.int32), trans


@pytest.mark.parametrize("shape,tlen,ties", [
    ((3, 40, 128), [40, 25, 33], False),
    ((4, 57, 139), [57, 2, 1, 30], False),
    ((2, 33, 1100), [33, 20], False),
    ((3, 24, 128), [24, 11, 1], True),
    ((2, 1, 16), [1, 1], False),
])
def test_viterbi_kernel_matches_plain(cuda, shape, tlen, ties):
    """Backpointers equal over every state; delta within 1e-4 where live
    (> -1e29), equal elsewhere."""
    rng = np.random.default_rng(shape[2])
    emit, tl, trans = (torch.tensor(a, device=cuda)
                       for a in _viterbi_inputs(rng, *shape, tlen, ties=ties))
    before = viterbi_cuda.viterbi_batch.launches
    bp, d = viterbi_cuda.viterbi_batch(emit, tl, trans, 4)
    bp_r, d_r = viterbi_cuda.viterbi_batch_reference(emit, tl, trans, 4)
    torch.cuda.synchronize()
    assert viterbi_cuda.viterbi_batch.launches == before + 1
    assert bp.dtype == torch.int8 and bp.shape == (shape[0], shape[1] - 1, shape[2])
    assert torch.equal(bp, bp_r)
    live = d_r > -1e29
    assert float((d - d_r)[live].abs().max()) <= 1e-4
    assert torch.equal(d[~live], d_r[~live])


@pytest.mark.parametrize("s", [128, 144, 256, 512, 1024, 1100])
@pytest.mark.parametrize("skip", [1, 4, 8])
def test_viterbi_kernel_states_and_skips(cuda, s, skip):
    """The warp kernel (S <= 1024, including K < skip and S not a multiple
    of 32) and the block kernel (S > 1024), with lengths 1, 2 and ragged."""
    rng = np.random.default_rng(1000 * skip + s)
    tlen = [1, 2, 37, 50, 13]
    emit, tl, trans = (torch.tensor(a, device=cuda)
                       for a in _viterbi_inputs(rng, 5, 50, s, tlen, skip=skip))
    bp, d = viterbi_cuda.viterbi_batch(emit, tl, trans, skip)
    bp_r, d_r = viterbi_cuda.viterbi_batch_reference(emit, tl, trans, skip)
    torch.cuda.synchronize()
    assert torch.equal(bp, bp_r)
    live = d_r > -1e29
    assert float((d - d_r)[live].abs().max()) <= 1e-4
    assert torch.equal(d[~live], d_r[~live])


def test_viterbi_wrapper_rejects_bad_input(cuda):
    emit = torch.zeros((2, 8, 16), device=cuda)
    tl = torch.tensor([8, 8], dtype=torch.int32, device=cuda)
    trans = torch.zeros((2, 3, 16), device=cuda)
    with pytest.raises(ValueError):
        viterbi_cuda.viterbi_batch(emit.double(), tl, trans)
    with pytest.raises(ValueError):
        viterbi_cuda.viterbi_batch(emit.transpose(1, 2).contiguous().transpose(1, 2), tl, trans)
    with pytest.raises(ValueError):
        viterbi_cuda.viterbi_batch(emit, tl.long(), trans)
    with pytest.raises(ValueError):
        viterbi_cuda.viterbi_batch(emit, tl, trans.cpu())
    big = viterbi_cuda.MAX_STATES + 1
    with pytest.raises(ValueError):
        viterbi_cuda.viterbi_batch(torch.zeros((1, 2, big), device=cuda), tl[:1],
                                   torch.zeros((1, 3, big), device=cuda))
