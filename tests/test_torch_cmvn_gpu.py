"""The sliding-CMVN kernel (`csrc/cmvn.cu`) on the card (marked ``gpu``; skipped without one).

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cmvn_gpu.py

Each case runs the kernel, its plain version in float32 (`torch.cumsum`)
and the plain version in float64 on the same features.  The kernel sums
in another order than `torch.cumsum` (32-frame tile sums, their prefixes in
double, window scans of at most 95 frames in float), so it is held to the
float64 result within a tolerance from float32 rounding (`_tolerance`), and
to the float32 plain version within that tolerance plus the plain version's
own distance from float64.
"""

import numpy as np
import pytest
import torch

from sepi_tpu_torch import graphs
from sepi_tpu_torch.config import CmvnConfig
from sepi_tpu_torch.graphs import CallGraphs
from sepi_tpu_torch.ops import cmvn

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu

EPS = float(np.finfo(np.float32).eps)
SPAN = 95  # most frames of one window scan in the kernel (kRows + kTile - 1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU build")
    return torch.device("cuda")


def _features(b, t, d, lengths, seed, device, holes=False):
    """MFCC-like features (column offsets -10..20, spread 3) zeroed past
    each utterance's length, and the frame mask; ``holes`` drops a third of
    the frames inside the lengths as well."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, d)) * 3 + np.linspace(-10, 20, d)
    mask = np.arange(t)[None] < np.asarray(lengths)[:, None]
    if holes:
        mask &= rng.random((b, t)) > 1 / 3
    x[~mask] = 0.0
    return (torch.tensor(x.astype(np.float32), device=device),
            torch.tensor(mask, device=device))


def _tolerance(feats, mask, cfg):
    """Float32 rounding of the kernel's arithmetic against float64.  A mean
    carries the window sum rounded once from double and two float scans of
    at most SPAN frames (random-walk rounding, ~SPAN^1.5 / 2 ulps of the
    largest feature, over w), then the subtraction (a few ulps).  With
    normalize_variance the same holds for the squares' window sums, and both
    errors are divided by the smallest window standard deviation."""
    w = cfg.window
    ref64 = cmvn.sliding_cmvn_reference
    x = feats.double()
    ulps = 4 + SPAN ** 1.5 / w
    tol_mean = EPS * float(x.abs().max()) * ulps
    if not cfg.normalize_variance:
        return tol_mean
    flat = CmvnConfig(window=w, center=cfg.center)
    valid = mask[..., None].expand_as(x)
    mean = (x - ref64(x, mask, flat))[valid]
    ex2 = (x * x - ref64(x * x, mask, flat))[valid]
    var = torch.clamp(ex2 - mean * mean, min=1e-10)
    out = ref64(x, mask, cfg)[valid]
    tol_ex2 = EPS * float((x * x).abs().max()) * ulps
    return float(((tol_mean + out.abs() * tol_ex2 / (2 * var.sqrt())) / var.sqrt()).max())


CASES = {
    # name: (B, T, D, lengths, CmvnConfig kwargs)
    "verify": (1, 6600, 23, [6431], {}),
    "verify_full": (1, 6600, 23, [6600], {}),
    "extract": (16, 32100, 23, [32100, 1, 100, 149, 150, 151, 299, 300, 301, 450, 2000,
                                9000, 17001, 24000, 31999, 32099], {}),
    "vox16k_short": (16, 3000, 80, [3000, 2999, 1, 40, 1000, 1500, 2048, 2500] * 2,
                     dict(window=10000)),
    "vox16k_long": (16, 18000, 80, [18000, 17999, 10001, 10000, 9999, 5001, 5000, 4999,
                                    12000, 15000, 1, 3, 600, 7000, 13333, 16000],
                    dict(window=10000)),
    "uncentred": (4, 2000, 23, [2000, 1, 299, 1200], dict(center=False)),
    "variance": (4, 2000, 23, [2000, 2, 149, 1200], dict(normalize_variance=True)),
    "variance_uncentred": (4, 2000, 23, [2000, 2, 301, 777],
                           dict(normalize_variance=True, center=False)),
    "hires40": (4, 2500, 40, [2500, 1, 140, 1999], {}),
    "deltas69": (4, 2500, 69, [2500, 1, 140, 1999], {}),
    "small_window": (3, 700, 23, [700, 1, 33], dict(window=7)),
    "holes": (3, 1500, 23, [1500, 1400, 600], {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cmvn_kernel_matches_plain(cuda, case):
    b, t, d, lengths, kw = CASES[case]
    cfg = CmvnConfig(**kw)
    feats, mask = _features(b, t, d, lengths, len(case), cuda, holes=case == "holes")
    before = cmvn.sliding_cmvn.launches
    got = cmvn.sliding_cmvn(feats, mask, cfg)
    torch.cuda.synchronize()
    assert cmvn.sliding_cmvn.launches == before + 1
    plain = cmvn.sliding_cmvn_reference(feats, mask, cfg)
    want = cmvn.sliding_cmvn_reference(feats.double(), mask, cfg)
    tol = _tolerance(feats, mask, cfg)
    err = float((got.double() - want).abs().max())
    plain_err = float((plain.double() - want).abs().max())
    assert err <= tol, (err, tol, plain_err)
    assert float((got - plain).abs().max()) <= tol + plain_err
    assert not got[~mask].any()  # zero on padding


def test_cmvn_kernel_takes_one_utterance(cuda):
    """(T, D) features and a (T,) mask: the batched call's first row."""
    feats, mask = _features(2, 900, 23, [900, 500], 3, cuda)
    both = cmvn.sliding_cmvn(feats, mask)
    assert torch.equal(cmvn.sliding_cmvn(feats[0], mask[0]), both[0])
    assert torch.equal(cmvn.sliding_cmvn(feats[1], mask[1]), both[1])


def test_cmvn_kernel_in_a_captured_call_equals_eager(cuda):
    """Captured into a CUDA graph and replayed on new features: equal to the
    eager call, one launch counted on every call, the replays' included."""
    cfg = CmvnConfig()
    run = CallGraphs(lambda f, m: cmvn.sliding_cmvn(f, m, cfg), device=cuda)
    for seed in (1, 2, 3):
        feats, mask = _features(4, 3300, 23, [3300, 1800, 150, 1], seed, cuda)
        before = cmvn.sliding_cmvn.launches
        got = run(feats, mask)
        torch.cuda.synchronize()
        # the capturing call counts its eager warm-up calls, a replay one
        assert cmvn.sliding_cmvn.launches - before == (graphs.CALL_WARMUP if seed == 1 else 1)
        before = cmvn.sliding_cmvn.launches
        want = cmvn.sliding_cmvn(feats, mask, cfg)
        assert cmvn.sliding_cmvn.launches == before + 1
        assert torch.equal(got, want)
    assert len(run.graphs) == 1


def test_cmvn_wrapper_rejects_bad_input(cuda):
    feats, mask = _features(2, 100, 23, [100, 50], 4, cuda)
    with pytest.raises(ValueError):
        cmvn.sliding_cmvn(feats.double(), mask)
    with pytest.raises(ValueError):
        cmvn.sliding_cmvn(feats, mask.float())
    with pytest.raises(ValueError):
        cmvn.sliding_cmvn(feats, mask[:, :99])
    with pytest.raises(ValueError):
        cmvn.sliding_cmvn(feats, mask, CmvnConfig(window=0))
