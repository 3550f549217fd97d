"""Port parity: energy VAD, sliding CMVN, voiced-frame compaction.

Both packages are fed identical features; VAD decisions and compaction
masks must be exact, CMVN within 1e-4 (float32 cumsum vs the reference's
blocked triangular-matmul cumsum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepi_tpu import config as jcfg
from sepi_tpu.ops import cmvn as jcmvn
from sepi_tpu.ops import select as jsel
from sepi_tpu.ops import vad as jvad
from sepi_tpu_torch import config as tcfg
from sepi_tpu_torch.ops import cmvn as tcmvn
from sepi_tpu_torch.ops import select as tsel
from sepi_tpu_torch.ops import vad as tvad

torch.set_num_threads(2)


def _ragged_mask(b, t, lengths):
    mask = np.zeros((b, t), bool)
    for i, n in enumerate(lengths):
        mask[i, :n] = True
    return mask


@pytest.mark.parametrize("context", [0, 2, 5])
def test_energy_vad_exact(context):
    rng = np.random.default_rng(context)
    e = (rng.normal(size=(4, 400)) * 3 + 12).astype(np.float32)
    mask = _ragged_mask(4, 400, [400, 250, 31, 3])
    e[~mask] = 0.0
    jc = jcfg.VadConfig(frames_context=context)
    tc = tcfg.VadConfig(frames_context=context)
    ref = np.asarray(jvad.energy_vad(jnp.asarray(e), jnp.asarray(mask), jc))
    got = tvad.energy_vad(torch.from_numpy(e), torch.from_numpy(mask), tc).numpy()
    np.testing.assert_array_equal(got, ref)
    got1 = tvad.energy_vad(torch.from_numpy(e[0]), torch.from_numpy(mask[0]), tc).numpy()
    np.testing.assert_array_equal(got1, ref[0])


@pytest.mark.parametrize("t_len", [50, 300, 700])
@pytest.mark.parametrize("norm_vars", [False, True])
@pytest.mark.parametrize("center", [True, False])
def test_sliding_cmvn(t_len, norm_vars, center):
    rng = np.random.default_rng(t_len)
    feats = (rng.normal(size=(t_len, 5)) * 3 + 1).astype(np.float32)
    kw = dict(normalize_variance=norm_vars, center=center)
    ref = np.asarray(jcmvn.sliding_cmvn(feats, np.ones(t_len, bool), jcfg.CmvnConfig(**kw)))
    got = tcmvn.sliding_cmvn(torch.from_numpy(feats), torch.ones(t_len, dtype=torch.bool),
                             tcfg.CmvnConfig(**kw)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_sliding_cmvn_batched_masked():
    rng = np.random.default_rng(123)
    feats = rng.normal(size=(2, 400, 4)).astype(np.float32)
    mask = _ragged_mask(2, 400, [120, 400])
    ref = np.asarray(jcmvn.sliding_cmvn(feats, mask, jcfg.CmvnConfig()))
    got = tcmvn.sliding_cmvn(torch.from_numpy(feats), torch.from_numpy(mask),
                             tcfg.CmvnConfig()).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert np.all(got[0, 120:] == 0)


@pytest.mark.parametrize("t_pad", [175, 200, 299, 360])
def test_sliding_cmvn_short_utt_in_short_pad(t_pad):
    """half < n < window inside a pad shorter than the window: the left-
    edge routing and the saturating prefix sum must match the reference."""
    rng = np.random.default_rng(t_pad)
    n = 175
    feats = np.zeros((1, t_pad, 4), np.float32)
    feats[0, :n] = rng.normal(size=(n, 4)) * 2 + 1
    mask = _ragged_mask(1, t_pad, [n])
    ref = np.asarray(jcmvn.sliding_cmvn(feats, mask, jcfg.CmvnConfig()))
    got = tcmvn.sliding_cmvn(torch.from_numpy(feats), torch.from_numpy(mask),
                             tcfg.CmvnConfig()).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kw", [{}, dict(center=False), dict(normalize_variance=True)])
@pytest.mark.parametrize("one_utterance", [False, True])
def test_sliding_cmvn_routes_cpu_tensors_to_the_plain_version(monkeypatch, kw, one_utterance):
    """CPU tensors never reach the CUDA kernel: the call loads no library
    (none need be built) and returns the plain version's result exactly."""
    from sepi_tpu_torch import build

    def refuse(name):
        raise AssertionError(f"a CPU call loaded the {name} library")

    monkeypatch.setattr(build, "load", refuse)
    rng = np.random.default_rng(5)
    feats = torch.from_numpy(rng.normal(size=(2, 500, 6)).astype(np.float32))
    mask = torch.from_numpy(_ragged_mask(2, 500, [500, 260]))
    if one_utterance:
        feats, mask = feats[1], mask[1]
    cfg = tcfg.CmvnConfig(**kw)
    before = tcmvn.sliding_cmvn.launches
    got = tcmvn.sliding_cmvn(feats, mask, cfg)
    assert tcmvn.sliding_cmvn.launches == before
    assert torch.equal(got, tcmvn.sliding_cmvn_reference(feats, mask, cfg))
    assert "cmvn" not in build._LOADED


def test_sliding_cmvn_refuses_other_devices():
    """Neither CPU nor CUDA: no plain fallback, no kernel."""
    feats = torch.empty((1, 8, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tcmvn.sliding_cmvn(feats, torch.ones((1, 8), dtype=torch.bool, device="meta"))


def test_select_voiced_frames_exact():
    rng = np.random.default_rng(9)
    feats = rng.normal(size=(3, 64, 6)).astype(np.float32)
    voiced = rng.random((3, 64)) > 0.4
    voiced[2] = False  # an utterance with nothing voiced
    ref, mref = jsel.select_voiced_frames(jnp.asarray(feats), jnp.asarray(voiced))
    got, mask = tsel.select_voiced_frames(torch.from_numpy(feats), torch.from_numpy(voiced))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # frame order is kept
    np.testing.assert_array_equal(got.numpy()[0, : voiced[0].sum()], feats[0][voiced[0]])
    g1, m1 = tsel.select_voiced_frames(torch.from_numpy(feats[0]), torch.from_numpy(voiced[0]))
    np.testing.assert_array_equal(g1.numpy(), np.asarray(ref)[0])
