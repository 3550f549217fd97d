"""Port parity: the fused MFCC's plain version (sepi_tpu_torch.ops.mfcc_cuda).

`mfcc_fused_reference` is what the CUDA kernel is held against on the
card; here it is held against the JAX kernel run in interpret mode, which
is the reference's main path for dithered configs (its CPU default runs a
different, per-frame dither).  Inputs span more than one 256-frame noise
tile, so the tile boundary and its halo frames are covered.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepi_tpu import config as jcfg
from sepi_tpu.ops import mfcc_pallas as jm
from sepi_tpu.ops.framing import num_frames
from sepi_tpu_torch import config as tcfg
from sepi_tpu_torch.ops import mfcc_cuda as tm

torch.set_num_threads(2)


def _inputs(seed, n=3 * 8000 + 123):
    rng = np.random.default_rng(seed)
    samples = (rng.normal(size=(3, n)) * 3000).astype(np.float32)
    lengths = np.array([n, int(0.61 * n), 207], np.int32)
    seeds = np.array([11, -5, 2**30 + 7], np.int32)
    return samples, lengths, seeds


@pytest.mark.parametrize("dither", [0.0, 1.0])
@pytest.mark.parametrize("snip", [False, True])
def test_plain_matches_interpret_kernel(dither, snip):
    jc = jcfg.FrontendConfig(dither=dither, snip_edges=snip)
    tc = tcfg.FrontendConfig(dither=dither, snip_edges=snip)
    samples, lengths, seeds = _inputs(int(dither) + 2 * snip)
    tmax = int(num_frames(samples.shape[1], jc))
    assert tmax > tm.NOISE_TILE + 2  # crosses a noise-tile boundary
    use = seeds if dither else None
    ref, mref = jm.mfcc_fused(jnp.asarray(samples), jnp.asarray(lengths), jc, tmax,
                              interpret=True, seeds=use)
    got, mask = tm.mfcc_fused_reference(
        torch.from_numpy(samples), torch.from_numpy(lengths), tc, tmax,
        None if use is None else torch.from_numpy(use))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mref))
    err = np.abs(got.numpy() - np.asarray(ref)).max()
    assert err < 2e-3, err
    # the halo frames at the tile edge, on their own
    edge = slice(tm.NOISE_TILE - 3, tm.NOISE_TILE + 2)
    assert np.abs(got.numpy()[0, edge] - np.asarray(ref)[0, edge]).max() < 2e-3


def test_tail_only_utterance_dithered():
    """A 207-sample utterance alone: every frame is a recomputed tail frame."""
    jc, tc = jcfg.FrontendConfig(), tcfg.FrontendConfig()
    x = (np.random.default_rng(8).normal(size=(1, 207)) * 500).astype(np.float32)
    l, s = np.array([207], np.int32), np.array([42], np.int32)
    tmax = int(num_frames(207, jc))
    ref, mref = jm.mfcc_fused(jnp.asarray(x), jnp.asarray(l), jc, tmax,
                              interpret=True, seeds=s)
    got, mask = tm.mfcc_fused_reference(torch.from_numpy(x), torch.from_numpy(l), tc,
                                        tmax, torch.from_numpy(s))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mref))
    assert np.abs(got.numpy() - np.asarray(ref)).max() < 2e-3


def test_noise_is_tied_to_reference_tiles():
    """Frame 255's last samples and frame 256's first samples are the
    same signal samples, but the reference draws them from different
    tiles' maps (255 reads tile 0's halo rows), so their noise differs;
    inside a tile, overlapping frames share their samples' noise."""
    tc = tcfg.FrontendConfig()
    flen, shift = tc.frame_length, tc.frame_shift
    z = tm.noise_frames(torch.tensor([123], dtype=torch.int32), 300, tc)[0].numpy()
    ov = flen - shift  # overlap of consecutive frames
    assert not np.allclose(z[255, shift:], z[256, :ov])
    np.testing.assert_array_equal(z[100, shift:], z[101, :ov])
    np.testing.assert_array_equal(z[256, shift:], z[257, :ov])
    # standard normal, roughly
    assert abs(z.mean()) < 0.05 and abs(z.std() - 1.0) < 0.05


def test_supported_and_constants_match():
    for kw in [{}, {"snip_edges": True}, {"frame_shift_ms": 9.125},
               {"raw_energy": False}, {"sample_rate": 16000}, {"frame_length_ms": 5.0}]:
        assert tm.supported(tcfg.FrontendConfig(**kw)) == jm.supported(jcfg.FrontendConfig(**kw))
    for got, ref in zip(tm.reduced_spectral_consts(tcfg.FrontendConfig()),
                        jm.reduced_spectral_consts(jcfg.FrontendConfig())):
        np.testing.assert_array_equal(got, np.asarray(ref).reshape(got.shape))


def test_wrapper_on_cpu_runs_plain_version_without_launch():
    tc = tcfg.FrontendConfig()
    samples, lengths, seeds = _inputs(5, n=4000)
    args = (torch.from_numpy(samples), torch.from_numpy(lengths), tc, 50,
            torch.from_numpy(seeds))
    before = tm.mfcc_fused.launches
    got, mask = tm.mfcc_fused(*args)
    ref, mref = tm.mfcc_fused_reference(*args)
    assert tm.mfcc_fused.launches == before
    assert torch.equal(got, ref) and torch.equal(mask, mref)
    with pytest.raises(ValueError):
        tm.mfcc_fused(args[0], args[1], tc.replace(raw_energy=False), 50)


def test_mel_band_ranges_cover_every_nonzero_weight():
    """The kernel sums each mel band over [mel_lo, mel_hi) only."""
    for kw in [{}, {"num_mel_bins": 40, "low_freq": 40.0, "high_freq": -200.0}]:
        tc = tcfg.FrontendConfig(**kw)
        c = tm._consts(tc, torch.device("cpu"))
        mel = c.mel.numpy()
        for m in range(mel.shape[1]):
            nz = np.nonzero(mel[:, m])[0]
            assert nz.min() >= c.mel_lo[m] and nz.max() < c.mel_hi[m]
            # the kernel's compact weights: band m's rows lo..hi-1 at mel_off[m]
            lo, hi, off = int(c.mel_lo[m]), int(c.mel_hi[m]), int(c.mel_off[m])
            np.testing.assert_array_equal(c.mel_w.numpy()[off:off + hi - lo], mel[lo:hi, m])
        assert c.mel_w.shape[0] == int((c.mel_hi - c.mel_lo).sum())


HIRES16K = dict(sample_rate=16000, num_mel_bins=40, num_ceps=40, low_freq=40.0,
                high_freq=-200.0, use_energy=False)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest, as the kernel's
    split does: (bits + 0x1000) & ~0x1FFF."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's tensor cores compute it: hi*hi + hi*lo + lo*hi
    with hi = tf32(x), lo = tf32(x - hi), products of TF32 values exact in
    float32, sums in float32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


@pytest.mark.parametrize("conf", ["sre8k", "hires16k"])
def test_3xtf32_emulation_matches_plain(conf, monkeypatch):
    """The kernel's 3xTF32 DFT, emulated in plain torch, stays within the
    kernel's 2e-3 limit of the float32 plain version (dithered, tail frames
    included); a one-pass TF32 DFT is far worse, so the emulation does round."""
    kw = {} if conf == "sre8k" else HIRES16K
    tc = tcfg.FrontendConfig(**kw)
    rng = np.random.default_rng(31)
    n = 2 * tc.sample_rate + 77
    samples = (rng.normal(size=(3, n)) * 3000).astype(np.float32)
    lengths = np.array([n, n // 3, tc.frame_length + 5], np.int32)
    seeds = np.array([5, -9, 12345], np.int32)
    tmax = int(num_frames(n, jcfg.FrontendConfig(**kw)))
    args = (torch.from_numpy(samples), torch.from_numpy(lengths), tc, tmax,
            torch.from_numpy(seeds))
    ref, mref = tm.mfcc_fused_reference(*args)
    plain_chain = tm._spectral_chain

    def run_with(dft):
        monkeypatch.setattr(tm, "_spectral_chain", functools.partial(plain_chain, dft=dft))
        return tm.mfcc_fused_reference(*args)

    got, mask = run_with(_matmul_3xtf32)
    one, _ = run_with(lambda a, b: _tf32(a) @ _tf32(b))
    assert torch.equal(mask, mref)
    err3 = float((got - ref).abs().max())
    err1 = float((one - ref).abs().max())
    assert err3 < 2e-3, err3
    assert err3 < err1 / 10, (err3, err1)
    print(f"{conf}: 3xTF32 {err3:.3e}, one-pass TF32 {err1:.3e}")


@pytest.mark.parametrize("conf", ["sre8k", "hires16k"])
def test_fragment_basis_holds_every_basis_value_once(conf):
    """Inverting the documented fragment map of `fragment_basis` gives back
    the basis (padded with zero rows to whole ring stages)."""
    kw = {} if conf == "sre8k" else HIRES16K
    basis = tm.reduced_spectral_consts(tcfg.FrontendConfig(**kw))[0]
    frag = tm.fragment_basis(basis)
    flen, two_km = basis.shape
    km = two_km // 2
    passes, ksteps = frag.shape[:2]
    assert passes * tm.PASS_BINS == km and ksteps % tm.STEPS_PER_STAGE == 0
    assert ksteps * 8 >= flen > (ksteps - tm.STEPS_PER_STAGE) * 8
    rebuilt = np.full((ksteps * 8, two_km), np.nan, np.float32)
    for p in range(passes):
        for ks in range(ksteps):
            for wn in range(2):
                for q in range(4):
                    for lane in range(32):
                        g, c = divmod(lane, 4)
                        for e in range(4):
                            tile = 2 * q + e // 2
                            b = p * 64 + wn * 32 + (tile % 4) * 8 + g
                            col = b + (km if tile >= 4 else 0)
                            row = 8 * ks + c + 4 * (e % 2)
                            assert np.isnan(rebuilt[row, col])
                            rebuilt[row, col] = frag[p, ks, wn, q, lane, e]
    np.testing.assert_array_equal(rebuilt[:flen], basis)
    assert np.all(rebuilt[flen:] == 0.0)


@pytest.mark.parametrize("snip", [False, True])
def test_tail_plan_matches_frame_indices_and_patch(snip):
    """`tail_plan` (the kernel's tail-frame formula) against
    `framing.frame_indices` and `_patch_tail_and_mask`, over random lengths
    including ones shorter than a frame and than the tail window."""
    from sepi_tpu_torch.ops import framing
    from sepi_tpu_torch.ops.dither import MASK32, fmix32, hash_normal

    tc = tcfg.FrontendConfig(snip_edges=snip)
    flen, shift = tc.frame_length, tc.frame_shift
    rng = np.random.default_rng(7 + snip)
    n = 40 * shift
    lengths = [n, 1, 2, shift // 2 + 1, shift + 3, flen - 1, flen, flen + 1, 3 * shift]
    lengths += rng.integers(1, n + 1, size=12).tolist()
    b = len(lengths)
    tmax = int(framing.num_frames(n, tc)) - 2  # some utterances outrun max_frames
    samples = torch.from_numpy((rng.normal(size=(b, n)) * 100).astype(np.float32))
    lens = torch.tensor(lengths, dtype=torch.int32)
    seeds = torch.from_numpy(rng.integers(-2**31, 2**31, size=b).astype(np.int32))
    c = tm._consts(tc, torch.device("cpu"))
    zero = torch.zeros((b, tmax, tc.num_ceps))
    patched, mask = tm._patch_tail_and_mask(zero.clone(), samples, lens, tc, tmax, seeds, c)
    for u, ln in enumerate(lengths):
        t_valid = min(int(framing.num_frames(ln, tc)), tmax)
        assert int(mask[u].sum()) == t_valid
        t0, n_fix, idx, cnt, span = tm.tail_plan(t_valid, ln, tmax, tc)
        frames = torch.arange(t0, t0 + n_fix)[None]
        ref_idx = framing.frame_indices(frames, torch.tensor([ln]), tc)[0].numpy()
        np.testing.assert_array_equal(idx, ref_idx)
        pseed = fmix32(torch.tensor(int(seeds[u]) & MASK32) ^ tm._TAIL_MIX)
        x = samples[u][torch.from_numpy(idx)]
        x = x + tc.dither * hash_normal(pseed, torch.from_numpy(cnt), span)
        ceps = tm._spectral_chain(x, c, tc)
        for i in range(n_fix):
            f = t0 + i
            want = ceps[i] if f < t_valid else torch.zeros(tc.num_ceps)
            np.testing.assert_allclose(patched[u, f].numpy(), want.numpy(), rtol=0, atol=1e-5)
        # every frame outside the window is untouched (zero) by the patch
        outside = np.ones(tmax, bool)
        outside[t0:t0 + n_fix] = False
        assert np.all(patched[u].numpy()[outside] == 0.0)
