"""The port's audio ingest against the JAX package's: WAV round trips,
SPHERE through each package's binding of native/sphere.cc (PCM16 in both
byte orders, mu-law, a shorten stream), the cache fingerprints as equal
strings, and the lazy views."""

import numpy as np
import pytest
import torch

from sepi_tpu.data import audio as ref_audio
from sepi_tpu.data.manifest import Dataset as RefDataset
from sepi_tpu.data.manifest import Utterance as RefUtterance
from sepi_tpu.utils import sphere as ref_sphere
from sepi_tpu_torch.data import audio
from sepi_tpu_torch.data.manifest import Dataset, Utterance
from sepi_tpu_torch.utils import sphere

torch.set_num_threads(2)


def write_sph(path, payload: bytes, *, rate=8000, channels=1, samples=0,
              n_bytes=2, byte_format="01", coding="pcm"):
    fields = [
        f"sample_rate -i {rate}",
        f"channel_count -i {channels}",
        f"sample_count -i {samples}",
        f"sample_n_bytes -i {n_bytes}",
        f"sample_byte_format -s{len(byte_format)} {byte_format}",
        f"sample_coding -s{len(coding)} {coding}",
        "end_head",
    ]
    head = "NIST_1A\n   1024\n" + "\n".join(fields) + "\n"
    head = head.encode().ljust(1024, b" ")
    with open(path, "wb") as f:
        f.write(head)
        f.write(payload)


def _shorten_diff1(x, blocksize=256):
    """A one-channel shorten v2 stream (TR.156) of DIFF1 blocks, no running
    mean: header fields, per block the command, the residual width and the
    Rice-coded residuals, then QUIT."""
    bits = []

    def uvar(val, k):
        bits.extend([0] * (val >> k) + [1])
        bits.extend((val >> i) & 1 for i in range(k - 1, -1, -1))

    def ulong(val):
        nbit = int(val).bit_length()
        uvar(nbit, 2)
        uvar(val, nbit)

    def var(val, k):
        uvar((val << 1) if val >= 0 else (((-val - 1) << 1) | 1), k + 1)

    for v in (3, 1, blocksize, 0, 0, 0):  # s16 hi-lo, 1 channel, maxnlpc, nmean, nskip
        ulong(v)
    prev, pos, bs = 0, 0, blocksize
    while pos < len(x):
        if pos + bs > len(x):
            bs = len(x) - pos
            uvar(5, 2)  # BLOCKSIZE
            ulong(bs)
        block = [int(v) for v in x[pos:pos + bs]]
        res = []
        for v in block:
            res.append(v - prev)
            prev = v
        resn = min(30, max(1, max(abs(r).bit_length() for r in res)))
        uvar(1, 2)  # DIFF1
        uvar(resn, 3)
        for r in res:
            var(r, resn)
        pos += bs
    uvar(4, 2)  # QUIT
    bits += [0] * (-len(bits) % 32)
    body = bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))
    return b"ajkg" + bytes([2]) + body


def _ulaw_to_lin(u: int) -> int:
    u = ~u & 0xFF
    sign, exp, mant = u & 0x80, (u >> 4) & 7, u & 0x0F
    lin = (((mant << 3) + 0x84) << exp) - 0x84
    return -lin if sign else lin


def test_wav_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4001) * 9000).astype(np.float32)
    p = str(tmp_path / "a.wav")
    audio.write_wav(p, x, 8000)
    got, rate = audio.read_wav(p)
    ref, ref_rate = ref_audio.read_wav(p)
    assert rate == ref_rate == 8000 and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.round(np.clip(x, -32768, 32767)))
    ref_audio.write_wav(str(tmp_path / "b.wav"), x, 8000)
    assert open(p, "rb").read() == open(tmp_path / "b.wav", "rb").read()


@pytest.mark.parametrize("kind", ["pcm01", "pcm10", "ulaw", "shorten"])
def test_read_sph_equals_the_reference(tmp_path, kind):
    rng = np.random.default_rng(1)
    p = str(tmp_path / f"{kind}.sph")
    if kind.startswith("pcm"):
        x = rng.integers(-30000, 30000, size=700).astype(np.int16)
        fmt, dt = ("01", "<i2") if kind == "pcm01" else ("10", ">i2")
        write_sph(p, x.astype(dt).tobytes(), samples=len(x), byte_format=fmt)
        want = x.astype(np.int64)
    elif kind == "ulaw":
        payload = bytes(range(256))
        write_sph(p, payload, samples=256, n_bytes=1, byte_format="1", coding="ulaw")
        want = np.array([_ulaw_to_lin(b) for b in payload])
    else:
        t = np.arange(1000)
        x = np.clip(8000 * np.sin(t / 7.0) + rng.normal(scale=300, size=t.size),
                    -20000, 20000).astype(np.int64)
        write_sph(p, _shorten_diff1(x), samples=len(x),
                  coding="pcm,embedded-shorten-v2.00")
        want = x
    got, rate = sphere.read_sph(p)
    ref, _ = ref_sphere.read_sph(p)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got.astype(np.int64), want)
    assert rate == 8000 and sphere.sph_info(p) == ref_sphere.sph_info(p)
    # read_audio dispatches on the extension
    np.testing.assert_array_equal(audio.read_audio(p)[0], got)


def test_bad_sphere_raises(tmp_path):
    p = str(tmp_path / "x.sph")
    with open(p, "wb") as f:
        f.write(b"RIFFnot a sphere header")
    with pytest.raises(ValueError, match="bad SPHERE header"):
        sphere.read_sph(p)


def _manifests(tmp_path):
    """The same rows for both packages: two WAV files, one SPHERE file and
    two utterances of an in-memory pool."""
    rng = np.random.default_rng(2)
    rows, pool = [], {}
    for i in range(2):
        p = str(tmp_path / f"w{i}.wav")
        audio.write_wav(p, rng.standard_normal(3000 + 100 * i) * 3000, 8000)
        rows.append(dict(utt_id=f"w{i}", spk_id="s0", wav=p, sample_rate=8000))
    sph = str(tmp_path / "s.sph")
    write_sph(sph, rng.integers(-3000, 3000, 1200).astype("<i2").tobytes(), samples=1200)
    rows.append(dict(utt_id="s", spk_id="s1", wav=sph, sample_rate=8000))
    for i in range(2):
        pool[f"p{i}"] = (rng.standard_normal(2000 + i) * 100).astype(np.float32)
        rows.append(dict(utt_id=f"p{i}", spk_id="s1", wav=f"mem:p{i}", sample_rate=8000))
    ds = Dataset([Utterance(**r) for r in rows], "m")
    ref_ds = RefDataset([RefUtterance(**r) for r in rows], "m")
    store, ref_store = audio.AudioStore(), ref_audio.AudioStore()
    store.register_pool("mem", pool)
    ref_store.register_pool("mem", pool)
    return store.lazy_dataset(ds), ref_store.lazy_dataset(ref_ds), pool


def test_fingerprints_are_the_reference_strings(tmp_path):
    lazy, ref_lazy, pool = _manifests(tmp_path)
    assert lazy.manifest_fingerprint() == ref_lazy.manifest_fingerprint()
    decoded = {u: lazy[u] for u in lazy}
    assert audio.content_fingerprint(decoded) == ref_audio.content_fingerprint(decoded)
    chain = audio.ChainAudio(lazy, {"x": np.ones(5, np.float32)})
    ref_chain = ref_audio.ChainAudio(ref_lazy, {"x": np.ones(5, np.float32)})
    assert chain.manifest_fingerprint() == ref_chain.manifest_fingerprint()
    changed = dict(decoded, p0=decoded["p0"] + 1.0)
    assert audio.content_fingerprint(changed) != audio.content_fingerprint(decoded)


def test_lazy_and_chain_views_behave_as_the_reference(tmp_path):
    lazy, ref_lazy, pool = _manifests(tmp_path)
    extra = {"x": np.arange(7, dtype=np.float32), "p0": np.zeros(3, np.float32)}
    for view, ref in ((lazy, ref_lazy),
                      (audio.ChainAudio(lazy, extra), ref_audio.ChainAudio(ref_lazy, extra))):
        assert list(view) == list(ref) and len(view) == len(ref)
        for u in ref:
            assert u in view
            assert view.num_samples(u) == ref.num_samples(u) == len(ref[u])
            np.testing.assert_array_equal(view[u], ref[u])
        assert "nope" not in view
    np.testing.assert_array_equal(lazy["p1"], pool["p1"])
    with pytest.raises(KeyError):
        audio.ChainAudio(lazy)["nope"]


def test_extract_segments_as_the_reference():
    rng = np.random.default_rng(3)
    recs = {"r1": rng.standard_normal(8000).astype(np.float32)}
    rows = [dict(utt_id="a", spk_id="s", recording="r1", start=0.1, end=0.6),
            dict(utt_id="b", spk_id="s", recording="r1", start=0.5, end=1.2),
            dict(utt_id="c", spk_id="s", recording="r9", start=0.0, end=0.5),
            dict(utt_id="d", spk_id="s", recording="r1", start=0.2, end=0.25)]
    msgs, ref_msgs = [], []
    out = audio.extract_segments(recs, Dataset([Utterance(**r) for r in rows]), 8000,
                                 log=msgs.append)
    ref = ref_audio.extract_segments(recs, RefDataset([RefUtterance(**r) for r in rows]),
                                     8000, log=ref_msgs.append)
    assert sorted(out) == sorted(ref) == ["a", "b"] and msgs == ref_msgs
    for u in ref:
        np.testing.assert_array_equal(out[u], ref[u])
