"""The serving path's one way across the host-device boundary
(`sepi_tpu_torch.device`), on the CPU.  Callers pack each host batch in
place into `host_buffer`s, which on a CUDA device are pinned blocks that
torch's caching host allocator hands out again, so:
- `pack_rows`, into a buffer that holds a former batch's bytes, is
  byte-equal to zero padding: 1-D sample rows with their lengths, 2-D
  feature rows with their bool mask, at mixed lengths, at lengths equal to
  the bucket, and with rows of the buffer left unused;
- `readback` on the CPU equals ``.cpu().numpy()``;
- `padded_audio_batches`' default call still yields numpy arrays, equal
  to zero padding, and with a device yields host tensors of the same bytes;
- on the CPU nothing is staged (``frontend.staged_bytes`` stays 0), and
  `prepare_features_phonetic` hands out arrays that own their memory.
The pinned path itself runs on the card (`tests/test_torch_gpu.py`).
"""

import numpy as np
import pytest
import torch

from sepi_tpu_torch.config import CmvnConfig, FrontendConfig, VadConfig
from sepi_tpu_torch.device import host_buffer, pack_rows, readback
from sepi_tpu_torch.recipes import pipeline
from sepi_tpu_torch.utils import logging as L

torch.set_num_threads(2)


def _zero_padded(rows, shape):
    """The padding as a fresh zero buffer gives it: (rows, lengths, mask)."""
    out = np.zeros(shape, np.float32)
    lengths = np.zeros(shape[:1], np.int32)
    mask = np.zeros(shape[:2], bool)
    for b, x in enumerate(rows):
        out[b, :len(x)] = x
        lengths[b] = len(x)
        mask[b, :len(x)] = True
    return out, lengths, mask


def _audio(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return {f"a{i}": (rng.standard_normal(n) * 1000).astype(np.float32)
            for i, n in enumerate(lengths)}


# (row lengths, the buffer's shape): 1-D sample rows packed with their
# lengths, 2-D feature rows (23 wide) with their mask
PACKS = {
    "mixed": ((8000, 3217, 11999, 1), (4, 12000)),
    "full": ((12000, 12000, 12000), (3, 12000)),
    "features-mixed": ((50, 17, 64, 1), (4, 64, 23)),
    "features-full": ((64, 64), (2, 64, 23)),
    "features-unused-rows": ((30, 5, 64), (8, 64, 23)),
    "samples-unused-rows": ((7, 4000), (4, 4000)),
}


@pytest.mark.parametrize("case", list(PACKS), ids=list(PACKS))
def test_packing_in_place_over_stale_bytes_equals_zero_padding(case):
    lengths, shape = PACKS[case]
    rng = np.random.default_rng(len(case))
    rows = [(rng.standard_normal((n,) + shape[2:]) * 1000).astype(np.float32) for n in lengths]
    out = host_buffer(shape, torch.float32, "cpu")
    lens = host_buffer(shape[:1], torch.int32, "cpu")
    mask = host_buffer(shape[:2], torch.bool, "cpu")
    out.fill_(-7.25), lens.fill_(123456), mask.fill_(True)  # a former batch's bytes
    pack_rows(out, rows, lengths=lens, mask=mask)
    want = _zero_padded(rows, shape)
    assert out.numpy().tobytes() == want[0].tobytes()
    assert lens.numpy().tobytes() == want[1].tobytes()
    assert mask.numpy().tobytes() == want[2].tobytes()


def test_host_buffers_off_the_card_are_plain_cpu_tensors():
    for device in (None, "cpu", torch.device("cpu")):
        t = host_buffer((3, 5), torch.bool, device)
        assert t.device.type == "cpu" and t.dtype == torch.bool and tuple(t.shape) == (3, 5)


def test_readback_on_the_cpu_equals_cpu_numpy():
    g = torch.Generator().manual_seed(0)
    outs = [torch.randn((4, 9, 23), generator=g), torch.rand((4, 9), generator=g) > 0.5,
            torch.arange(4, dtype=torch.int64)]
    got = readback(outs)
    for g_, t in zip(got, outs):
        want = t.cpu().numpy()
        assert isinstance(g_, np.ndarray) and g_.dtype == want.dtype
        assert g_.tobytes() == want.tobytes()


def test_default_padded_batches_are_numpy_zero_padded():
    audio = _audio((9000, 4100, 13000, 8000, 30001))
    got = list(pipeline.padded_audio_batches(audio, 2))
    on_cpu = list(pipeline.padded_audio_batches(audio, 2, device="cpu"))
    assert [names for names, _, _ in got] == [["a1", "a3"], ["a0", "a2"], ["a4"]]
    for (names, samples, lengths), (names_t, samples_t, lengths_t) in zip(got, on_cpu):
        assert isinstance(samples, np.ndarray) and isinstance(lengths, np.ndarray)
        assert samples.dtype == np.float32 and lengths.dtype == np.int32
        rows = [audio[u] for u in names]
        width = pipeline._shape_bucket(max(len(x) for x in rows), pipeline.PAD_GRID)
        want = _zero_padded(rows, (len(rows), width))
        assert samples.tobytes() == want[0].tobytes() and np.array_equal(lengths, want[1])
        assert names_t == names and isinstance(samples_t, torch.Tensor)
        assert samples_t.numpy().tobytes() == samples.tobytes()
        assert lengths_t.numpy().tobytes() == lengths.tobytes()


def test_nothing_staged_on_the_cpu_and_phonetic_arrays_own_their_memory():
    L.reset()
    audio = _audio((8000, 12000, 16000), seed=3)
    pf = pipeline.prepare_features_phonetic(audio, FrontendConfig(dither=0.0), VadConfig(),
                                            CmvnConfig(), None, 2, device="cpu")
    feats = pipeline.prepare_features_nosil(audio, FrontendConfig(dither=0.0), VadConfig(),
                                            CmvnConfig(), None, 2, device="cpu")
    assert L.counters().get("frontend.staged_bytes", 0) == 0
    assert sorted(pf.full) == sorted(audio)
    for out in (pf.full, pf.voiced, pf.nosil):
        assert all(a.base is None for a in out.values())
    assert all(np.array_equal(pf.nosil[u], feats[u]) for u in feats)
