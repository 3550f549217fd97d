"""How the frontend stages a batch's host memory (`recipes/pipeline.py`), on
the CPU.  A CUDA frontend packs each padded batch in place into pinned
blocks that torch's caching host allocator hands out again, so:
- the in-place packing, into a buffer that holds a former batch's bytes,
  is byte-equal to zero padding, at mixed lengths and at lengths equal to
  the bucket;
- `padded_audio_batches`' default call still yields numpy arrays, equal
  to zero padding;
- on the CPU nothing is staged (``frontend.staged_bytes`` stays 0), and
  `prepare_features_phonetic` hands out arrays that own their memory.
The pinned path itself runs on the card (`tests/test_torch_gpu.py`).
"""

import numpy as np
import pytest
import torch

from sepi_tpu_torch.config import CmvnConfig, FrontendConfig, VadConfig
from sepi_tpu_torch.recipes import pipeline
from sepi_tpu_torch.utils import logging as L

torch.set_num_threads(2)


def _zero_padded(chunk, pad_len):
    """The padding as a fresh zero buffer gives it."""
    samples = np.zeros((len(chunk), pad_len), np.float32)
    lengths = np.zeros((len(chunk),), np.int32)
    for b, (_, x) in enumerate(chunk):
        samples[b, :len(x)] = x
        lengths[b] = len(x)
    return samples, lengths


def _audio(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return {f"a{i}": (rng.standard_normal(n) * 1000).astype(np.float32)
            for i, n in enumerate(lengths)}


@pytest.mark.parametrize("lengths", [(8000, 3217, 11999, 1), (12000, 12000, 12000)],
                         ids=["mixed", "full"])
def test_packing_in_place_over_stale_bytes_equals_zero_padding(lengths):
    chunk = list(_audio(lengths).items())
    pad_len = pipeline._shape_bucket(max(lengths), 4000)
    assert pad_len == 12000
    rows = np.full((len(chunk), pad_len), -7.25, np.float32)  # a former batch's bytes
    lens = np.full((len(chunk),), 123456, np.int32)
    pipeline._pack_rows(chunk, rows, lens)
    want_rows, want_lens = _zero_padded(chunk, pad_len)
    assert rows.tobytes() == want_rows.tobytes() and lens.tobytes() == want_lens.tobytes()


def test_default_padded_batches_are_numpy_zero_padded():
    audio = _audio((9000, 4100, 13000, 8000, 30001))
    got = list(pipeline.padded_audio_batches(audio, 2))
    assert [names for names, _, _ in got] == [["a1", "a3"], ["a0", "a2"], ["a4"]]
    for names, samples, lengths in got:
        assert isinstance(samples, np.ndarray) and isinstance(lengths, np.ndarray)
        assert samples.dtype == np.float32 and lengths.dtype == np.int32
        chunk = [(u, audio[u]) for u in names]
        want = _zero_padded(chunk, pipeline._shape_bucket(max(len(x) for _, x in chunk), 4000))
        assert samples.tobytes() == want[0].tobytes() and np.array_equal(lengths, want[1])


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
