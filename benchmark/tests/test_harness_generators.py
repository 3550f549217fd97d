"""Every generator of the benchmark is a function of the seed."""

import numpy as np
import torch

import tiny  # noqa: F401  (paths)
from harness import audio
from harness import weights as W

AUDIO = {"sample_rate": 8000, "speech_rms": 1000.0, "pause_rms": 8.0, "period_s": 2.0,
         "pause_s": [0.5, 0.7], "syllable_hz": 4.0}
CPU = torch.device("cpu")


def test_audio_pool_is_a_function_of_the_seed():
    secs = np.array([1.0, 2.5, 4.0])
    a = audio.make_pool(secs, AUDIO, 3000000001, CPU)
    b = audio.make_pool(secs, AUDIO, 3000000001, CPU)
    c = audio.make_pool(secs, AUDIO, 3000000002, CPU)
    assert [len(x) for x in a] == [8000, 20000, 32000]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1])


def test_every_seed_gets_the_same_durations_in_its_own_order():
    law = {"law": "log_uniform", "min": 10.0, "max": 300.0}
    d = audio.durations(law, 256)
    one, two = audio.shuffled(d, 1), audio.shuffled(d, 2 ** 31 + 5)
    assert np.array_equal(np.sort(one), np.sort(two)) and not np.array_equal(one, two)
    assert np.array_equal(one, audio.shuffled(d, 1))
    assert 80.0 < d.mean() < 90.0 and d.min() > 10.0 and d.max() < 300.0


def test_audio_has_pauses_for_the_vad():
    x = audio.make_pool(np.array([20.0]), AUDIO, 7, CPU)[0]
    frames = x[: len(x) // 80 * 80].reshape(-1, 80)
    quiet = (frames.std(1) < 100.0).mean()
    assert 0.2 < quiet < 0.4


def test_weights_are_a_function_of_the_seed():
    shapes = {"a.affine.weight": (6, 4, 3), "a.affine.bias": (6,), "a.batchnorm.weight": (6,),
              "a.batchnorm.running_var": (6,), "out.weight": (5, 6)}
    from harness import core

    tdnn = core.model_kind({"model": "xvector"})
    w1, w2, w3 = (W.make(shapes, seed, CPU, tdnn) for seed in (11, 11, 12))
    assert all(torch.equal(w1[n], w2[n]) for n in shapes)
    assert not torch.equal(w1["out.weight"], w3["out.weight"])
    std = (1 / 12) ** 0.5 / 0.87962566103423978
    assert float(w1["a.affine.weight"].abs().max()) <= 2 * std + 1e-6
    assert float(w1["a.batchnorm.running_var"].min()) == 1.0 == float(w1["a.batchnorm.weight"][0])
    assert float(w1["a.affine.bias"].abs().max()) == 0.0


def _driver(name):
    from harness import core

    return core.load_module(core.BENCH_DIR / "drivers" / f"{name}.py")


def test_shards_are_functions_of_the_seed():
    ext = _driver("extract")
    pool = [np.full(3, i, np.float32) for i in range(5)]
    a, order_a = ext.shard_audio(pool, 3000000001, 4)
    b, order_b = ext.shard_audio(pool, 3000000001, 4)
    c, _ = ext.shard_audio(pool, 3000000001, 5)
    assert list(a) == list(b) and order_a == order_b and sorted(order_a) == list(range(5))
    assert set(a).isdisjoint(c)  # a shard's names, and so its dither, are its own


def test_verify_back_end_is_a_function_of_the_seed():
    ver = _driver("verify")
    tr = {"backend": {"lda_dim": 6, "enrolled": 5, "enroll_utts": [1, 3], "psi": [0.1, 5.0]}}
    a, b, c = (ver.synthetic_backend(tr, 8, s) for s in (9, 9, 10))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["enroll"], c["enroll"])
    p = a["projection"]
    assert np.allclose(p @ p.T, np.eye(6))  # well conditioned: orthonormal rows
    assert np.allclose(np.linalg.norm(a["enroll"], axis=1), np.sqrt(6))


def test_training_data_is_a_function_of_the_seed():
    tr = _driver("train")
    traffic = {"speakers": 4, "utts_per_speaker": 3, "frames_per_utt": 50}
    cfg = {"feat_dim": 5, "num_senones": 7}
    f1, a1, u1 = tr.make_data(traffic, cfg, 21, CPU)
    f2, a2, _ = tr.make_data(traffic, cfg, 21, CPU)
    f3, _, _ = tr.make_data(traffic, cfg, 22, CPU)
    assert list(f1) == list(f2) and len(u1) == 12
    assert all(np.array_equal(f1[k], f2[k]) and np.array_equal(a1[k], a2[k]) for k in f1)
    assert not np.array_equal(f1[u1[0].utt_id], f3[u1[0].utt_id])
    assert all(0 <= a.min() and a.max() < 7 for a in a1.values())
