"""Port parity: the on-device backend (`sepi_tpu_torch.backend.device`)
against `sepi_tpu.backend.device` and the float64 numpy path.

Every case of tests/test_backend_device.py but the sharded scorer (held
against the reference across processes in tests/test_torch_multiprocess.py),
with that file's tolerances: the score matrix within
1e-3 of its scale and 1e-3 relative of float64; PLDA EM psi within 0.05
and its trial scores within 2% of the scale; LDA rows cosine 1 +- 1e-3;
length-norm 1e-5.  The port runs on ``device="cpu"`` in float32 (TF32
does not arise on the CPU); the JAX functions run on the CPU.  Also:
score_trials(device=True), backend_eval with device_scoring=True, the
label encoding's order, and uneven last blocks of the PLDA EM.
"""

import numpy as np
import pytest
import torch

from sepi_tpu.backend import device as jdev
from sepi_tpu.backend import plda as jplda
from sepi_tpu_torch.backend import (Plda, compute_lda, compute_lda_device, length_normalize,
                                    length_normalize_device, plda_score_matrix,
                                    plda_score_matrix_device, score_trials, train_plda,
                                    train_plda_device)
from sepi_tpu_torch.backend.device import encode_labels, scatter_stats_device

torch.set_num_threads(2)


def _synth(rng, num_spk=40, utts=10, dim=8, b_scale=4.0, w_scale=1.0):
    mu = rng.normal(size=dim)
    ys = rng.normal(size=(num_spk, dim)) * np.sqrt(b_scale)
    x, labels = [], []
    for k in range(num_spk):
        e = rng.normal(size=(utts, dim)) * np.sqrt(w_scale)
        x.append(mu + ys[k] + e)
        labels += [k] * utts
    return np.concatenate(x), labels


def _jplda(p: Plda) -> jplda.Plda:
    return jplda.Plda(mean=p.mean, transform=p.transform, psi=p.psi)


def _assert_scores(got, want, rel=1e-3):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=rel)


def test_length_normalize_device():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(7, 12)).astype(np.float32)
    got = length_normalize_device(v, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), length_normalize(v), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jdev.length_normalize_device(v)),
                               rtol=1e-5, atol=1e-5)
    raw = length_normalize_device(v, scale_to_sqrt_dim=False, device="cpu").numpy()
    np.testing.assert_allclose(np.linalg.norm(raw, axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("with_counts", [True, False], ids=["num_utts", "default_num_utts"])
def test_plda_score_device_matches_numpy(with_counts):
    """The (M, N) LLR matrix, with per-model utterance counts and with
    the default of one (reference :41 and :112)."""
    rng = np.random.default_rng(1 if with_counts else 2)
    x, labels = _synth(rng, num_spk=30, utts=8, dim=10)
    plda = train_plda(x, labels, num_iters=8)
    enroll = rng.normal(size=(9, 10))
    test = rng.normal(size=(13, 10))
    n = rng.integers(1, 6, size=9).astype(np.float64) if with_counts else None
    want = plda_score_matrix(plda, enroll, test, n)
    got = plda_score_matrix_device(plda, enroll, test, n, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (9, 13)
    _assert_scores(got.numpy(), want)
    ref = np.asarray(jdev.plda_score_matrix_device(_jplda(plda), enroll, test, n))
    _assert_scores(got.numpy(), ref)


def test_plda_score_device_at_scale_of_the_bench():
    """A 150-dim PLDA (the bench's dimension) over 64 x 96 trials: the
    expansion's cancellation stays within 1e-3 in float32."""
    rng = np.random.default_rng(3)
    d = 150
    a = rng.normal(size=(d, d))
    plda = Plda(mean=rng.normal(size=d) * 0.1, transform=np.linalg.qr(a)[0],
                psi=np.sort(rng.gamma(2.0, 2.0, size=d))[::-1])
    enroll = length_normalize(rng.normal(size=(64, d)))
    test = length_normalize(rng.normal(size=(96, d)))
    n = rng.integers(1, 4, size=64).astype(np.float64)
    want = plda_score_matrix(plda, enroll, test, n)
    _assert_scores(plda_score_matrix_device(plda, enroll, test, n, device="cpu").numpy(), want)


def test_train_plda_device_matches_numpy():
    rng = np.random.default_rng(4)
    x, labels = _synth(rng, num_spk=50, utts=12, dim=8, b_scale=3.0)
    ref = train_plda(x, labels, num_iters=10)
    dev = train_plda_device(x, labels, num_iters=10, block=16, device="cpu")
    # model-space parity: psi spectra agree and trial scores agree
    np.testing.assert_allclose(dev.psi, ref.psi, rtol=0.05, atol=0.05)
    enroll = rng.normal(size=(5, 8))
    test = rng.normal(size=(7, 8))
    s_ref = plda_score_matrix(ref, enroll, test)
    s_dev = plda_score_matrix(dev, enroll, test)
    _assert_scores(s_dev, s_ref, rel=0.02)
    jax_dev = jdev.train_plda_device(x, labels, num_iters=10, block=16)
    np.testing.assert_allclose(dev.psi, jax_dev.psi, rtol=0.05, atol=0.05)
    _assert_scores(s_dev, jplda.plda_score_matrix(jax_dev, enroll, test), rel=0.02)


@pytest.mark.parametrize("num_spk,block", [(23, 8), (23, 23), (17, 5), (2, 512)])
def test_train_plda_device_uneven_blocks(num_spk, block):
    """Speaker counts that are not a multiple of the E-step block: the
    last block is shorter (the reference pads it with zero-count
    speakers); one block and a block larger than the speakers too."""
    rng = np.random.default_rng(5 + num_spk + block)
    x, labels = _synth(rng, num_spk=num_spk, utts=5, dim=5)
    dev = train_plda_device(x, labels, num_iters=5, block=block, device="cpu")
    ref = train_plda(x, labels, num_iters=5)
    np.testing.assert_allclose(dev.psi, ref.psi, rtol=0.05, atol=0.05)
    whole = train_plda_device(x, labels, num_iters=5, block=num_spk, device="cpu")
    np.testing.assert_allclose(dev.psi, whole.psi, rtol=1e-4, atol=1e-5)


def test_compute_lda_device_matches_numpy():
    rng = np.random.default_rng(6)
    x, labels = _synth(rng, num_spk=30, utts=20, dim=12, b_scale=2.0)
    ref = compute_lda(x, labels, lda_dim=6)
    dev = compute_lda_device(x, labels, lda_dim=6, device="cpu")
    jax_dev = jdev.compute_lda_device(x, labels, lda_dim=6)
    np.testing.assert_allclose(dev.mean, ref.mean, atol=1e-4)
    # rows may flip sign; compare per-row cosine magnitude
    for other in (ref, jax_dev):
        for r_ref, r_dev in zip(other.projection, dev.projection):
            cos = abs(r_ref @ r_dev) / (np.linalg.norm(r_ref) * np.linalg.norm(r_dev))
            assert cos == pytest.approx(1.0, abs=1e-3)
    with pytest.raises(ValueError, match="lda_dim"):
        compute_lda_device(x, labels, lda_dim=13, device="cpu")
    with pytest.raises(ValueError, match="classes"):
        compute_lda_device(x[:40], labels[:40], lda_dim=6, device="cpu")


def test_scatter_stats_match_jax():
    """Class sums, counts, the within-class scatter X'X - sum n_k m_k m_k'
    and the mean against the reference's segment sums, labels unsorted;
    and the same numbers on a second call (no atomics)."""
    rng = np.random.default_rng(7)
    x, labels = _synth(rng, num_spk=12, utts=7, dim=9)
    perm = rng.permutation(len(labels))
    x, labels = x[perm].astype(np.float32), [labels[i] for i in perm]
    ids, k = encode_labels(labels)
    got = [a.numpy() for a in scatter_stats_device(x, ids, k, device="cpu")]
    want = [np.asarray(a) for a in jdev.scatter_stats_device(x, ids, k)]
    for g, w, tol in zip(got, want, (1e-5, 0.0, 1e-5, 1e-5)):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * np.abs(w).max())
    again = [a.numpy() for a in scatter_stats_device(x, ids, k, device="cpu")]
    assert all(np.array_equal(a, b) for a, b in zip(got, again))
    xc = x.astype(np.float64)
    sw = sum((xc[ids == c] - xc[ids == c].mean(0)).T @ (xc[ids == c] - xc[ids == c].mean(0))
             for c in range(k))
    np.testing.assert_allclose(got[2], sw, atol=1e-3 * np.abs(sw).max())


def test_encode_labels_order():
    """Ids in order of first appearance, equal to the reference's."""
    labels = ["b", "a", "b", "c", "a", "d", "c"]
    ids, k = encode_labels(labels)
    assert k == 4 and ids.dtype == np.int32
    assert ids.tolist() == [0, 1, 0, 2, 1, 3, 2]
    jids, jk = jdev.encode_labels(labels)
    assert jk == k and np.array_equal(jids, ids)


def _trials_world(seed=8, num_spk=20, utts=6, dim=12):
    from sepi_tpu_torch.data import Dataset, Trial, Utterance

    rng = np.random.default_rng(seed)
    x, labels = _synth(rng, num_spk=num_spk, utts=utts, dim=dim)
    embs, ds_utts = {}, []
    for i, (v, lab) in enumerate(zip(x, labels)):
        u = f"spk{lab}_u{i}"
        embs[u] = v.astype(np.float32)
        ds_utts.append(Utterance(u, f"spk{lab}"))
    train = Dataset(ds_utts, "train")
    spk2utt = train.spk2utt
    enroll = {s: us[:2] for s, us in spk2utt.items()}
    speakers = list(spk2utt)[:8]
    tests = [u for s in speakers for u in spk2utt[s][2:4]]
    trials = [Trial(s, u, target=(train[u].spk_id == s)) for s in speakers for u in tests]
    return embs, train, trials, enroll


def test_score_trials_device_flag():
    """score_trials(device=True) scores on the named device and agrees
    with the host float64 path and with the reference's device path."""
    rng = np.random.default_rng(9)
    x, labels = _synth(rng, num_spk=10, utts=5, dim=6)
    plda = train_plda(x, labels, num_iters=5)
    from sepi_tpu_torch.data import Trial

    enroll = {f"m{i}": rng.normal(size=6) for i in range(4)}
    test = {f"t{i}": rng.normal(size=6) for i in range(5)}
    trials = [Trial(m, t, m[1] == t[1]) for m in enroll for t in test]
    num_utts = {"m0": 3, "m2": 2}
    host = score_trials(plda, enroll, test, trials, num_utts)
    dev = score_trials(plda, enroll, test, trials, num_utts, device=True, scoring_device="cpu")
    ref = jplda.score_trials(_jplda(plda), enroll, test, trials, num_utts, device=True)
    assert set(dev) == set(host) == set(ref)
    keys = sorted(host)
    h = np.array([host[k] for k in keys])
    _assert_scores(np.array([dev[k] for k in keys]), h)
    _assert_scores(np.array([dev[k] for k in keys]), np.array([ref[k] for k in keys]))


def test_backend_eval_device_scoring_flag():
    """BackendConfig(device_scoring=True) routes backend_eval's trial
    matrix through the device scorer; EER and scores match the float64
    host path (reference tests/test_backend_device.py:112-145) and the
    reference's own device-scoring run."""
    from sepi_tpu.config import BackendConfig as JBackendConfig
    from sepi_tpu.data.manifest import Dataset as JDataset
    from sepi_tpu.data.manifest import Trial as JTrial
    from sepi_tpu.data.manifest import Utterance as JUtterance
    from sepi_tpu.recipes.pipeline import backend_eval as jbackend_eval
    from sepi_tpu_torch.config import BackendConfig
    from sepi_tpu_torch.recipes import backend_eval

    embs, train, trials, enroll = _trials_world()
    host, ah = backend_eval(embs, train, trials, enroll, BackendConfig(lda_dim=8))
    dev, ad = backend_eval(embs, train, trials, enroll,
                           BackendConfig(lda_dim=8, device_scoring=True), device="cpu")
    assert host.eer == pytest.approx(dev.eer, abs=2e-3)
    keys = sorted(ah["scores"])
    hs = np.array([ah["scores"][k] for k in keys])
    dsc = np.array([ad["scores"][k] for k in keys])
    _assert_scores(dsc, hs, rel=2e-3)

    jtrain = JDataset([JUtterance(u.utt_id, u.spk_id) for u in train], "train")
    jtrials = [JTrial(t.model, t.test, t.target) for t in trials]
    jres, aj = jbackend_eval(embs, jtrain, jtrials, enroll,
                             JBackendConfig(lda_dim=8, device_scoring=True))
    assert jres.eer == pytest.approx(dev.eer, abs=2e-3)
    _assert_scores(dsc, np.array([aj["scores"][k] for k in keys]), rel=2e-3)


def test_device_functions_refuse_cpu_fallback(monkeypatch):
    """With no usable GPU, every device function called without device=
    raises, and so does score_trials(device=True)."""
    from sepi_tpu_torch.data import Trial

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(10)
    x, labels = _synth(rng, num_spk=6, utts=4, dim=4)
    plda = train_plda(x, labels, num_iters=2)
    calls = [
        lambda: length_normalize_device(x),
        lambda: plda_score_matrix_device(plda, x[:2], x[:3]),
        lambda: scatter_stats_device(x, encode_labels(labels)[0], 6),
        lambda: train_plda_device(x, labels, num_iters=1),
        lambda: compute_lda_device(x, labels, 2),
        lambda: score_trials(plda, {"m": x[0]}, {"t": x[1]}, [Trial("m", "t", True)],
                             device=True),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
