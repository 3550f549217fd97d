"""Port parity: the monophone aligner (`sepi_tpu_torch.align.mono`).

The synthetic phone-HMM world of tests/test_align.py, made from a numpy
seed, goes through both packages on the CPU.  Graphs, length buckets and
transition tables are compared for equality, the batched emissions
within rtol 1e-5 (fp32 GEMM + logsumexp in two frameworks), and
alignments frame for frame, both with one acoustic model carried across
(`bridge.mono_aligner_from_jax`) and with each package training its own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepi_tpu.align import mono as jm
from sepi_tpu_torch.align import mono as tm
from sepi_tpu_torch.bridge import mono_aligner_from_jax

torch.set_num_threads(2)

D = 5
PRON = {"bat": ["b", "a", "t"], "cab": ["k", "a", "b"], "tack": ["t", "a", "k"]}
PHONE_MEANS = {
    "sil": np.zeros(D),
    "a": np.array([4.0, 0, 0, 0, 0]),
    "b": np.array([0, 4.0, 0, 0, 0]),
    "k": np.array([0, 0, 4.0, 0, 0]),
    "t": np.array([0, 0, 0, 4.0, 0]),
}
J_LEX, T_LEX = jm.Lexicon.from_dict(PRON), tm.Lexicon.from_dict(PRON)
SENTENCES = [["bat"], ["cab"], ["tack"], ["bat", "cab"], ["tack", "bat"],
             ["cab", "tack"], ["bat", "tack", "cab"], ["cab", "bat"]]


def _speak(rng, words, frames_per_phone=12, sil_frames=8):
    phones = ["sil"] + [p for w in words for p in PRON[w]] + ["sil"]
    feats, labels = [], []
    for p in phones:
        n = sil_frames if p == "sil" else frames_per_phone + int(rng.integers(-3, 4))
        feats.append(PHONE_MEANS[p] + rng.normal(size=(n, D)) * 0.4)
        labels.extend([p] * n)
    return np.concatenate(feats).astype(np.float32), labels


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(7)
    features, transcripts, truth = {}, {}, {}
    for i, words in enumerate(SENTENCES * 3):
        u = f"utt{i:02d}"
        features[u], truth[u] = _speak(rng, words)
        transcripts[u] = words
    return features, transcripts, truth


@pytest.fixture(scope="module")
def trained(world):
    features, transcripts, _ = world
    j = jm.train_mono_aligner(features, transcripts, J_LEX, num_iters=4)
    t = tm.train_mono_aligner(features, transcripts, T_LEX, num_iters=4, device="cpu")
    return j, t


def _bridge(j):
    return mono_aligner_from_jax(np.asarray(j.means), np.asarray(j.vars),
                                 np.asarray(j.mix_w), np.asarray(j.loop_logp),
                                 j.phones, j.states_per_phone, device="cpu")


@pytest.mark.parametrize("words", [["bat"], ["bat", "cab"], ["tack", "bat", "cab", "bat"]])
def test_build_graph_equal(words):
    a, b = jm.build_graph(J_LEX, words, 3), tm.build_graph(T_LEX, words, 3)
    assert a.num_states == b.num_states
    for f in ("pdf", "preds", "final_states"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert T_LEX.phones == J_LEX.phones
    with pytest.raises(KeyError):
        tm.build_graph(T_LEX, ["zzz"], 3)


def test_bucket_len_and_flat_start_equal():
    for n in [1, 63, 64, 65, 255, 256, 257, 300, 320, 321, 999, 1200, 2048, 2500]:
        assert tm._bucket_len(n) == jm._bucket_len(n), n
        assert tm._round_up(n, 128) == jm._round_up(n, 128)
    g = tm.build_graph(T_LEX, ["bat", "cab"], 3)
    np.testing.assert_array_equal(tm._flat_start_alignment(g, 100),
                                  jm._flat_start_alignment(jm.build_graph(J_LEX, ["bat", "cab"], 3), 100))


def test_utt_tables_equal(trained):
    j, _ = trained
    t = _bridge(j)
    for words in SENTENCES:
        jg, tg = jm.build_graph(J_LEX, words, 3), tm.build_graph(T_LEX, words, 3)
        for s_pad in (tm._round_up(tg.num_states, 128), tg.num_states + 5):
            for a, b in zip(jm._utt_tables(j, jg, s_pad), tm._utt_tables(t, tg, s_pad)):
                np.testing.assert_array_equal(a, b)


def test_emissions_batch_matches(trained):
    j, _ = trained
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(3, 70, D)).astype(np.float32) * 2
    ref = np.asarray(jm._emissions_batch(j.means, j.vars, j.mix_w, jnp.asarray(feats)))
    t = _bridge(j)
    got = tm._emissions_batch(t.means, t.vars, t.mix_w, torch.from_numpy(feats)).numpy()
    assert got.shape == ref.shape == (3, 70, j.num_pdf)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    # log_emissions is the same function on one utterance
    np.testing.assert_array_equal(t.log_emissions(feats[1]).numpy(), got[1])


def test_mixture_weights_floored_so_logsumexp_is_finite(world, trained):
    """The M-step floors each component weight at log(1e-3), so no
    emission row is all -inf and torch.logsumexp agrees with JAX's."""
    _, t = trained
    assert t.mix_w.shape[1] == 2
    # floor 1e-3 before normalizing by a sum of at most 1.5 (0.5 + 1)
    assert float(t.mix_w.min()) >= np.log(1e-3 / 1.5) - 1e-6
    assert torch.isfinite(t.mix_w).all() and torch.isfinite(t.vars).all()
    far = torch.full((1, 4, D), 1e3)
    assert torch.isfinite(tm._emissions_batch(t.means, t.vars, t.mix_w, far)).all()


def test_align_paths_equal_with_shared_model(world, trained):
    """The port's one alignment path equals both of JAX's: the
    per-utterance scan and the bucketed batched Viterbi."""
    features, transcripts, _ = world
    j, _ = trained
    t = _bridge(j)
    j_per_utt = jm.align_corpus(j, features, transcripts, J_LEX)
    j_batched = jm.align_corpus(j, features, transcripts, J_LEX, batched=True,
                                batch_size=5, use_pallas=False)
    t_ali = tm.align_corpus(t, features, transcripts, T_LEX, batch_size=5, device="cpu")
    t_default = tm.align_corpus(t, features, transcripts, T_LEX, device="cpu")
    for u in features:
        np.testing.assert_array_equal(t_ali[u], j_batched[u])
        np.testing.assert_array_equal(t_ali[u], j_per_utt[u])
        np.testing.assert_array_equal(t_default[u], j_per_utt[u])
    u = next(iter(features))
    jg, tg = jm.build_graph(J_LEX, transcripts[u], 3), tm.build_graph(T_LEX, transcripts[u], 3)
    ja, js = jm.align_utterance(j, jg, features[u], return_states=True)
    ta, ts = tm.align_utterance(t, tg, features[u], return_states=True, device="cpu")
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(ts, js)
    graphs_j = {v: jm.build_graph(J_LEX, transcripts[v], 3) for v in features}
    graphs_t = {v: tm.build_graph(T_LEX, transcripts[v], 3) for v in features}
    ja, js = jm.align_graphs(j, graphs_j, features, batch_size=32, use_pallas=False,
                             return_states=True)
    ta, ts = tm.align_graphs(t, graphs_t, features, batch_size=32, return_states=True,
                             device="cpu")
    for v in features:
        np.testing.assert_array_equal(ta[v], ja[v])
        np.testing.assert_array_equal(ts[v], js[v])


def test_train_mono_aligner_parity(world, trained):
    """Same flat start, same EM, same k-means draws: the two packages'
    models agree to fp32 rounding and align every frame the same."""
    features, transcripts, _ = world
    j, t = trained
    for name in ("means", "vars", "mix_w"):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.loop_logp, np.asarray(j.loop_logp), rtol=1e-6)
    j_ali = jm.align_corpus(j, features, transcripts, J_LEX, batched=True, use_pallas=False)
    t_ali = tm.align_corpus(t, features, transcripts, T_LEX, device="cpu")
    for u in features:
        np.testing.assert_array_equal(t_ali[u], j_ali[u])


def test_phone_accuracy_and_silence_edges(world, trained):
    features, transcripts, truth = world
    _, t = trained
    alis = tm.align_corpus(t, features, transcripts, T_LEX, device="cpu")
    total = correct = 0
    for u, ali in alis.items():
        assert len(ali) == features[u].shape[0]
        assert ali[0] // 3 == 0 and ali[-1] // 3 == 0  # starts and ends in sil
        for h, r in zip((t.phones[p // 3] for p in ali), truth[u]):
            total += 1
            correct += h == r
    assert correct / total > 0.85, correct / total


def test_unalignable_raises_and_cuda_default(world, trained, monkeypatch):
    features, transcripts, _ = world
    _, t = trained
    g = tm.build_graph(T_LEX, ["bat", "cab", "tack"], 3)
    with pytest.raises(ValueError, match="unalignable"):
        tm.align_utterance(t, g, features[next(iter(features))][:10], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tm.align_corpus(t, features, transcripts, T_LEX)
    with pytest.raises(RuntimeError, match="cuda"):
        tm.align_graphs(t, {"u": g}, {"u": features["utt00"]})
    with pytest.raises(RuntimeError, match="cuda"):
        tm.train_mono_aligner(features, transcripts, T_LEX, num_iters=1)
