"""Port parity: tied senones, LDA+MLLT and fMLLR (`sepi_tpu_torch.align`).

The planted-allophone world of tests/test_tied.py, from a numpy seed,
goes through both packages on the CPU.  Host-numpy stages (tree
building, context graphs, LDA+MLLT, the fMLLR row solver) must agree
exactly or to 1e-10 in float64; the fp32 torch pieces (`_frame_coeffs`)
to 1e-5; alignments frame for frame, with the acoustic model and tree
carried across by `bridge.mono_aligner_from_jax` / `tied_tree_from_jax`.
"""

import numpy as np
import pytest
import torch

from sepi_tpu.align import fmllr as jf
from sepi_tpu.align import lda_mllt as jl
from sepi_tpu.align import mono as jm
from sepi_tpu.align import tied as jt
from sepi_tpu_torch.align import fmllr as tf
from sepi_tpu_torch.align import lda_mllt as tl
from sepi_tpu_torch.align import mono as tm
from sepi_tpu_torch.align import tied as tt
from sepi_tpu_torch.bridge import mono_aligner_from_jax, tied_tree_from_jax

torch.set_num_threads(2)

D = 6
PRON = {"bat": ["b", "a", "t"], "kat": ["k", "a", "t"], "tab": ["t", "a", "b"]}
J_LEX, T_LEX = jm.Lexicon.from_dict(PRON), tm.Lexicon.from_dict(PRON)
BASE = {p: np.eye(D)[i] * 4 for i, p in enumerate(J_LEX.phones)}


def _speak(rng, words):
    """'a' after 'b' carries a planted allophone shift."""
    phones = ["sil"] + [p for w in words for p in PRON[w]] + ["sil"]
    feats = []
    for i, p in enumerate(phones):
        mu = BASE[p].copy()
        if p == "a" and i > 0 and phones[i - 1] == "b":
            mu = mu + np.array([0, 0, 0, 0, 0, 3.0])
        n = 8 + int(rng.integers(-2, 3))
        feats.append(mu + rng.normal(size=(n, D)) * 0.3)
    return np.concatenate(feats).astype(np.float32)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(11)
    sents = [["bat"], ["kat"], ["tab"], ["bat", "kat"], ["kat", "tab"], ["tab", "bat"]]
    features, transcripts = {}, {}
    for i, ws in enumerate(sents * 6):
        features[f"u{i:02d}"] = _speak(rng, ws)
        transcripts[f"u{i:02d}"] = ws
    return features, transcripts


@pytest.fixture(scope="module")
def tied_pair(world):
    features, transcripts = world
    kw = dict(num_leaves=len(J_LEX.phones) * 3 + 8, mono_iters=3, min_count=20.0)
    j = jt.train_tied_aligner(features, transcripts, J_LEX, **kw)
    t = tt.train_tied_aligner(features, transcripts, T_LEX, device="cpu", **kw)
    return j, t


def _bridged(j):
    m = j.mono
    mono = mono_aligner_from_jax(np.asarray(m.means), np.asarray(m.vars), np.asarray(m.mix_w),
                                 np.asarray(m.loop_logp), m.phones, m.states_per_phone,
                                 device="cpu")
    return tt.TiedAligner(mono, tied_tree_from_jax(j.tree), T_LEX)


def _random_stats(mod, seed, num_phones=5, spp=3, d=4):
    rng = np.random.default_rng(seed)
    stats = {}
    for c in range(num_phones):
        for s in range(spp):
            stats[(c, s)] = {}
            for l in range(num_phones):
                for r in range(num_phones):
                    if rng.random() < 0.6:
                        g = mod._Gauss(d)
                        x = rng.normal(loc=0.5 * l - 0.3 * r, size=(int(rng.integers(5, 60)), d))
                        g.n, g.s1, g.s2 = float(len(x)), x.sum(0), (x * x).sum(0)
                        stats[(c, s)][(l, r)] = g
    return stats


@pytest.mark.parametrize("num_leaves,min_count", [(30, 20.0), (60, 10.0), (15, 20.0)])
def test_tree_from_identical_stats(num_leaves, min_count):
    jtree = jt.build_tied_tree(_random_stats(jt, 1), num_leaves, 3, 5, min_count)
    ttree = tt.build_tied_tree(_random_stats(tt, 1), num_leaves, 3, 5, min_count)
    assert ttree.num_leaves == jtree.num_leaves
    np.testing.assert_array_equal(ttree.dense_table(), jtree.dense_table())
    np.testing.assert_array_equal(tied_tree_from_jax(jtree).dense_table(), jtree.dense_table())


def test_train_tied_aligner_parity(world, tied_pair):
    j, t = tied_pair
    assert t.num_senones == j.num_senones > len(J_LEX.phones) * 3
    np.testing.assert_array_equal(t.tree.dense_table(), j.tree.dense_table())
    features, transcripts = world
    # the port's one path against both of JAX's (per-utterance, batched)
    ja = j.senone_alignments(features, transcripts)
    jb = j.senone_alignments(features, transcripts, batched=True)
    ta = t.senone_alignments(features, transcripts, device="cpu")
    for u in features:
        np.testing.assert_array_equal(ta[u], ja[u])
        np.testing.assert_array_equal(ta[u], jb[u])


def test_context_graph_equal(world, tied_pair):
    j, _ = tied_pair
    tree = tied_tree_from_jax(j.tree)
    for words in (["bat"], ["kat", "tab"], ["tab", "bat", "kat"]):
        a = jt.context_graph(J_LEX, words, j.tree, 3)
        b = tt.context_graph(T_LEX, words, tree, 3)
        assert a.num_states == b.num_states
        for f in ("pdf", "preds", "final_states"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(tt._block_contexts(b, 3), jt._block_contexts(a, 3))


def test_refine_tied_aligner_equal(world, tied_pair):
    features, transcripts = world
    j, _ = tied_pair
    jr = jt.refine_tied_aligner(j, features, transcripts, num_iters=2)
    tr = tt.refine_tied_aligner(_bridged(j), features, transcripts, num_iters=2, device="cpu")
    assert tr.frames_shifted == jr.frames_shifted
    for u in features:
        np.testing.assert_array_equal(tr.alignments[u], jr.alignments[u])
        np.testing.assert_array_equal(tr.phone_alignments[u], jr.phone_alignments[u])
    np.testing.assert_allclose(tr.model.means.numpy(), np.asarray(jr.model.means),
                               rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def spliced_world(world, tied_pair):
    features, transcripts = world
    j, _ = tied_pair
    return features, j.senone_alignments(features, transcripts), j.num_senones


def test_lda_mllt_functions_agree(spliced_world):
    features, ali, n = spliced_world
    f0 = next(iter(features.values()))
    np.testing.assert_array_equal(tl.splice_features(f0, 2), jl.splice_features(f0, 2))
    wj = jl.estimate_lda(features, ali, n, context=2, dim=8)
    wt = tl.estimate_lda(features, ali, n, context=2, dim=8)
    np.testing.assert_allclose(wt, wj, rtol=0, atol=1e-10)
    xj = jl.apply_transform(features, wj, 2)
    xt = tl.apply_transform(features, wt, 2)
    for u in features:
        np.testing.assert_array_equal(xt[u], xj[u])
    mj = jl.estimate_mllt(xj, ali, n)
    mt = tl.estimate_mllt(xt, ali, n)
    np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-10)
    gj = jl.mllt_objf_improvement(xj, ali, n, mj)
    gt = tl.mllt_objf_improvement(xt, ali, n, mt)
    assert abs(gt - gj) <= 1e-10 and gt >= 0.0


def test_frame_coeffs_and_fmllr(world, tied_pair, spliced_world):
    features, ali, n = spliced_world
    j, _ = tied_pair
    jr = jt.refine_tied_aligner(j, features, world[1], num_iters=1)
    jmodel = jr.model
    tmodel = mono_aligner_from_jax(np.asarray(jmodel.means), np.asarray(jmodel.vars),
                                   np.asarray(jmodel.mix_w), np.asarray(jmodel.loop_logp),
                                   (), 3, device="cpu")
    u = next(iter(features))
    a = jr.alignments[u]
    args = [np.asarray(x)[a] for x in (jmodel.means, jmodel.vars, jmodel.mix_w)]
    cj = jf._frame_coeffs(*args, features[u])
    ct = tf._frame_coeffs(*(torch.from_numpy(x) for x in args), torch.from_numpy(features[u]))
    for x, y in zip(ct, cj):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
    sj = jf.accumulate_fmllr_stats(jmodel, features[u], a)
    st = tf.accumulate_fmllr_stats(tmodel, features[u], a)
    np.testing.assert_allclose(st.g, sj.g, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(st.k, sj.k, rtol=1e-5, atol=1e-6)
    # from identical statistics the host row solver is identical
    spk = {v: "s0" if i % 2 else "s1" for i, v in enumerate(features)}
    total = None
    for v in features:
        s = jf.accumulate_fmllr_stats(jmodel, features[v], jr.alignments[v])
        total = s if total is None else total + s
    same = tf.FmllrStats(total.g.copy(), total.k.copy(), total.beta)
    wj = jf.estimate_fmllr(total, min_beta=50.0)
    wt = tf.estimate_fmllr(same, min_beta=50.0)
    np.testing.assert_array_equal(wt, wj)
    assert not np.allclose(wt[:, :-1], np.eye(D))
    # the corpus functions, end to end, agree to fp32 rounding of the stats
    tj = jf.fmllr_transforms(jmodel, features, jr.alignments, spk, min_beta=50.0)
    tt_ = tf.fmllr_transforms(tmodel, features, jr.alignments, spk, min_beta=50.0)
    for s in tj:
        np.testing.assert_allclose(tt_[s], tj[s], rtol=1e-4, atol=1e-4)
    xa = tf.apply_fmllr_corpus(features, tt_, spk)
    xb = jf.apply_fmllr_corpus(features, tt_, spk)
    for v in features:
        np.testing.assert_array_equal(xa[v], xb[v])
    gj = jf.fmllr_loglike_gain(jmodel, features[u], a, wj)
    gt = tf.fmllr_loglike_gain(tmodel, features[u], a, wj)
    assert abs(gt - gj) <= 1e-4 * max(1.0, abs(gj))
