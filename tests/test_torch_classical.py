"""Port parity: deltas, splicing, the GMM-UBM and i-vector EM, the GMM VAD
and the pseudo-senone labels against `sepi_tpu` on the CPU.

The same seeded numpy inputs go through both packages (the port with
``device="cpu"``).  Tolerances, from the gaps observed at these sizes:
- splicing and the deltas' clamped neighbour indices exactly; delta
  values within 1e-6 absolute (a 5-tap float32 dot summed in another
  order: observed 6e-8 at |x| <= 4);
- log-likelihoods and the whitener within 1e-4 relative (observed
  2e-7); gselect supports equal, values within 1e-6;
- E-step statistics within 1e-4 relative (observed 2e-7);
- one M-step within 1e-5 relative; UBM training (3 + 3 iterations)
  within 1e-3 relative of each array's scale (observed 5e-5);
- i-vector stats and posteriors within 1e-4 relative; two EM iterations
  of the T-matrix within 1e-3 relative (observed 2e-4); final
  i-vectors cosine >= 0.999 per utterance;
- GMM VAD decisions and pseudo-senone labels equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepi_tpu.classical import gmm as jg
from sepi_tpu.classical import ivector as jiv
from sepi_tpu.config import IvectorConfig as JIvectorConfig
from sepi_tpu.config import UbmConfig as JUbmConfig
from sepi_tpu.ops import deltas as jd
from sepi_tpu.ops import vad as jvad
from sepi_tpu.recipes.phonetic import pseudo_senone_alignments as jpseudo
from sepi_tpu_torch.bridge import diag_gmm_from_jax, full_gmm_from_jax, ivector_extractor_from_jax
from sepi_tpu_torch.classical import gmm as tg
from sepi_tpu_torch.classical import ivector as tiv
from sepi_tpu_torch.config import IvectorConfig, UbmConfig
from sepi_tpu_torch.ops import deltas as td
from sepi_tpu_torch.ops import vad as tvad
from sepi_tpu_torch.recipes import pseudo_senone_alignments

torch.set_num_threads(2)

K, D, M = 16, 12, 8


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _frames(seed=0, n=3000, d=D, clusters=4):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, d)) * 3.0
    comp = rng.integers(0, clusters, size=n)
    return (centers[comp] + rng.normal(size=(n, d))).astype(np.float32)


def _full_params(seed=1, k=K, d=D):
    rng = np.random.default_rng(seed)
    w = rng.dirichlet(np.ones(k)).astype(np.float32)
    m = (rng.normal(size=(k, d)) * 2.0).astype(np.float32)
    a = rng.normal(size=(k, d, d)) * 0.3
    cov = (a @ a.transpose(0, 2, 1) + np.eye(d)).astype(np.float32)
    return w, m, cov


def _diag_params(seed=2, k=K, d=D):
    rng = np.random.default_rng(seed)
    return (rng.dirichlet(np.ones(k)).astype(np.float32),
            (rng.normal(size=(k, d)) * 2.0).astype(np.float32),
            rng.uniform(0.5, 2.0, size=(k, d)).astype(np.float32))


def _models(kind):
    if kind == "diag":
        w, m, v = _diag_params()
        return jg.DiagGmm(jnp.asarray(w), jnp.asarray(m), jnp.asarray(v)), \
            tg.DiagGmm(torch.tensor(w), torch.tensor(m), torch.tensor(v))
    w, m, c = _full_params()
    return jg.FullGmm(jnp.asarray(w), jnp.asarray(m), jnp.asarray(c)), \
        tg.FullGmm(torch.tensor(w), torch.tensor(m), torch.tensor(c))


# ------------------------------------------------------------ deltas


def _ragged(seed=0, lens=(40, 17, 1, 0)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(len(lens), 40, 7)).astype(np.float32)
    m = np.arange(40)[None, :] < np.asarray(lens)[:, None]
    return x, m


@pytest.mark.parametrize("order,window", [(2, 2), (1, 3)])
def test_add_deltas_match_reference(order, window):
    x, m = _ragged()
    ref = np.asarray(jd.add_deltas(jnp.asarray(x), jnp.asarray(m), order=order, window=window))
    got = td.add_deltas(torch.tensor(x), torch.tensor(m), order=order, window=window).numpy()
    assert got.shape == ref.shape == (4, 40, 7 * (order + 1))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[~m], 0.0)
    # 2-D input squeezes like the reference
    one = td.add_deltas(torch.tensor(x[1]), torch.tensor(m[1]), order, window).numpy()
    np.testing.assert_allclose(one, ref[1], rtol=0, atol=1e-6)


def test_delta_edge_clamp_per_utterance():
    """Frame t reads frames clipped to [0, n_valid - 1] of its own
    utterance: the first-order delta of a ramp is 1 inside and shrinks at
    each utterance's own edges, whatever the padding holds."""
    lens = np.array([12, 7])
    x = np.zeros((2, 12, 1), np.float32)
    x[:, :, 0] = np.arange(12)
    x[1, 7:] = 1000.0  # padding must not leak in
    m = np.arange(12)[None, :] < lens[:, None]
    idx = td._clipped_index(torch.tensor(m), torch.arange(-2, 3)).numpy()
    for b, n in enumerate(lens):
        want = np.clip(np.arange(12)[:, None] + np.arange(-2, 3)[None, :], 0, n - 1)
        np.testing.assert_array_equal(idx[b], want)
    d1 = td.add_deltas(torch.tensor(x), torch.tensor(m), order=1).numpy()[..., 1]
    ref = np.asarray(jd.add_deltas(jnp.asarray(x), jnp.asarray(m), order=1))[..., 1]
    np.testing.assert_allclose(d1, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(d1[1, 2:5], 1.0, atol=1e-6)
    np.testing.assert_allclose(d1[1, [0, 6]], 0.5, atol=1e-6)
    np.testing.assert_array_equal(d1[1, 7:], 0.0)


@pytest.mark.parametrize("context", [(-2, -1, 0, 1, 2), (-3, 0, 2), (0,)])
def test_splice_frames_exact(context):
    x, m = _ragged(seed=3)
    ref = np.asarray(jd.splice_frames(jnp.asarray(x), jnp.asarray(m), context))
    got = td.splice_frames(torch.tensor(x), torch.tensor(m), context).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(td.splice_frames(torch.tensor(x[0]), torch.tensor(m[0]),
                                                   context).numpy(), ref[0])


def test_subsample_and_paste():
    x, _ = _ragged()
    np.testing.assert_array_equal(td.subsample_frames(torch.tensor(x), 3, 1).numpy(),
                                  np.asarray(jd.subsample_frames(jnp.asarray(x), 3, 1)))
    a, b = torch.tensor(x[..., :3]), torch.tensor(x[..., 3:])
    np.testing.assert_array_equal(td.paste_features([a, b]).numpy(), x)
    with pytest.raises(ValueError, match="frame counts"):
        td.paste_features([a, b[:, :-1]])


# ------------------------------------------------------- GMM building blocks


@pytest.mark.parametrize("kind", ["diag", "full"])
def test_log_likes_match_reference(kind):
    jm, tm = _models(kind)
    x = _frames(n=700)
    ref = np.asarray(jm.log_likes(jnp.asarray(x)))
    got = tm.log_likes(torch.tensor(x)).numpy()
    assert _rel(ref, got) <= 1e-4
    if kind == "full":
        ji, jc = jm._whitener()
        ti, tc = tm._whitener()
        assert _rel(ji, ti.numpy()) <= 1e-4 and _rel(jc, tc.numpy()) <= 1e-4


def test_full_log_likes_chunked_rows(monkeypatch):
    """The frame chunking of the whitening GEMM changes no number."""
    _, tm = _models("full")
    x = torch.tensor(_frames(n=300))
    whole = tm.log_likes(x)
    monkeypatch.setattr(tg, "_WHITEN_ELEMS", 37 * K * D)
    np.testing.assert_allclose(tm.log_likes(x).numpy(), whole.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_sel,min_post", [(5, 0.0), (5, 0.025), (20, 0.0), (1, 0.0)])
def test_gselect_posteriors_match_reference(n_sel, min_post):
    rng = np.random.default_rng(4)
    ll = (rng.normal(size=(200, K)) * 3).astype(np.float32)
    # planted ties at the cut: frame 0 has three components equal to its
    # 5th largest, so the mask keeps 7 (ties keep more than n)
    order = np.argsort(-ll[0])
    ll[0, order[5:7]] = ll[0, order[4]]
    ref = np.asarray(jg.gselect_posteriors(jnp.asarray(ll), n_sel, min_post))
    got = tg.gselect_posteriors(torch.tensor(ll), n_sel, min_post).numpy()
    np.testing.assert_array_equal(got > 0, ref > 0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    if n_sel == 5 and min_post == 0.0:
        assert (got[0] > 0).sum() == 7


@pytest.mark.parametrize("kind", ["diag", "full"])
@pytest.mark.parametrize("masked", [False, True])
def test_accumulate_stats_match_reference(kind, masked):
    jm, tm = _models(kind)
    x = _frames(n=2500)
    valid = np.random.default_rng(5).random(2500) > 0.3 if masked else None
    kw = dict(num_gselect=5, min_post=0.025, full=kind == "full", chunk=1000)
    ref = jg.accumulate_stats(jm, jnp.asarray(x), valid=None if valid is None
                              else jnp.asarray(valid), **kw)
    got = tg.accumulate_stats(tm, torch.tensor(x), valid=None if valid is None
                              else torch.tensor(valid), **kw)
    for f in ("gamma", "first", "second"):
        assert _rel(getattr(ref, f), getattr(got, f).numpy()) <= 1e-4, f


@pytest.mark.parametrize("kind", ["diag", "full"])
@pytest.mark.parametrize("with_prev", [False, True])
def test_mstep_matches_reference_with_starved_components(kind, with_prev):
    """One M-step on the same statistics; components 0-2 are starved
    (count below the floor), so they keep the previous parameters or, in
    the full M-step without one, take the global covariance."""
    jm, tm = _models(kind)
    x = _frames(n=2500)
    full = kind == "full"
    stats = jg.accumulate_stats(jm, jnp.asarray(x), num_gselect=5, full=full)
    g = np.array(stats.gamma)
    g[:3] = [0.5, 2.0, 4.0]
    jstats = jg.GmmStats(jnp.asarray(g), stats.first, stats.second)
    tstats = tg.GmmStats(torch.tensor(g), torch.tensor(np.asarray(stats.first)),
                         torch.tensor(np.asarray(stats.second)))
    jcfg, tcfg = JUbmConfig(num_gauss=K), UbmConfig(num_gauss=K)
    step_j, step_t = (jg._mstep_full, tg._mstep_full) if full else (jg._mstep_diag,
                                                                     tg._mstep_diag)
    ref = step_j(jstats, jcfg, 1e-3, prev=jm if with_prev else None)
    got = step_t(tstats, tcfg, 1e-3, prev=tm if with_prev else None)
    for f in ("weights", "means", "covars" if full else "vars"):
        r, t = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert r.dtype == t.dtype == np.float32
        assert _rel(r, t) <= 1e-5, f
        if with_prev and f != "weights":
            np.testing.assert_array_equal(t[:3], getattr(tm, f).numpy()[:3])


def test_full_gmm_from_posteriors_matches_reference():
    x = _frames(n=1500)
    rng = np.random.default_rng(6)
    post = rng.dirichlet(np.ones(K) * 0.3, size=1500).astype(np.float32)
    ref = jg.full_gmm_from_posteriors(x, post)
    got = tg.full_gmm_from_posteriors(x, post, device="cpu", chunk=400)
    for f in ("weights", "means", "covars"):
        assert _rel(getattr(ref, f), getattr(got, f).numpy()) <= 1e-4, f


def test_ubm_training_matches_reference():
    """init-from-frames, 3 diag + 3 full EM iterations at subsample 5."""
    x = _frames(n=6000)
    jcfg = JUbmConfig(num_gauss=K, num_iters_init=3, num_iters_full=3)
    tcfg = UbmConfig(num_gauss=K, num_iters_init=3, num_iters_full=3)
    jdiag = jg.train_diag_ubm(x, jcfg, seed=1)
    tdiag = tg.train_diag_ubm(x, tcfg, seed=1, device="cpu")
    for f in ("weights", "means", "vars"):
        assert _rel(getattr(jdiag, f), getattr(tdiag, f).numpy()) <= 1e-3, f
    jfull = jg.train_full_ubm(x, jdiag, jcfg)
    tfull = tg.train_full_ubm(x, tdiag, tcfg)
    for f in ("weights", "means", "covars"):
        assert _rel(getattr(jfull, f), getattr(tfull, f).numpy()) <= 1e-3, f


# ------------------------------------------------------------- i-vectors


@pytest.fixture(scope="module")
def iv_world():
    x = _frames(n=3000)
    w, m, c = _full_params()
    jubm = jg.FullGmm(jnp.asarray(w), jnp.asarray(m), jnp.asarray(c))
    tubm = full_gmm_from_jax(jubm, device="cpu")
    feats = {f"u{i:02d}": x[i * 120:i * 120 + 40 + 9 * i] for i in range(20)}
    jext = jiv.init_extractor(jubm, M, 3)
    text = tiv.init_extractor(tubm, M, 3)
    return jubm, tubm, feats, jext, text


def test_init_extractor_same_draw(iv_world):
    _, _, _, jext, text = iv_world
    np.testing.assert_array_equal(text.t.numpy(), np.asarray(jext.t))
    assert _rel(jext.whitener, text.whitener.numpy()) <= 1e-4


def test_utterance_stats_and_posteriors_match_reference(iv_world):
    jubm, tubm, feats, jext, text = iv_world
    ju, js = jiv.stats_from_features(jext, jubm, feats, JIvectorConfig(ivector_dim=M), 5)
    tu, ts = tiv.stats_from_features(text, tubm, feats, IvectorConfig(ivector_dim=M), 5,
                                     batch=3)
    assert tu == ju
    assert _rel(js.n, ts.n.numpy()) <= 1e-4 and _rel(js.f, ts.f.numpy()) <= 1e-4
    jw, jc = jiv.posterior_ivectors(jext, js, 1.0)
    tw, tc = tiv.posterior_ivectors(text, ts, 1.0)
    assert _rel(jw, tw.numpy()) <= 1e-4 and _rel(jc, tc.numpy()) <= 1e-4
    # the utterance batching of the posterior changes no number
    old = tiv._POSTERIOR_ELEMS
    try:
        tiv._POSTERIOR_ELEMS = 3 * M * M
        bw, bc = tiv.posterior_ivectors(text, ts, 1.0)
    finally:
        tiv._POSTERIOR_ELEMS = old
    np.testing.assert_allclose(bw.numpy(), tw.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(bc.numpy(), tc.numpy(), rtol=0, atol=1e-6)


def test_utterance_stats_direct(iv_world):
    """`utterance_stats` on one padded batch with given posteriors."""
    _, _, feats, jext, text = iv_world
    rng = np.random.default_rng(8)
    f = rng.normal(size=(3, 30, D)).astype(np.float32)
    mask = np.arange(30)[None, :] < np.array([30, 11, 4])[:, None]
    post = rng.dirichlet(np.ones(K), size=(3, 30)).astype(np.float32)
    js = jiv.utterance_stats(jext, jnp.asarray(f), jnp.asarray(mask), jnp.asarray(post))
    ts = tiv.utterance_stats(text, torch.tensor(f), torch.tensor(mask), torch.tensor(post))
    assert _rel(js.n, ts.n.numpy()) <= 1e-5 and _rel(js.f, ts.f.numpy()) <= 1e-4


def test_tmatrix_em_and_ivectors_match_reference(iv_world):
    jubm, tubm, feats, jext, text = iv_world
    _, js = jiv.stats_from_features(jext, jubm, feats, JIvectorConfig(ivector_dim=M), 5)
    _, ts = tiv.stats_from_features(text, tubm, feats, IvectorConfig(ivector_dim=M), 5)
    jcfg, tcfg = JIvectorConfig(ivector_dim=M, num_iters=2), IvectorConfig(ivector_dim=M,
                                                                           num_iters=2)
    jt = jiv.train_ivector_extractor(jext, js, jcfg)
    tt = tiv.train_ivector_extractor(text, ts, tcfg)
    assert _rel(jt.t, tt.t.numpy()) <= 1e-3
    jw = jiv.extract_ivectors(jt, js, jcfg)
    tw = tiv.extract_ivectors(tt, ts, tcfg)
    cos = (jw * tw).sum(1) / np.linalg.norm(jw, axis=1) / np.linalg.norm(tw, axis=1)
    assert cos.min() >= 0.999


def test_dnn_posteriors_replace_gselect(iv_world):
    """Supplied frame-aligned posteriors replace the UBM's, and rows that
    disagree with the frames raise."""
    jubm, tubm, feats, jext, text = iv_world
    rng = np.random.default_rng(9)
    post = {u: rng.dirichlet(np.ones(K), size=f.shape[0]).astype(np.float32)
            for u, f in feats.items()}
    _, js = jiv.stats_from_features(jext, jubm, feats, posteriors=post)
    _, ts = tiv.stats_from_features(text, tubm, feats, posteriors=post)
    assert _rel(js.n, ts.n.numpy()) <= 1e-5 and _rel(js.f, ts.f.numpy()) <= 1e-4
    bad = dict(post, u03=post["u03"][:-1])
    with pytest.raises(ValueError, match="frame-aligned"):
        tiv.stats_from_features(text, tubm, feats, posteriors=bad)


# ------------------------------------------------------------- GMM VAD


def test_gmm_vad_matches_reference():
    rng = np.random.default_rng(10)
    n = 900
    voiced = rng.random(n) > 0.4
    x = (rng.normal(size=(n, 6)) + np.where(voiced[:, None], 2.5, -1.0)).astype(np.float32)
    jg_ = jvad.train_vad_gmms(x, voiced, num_comps=4, num_iters=3, seed=2)
    tg_ = tvad.train_vad_gmms(x, voiced, num_comps=4, num_iters=3, seed=2, device="cpu")
    for a, b in zip(jg_, tg_):
        for f in ("weights", "means", "vars"):
            assert _rel(getattr(a, f), getattr(b, f).numpy()) <= 1e-4
    mask = np.arange(n) < 850
    energy = rng.random(n) > 0.2
    for kw in ({}, {"priors": [0.0, 0.7]}, {"energy_voiced": energy}):
        jkw = {k: jnp.asarray(v) for k, v in kw.items()}
        tkw = {k: torch.tensor(np.asarray(v)) for k, v in kw.items()}
        ref = np.asarray(jvad.gmm_vad(jnp.asarray(x), jnp.asarray(mask), jg_, **jkw))
        got = tvad.gmm_vad(torch.tensor(x), torch.tensor(mask), tg_, **tkw).numpy()
        np.testing.assert_array_equal(got, ref)
        assert got[~mask].sum() == 0
    # the class decision on its own, batched, with several speech classes
    ll = rng.normal(size=(2, 3, 50)).astype(np.float32)
    m2 = np.ones((2, 50), bool)
    np.testing.assert_array_equal(
        tvad.vad_from_frame_likes(torch.tensor(ll), torch.tensor(m2), (0, 2)).numpy(),
        np.asarray(jvad.vad_from_frame_likes(jnp.asarray(ll), jnp.asarray(m2), (0, 2))))


def test_pseudo_senone_alignments_equal():
    x = _frames(n=2000, d=10, clusters=6)
    feats = {f"u{i}": x[i * 100:(i + 1) * 100] for i in range(20)}
    ref = jpseudo(feats, 12, seed=3)
    got = pseudo_senone_alignments(feats, 12, seed=3, device="cpu")
    assert list(got) == list(ref)
    for u in ref:
        assert got[u].dtype == np.int32
        np.testing.assert_array_equal(got[u], ref[u])


def test_bridged_diag_gmm_scores_like_the_reference():
    w, m, v = _diag_params()
    jm = jg.DiagGmm(jnp.asarray(w), jnp.asarray(m), jnp.asarray(v))
    tm = diag_gmm_from_jax(jm, device="cpu")
    x = _frames(n=100)
    assert _rel(jm.log_likes(jnp.asarray(x)), tm.log_likes(torch.tensor(x)).numpy()) <= 1e-5
    jext = jiv.init_extractor(jg.diag_to_full(jm), M, 0)
    text = ivector_extractor_from_jax(jext, device="cpu")
    np.testing.assert_array_equal(text.t.numpy(), np.asarray(jext.t))
    np.testing.assert_array_equal(text.whitener.numpy(), np.asarray(jext.whitener))


def test_mstep_accumulate_matches_reference(iv_world):
    """A and C of one M-step, returned and accumulated in place over two
    utterance batches, against the reference's single call."""
    jubm, tubm, feats, jext, text = iv_world
    _, js = jiv.stats_from_features(jext, jubm, feats, JIvectorConfig(ivector_dim=M), 5)
    _, ts = tiv.stats_from_features(text, tubm, feats, IvectorConfig(ivector_dim=M), 5)
    jw, jc = jiv.posterior_ivectors(jext, js, 1.0)
    ja, jcc = jiv._mstep_accumulate(jext, js, jw, jc)
    tw, tc = tiv.posterior_ivectors(text, ts, 1.0)
    ta, tcc = tiv._mstep_accumulate(text, ts, tw, tc)
    assert _rel(ja, ta.numpy()) <= 1e-4 and _rel(jcc, tcc.numpy()) <= 1e-4
    a, c = torch.zeros_like(ta), torch.zeros_like(tcc)
    for sl in (slice(0, 7), slice(7, None)):
        tiv._mstep_accumulate(text, tiv.IvectorStats(ts.n[sl], ts.f[sl]), tw[sl], tc[sl], a, c)
    assert _rel(ja, a.numpy()) <= 1e-4 and _rel(jcc, c.numpy()) <= 1e-4


def test_posterior_holds_where_float32_loses_definiteness():
    """One component with a large T row (as the DNN/i-vector variant's
    starved components reach after an EM iteration) spreads L_u's
    eigenvalues from ~3 to ~1e8: float32 rounding of U_k alone moves L_u
    by more than its smallest eigenvalue, and the reference's float32
    posterior lands 70% from the exact one.  The port forms the posterior
    in float64 and holds a float64 numpy solve to 1e-6."""
    rng = np.random.default_rng(0)
    k, d, m, u = 3, 4, 10, 5
    t = rng.normal(size=(k, d, m)).astype(np.float32)
    t[0] *= 400
    wh = np.tile(np.eye(d, dtype=np.float32), (k, 1, 1))
    n = rng.uniform(20, 60, size=(u, k)).astype(np.float32)
    f = (rng.normal(size=(u, k, d)) * 5).astype(np.float32)
    ext = tiv.IvectorExtractor(torch.tensor(t), torch.tensor(wh), torch.zeros(k, d))
    w, cov = tiv.posterior_ivectors(ext, tiv.IvectorStats(torch.tensor(n), torch.tensor(f)))
    t64 = t.astype(np.float64)
    l64 = np.eye(m)[None] + np.einsum("uk,kmn->umn", n.astype(np.float64),
                                      np.einsum("kdm,kdn->kmn", t64, t64))
    assert np.linalg.eigvalsh(l64)[:, -1].min() > 1e7 * np.linalg.eigvalsh(l64)[:, 0].max()
    b = np.einsum("kdm,ukd->um", t64, f.astype(np.float64))
    assert _rel(np.linalg.solve(l64, b[..., None])[..., 0], w.numpy()) <= 1e-6
    assert _rel(np.linalg.inv(l64), cov.numpy()) <= 1e-6
    jw, _ = jiv.posterior_ivectors(jiv.IvectorExtractor(jnp.asarray(t), jnp.asarray(wh),
                                                        jnp.zeros((k, d))),
                                   jiv.IvectorStats(jnp.asarray(n), jnp.asarray(f)))
    assert _rel(np.linalg.solve(l64, b[..., None])[..., 0], np.asarray(jw)) > 0.1
