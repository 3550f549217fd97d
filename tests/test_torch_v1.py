"""Port parity: the v1 recipe and driver against `sepi_tpu` on the CPU.

The reference's MFCC runs through its Pallas kernel in interpret mode
(the dither field the port reproduces; see tests/test_torch_nnet2.py).
- `prepare_features_ivector`: the same utterances and frame counts,
  values within 5e-3 (the MFCC's 2e-3 through deltas and CMVN);
- `train_v1_frontend` with each posterior source (GMM EM,
  ``posterior_fn``, per-utterance ``posteriors``) on the same frames:
  UBM and T-matrix within 1e-3 relative of each array's scale, the
  i-vectors of the trained extractor cosine >= 0.999;
- `run_v1` at tiny size, GMM and DNN/i-vector variants (the DNN's
  weights are the reference's, bridged): the same stage keys, the same
  files, and the pooled EER within one trial's worth (1 / targets) of
  the reference's on the same corpus.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from sepi_tpu.config import IvectorConfig as JIvectorConfig
from sepi_tpu.config import OptimizerConfig as JOptimizerConfig
from sepi_tpu.config import TrainConfig as JTrainConfig
from sepi_tpu.config import UbmConfig as JUbmConfig
from sepi_tpu.data import make_synthetic_corpus as jcorpus
from sepi_tpu.models import nnet2 as jn2
from sepi_tpu.models.tdnn import TdnnSpec as JSpec
from sepi_tpu.ops.features import FeatureExtractor as JFeatureExtractor
from sepi_tpu.recipes import drivers as jdrivers
from sepi_tpu.recipes import ivector_recipe as jrec
from sepi_tpu.recipes import nnet2_recipe as jn2rec
from sepi_tpu.recipes.phonetic import pseudo_senone_alignments as jpseudo
from sepi_tpu_torch.bridge import nnet2_state_dict_from_flax
from sepi_tpu_torch.config import IvectorConfig, UbmConfig
from sepi_tpu_torch.data import make_synthetic_corpus
from sepi_tpu_torch.models import nnet2 as tn2
from sepi_tpu_torch.models.tdnn import TdnnSpec
from sepi_tpu_torch.recipes import drivers, ivector_recipe, nnet2_recipe
from sepi_tpu_torch.utils import kaldi_models, read_scp, read_vector

torch.set_num_threads(2)

CORPUS = dict(num_speakers=5, utts_per_speaker=4, duration_sec=2.0, seed=17,
              duration_jitter=0.0)
UBM = dict(num_gauss=16, num_iters_init=2, num_iters_full=2)
IVEC = dict(ivector_dim=8, num_iters=2)
FEAT_TOL = 5e-3
TOL = 1e-3
SPECS = [(16, (-2, -1, 0, 1, 2)), (16, (-1, 2)), (16, (0,)), (16, (-3, 3)), (16, (-7, 2))]
NNET2 = dict(feat_dim=40, num_senones=12, pnorm_output_dim=16, group_size=4)


@pytest.fixture(autouse=True)
def _reference_mfcc_on_its_kernel(monkeypatch):
    pallas = functools.partial(JFeatureExtractor, spectral_mode="pallas")
    monkeypatch.setattr(jrec, "FeatureExtractor", pallas)
    monkeypatch.setattr(jn2rec, "FeatureExtractor", pallas)


@pytest.fixture(scope="module")
def corpora():
    return jcorpus(**CORPUS), make_synthetic_corpus(**CORPUS)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def test_prepare_features_ivector_matches_reference(corpora):
    jc, tc = corpora
    ref = jrec.prepare_features_ivector(jc.audio)
    got = ivector_recipe.prepare_features_ivector(tc.audio, device="cpu")
    assert sorted(got) == sorted(ref)
    for u in ref:
        assert got[u].shape == ref[u].shape and got[u].shape[1] == 60
        assert np.abs(got[u] - ref[u]).max() <= FEAT_TOL


def _frames(seed=0, n_utts=12, d=10):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(5, d)) * 3.0
    out = {}
    for i in range(n_utts):
        n = 80 + 13 * i
        out[f"u{i:02d}"] = (centers[rng.integers(0, 5, n)] + rng.normal(size=(n, d))).astype(
            np.float32)
    return out


@pytest.mark.parametrize("source", ["gmm", "posterior_fn", "posteriors"])
def test_train_v1_frontend_matches_reference(source):
    feats = _frames()
    k = UBM["num_gauss"]
    w = np.random.default_rng(1).normal(size=(10, k)).astype(np.float32)

    def post_fn(x):
        z = np.asarray(x, np.float64) @ w
        z = np.exp(z - z.max(1, keepdims=True))
        return (z / z.sum(1, keepdims=True)).astype(np.float32)

    kw = {}
    if source == "posterior_fn":
        kw = dict(posterior_fn=post_fn)
    elif source == "posteriors":
        kw = dict(posteriors={u: post_fn(f) for u, f in feats.items()})
    jubm, jext = jrec.train_v1_frontend(feats, JUbmConfig(**UBM), JIvectorConfig(**IVEC),
                                        seed=2, **kw)
    tubm, text = ivector_recipe.train_v1_frontend(feats, UbmConfig(**UBM), IvectorConfig(**IVEC),
                                                  seed=2, device="cpu", **kw)
    for f in ("weights", "means", "covars"):
        assert _rel(getattr(jubm, f), getattr(tubm, f).numpy()) <= TOL, f
    for f in ("t", "whitener", "means"):
        assert _rel(getattr(jext, f), getattr(text, f).numpy()) <= TOL, f
    pa = kw.get("posteriors")
    ref = jrec.extract_v1_ivectors(jubm, jext, feats, JIvectorConfig(**IVEC), posteriors=pa)
    got = ivector_recipe.extract_v1_ivectors(tubm, text, feats, IvectorConfig(**IVEC),
                                             posteriors=pa)
    for u in ref:
        cos = float(np.dot(ref[u], got[u]) / np.linalg.norm(ref[u]) / np.linalg.norm(got[u]))
        assert cos >= 0.999, (u, cos)


def _trial_setup(corpus):
    enroll = {s: us[:1] for s, us in corpus.dataset.spk2utt.items()}
    return enroll


def _listing(root):
    out = set()
    for d, _, files in os.walk(root):
        for f in files:
            out.add(os.path.relpath(os.path.join(d, f), root))
    return out


def _nnet2(corpora):
    """A tiny nnet2 trained 3 steps in the reference on its hires features,
    and the same weights in the port."""
    jc, _ = corpora
    _, hires = jn2rec.prepare_paired_features(jc.audio)
    ali = jpseudo(hires, NNET2["num_senones"], seed=1)
    jcfg = jn2.Nnet2Config(specs=tuple(JSpec(d, o) for d, o in SPECS), **NNET2)
    jtc = JTrainConfig(optimizer=JOptimizerConfig(initial_lr=0.05, final_lr=0.01, momentum=0.0,
                                                  proportional_shrink=0.0,
                                                  preconditioner="none"),
                       am_batch_size=32, prefetch=0)
    jmodel, jstate = jn2rec.train_nnet2_am(hires, ali, jcfg, jtc, num_steps=3)
    tmodel = tn2.Nnet2Multisplice(tn2.Nnet2Config(
        specs=tuple(TdnnSpec(d, o) for d, o in SPECS), **NNET2))
    sd = nnet2_state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray,
                                                                      jstate.params)})
    return (functools.partial(jn2rec.nnet2_posteriors, jmodel, jstate),
            functools.partial(nnet2_recipe.nnet2_posteriors, tmodel, sd, device="cpu"))


@pytest.mark.parametrize("variant", ["gmm", "dnn"])
def test_run_v1_matches_reference(tmp_path, corpora, variant):
    jc, tc = corpora
    enroll = _trial_setup(tc)
    jkw = dict(ubm_cfg=JUbmConfig(**UBM), iv_cfg=JIvectorConfig(**IVEC), export_kaldi=True)
    tkw = dict(ubm_cfg=UbmConfig(**UBM), iv_cfg=IvectorConfig(**IVEC), export_kaldi=True)
    if variant == "dnn":
        jprov, tprov = _nnet2(corpora)
        jkw["posterior_provider"], tkw["posterior_provider"] = jprov, tprov
    adapt = dict(list(tc.audio.items())[:6])
    jwd, twd = str(tmp_path / "ref"), str(tmp_path / "port")
    ref = jdrivers.run_v1(jc.dataset, jc.audio, jc.audio, jc.trials, enroll, jwd,
                          adapt_audio=adapt, **jkw)
    got = drivers.run_v1(tc.dataset, tc.audio, tc.audio, tc.trials, enroll, twd,
                         adapt_audio=adapt, device="cpu", **tkw)
    # the same stage keys and files (metrics and logs aside)
    assert _listing(twd) == _listing(jwd)
    stages = {"paired_feats_train", "paired_feats_eval"} if variant == "dnn" else {
        "ivec_feats_train", "ivec_feats_eval"}
    names = {f.split("-")[0] for f in os.listdir(twd)}
    assert stages | {"v1_frontend", "v1_ivectors"} <= names
    n_tgt = ref.pooled.num_target
    assert got.pooled.num_target == n_tgt and got.pooled.num_nontarget == ref.pooled.num_nontarget
    assert abs(got.pooled.eer - ref.pooled.eer) <= 1.0 / n_tgt + 1e-12
    want = {"features", "ubm_tmatrix", "ivectors", "backend", "files"}
    if variant == "dnn":
        want.add("posteriors")
    assert set(got.seconds) == want
    # the written files read back to what the run used
    table = dict(read_scp(os.path.join(twd, "xvector.scp")))
    assert set(table) <= set(tc.audio) and len(table) >= len(tc.audio) - 2
    vec = read_vector(*table[next(iter(table))])
    assert vec.shape == (IVEC["ivector_dim"],) and np.all(np.isfinite(vec))
    ubm = kaldi_models.read_full_ubm(os.path.join(twd, "kaldi", "final.ubm"), device="cpu")
    assert ubm.means.shape == (UBM["num_gauss"] if variant == "gmm" else NNET2["num_senones"],
                               60)
    # a natively trained extractor exports with the mean-carrying column
    ext, meta = kaldi_models.read_ivector_extractor(os.path.join(twd, "kaldi", "final.ie"),
                                                    device="cpu")
    assert ext.ivector_dim == IVEC["ivector_dim"] + 1 and meta.w.size == 0
