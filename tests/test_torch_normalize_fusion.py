"""Port parity: score normalisation (z/t/s-norm), score fusion and
`extract.streaming_embed` against `sepi_tpu.backend.{normalize,fusion}`
and `sepi_tpu.extract.streaming_embed`.

Normalisation and fusion are host numpy in both packages: equal to
1e-12.  Streaming extraction follows tests/test_e2e.py:117-138: a model
trained a few steps, one long utterance, ``chunk=97`` against
whole-utterance extraction at rtol/atol 2e-3; and the port's streaming
embedding against the reference's on bridged weights, 1e-4 of the scale
in float32 and 4 bf16 ulps of the scale in bfloat16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepi_tpu.backend import fusion as jfusion
from sepi_tpu.backend import normalize as jnorm
from sepi_tpu.extract import streaming_embed as jstreaming_embed
from sepi_tpu.models import XVector as JXVector
from sepi_tpu.models import XVectorConfig as JConfig
from sepi_tpu.models.tdnn import TdnnSpec as JSpec
from sepi_tpu_torch.backend import fit_fusion_weights, linear_fusion, s_norm, t_norm, z_norm
from sepi_tpu_torch.bridge import xvector_state_dict_from_flax
from sepi_tpu_torch.config import ChunkConfig, ExtractConfig, TrainConfig
from sepi_tpu_torch.data import make_synthetic_corpus
from sepi_tpu_torch.extract import streaming_embed
from sepi_tpu_torch.models import TdnnSpec, XVector, XVectorConfig
from sepi_tpu_torch.recipes import (extract_and_score, prepare_features_nosil,
                                    train_xvector_model)

torch.set_num_threads(2)

SPECS = [(24, (-2, -1, 0, 1, 2)), (24, (-2, 0, 2)), (24, (-3, 0, 3)), (24, (0,)), (48, (0,))]
KW = dict(feat_dim=23, num_speakers=8, embed_dim=48)
TCFG = XVectorConfig(frame_specs=tuple(TdnnSpec(d, o) for d, o in SPECS), **KW)
JCFG = JConfig(frame_specs=tuple(JSpec(d, o) for d, o in SPECS), **KW)


def _cohorts(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(6, 9)), rng.normal(1.0, 2.0, size=(6, 40)),
            rng.normal(-0.5, 0.7, size=(9, 40)))


@pytest.mark.parametrize("top_k", [None, 10, 40, 100])
@pytest.mark.parametrize("norm", ["z", "t", "s"])
def test_score_normalization_matches_reference(norm, top_k):
    scores, ecoh, tcoh = _cohorts(1 if top_k is None else top_k)
    if norm == "z":
        got, want = z_norm(scores, ecoh, top_k), jnorm.z_norm(scores, ecoh, top_k)
    elif norm == "t":
        got, want = t_norm(scores, tcoh, top_k), jnorm.t_norm(scores, tcoh, top_k)
    else:
        got = s_norm(scores, ecoh, tcoh, top_k)
        want = jnorm.s_norm(scores, ecoh, tcoh, top_k)
    assert got.shape == scores.shape
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_z_norm_standardises_the_cohort():
    """z-norm of the cohort scores themselves has mean 0 and std 1 per model."""
    _, ecoh, _ = _cohorts(2)
    out = z_norm(ecoh, ecoh)
    np.testing.assert_allclose(out.mean(axis=1), 0.0, atol=1e-12)
    np.testing.assert_allclose(out.std(axis=1), 1.0, atol=1e-9)


@pytest.mark.parametrize("weights", [None, [0.2, 0.5, 0.3]])
def test_linear_fusion_matches_reference(weights):
    rng = np.random.default_rng(3)
    lists = [rng.normal(size=17) for _ in range(3)]
    np.testing.assert_allclose(linear_fusion(lists, weights),
                               jfusion.linear_fusion(lists, weights), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="aligned"):
        linear_fusion([lists[0], lists[1][:5]])
    with pytest.raises(ValueError, match="one weight"):
        linear_fusion(lists, [1.0])


def test_fit_fusion_weights_matches_reference():
    """Logistic-regression weights on a strong and a weak system: equal
    to the reference's, summing to 1, the strong system weighted more."""
    rng = np.random.default_rng(4)
    tgt = [rng.normal(3.0, 1.0, 200), rng.normal(0.5, 1.0, 200)]
    non = [rng.normal(0.0, 1.0, 800), rng.normal(0.0, 1.0, 800)]
    got = fit_fusion_weights(tgt, non)
    np.testing.assert_allclose(got, jfusion.fit_fusion_weights(tgt, non), rtol=1e-12,
                               atol=1e-12)
    assert got.sum() == pytest.approx(1.0) and got[0] > got[1]


@pytest.fixture(scope="module")
def trained():
    corpus = make_synthetic_corpus(num_speakers=8, utts_per_speaker=3, seed=13)
    nosil = prepare_features_nosil(corpus.audio, device="cpu")
    train_cfg = TrainConfig(
        chunks=ChunkConfig(min_chunk_len=50, max_chunk_len=100, num_buckets=2),
        batch_size=16)
    model, state, _ = train_xvector_model(nosil, corpus.dataset, TCFG, train_cfg,
                                          num_steps=20, device="cpu")
    return model, state, nosil


def test_streaming_embed_matches_whole_utterance(trained):
    """Exact streaming pooling == one-shot pooling on the same utterance
    (reference tests/test_e2e.py:117-138)."""
    model, state, nosil = trained
    utt = max(nosil, key=lambda u: nosil[u].shape[0])
    feats = nosil[utt]
    whole = extract_and_score(model, state, {utt: feats}, ExtractConfig(chunk_size=10000),
                              TCFG.min_frames, device="cpu")[utt]
    streamed = streaming_embed(model, feats, chunk=97, device="cpu")
    assert streamed.dtype == np.float32 and streamed.shape == whole.shape
    np.testing.assert_allclose(streamed, whole, rtol=2e-3, atol=2e-3)
    with pytest.raises(ValueError, match="too short"):
        streaming_embed(model, feats[:14], device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streaming_embed_matches_reference(dtype):
    """The port's streaming embedding against the reference's, on the
    same Flax weights (batch norm perturbed), chunk 97 over 700 frames."""
    jmodel = JXVector(JCFG, dtype=dtype)
    rng = np.random.default_rng(5)
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, 40, 23))))
    for layer in variables["batch_stats"]["frames"].values():
        bn = layer["batchnorm"]
        bn["mean"] = (0.1 * rng.normal(size=bn["mean"].shape)).astype(np.float32)
        bn["var"] = (0.5 + rng.random(bn["var"].shape)).astype(np.float32)
    feats = rng.normal(size=(700, 23)).astype(np.float32)
    want = np.asarray(jstreaming_embed(jmodel, variables, feats, chunk=97), np.float32)
    model = XVector(TCFG, dtype=dtype)
    model.load_state_dict(xvector_state_dict_from_flax(variables))
    got = streaming_embed(model, feats, chunk=97, device="cpu")
    assert got.dtype == np.float32
    tol = 1e-4 if dtype == "float32" else 4 * 2.0 ** -7
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())
