"""Port parity, end to end: the extraction-and-scoring path.

make_synthetic_corpus -> prepare_features_nosil -> extract_and_score
(a narrow x-vector, bridged weights) -> backend_eval in both packages on
the CPU.  Undithered, because the reference's CPU default dithers per
frame while its (and the port's) main path dithers the waveform.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepi_tpu.config import BackendConfig as JBackend
from sepi_tpu.config import FrontendConfig as JFrontend
from sepi_tpu.data import make_synthetic_corpus as j_corpus
from sepi_tpu.models import XVector as JXVector
from sepi_tpu.models import XVectorConfig as JConfig
from sepi_tpu.models.tdnn import TdnnSpec as JSpec
from sepi_tpu.recipes import pipeline as jp
from sepi_tpu_torch.bridge import xvector_state_dict_from_flax
from sepi_tpu_torch.config import BackendConfig, FrontendConfig
from sepi_tpu_torch.data import make_synthetic_corpus
from sepi_tpu_torch.models import TdnnSpec, XVector, XVectorConfig
from sepi_tpu_torch.recipes import pipeline as tp

torch.set_num_threads(2)

SPECS = [(32, (-2, -1, 0, 1, 2)), (32, (-2, 0, 2)), (32, (-3, 0, 3)), (32, (0,)), (64, (0,))]


@pytest.fixture(scope="module")
def both():
    kw = dict(num_speakers=4, utts_per_speaker=3, duration_sec=2.0)
    jc, tc = j_corpus(**kw), make_synthetic_corpus(**kw)
    assert jc.dataset.utt_ids == tc.dataset.utt_ids and jc.trials == [
        type(jc.trials[0])(t.model, t.test, t.target) for t in tc.trials]
    for u in jc.audio:
        np.testing.assert_array_equal(jc.audio[u], tc.audio[u])

    j_nosil = jp.prepare_features_nosil(jc.audio, JFrontend(dither=0.0))
    t_nosil = tp.prepare_features_nosil(tc.audio, FrontendConfig(dither=0.0), device="cpu")

    jmodel = JXVector(JConfig(feat_dim=23, num_speakers=0,
                              frame_specs=tuple(JSpec(d, o) for d, o in SPECS), embed_dim=32))
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 40, 23)), train=False))
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.normal(size=x.shape) * 0.2 if p[-1].key == "mean"
                      else rng.uniform(0.5, 2.0, size=x.shape)).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    state = types.SimpleNamespace(params=variables["params"], batch_stats=stats)
    j_embs = jp.extract_and_score(jmodel, state, j_nosil)

    tmodel = XVector(XVectorConfig(feat_dim=23, num_speakers=0,
                                   frame_specs=tuple(TdnnSpec(d, o) for d, o in SPECS),
                                   embed_dim=32))
    t_embs = tp.extract_and_score(tmodel, xvector_state_dict_from_flax(variables), t_nosil,
                                  device="cpu")
    enroll = {s: us[:1] for s, us in jc.dataset.spk2utt.items()}
    j_res, _ = jp.backend_eval(j_embs, jc.dataset, jc.trials, enroll, JBackend())
    t_res, _ = tp.backend_eval(t_embs, tc.dataset, tc.trials, enroll, BackendConfig())
    return dict(j_nosil=j_nosil, t_nosil=t_nosil, j_embs=j_embs, t_embs=t_embs,
                j_res=j_res, t_res=t_res)


def test_voiced_frame_counts_equal(both):
    j, t = both["j_nosil"], both["t_nosil"]
    assert sorted(j) == sorted(t)
    for u in j:
        assert t[u].shape == j[u].shape, u
        assert np.abs(t[u] - j[u]).max() <= 1e-3, u


def test_embeddings_match(both):
    j, t = both["j_embs"], both["t_embs"]
    assert sorted(j) == sorted(t)
    for u in j:
        rel = np.abs(t[u] - j[u]).max() / np.abs(j[u]).max()
        assert rel <= 1e-3, (u, rel)


def test_eer_within_one_target_trial(both):
    j, t = both["j_res"], both["t_res"]
    assert (t.num_target, t.num_nontarget) == (j.num_target, j.num_nontarget)
    assert abs(t.eer - j.eer) <= 1.0 / j.num_target, (t.eer, j.eer)
    assert np.isfinite([t.min_dcf08, t.min_dcf10, t.dcf12]).all()


def test_shape_bucket_and_salt():
    for n in [1, 3999, 4000, 16001, 50000, 123456]:
        assert tp._shape_bucket(n, 4000) == jp._shape_bucket(n, 4000)
    # an int key salts the dither seeds: features change, deterministically
    audio = {"a": (np.random.default_rng(0).normal(size=8000) * 1000).astype(np.float32)}
    f0 = tp.prepare_features_nosil(audio, FrontendConfig(), device="cpu")["a"]
    f1 = tp.prepare_features_nosil(audio, FrontendConfig(), key=5, device="cpu")["a"]
    f1b = tp.prepare_features_nosil(audio, FrontendConfig(), key=5, device="cpu")["a"]
    np.testing.assert_array_equal(f1, f1b)
    assert f0.shape != f1.shape or not np.array_equal(f0, f1)


def test_device_scoring_is_not_ported(monkeypatch):
    """Device scoring is ported now (tests/test_torch_backend_device.py
    holds it against the reference); what stays is that it never falls
    back: with no usable GPU it raises unless the caller names the CPU."""
    rng = np.random.default_rng(0)
    embs = {f"s{i}-u{j}": rng.normal(size=8) for i in range(3) for j in range(3)}
    from sepi_tpu_torch.data import Dataset, Trial, Utterance

    ds = Dataset([Utterance(u, u.split("-")[0]) for u in embs])
    trials = [Trial("s0", "s1-u1", False), Trial("s0", "s0-u1", True)]
    enroll = {"s0": ["s0-u0"]}
    cfg = dataclasses.replace(BackendConfig(), device_scoring=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tp.backend_eval(embs, ds, trials, enroll, cfg)
    host, _ = tp.backend_eval(embs, ds, trials, enroll)
    dev, _ = tp.backend_eval(embs, ds, trials, enroll, cfg, device="cpu")
    assert dev.eer == host.eer
