"""Port parity: the DNN/i-vector nnet2 path against `sepi_tpu` on the CPU.

- `prepare_paired_features` with dither on: the reference runs its
  MFCC through the Pallas kernel in interpret mode (the dither field the
  port's kernel reproduces; the reference's CPU default dithers per
  frame, another noise field), one utterance at a time; the port batches.
  Frame counts equal (one sid-energy VAD strips both streams), values
  within 5e-3 absolute: the MFCC's own 2e-3 (tests/
  test_torch_mfcc_kernel.py) carried through deltas and sliding CMVN.
- `Nnet2Multisplice` with the reference's Flax weights through the
  bridge: logits within 1e-5 (the p-norm groups consecutive channels).
- `train_nnet2_am` for 1 and 3 steps from the reference's initial
  weights under momentum-free SGD (`preconditioner="none"`, the
  reference's nnet2 settings at a learning rate of 0.05, so each step
  stands well above float32 rounding of the weights): the logged
  objectives within 1e-5; every weight within 1e-5 of its tensor's
  largest step entry plus one float32 ulp of its value (the storage
  rounding of p + step, which alone puts ||p_port - p_ref|| /
  ||p_ref - p_init|| at 1.3e-5 in the first layer after one step).
- `nnet2_posteriors`: T rows for T frames, within 1e-5 of the reference.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepi_tpu.config import OptimizerConfig as JOptimizerConfig
from sepi_tpu.config import TrainConfig as JTrainConfig
from sepi_tpu.data import make_synthetic_corpus as jcorpus
from sepi_tpu.models import nnet2 as jn2
from sepi_tpu.models.tdnn import TdnnSpec as JSpec
from sepi_tpu.ops.features import FeatureExtractor as JFeatureExtractor
from sepi_tpu.recipes import nnet2_recipe as jrec
from sepi_tpu_torch.bridge import flax_variables_from_state_dict, nnet2_state_dict_from_flax
from sepi_tpu_torch.config import OptimizerConfig, TrainConfig
from sepi_tpu_torch.data import make_synthetic_corpus
from sepi_tpu_torch.models import nnet2 as tn2
from sepi_tpu_torch.models.tdnn import TdnnSpec
from sepi_tpu_torch.recipes import nnet2_recipe as trec
from sepi_tpu_torch.recipes import pseudo_senone_alignments
from sepi_tpu_torch.train import trainer as port_trainer

torch.set_num_threads(2)

SPECS = [(32, (-2, -1, 0, 1, 2)), (32, (-1, 2)), (32, (0,)), (32, (-3, 3)), (32, (-7, 2))]
TINY = dict(feat_dim=40, num_senones=24, pnorm_output_dim=32, group_size=4)
J_CFG = jn2.Nnet2Config(specs=tuple(JSpec(d, o) for d, o in SPECS), **TINY)
T_CFG = tn2.Nnet2Config(specs=tuple(TdnnSpec(d, o) for d, o in SPECS), **TINY)
CORPUS = dict(num_speakers=3, utts_per_speaker=2, duration_sec=2.0, seed=31, duration_jitter=0.0)
OPT = dict(initial_lr=0.05, final_lr=0.01, momentum=0.0, proportional_shrink=0.0,
           preconditioner="none")
TRAIN = dict(am_batch_size=32, prefetch=0, seed=5)
FEAT_TOL = 5e-3
TOL = 1e-5


@pytest.fixture(scope="module")
def paired():
    jc, tc = jcorpus(**CORPUS), make_synthetic_corpus(**CORPUS)
    sid, hires = trec.prepare_paired_features(tc.audio, device="cpu")
    orig = jrec.FeatureExtractor
    jrec.FeatureExtractor = functools.partial(JFeatureExtractor, spectral_mode="pallas")
    try:
        jsid, jhires = jrec.prepare_paired_features(jc.audio)
    finally:
        jrec.FeatureExtractor = orig
    return sid, hires, jsid, jhires


def test_paired_features_match_reference(paired):
    sid, hires, jsid, jhires = paired
    assert list(sid) == list(jsid) and list(hires) == list(jhires)
    for u in sid:
        assert sid[u].shape == np.asarray(jsid[u]).shape
        assert hires[u].shape == np.asarray(jhires[u]).shape
        assert sid[u].shape[0] == hires[u].shape[0] and sid[u].shape[1] == 60
        assert hires[u].shape[1] == 40
        assert np.abs(sid[u] - jsid[u]).max() <= FEAT_TOL
        assert np.abs(hires[u] - jhires[u]).max() <= FEAT_TOL


def test_paired_streams_dither_independently(paired):
    """Batching changes nothing, and the hires stream's noise is its own
    (salted apart from the sid stream's)."""
    sid, hires, _, _ = paired
    tc = make_synthetic_corpus(**CORPUS)
    u = next(iter(sid))
    one_s, one_h = trec.prepare_paired_features({u: tc.audio[u]}, device="cpu")
    np.testing.assert_allclose(one_s[u], sid[u], rtol=0, atol=1e-5)
    np.testing.assert_allclose(one_h[u], hires[u], rtol=0, atol=1e-5)
    salted_s, salted_h = trec.prepare_paired_features({u: tc.audio[u]}, key=7, device="cpu")
    assert not np.allclose(salted_h[u], hires[u], atol=1e-6)
    with pytest.raises(ValueError, match="identical framing"):
        trec.prepare_paired_features(tc.audio, hires_frontend=trec.MFCC_HIRES.replace(
            frame_shift_ms=12.0), device="cpu")


def _flax_init(seed):
    v = jn2.Nnet2Multisplice(J_CFG).init(jax.random.PRNGKey(seed), jnp.zeros((2, 60, 40)))
    return jax.tree_util.tree_map(np.asarray, v)


def test_forward_with_bridged_weights():
    init = _flax_init(3)
    model = tn2.Nnet2Multisplice(T_CFG)
    model.load_state_dict(nnet2_state_dict_from_flax(init))
    x = np.random.default_rng(0).normal(size=(3, 50, 40)).astype(np.float32)
    ref = jn2.Nnet2Multisplice(J_CFG).apply(init, jnp.asarray(x))
    out = model.eval()(torch.tensor(x))
    assert out["context"] == ref["context"] == (13, 9)
    assert out["logits"].shape == (3, 50 - 22, 24)
    np.testing.assert_allclose(out["logits"].detach().numpy(), np.asarray(ref["logits"]),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(out["stream"].x.detach().numpy(), np.asarray(ref["stream"].x),
                               rtol=0, atol=TOL)
    # the bridge's inverse restores the reference's tree
    back = flax_variables_from_state_dict(model.state_dict())["params"]
    for name, leaf in jax.tree_util.tree_leaves_with_path(init["params"]):
        keys = [k.key for k in name]
        node = back
        for k in keys:
            node = node[k]
        np.testing.assert_array_equal(node, leaf)


@pytest.mark.parametrize("steps", [1, 3])
def test_train_nnet2_am_matches_reference(paired, monkeypatch, steps):
    _, hires, _, _ = paired
    ali = pseudo_senone_alignments(hires, TINY["num_senones"], seed=2, device="cpu")
    jtc = JTrainConfig(optimizer=JOptimizerConfig(**OPT), **TRAIN)
    ttc = TrainConfig(optimizer=OptimizerConfig(**OPT), **TRAIN)
    jlog, tlog = [], []
    _, jstate = jrec.train_nnet2_am(hires, ali, J_CFG, jtc, num_steps=steps,
                                    log=lambda *a: jlog.append(a))
    init = _flax_init(TRAIN["seed"])
    bridged = nnet2_state_dict_from_flax(init)
    monkeypatch.setattr(port_trainer, "init_weights",
                        lambda model, seed: model.load_state_dict(bridged))
    model, state = trec.train_nnet2_am(hires, ali, T_CFG, ttc, num_steps=steps,
                                       log=lambda *a: tlog.append(a), device="cpu")
    assert state.model is model and not model.training and state.step == steps
    assert [(n, t) for n, t, _ in tlog] == [(n, t) for n, t, _ in jlog]
    for (_, _, tm), (_, _, jm) in zip(tlog, jlog):
        for k in ("objf", "accuracy"):
            assert tm[k] == pytest.approx(jm[k], abs=TOL), k
    got = flax_variables_from_state_dict(model.state_dict())["params"]
    for path, ref in jax.tree_util.tree_leaves_with_path(jstate.params):
        keys = [k.key for k in path]
        port, p0 = got, init["params"]
        for k in keys:
            port, p0 = port[k], p0[k]
        ref = np.asarray(ref)
        step = np.abs(ref - p0).max()
        assert step > 0, keys
        bound = TOL * step + np.spacing(np.abs(ref))
        assert np.all(np.abs(port - ref) <= bound), (keys, np.abs(port - ref).max(), step)


def test_nnet2_posteriors_match_reference(paired):
    _, hires, _, _ = paired
    init = _flax_init(4)
    model = tn2.Nnet2Multisplice(T_CFG)
    # short utterances too: edge replication covers every frame
    feats = dict(hires, short=hires[next(iter(hires))][:5])
    got = trec.nnet2_posteriors(model, nnet2_state_dict_from_flax(init), feats,
                                batch_frames=400, device="cpu")

    class _State:
        params = init["params"]
        batch_stats = {}

    class _Model:
        cfg = J_CFG

        def apply(self, variables, x, train=False):
            return jn2.Nnet2Multisplice(J_CFG).apply(variables, x, train=train)

    ref = jrec.nnet2_posteriors(_Model(), _State(), feats, batch_frames=400)
    assert set(got) == set(feats)
    for u, f in feats.items():
        assert got[u].shape == (f.shape[0], 24) and got[u].dtype == np.float32
        np.testing.assert_allclose(got[u], np.asarray(ref[u]), rtol=0, atol=TOL)
        np.testing.assert_allclose(got[u].sum(1), 1.0, atol=1e-5)
