"""Port parity: the phonetic models (AM net, v3 multitask, v4 adapted, v5
combined), the bridge and the graft against `sepi_tpu.models.cvector`
and `sepi_tpu.train.graft`.

Tiny widths as tests/test_phonetic.py (senones 12, hidden 24, pool 48,
embed 32, TINY_AM).  Flax initialises each model from a seed; its batch-norm
scales and statistics are then perturbed (so eval mode is not the
identity), the variables go through the bridge, and both packages run the
same numpy inputs, masked and unmasked, in eval and train mode.
Measures: every output within 1e-4 of its own scale (max abs error <=
1e-4 x max(1, max |reference|): in train mode the segment layers' batch
norm reduces over the batch only and scales float32 rounding up by
1/std); batch-norm statistics after one train-mode forward within
STAT_TOL of the reference's scale, as tests/test_torch_train.py holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepi_tpu.models import cvector as jcv
from sepi_tpu.models.tdnn import TdnnSpec as JSpec
from sepi_tpu.train.graft import graft_subtree as jgraft
from sepi_tpu_torch.bridge import (
    flax_variables_from_state_dict,
    state_dict_from_flax,
    xvector_state_dict_from_flax,
)
from sepi_tpu_torch.models import cvector as tcv
from sepi_tpu_torch.models.tdnn import Stream, TdnnSpec, append_streams
from sepi_tpu_torch.train.graft import graft_subtree

torch.set_num_threads(2)

NUM_SENONES = 12
AM_SPECS = [(24, (-2, -1, 0, 1, 2)), (24, (-1, 0, 1)), (24, (-1, 0, 1)), (24, (-3, 0, 3)),
            (12, (-6, -3, 0))]
J_AM = jcv.AmConfig(feat_dim=23, num_senones=NUM_SENONES,
                    specs=tuple(JSpec(d, o) for d, o in AM_SPECS))
T_AM = tcv.AmConfig(feat_dim=23, num_senones=NUM_SENONES,
                    specs=tuple(TdnnSpec(d, o) for d, o in AM_SPECS))
WIDTHS = dict(num_speakers=6, embed_dim=32, hidden_dim=24, pool_dim=48)
OUT_TOL = 1e-4
STAT_TOL = 1e-5
B, T = 8, 70


def _pair(kind, num_shared=1):
    """(reference module, port module) of one model at the tiny widths."""
    if kind == "am":
        return jcv.AmNet(J_AM), tcv.AmNet(T_AM)
    if kind == "multitask":
        kw = dict(WIDTHS, num_senones=NUM_SENONES, num_shared=num_shared)
        return (jcv.MultitaskCVector(jcv.MultitaskConfig(**kw)),
                tcv.MultitaskCVector(tcv.MultitaskConfig(**kw)))
    if kind == "adapted":
        return (jcv.AdaptedXVector(jcv.AdaptedConfig(am=J_AM, **WIDTHS)),
                tcv.AdaptedXVector(tcv.AdaptedConfig(am=T_AM, **WIDTHS)))
    kw = dict(WIDTHS, num_senones=NUM_SENONES, num_shared=num_shared)
    return (jcv.CombinedCVector(jcv.CombinedConfig(am=J_AM, **kw)),
            tcv.CombinedCVector(tcv.CombinedConfig(am=T_AM, **kw)))


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _init(jmodel, seed=0, perturb=True):
    """The reference's variables from ``seed`` (numpy leaves), batch-norm
    scales and statistics perturbed from a numpy generator."""
    feats = jnp.zeros((2, 40, 23))
    variables = _np(jmodel.init(jax.random.PRNGKey(seed), feats, train=False))
    if not perturb:
        return variables
    rng = np.random.default_rng(seed + 100)

    def bump(path, x):
        key = jax.tree_util.keystr(path)
        if key.endswith("['scale']"):
            return (0.5 + rng.random(x.shape)).astype(np.float32)
        if key.endswith("['mean']"):
            return (0.1 * rng.normal(size=x.shape)).astype(np.float32)
        if key.endswith("['var']"):
            return (0.5 + 1.5 * rng.random(x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(bump, variables)


def _port_model(tmodel, variables):
    tmodel.load_state_dict(state_dict_from_flax(variables))
    return tmodel


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, T, 23)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, 50:] = False
    mask[3, 31:] = False
    return feats, mask


def _compare(jout, tout):
    assert set(tout) == set(jout)
    for k, v in jout.items():
        if k == "bottleneck":
            assert (tout[k].left, tout[k].right) == (v.left, v.right)
            _close(tout[k].x, v.x, k)
            continue
        if k == "am_context":
            assert tuple(tout[k]) == tuple(v)
            continue
        _close(tout[k], v, k)


def _close(got, want, name):
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= OUT_TOL * max(1.0, np.abs(want).max()), (name, err)


def _assert_stats_close(port_stats, ref_stats):
    ref, port = _leaves(ref_stats), _leaves(port_stats)
    assert set(ref) == set(port)
    for k, r in ref.items():
        assert np.abs(port[k] - r).max() <= STAT_TOL * max(1.0, np.abs(r).max()), k


CASES = ([("am", 1, None)]
         + [("multitask", s, t) for s in (1, 3) for t in ("am", "xvec", "both")]
         + [("adapted", 1, None)]
         + [("combined", 1, t) for t in ("am", "xvec", "both")])


@pytest.mark.parametrize("kind,num_shared,task", CASES)
@pytest.mark.parametrize("masked", [False, True])
def test_forward_matches_reference(kind, num_shared, task, masked):
    jmodel, tmodel = _pair(kind, num_shared)
    variables = _init(jmodel)
    tmodel = _port_model(tmodel, variables)
    feats, mask = _inputs()
    kw = {} if task is None else {"task": task}
    if masked and kind != "am":  # the AM net takes no mask
        kw["frame_mask"] = mask
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}

    # eval mode: the perturbed running statistics
    tmodel.eval()
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(feats), **tkw)
    _compare(jmodel.apply(variables, feats, train=False, **kw), tout)

    # train mode: batch statistics, and the running statistics after one forward
    jout, mut = jmodel.apply(variables, feats, train=True, mutable=["batch_stats"], **kw)
    tmodel.train()
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(feats), **tkw)
    _compare(jout, tout)
    _assert_stats_close(flax_variables_from_state_dict(tmodel.state_dict())["batch_stats"],
                        mut["batch_stats"])


def test_default_contexts_equal_the_reference():
    assert tcv.AmConfig().context == jcv.AmConfig().context == (13, 7)
    assert tcv.AM_BOTTLENECK.bottleneck_dim == jcv.AM_BOTTLENECK.bottleneck_dim == 128
    for n in (1, 2, 3, 4):
        t, j = tcv.MultitaskConfig(num_shared=n), jcv.MultitaskConfig(num_shared=n)
        assert (t.xvec_context, t.am_context) == (j.xvec_context, j.am_context)
        assert t.shared_specs == tuple(TdnnSpec(s.dim, s.offsets) for s in j.shared_specs)
    for n in (1, 2, 3):
        t, j = tcv.CombinedConfig(num_shared=n), jcv.CombinedConfig(num_shared=n)
        assert (t.xvec_context, t.am_context) == (j.xvec_context, j.am_context)
    assert tcv.V4_ADAPTED.context == jcv.V4_ADAPTED.context == (13, 7)
    assert tcv.V3_MULTITASK.am_context == jcv.V3_MULTITASK.am_context == (7, 7)
    assert tcv.V5_COMBINED.xvec_context == jcv.V5_COMBINED.xvec_context == (13, 7)
    for t, j in ((tcv.V3_MULTITASK, jcv.V3_MULTITASK), (tcv.V4_ADAPTED, jcv.V4_ADAPTED),
                 (tcv.V5_COMBINED, jcv.V5_COMBINED)):
        assert (t.num_speakers, t.embed_dim, t.hidden_dim, t.pool_dim) == \
            (j.num_speakers, j.embed_dim, j.hidden_dim, j.pool_dim)


def test_frame_egs_context_gives_one_logit_per_label():
    """FrameSampler cuts chunk_len + left + right frames: 28 for the AM
    net, 22 for the v3/v5 AM head; the VALID stacks return chunk_len."""
    am = tcv.AmNet(tcv.AmConfig(num_senones=40))
    assert am(torch.zeros(1, 8 + 13 + 7, 23))["logits"].shape == (1, 8, 40)
    mt = tcv.MultitaskCVector(tcv.MultitaskConfig(num_speakers=3, num_senones=40))
    assert mt(torch.zeros(2, 8 + 7 + 7, 23), task="am")["am_logits"].shape == (2, 8, 40)
    with pytest.raises(ValueError, match="task"):
        mt(torch.zeros(2, 30, 23), task="speaker")


def test_append_streams_crops_to_the_larger_context():
    """v4/v5: the x-vector prefix (7, 7) is cropped 6 frames on the left to
    meet the AM bottleneck (13, 7); shorter than l + r + 1 = 21 frames
    leaves nothing."""
    x = torch.arange(2 * 30 * 3, dtype=torch.float32).reshape(2, 30, 3)  # T - 14 frames
    a = torch.zeros(2, 24, 2)  # T - 20 frames
    merged = append_streams([Stream(x, 7, 7), Stream(a, 13, 7)])
    assert (merged.left, merged.right) == (13, 7) and merged.x.shape == (2, 24, 5)
    torch.testing.assert_close(merged.x[..., :3], x[:, 6:, :])
    with pytest.raises(ValueError):
        Stream(a, 13, 7).crop_to(7, 7)
    v4 = tcv.AdaptedXVector(tcv.AdaptedConfig(am=T_AM, **WIDTHS)).eval()
    assert v4(torch.zeros(1, 21, 23))["embedding_a"].shape == (1, 32)
    with pytest.raises(RuntimeError):
        v4(torch.zeros(1, 20, 23))


@pytest.mark.parametrize("kind", ["am", "multitask", "adapted", "combined"])
def test_bridge_round_trips(kind):
    jmodel, tmodel = _pair(kind)
    variables = _init(jmodel, seed=3)
    tmodel.load_state_dict(state_dict_from_flax(variables))  # strict: every key
    back = flax_variables_from_state_dict(tmodel.state_dict())
    ref, got = _leaves(variables), _leaves(back)
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


def test_xvector_bridge_keeps_its_name():
    from sepi_tpu.models import XVector as JXVector
    from sepi_tpu.models import XVectorConfig as JXConfig

    cfg = JXConfig(feat_dim=23, num_speakers=5, embed_dim=16,
                   frame_specs=(JSpec(16, (-1, 0, 1)), JSpec(32, (0,))))
    variables = _init(JXVector(cfg), seed=4)
    a, b = xvector_state_dict_from_flax(variables), state_dict_from_flax(variables)
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("kind", ["adapted", "combined"])
def test_graft_matches_reference(kind):
    """The port's graft on the bridged weights equals the reference's graft,
    copies (the source stays as it was after the target changes), drops
    the AM's output head and takes the source at top level or under am."""
    jtarget, ttarget = _pair(kind)
    target_vars = _init(jtarget, seed=5)
    source_vars = _init(jcv.AmNet(J_AM), seed=6)
    ref = jgraft(target_vars, source_vars, "am")
    ttarget = _port_model(ttarget, target_vars)
    source = _port_model(tcv.AmNet(T_AM), source_vars)
    before = {k: v.clone() for k, v in source.state_dict().items()}
    assert graft_subtree(ttarget, source, "am") is ttarget
    got, want = _leaves(flax_variables_from_state_dict(ttarget.state_dict())), _leaves(_np(ref))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with torch.no_grad():
        for p in ttarget.am.parameters():
            p.add_(1.0)
        ttarget.am.frames.tdnn1.batchnorm.running_mean.add_(1.0)
    assert all(torch.equal(v, before[k]) for k, v in source.state_dict().items())
    # the source's contents under "am": another grafted model's state_dict
    _, other = _pair(kind)
    graft_subtree(other, ttarget.state_dict(), "am")
    assert all(torch.equal(v, ttarget.state_dict()[f"am.{k}"])
               for k, v in other.am.state_dict().items())


def test_graft_refuses_a_shape_mismatch():
    _, target = _pair("adapted")
    wide = tcv.AmConfig(feat_dim=23, num_senones=NUM_SENONES,
                        specs=tuple(TdnnSpec(d + 1, o) for d, o in AM_SPECS))
    with pytest.raises(ValueError, match="shape mismatch at am.frames.tdnn1.affine.weight"):
        graft_subtree(target, tcv.AmNet(wide), "am")
    short = tcv.AmConfig(feat_dim=23, num_senones=NUM_SENONES,
                         specs=tuple(TdnnSpec(d, o) for d, o in AM_SPECS[:4]))
    with pytest.raises(ValueError, match="source missing"):
        graft_subtree(target, tcv.AmNet(short), "am")
