"""Port parity: x-vector TDNN through the Flax -> torch weight bridge.

A narrow XVectorConfig (the 32-wide specs of __graft_entry__), random
weights from the reference's init and non-trivial batch statistics,
compared with `XVector.apply(..., train=False)` in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepi_tpu.models import XVector as JXVector
from sepi_tpu.models import XVectorConfig as JConfig
from sepi_tpu.models.tdnn import TdnnSpec as JSpec
from sepi_tpu_torch.bridge import xvector_state_dict_from_flax
from sepi_tpu_torch.models import TdnnSpec, XVector, XVectorConfig

torch.set_num_threads(2)

SPECS = [(32, (-2, -1, 0, 1, 2)), (32, (-2, 0, 2)), (32, (-3, 0, 3)), (32, (0,)), (64, (0,))]


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.fixture(scope="module")
def pair():
    jcfg = JConfig(feat_dim=23, num_speakers=16,
                   frame_specs=tuple(JSpec(d, o) for d, o in SPECS), embed_dim=32)
    tcfg = XVectorConfig(feat_dim=23, num_speakers=16,
                         frame_specs=tuple(TdnnSpec(d, o) for d, o in SPECS), embed_dim=32)
    jmodel = JXVector(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, 40, 23)), train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(0)

    def nontrivial(path, x):
        name = path[-1].key
        if name == "mean":
            return rng.normal(size=x.shape).astype(np.float32) * 0.3
        if name == "var":
            return rng.uniform(0.5, 2.0, size=x.shape).astype(np.float32)
        if name in ("scale", "bias"):
            return rng.uniform(0.5, 1.5, size=x.shape).astype(np.float32)
        return x

    variables = {
        "params": jax.tree_util.tree_map_with_path(nontrivial, variables["params"]),
        "batch_stats": jax.tree_util.tree_map_with_path(nontrivial, variables["batch_stats"]),
    }
    tmodel = XVector(tcfg)
    tmodel.load_state_dict(xvector_state_dict_from_flax(variables))
    return jmodel, variables, tmodel.eval()


def _feats(seed, b=3, t=60):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, t, 23)).astype(np.float32)
    mask = np.ones((b, t), bool)
    mask[1, 41:] = False
    mask[2, 20:] = False
    return feats, mask


def test_bridge_covers_every_torch_tensor(pair):
    _, variables, tmodel = pair
    sd = xvector_state_dict_from_flax(variables)
    assert set(sd) == set(tmodel.state_dict())
    assert sd["frames.tdnn2.affine.weight"].shape == (32, 32, 3)
    assert torch.count_nonzero(sd["frames.tdnn1.batchnorm.bias"]) == 0


@pytest.mark.parametrize("masked", [True, False])
def test_forward_matches_reference(pair, masked):
    jmodel, variables, tmodel = pair
    feats, mask = _feats(1)
    m = mask if masked else None
    ref = jmodel.apply(variables, jnp.asarray(feats),
                       frame_mask=None if m is None else jnp.asarray(m), train=False)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(feats), None if m is None else torch.from_numpy(m))
    for key in ("embedding_a", "embedding_b", "logits"):
        assert got[key].shape == ref[key].shape
        assert _rel(got[key].numpy(), ref[key]) <= 1e-4, key


def test_trunk_and_head_match_reference(pair):
    jmodel, variables, tmodel = pair
    feats, _ = _feats(2)
    ref = jmodel.apply(variables, jnp.asarray(feats), method="trunk")
    with torch.no_grad():
        got = tmodel.trunk(torch.from_numpy(feats))
    assert (got.left, got.right) == (ref.left, ref.right) == (7, 7)
    assert _rel(got.x.numpy(), ref.x) <= 1e-4
    pooled = np.random.default_rng(3).normal(size=(4, 128)).astype(np.float32)
    ref_h = jmodel.apply(variables, jnp.asarray(pooled), method="head")
    with torch.no_grad():
        got_h = tmodel.head(torch.from_numpy(pooled))
    for key in ("embedding_a", "embedding_b", "logits"):
        assert _rel(got_h[key].numpy(), ref_h[key]) <= 1e-4, key


def test_config_context():
    from sepi_tpu.models import V2_XVECTOR as JV2
    from sepi_tpu_torch.models import V2_XVECTOR

    assert V2_XVECTOR.context == JV2.context == (7, 7)
    assert V2_XVECTOR.min_frames == JV2.min_frames
    model = XVector(V2_XVECTOR)
    assert model.frames.tdnn5.affine.weight.shape == (1500, 512, 1)
    assert model.segment.tdnn6.affine.weight.shape == (512, 3000, 1)
