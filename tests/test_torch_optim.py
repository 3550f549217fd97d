"""Port parity: the optimizer chain against optax's `build_optimizer`.

The same five gradients (numpy, from a seed) go through the reference's
optax chain on Flax parameters and through the port's chain on the same
parameters bridged to torch.  After every step the parameters agree to
1e-6 relative over the whole set (l2), and each parameter's change since
the start agrees to 1e-5 of its own l2 size, plus one float32 rounding of
the parameter.  (The reference's own float32
global norm, the clip's input, is 2e-6 off its float64 value here: a
per-entry 1e-6 limit on a bias that starts at zero would test that.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sepi_tpu.config import OptimizerConfig as JOptimizerConfig
from sepi_tpu.models import XVector as JXVector
from sepi_tpu.models import XVectorConfig as JConfig
from sepi_tpu.models.tdnn import TdnnSpec as JSpec
from sepi_tpu.train import optim as joptim
from sepi_tpu_torch.bridge import flax_variables_from_state_dict, xvector_state_dict_from_flax
from sepi_tpu_torch.config import OptimizerConfig
from sepi_tpu_torch.models import TdnnSpec, XVector, XVectorConfig
from sepi_tpu_torch.train import optim

torch.set_num_threads(2)

SPECS = [(24, (-2, -1, 0, 1, 2)), (24, (-2, 0, 2)), (24, (-3, 0, 3)), (24, (0,)), (64, (0,))]
STEPS = 5
TOL_PARAM = 1e-6  # l2 over all parameters, relative, after every step
TOL_CHANGE = 1e-5  # l2 of each parameter's error over the l2 of its change since step 0


def _models(num_speakers):
    kw = dict(feat_dim=8, num_speakers=num_speakers, embed_dim=16)
    jcfg = JConfig(frame_specs=tuple(JSpec(d, o) for d, o in SPECS), **kw)
    tcfg = XVectorConfig(frame_specs=tuple(TdnnSpec(d, o) for d, o in SPECS), **kw)
    variables = JXVector(jcfg).init(jax.random.PRNGKey(3), jnp.zeros((2, 30, 8)), train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    model = XVector(tcfg)
    model.load_state_dict(xvector_state_dict_from_flax(variables))
    return variables, model


def _grads(variables, seed):
    rng = np.random.default_rng(seed)
    return [jax.tree_util.tree_map(
        lambda p: (0.1 * rng.standard_normal(p.shape)).astype(np.float32),
        variables["params"]) for _ in range(STEPS)]


def _run_both(kw, num_speakers=6, lr_factors=None, total_steps=20):
    variables, model = _models(num_speakers)
    grads = _grads(variables, 11)
    tx, _ = joptim.build_optimizer(JOptimizerConfig(**kw), total_steps, lr_factors=lr_factors)
    jparams = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    opt_state = tx.init(jparams)

    chain, _ = optim.build_optimizer(OptimizerConfig(**kw), total_steps, lr_factors=lr_factors)
    params = dict(model.named_parameters())
    state = chain.init(params)
    stats = variables["batch_stats"]

    p0 = variables["params"]
    for g in grads:
        updates, opt_state = tx.update(g, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tg = xvector_state_dict_from_flax({"params": g, "batch_stats": stats})
        optim.apply_updates(params, chain.update({n: tg[n] for n in params}, state, params))
        port = flax_variables_from_state_dict(model.state_dict())["params"]
        ref = jax.tree_util.tree_map(np.asarray, jparams)
        sq_err = sq_ref = 0.0
        for path, r in jax.tree_util.tree_leaves_with_path(ref):
            p = _at(port, path)
            sq_err += float(np.sum((p.astype(np.float64) - r) ** 2))
            sq_ref += float(np.sum(r.astype(np.float64) ** 2))
            change = np.linalg.norm(r - _at(p0, path))
            err = np.linalg.norm(p - r)
            ulp = np.finfo(np.float32).eps * np.linalg.norm(r)
            assert err <= TOL_CHANGE * change + ulp, (jax.tree_util.keystr(path), err / change)
        assert np.sqrt(sq_err / sq_ref) <= TOL_PARAM
    assert state["count"] == STEPS
    return ref, p0


def _at(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


CASES = {
    "muon-default": dict(initial_lr=0.02, final_lr=0.005),
    "muon-no-shrink": dict(initial_lr=0.02, final_lr=0.005, proportional_shrink=0.0),
    "muon-clip": dict(initial_lr=0.02, final_lr=0.005, max_param_change=0.05),
    "none": dict(initial_lr=0.02, final_lr=0.005, preconditioner="none"),
    "none-no-shrink-l2": dict(initial_lr=0.02, final_lr=0.005, preconditioner="none",
                              proportional_shrink=0.0, l2_regularize=1e-2),
    "none-clip": dict(initial_lr=0.02, final_lr=0.005, preconditioner="none",
                      max_param_change=0.05, momentum=0.9),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chain_matches_optax(case):
    _run_both(CASES[case])


def test_muon_wide_head_is_not_transposed():
    """More speakers than embedding dims: the Flax kernel (16, 40) runs
    untransposed and the shape factor is sqrt(40/16)."""
    _run_both(CASES["muon-default"], num_speakers=40)


def test_lr_factor_prefix_maps_onto_torch_paths():
    ref, p0 = _run_both(CASES["muon-no-shrink"], lr_factors={"segment/tdnn6": 0.0})
    seg = ref["segment"]["tdnn6"]
    np.testing.assert_array_equal(seg["affine"]["kernel"],
                                  p0["segment"]["tdnn6"]["affine"]["kernel"])
    assert not np.array_equal(ref["segment"]["tdnn7"]["affine"]["kernel"],
                              p0["segment"]["tdnn7"]["affine"]["kernel"])
    factors = optim.subtree_lr_factors(
        ["segment.tdnn6.affine.weight", "segment.tdnn6.batchnorm.weight",
         "segment.tdnn60.affine.bias", "frames.tdnn1.affine.bias"],
        {"segment/tdnn6": 0.5, "frames/tdnn1/affine/bias": 0.25})
    assert factors == {"segment.tdnn6.affine.weight": 0.5, "segment.tdnn6.batchnorm.weight": 0.5,
                       "segment.tdnn60.affine.bias": 1.0, "frames.tdnn1.affine.bias": 0.25}


@pytest.mark.parametrize("mult", [1.0, 4.0])
def test_lr_schedule_matches(mult):
    kw = dict(initial_lr=1e-3, final_lr=1e-4)
    ref = joptim.lr_schedule(JOptimizerConfig(**kw), 100, mult)
    port = optim.lr_schedule(OptimizerConfig(**kw), 100, mult)
    for step in (0, 1, 37, 99, 100, 250):
        assert port(step) == pytest.approx(float(ref(step)), rel=1e-6)


def test_dropout_schedule_matches():
    spec = "0,0@0.20,0.1@0.50,0"
    ref, port = joptim.dropout_schedule(spec), optim.dropout_schedule(spec)
    for frac in np.linspace(0.0, 1.0, 21):
        assert port(frac) == ref(frac)


def test_guards_raise_like_the_reference():
    bad_shrink = dict(proportional_shrink=600.0)
    with pytest.raises(ValueError, match="guard"):
        joptim.build_optimizer(JOptimizerConfig(**bad_shrink), 10)
    with pytest.raises(ValueError, match="guard"):
        optim.build_optimizer(OptimizerConfig(**bad_shrink), 10)
    l2_muon = dict(l2_regularize=1e-4)
    with pytest.raises(ValueError, match="l2_regularize"):
        joptim.build_optimizer(JOptimizerConfig(**l2_muon), 10)
    with pytest.raises(ValueError, match="l2_regularize"):
        optim.build_optimizer(OptimizerConfig(**l2_muon), 10)
    with pytest.raises(ValueError, match="unknown preconditioner"):
        optim.build_optimizer(OptimizerConfig(preconditioner="adagrad"), 10)


def test_config_defaults_match_the_reference():
    from sepi_tpu.config import ChunkConfig as JChunk
    from sepi_tpu.config import TrainConfig as JTrain
    from sepi_tpu_torch.config import ChunkConfig, TrainConfig

    for port, ref in ((OptimizerConfig, JOptimizerConfig), (ChunkConfig, JChunk),
                      (TrainConfig, JTrain)):
        pf = {f.name: f.default for f in dataclasses.fields(port)}
        rf = {f.name: f.default for f in dataclasses.fields(ref)}
        assert set(pf) == set(rf)
        for k in pf:
            if dataclasses.is_dataclass(pf[k]):
                assert dataclasses.asdict(pf[k]) == dataclasses.asdict(rf[k]), k
            else:
                assert pf[k] == rf[k], k
