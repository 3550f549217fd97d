"""Port parity in bfloat16: the TDNN models with ``dtype="bfloat16"``
against the reference's Flax models with the same dtype, on the CPU.

The convention both packages follow: parameters stay float32; each
affine casts its input, weight and bias to bf16 and returns bf16, its
ReLU runs in bf16; batch norm casts to float32 first, so statistics
pooling, the batch statistics and the logits are float32; the embedding
tap (an affine pre-activation) is bf16.

Every model starts from the reference's Flax variables (bridged, batch
norm perturbed as tests/test_torch_cvector.py does) and both run the same
numpy inputs.  Tolerance: ``ULPS`` bf16 units in the last place at the
scale of what is compared, |port - ref| <= ULPS * 2^-7 * max |ref|, each
tensor (each gradient leaf) at its own scale.  A running statistic is
held by its change in the forward, (post - pre) against the reference's,
at the scale of that change.  A gradient is a bf16 reduction over every
frame of the batch, behind every bf16 layer above its parameter, and bf16
alone moves it far more than an output: the reference's own bf16
gradients land 17-21% (relative L2) from its float32 ones here.  So a
gradient leaf is held to ``GRAD_ULPS`` ulps of its own largest entry,
and all leaves together to ``GRAD_RTOL`` relative L2 (measured: at most
17.9 ulps and 4.8%, both in the am task; a zeroed leaf reads 128 ulps, a
gradient 10% off reads 10%).  The two
frameworks round bf16 at different places (XLA rounds the convolution to
bf16 before adding the bias; a fused convolution may add it first), so an
entry may differ by an ulp of its own and that difference carries through
the layers above; float32 outputs downstream of bf16 layers are held to
the same limit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepi_tpu.config import ExtractConfig as JExtractConfig
from sepi_tpu.extract import EmbeddingExtractor as JExtractor
from sepi_tpu.models import XVector as JXVector
from sepi_tpu.models import XVectorConfig as JXConfig
from sepi_tpu.models import cvector as jcv
from sepi_tpu.models.tdnn import TdnnLayer as JTdnnLayer
from sepi_tpu.models.tdnn import TdnnSpec as JSpec
from sepi_tpu_torch.bridge import (flax_variables_from_state_dict, state_dict_from_flax,
                                   xvector_state_dict_from_flax)
from sepi_tpu_torch.config import ChunkConfig, ExtractConfig, OptimizerConfig
from sepi_tpu_torch.data import ChunkSampler, FrameSampler, make_synthetic_corpus
from sepi_tpu_torch.extract import EmbeddingExtractor
from sepi_tpu_torch.models import TdnnLayer, TdnnSpec, XVector, XVectorConfig, compute_dtype
from sepi_tpu_torch.models import cvector as tcv
from sepi_tpu_torch.recipes import extract_and_score, prepare_features_nosil
from sepi_tpu_torch.recipes.phonetic import pseudo_senone_alignments
from sepi_tpu_torch.train import (Trainer, TrainState, build_optimizer, create_train_state,
                                  make_am_step, make_eval_step, make_xvec_step)

torch.set_num_threads(2)

ULPS = 4
GRAD_ULPS = 24
GRAD_RTOL = 1 / 16
BF16_EPS = 2.0 ** -7  # spacing of bf16 at 1.0

SPECS = [(24, (-2, -1, 0, 1, 2)), (24, (-2, 0, 2)), (24, (-3, 0, 3)), (24, (0,)), (48, (0,))]
AM_SPECS = [(24, (-2, -1, 0, 1, 2)), (24, (-1, 0, 1)), (24, (-1, 0, 1)), (24, (-3, 0, 3)),
            (12, (-6, -3, 0))]
NUM_SENONES = 12
WIDTHS = dict(num_speakers=6, embed_dim=32, hidden_dim=24, pool_dim=48)
J_AM = jcv.AmConfig(feat_dim=23, num_senones=NUM_SENONES,
                    specs=tuple(JSpec(d, o) for d, o in AM_SPECS))
T_AM = tcv.AmConfig(feat_dim=23, num_senones=NUM_SENONES,
                    specs=tuple(TdnnSpec(d, o) for d, o in AM_SPECS))
XKW = dict(feat_dim=23, num_speakers=6, embed_dim=32)
J_XCFG = JXConfig(frame_specs=tuple(JSpec(d, o) for d, o in SPECS), **XKW)
T_XCFG = XVectorConfig(frame_specs=tuple(TdnnSpec(d, o) for d, o in SPECS), **XKW)
B, T = 8, 70
KINDS = ("xvector", "am", "multitask", "adapted", "combined")


def _pair(kind, dtype="bfloat16"):
    """(reference module, port module) of one model at the tiny widths."""
    if kind == "xvector":
        return JXVector(J_XCFG, dtype=dtype), XVector(T_XCFG, dtype=dtype)
    if kind == "am":
        return jcv.AmNet(J_AM, dtype=dtype), tcv.AmNet(T_AM, dtype=dtype)
    kw = dict(WIDTHS, num_senones=NUM_SENONES)
    if kind == "multitask":
        return (jcv.MultitaskCVector(jcv.MultitaskConfig(**kw), dtype=dtype),
                tcv.MultitaskCVector(tcv.MultitaskConfig(**kw), dtype=dtype))
    if kind == "adapted":
        return (jcv.AdaptedXVector(jcv.AdaptedConfig(am=J_AM, **WIDTHS), dtype=dtype),
                tcv.AdaptedXVector(tcv.AdaptedConfig(am=T_AM, **WIDTHS), dtype=dtype))
    return (jcv.CombinedCVector(jcv.CombinedConfig(am=J_AM, **kw), dtype=dtype),
            tcv.CombinedCVector(tcv.CombinedConfig(am=T_AM, **kw), dtype=dtype))


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _init(jmodel, seed=0):
    """The reference's variables from ``seed``, batch-norm scales and
    statistics perturbed from a numpy generator."""
    variables = _np(jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((2, 40, 23)), train=False))
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


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, T, 23)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, 50:] = False
    mask[3, 31:] = False
    return feats, mask


def _limit(want, ulps=ULPS) -> float:
    return ulps * BF16_EPS * float(np.abs(want).max())


def _close_np(got, want, name, ulps=ULPS):
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= _limit(want, ulps), (name, err, _limit(want, ulps))


def _close(got: torch.Tensor, want, name):
    """Same dtype (bf16 or float32) and within ULPS bf16 ulps of the scale."""
    want_dt = str(jnp.asarray(want).dtype)
    assert str(got.dtype) == f"torch.{want_dt}", (name, got.dtype, want_dt)
    _close_np(got.detach().float().numpy(), np.asarray(want, np.float32), name)


def _compare(jout, tout):
    assert set(tout) == set(jout)
    for k, v in jout.items():
        if k == "bottleneck":
            _close(tout[k].x, v.x, k)
        elif k != "am_context":
            _close(tout[k], v, k)


def _task_kw(kind):
    return {"task": "both"} if kind in ("multitask", "combined") else {}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_tdnn_layer_bf16_matches_flax(train):
    """One layer: the affine (bf16), its ReLU (bf16) and the batch norm's
    output (float32) and statistics."""
    spec = (32, (-2, 0, 2))
    jlayer = JTdnnLayer(JSpec(*spec), dtype="bfloat16")
    x = np.random.default_rng(3).normal(size=(B, T, 23)).astype(np.float32) * 2.0
    variables = _np(jlayer.init(jax.random.PRNGKey(2), jnp.asarray(x), train=False))
    variables["batch_stats"]["batchnorm"]["mean"] = np.full(32, 0.1, np.float32)
    variables["batch_stats"]["batchnorm"]["var"] = np.full(32, 1.7, np.float32)
    if train:
        (jh, jaff), mut = jlayer.apply(variables, jnp.asarray(x), True, True,
                                       mutable=["batch_stats"])
    else:
        jh, jaff = jlayer.apply(variables, jnp.asarray(x), False, True)

    layer = TdnnLayer(TdnnSpec(*spec), 23, dtype="bfloat16")
    sd = state_dict_from_flax({"params": {"l": variables["params"]},
                               "batch_stats": {"l": variables["batch_stats"]}})
    layer.load_state_dict({k[2:]: v for k, v in sd.items()})
    layer.train(train)
    h, aff = layer(torch.from_numpy(x).transpose(1, 2), return_affine=True)
    _close(aff.transpose(1, 2), jaff, "affine")
    _close(torch.relu(aff).transpose(1, 2), jax.nn.relu(jaff), "relu")
    _close(h.transpose(1, 2), jh, "batchnorm")
    assert all(p.dtype == torch.float32 for p in layer.parameters())
    if train:
        for stat, buf in (("mean", layer.batchnorm.running_mean),
                          ("var", layer.batchnorm.running_var)):
            pre = variables["batch_stats"]["batchnorm"][stat]
            want = np.asarray(mut["batch_stats"]["batchnorm"][stat]) - pre
            assert buf.dtype == torch.float32
            _close_np(buf.numpy() - pre, want, stat)


@pytest.mark.parametrize("kind", KINDS)
def test_models_bf16_match_flax(kind):
    """Eval and train mode, masked: the embeddings bf16 in both, the
    logits float32, the batch statistics after a train-mode forward."""
    jmodel, tmodel = _pair(kind)
    variables = _init(jmodel)
    tmodel.load_state_dict(state_dict_from_flax(variables))
    feats, mask = _inputs()
    kw = _task_kw(kind)
    if kind != "am":  # the AM net takes no mask
        kw["frame_mask"] = mask
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}

    tmodel.eval()
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(feats), **tkw)
    jout = jmodel.apply(variables, feats, train=False, **kw)
    _compare(jout, tout)
    emb = [k for k in jout if k.startswith("embedding")]
    assert all(tout[k].dtype == torch.bfloat16 for k in emb)
    assert all(tout[k].dtype == torch.float32 for k in tout if "logits" in k)

    jout, mut = jmodel.apply(variables, feats, train=True, mutable=["batch_stats"], **kw)
    tmodel.train()
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(feats), **tkw)
    _compare(jout, tout)
    pre = _leaves(variables["batch_stats"])
    ref = _leaves(mut["batch_stats"])
    port = _leaves(flax_variables_from_state_dict(tmodel.state_dict())["batch_stats"])
    assert set(ref) == set(port) == set(pre)
    for k, r in ref.items():
        assert port[k].dtype == np.float32
        _close_np(port[k] - pre[k], r - pre[k], k)


def _xent(logits, labels):
    return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), labels[..., None],
                                         axis=-1))


@pytest.mark.parametrize("kind,task", [("xvector", None), ("multitask", "am"),
                                       ("combined", "xvec")])
def test_bf16_gradients_match_flax(kind, task):
    """The gradient of one train-mode cross-entropy step, every parameter
    float32 in both: each leaf within GRAD_ULPS bf16 ulps of its own
    scale, all leaves within GRAD_RTOL relative L2."""
    jmodel, tmodel = _pair(kind)
    variables = _init(jmodel, seed=4)
    tmodel.load_state_dict(state_dict_from_flax(variables))
    feats, _ = _inputs(seed=5)
    rng = np.random.default_rng(6)
    kw = {} if task is None else {"task": task}
    key = "am_logits" if task == "am" else "logits"
    if task == "am":
        lf = jmodel.apply(variables, feats[:1], train=False, **kw)[key].shape[1]
        labels = rng.integers(0, NUM_SENONES, size=(B, lf)).astype(np.int32)
    else:
        labels = rng.integers(0, WIDTHS["num_speakers"], size=B).astype(np.int32)

    def loss(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              feats, train=True, mutable=["batch_stats"], **kw)
        assert out[key].dtype == jnp.float32
        return _xent(out[key], labels)

    jgrads = jax.grad(loss)(variables["params"])

    tmodel.train()
    params = dict(tmodel.named_parameters())
    logits = tmodel(torch.from_numpy(feats), **kw)[key]
    assert logits.dtype == torch.float32
    logp = torch.log_softmax(logits, -1)
    tloss = -torch.gather(logp, -1, torch.from_numpy(labels)[..., None].long()).mean()
    grads = torch.autograd.grad(tloss, list(params.values()), allow_unused=True)
    sd = dict(tmodel.state_dict())
    for (name, p), g in zip(params.items(), grads):
        sd[name] = torch.zeros_like(p) if g is None else g
        assert sd[name].dtype == torch.float32, name
    port = _leaves(flax_variables_from_state_dict(sd)["params"])
    ref = _leaves(jgrads)
    assert set(port) == set(ref)
    for k, r in ref.items():
        _close_np(port[k], r, k, GRAD_ULPS)
    got, want = (np.concatenate([d[k].ravel() for k in sorted(ref)]) for d in (port, ref))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= GRAD_RTOL, rel


def test_bridge_loads_flax_variables_into_bf16_model():
    """The converters load a bf16 Flax model's variables into a bf16 port
    model unchanged (both float32) and read them back equal."""
    jmodel, tmodel = _pair("xvector")
    variables = _init(jmodel, seed=7)
    tmodel.load_state_dict(xvector_state_dict_from_flax(variables))
    assert all(v.dtype == torch.float32 for v in tmodel.state_dict().values()
               if v.is_floating_point())
    back = _leaves(flax_variables_from_state_dict(tmodel.state_dict()))
    want = _leaves(variables)
    assert set(back) == set(want)
    assert all(np.array_equal(back[k], want[k]) for k in want)
    _, fp32 = _pair("combined", dtype="float32")
    bf16 = _pair("combined")[1]
    bf16.load_state_dict(fp32.state_dict())
    assert all(torch.equal(a, b) for a, b in zip(bf16.state_dict().values(),
                                                 fp32.state_dict().values()))


def test_extraction_bf16_matches_flax():
    """EmbeddingExtractor and extract_and_score on a bf16 model return
    float32 embeddings equal to the reference's bf16 extraction (chunked,
    bucketed, length-weighted)."""
    jmodel, tmodel = _pair("xvector")
    variables = _init(jmodel, seed=8)
    tmodel.load_state_dict(state_dict_from_flax(variables))
    rng = np.random.default_rng(9)
    feats = {f"u{i}": rng.normal(size=(n, 23)).astype(np.float32)
             for i, n in enumerate((40, 95, 130, 61, 300))}
    cfg = dict(chunk_size=64, min_chunk_size=25, batch_size=4)
    want = JExtractor(jmodel, variables, JExtractConfig(**cfg),
                      min_frames=J_XCFG.min_frames).extract_utterances(feats)
    got = EmbeddingExtractor(tmodel, ExtractConfig(**cfg), min_frames=T_XCFG.min_frames,
                             device="cpu").extract_utterances(feats)
    via = extract_and_score(tmodel, None, feats, ExtractConfig(**cfg), T_XCFG.min_frames,
                            device="cpu")
    assert set(got) == set(want) == set(via)
    for u, w in want.items():
        assert got[u].dtype == np.float32 and via[u].dtype == np.float32
        np.testing.assert_array_equal(got[u], via[u])
        _close_np(got[u], w, u)


# ------------------------------------------------ convergence (port only)

TINY = tuple(TdnnSpec(d, o) for d, o in [(24, (-2, -1, 0, 1, 2)), (24, (-2, 0, 2)),
                                         (24, (-3, 0, 3)), (24, (0,)), (48, (0,))])


@pytest.fixture(scope="module")
def world():
    corpus = make_synthetic_corpus(num_speakers=5, utts_per_speaker=4, seed=77)
    return corpus, prepare_features_nosil(corpus.audio, device="cpu")


def _train(world, dtype, num_steps=250):
    corpus, nosil = world
    cfg = XVectorConfig(feat_dim=23, num_speakers=5, frame_specs=TINY, embed_dim=32)
    sampler = ChunkSampler(nosil, corpus.dataset,
                           ChunkConfig(min_chunk_len=50, max_chunk_len=80, num_buckets=2),
                           batch_size=20, seed=3)
    tx, _ = build_optimizer(OptimizerConfig(initial_lr=0.02, final_lr=0.005,
                                            proportional_shrink=0.5), num_steps)
    sampler.sample_batch(sampler.buckets[0])
    state = create_train_state(XVector(cfg, dtype=dtype), tx, 0, torch.device("cpu"))
    state = Trainer(steps={"xvec": make_xvec_step(tx)}, state=state,
                    log_every=1000).run(iter(sampler), num_steps=num_steps)
    b = sampler.sample_batch(sampler.buckets[0])
    acc = float(make_eval_step()(state, b.feats, b.labels)["accuracy"])
    return acc, state


def test_bfloat16_training_converges(world):
    """Reference tests/test_optim_variants.py::test_bfloat16_training_converges
    on the port: bf16 accuracy > 0.8 and within 0.1 of float32; the
    parameters stay float32."""
    acc_f32, _ = _train(world, "float32")
    acc_bf16, state = _train(world, "bfloat16")
    assert acc_bf16 > 0.8, f"bf16 accuracy {acc_bf16:.2f}"
    assert acc_bf16 >= acc_f32 - 0.1
    assert all(p.dtype == torch.float32 for p in state.model.parameters())


def test_bfloat16_multitask_step_finite(world):
    """Reference tests/test_optim_variants.py::test_bfloat16_multitask_step_finite
    on the port: one xvec and one am minibatch on a bf16 MultitaskCVector
    give finite objectives and leave every parameter float32."""
    corpus, nosil = world
    ali = pseudo_senone_alignments(nosil, 6, seed=5, device="cpu")
    cfg = tcv.MultitaskConfig(feat_dim=23, num_speakers=5, num_senones=6, num_shared=1,
                              embed_dim=32, hidden_dim=24, pool_dim=48)
    tx, _ = build_optimizer(OptimizerConfig(initial_lr=0.01), 10)
    xv = ChunkSampler(nosil, corpus.dataset,
                      ChunkConfig(min_chunk_len=50, max_chunk_len=80, num_buckets=1),
                      batch_size=8, seed=1)
    l, r = cfg.am_context
    am = FrameSampler(nosil, ali, chunk_len=8, batch_size=16, seed=1, context=(l, r))
    state = create_train_state(tcv.MultitaskCVector(cfg, dtype="bfloat16"), tx, 0,
                               torch.device("cpu"))
    assert isinstance(state, TrainState)
    probe, ab = xv.sample_batch(xv.buckets[0]), am.sample_batch()
    m1 = make_xvec_step(tx, {"task": "xvec"})(state, torch.from_numpy(probe.feats),
                                              torch.from_numpy(probe.labels))
    m2 = make_am_step(tx, {"task": "am"})(state, torch.from_numpy(ab.feats),
                                          torch.from_numpy(ab.labels))
    assert bool(torch.isfinite(m1["objf"])) and bool(torch.isfinite(m2["objf"]))
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(b.dtype == torch.float32 for n, b in state.model.named_buffers()
               if b.is_floating_point())


def test_bf16_request_is_not_turned_into_fp32():
    """A bf16 model on the CPU computes in bf16 on the CPU; an unknown
    dtype raises."""
    model = XVector(T_XCFG, dtype="bfloat16").eval()
    out = model(torch.zeros(2, 30, 23))
    assert out["embedding_a"].dtype == torch.bfloat16
    assert compute_dtype(model) == torch.bfloat16
    with pytest.raises(ValueError, match="bfloat16"):
        XVector(T_XCFG, dtype="float16")
    with pytest.raises(ValueError, match="bfloat16"):
        tcv.AmNet(T_AM, dtype="float64")
