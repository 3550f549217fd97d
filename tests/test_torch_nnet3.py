"""`sepi_tpu_torch.utils.nnet3` (the Kaldi nnet3 model reader and writer)
against `sepi_tpu.utils.nnet3`.

For each architecture (am, v2, v3, v4, v5, and v3/v5 with two shared
layers) the reference initialises a tiny model with Flax and perturbs its
batch-norm scales and statistics; the variables go through the bridge.
Held: the port's `export_kaldi_raw` writes the reference's bytes; the
port's `import_kaldi_raw` of those bytes gives the reference's imported
weights exactly (as a `state_dict`) and a forward close to the
reference's, relative to each output's scale: frame-level outputs (the AM
logits and bottleneck) within 1e-5 of the reference's.  Outputs after the
mean+stddev pooling are ill-conditioned in float32: the pooled variance
E[x^2] - E[x]^2 cancels under the perturbed batch-norm statistics, and on
these weights the reference's pooled outputs lie 6e-5 to 2.8e-4 of scale
from a float64 evaluation of the same weights (frame-level outputs 5e-7).
So the port's pooled outputs are held within 1e-3 of the reference's,
and no farther from the float64 evaluation than 1e-5 plus twice the
reference's own distance from it (the port reads 3e-5 to 1.2e-4).
The reference's rejection and fuzz cases (tests/test_nnet3_interop.py)
raise the same error class in both; where a corrupt size field is
negative, the port raises and the reference's reader steps backwards and
crawls through ~2^31 bytes, so such inputs are held on the port alone.
"""

import copy
import dataclasses
import functools
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepi_tpu.models import cvector as jcv
from sepi_tpu.models import xvector as jxv
from sepi_tpu.models.tdnn import TdnnSpec
from sepi_tpu.utils import nnet3 as R
from sepi_tpu_torch.bridge import state_dict_from_flax
from sepi_tpu_torch.models.tdnn import Stream
from sepi_tpu_torch.utils import nnet3 as P

torch.set_num_threads(2)

FEAT = 8
FWD_TOL = 1e-5  # frame-level outputs against the reference's
POOLED_TOL = 1e-3  # pooled outputs against the reference's
FRAME_KEYS = ("am_logits", "bottleneck")


def tiny_xvector_cfg(num_speakers=11):
    return dataclasses.replace(
        jxv.XVectorConfig(), feat_dim=FEAT, num_speakers=num_speakers,
        frame_specs=(TdnnSpec(16, (-2, -1, 0, 1, 2)), TdnnSpec(16, (-2, 0, 2)),
                     TdnnSpec(16, (-3, 0, 3)), TdnnSpec(16, (0,)), TdnnSpec(24, (0,))),
        embed_dim=12)


def tiny_am_cfg(num_senones=17):
    return dataclasses.replace(
        jcv.AmConfig(), feat_dim=FEAT, num_senones=num_senones,
        specs=(TdnnSpec(16, (-2, -1, 0, 1, 2)), TdnnSpec(16, (-1, 0, 1)),
               TdnnSpec(16, (-1, 0, 1)), TdnnSpec(16, (-3, 0, 3)), TdnnSpec(6, (-6, -3, 0))))


WIDTHS = dict(feat_dim=FEAT, num_speakers=11, hidden_dim=16, pool_dim=24, embed_dim=12)


def reference_model(arch, num_shared=1):
    """(Flax model, task kwargs) of one architecture at the tiny widths."""
    am = dataclasses.replace(tiny_am_cfg(), num_senones=0)
    if arch == "v2":
        return jxv.XVector(tiny_xvector_cfg()), {}
    if arch == "am":
        return jcv.AmNet(tiny_am_cfg()), {}
    if arch == "v3":
        return jcv.MultitaskCVector(jcv.MultitaskConfig(
            num_senones=17, num_shared=num_shared, **WIDTHS)), {"task": "both"}
    if arch == "v4":
        return jcv.AdaptedXVector(jcv.AdaptedConfig(am=am, **WIDTHS)), {}
    return jcv.CombinedCVector(jcv.CombinedConfig(
        num_senones=17, am=am, num_shared=num_shared, **WIDTHS)), {"task": "both"}


def randomize_bn(variables, rng):
    """Non-trivial batch-norm statistics and scales, so the export's
    scale -> variance fold is exercised."""
    variables = jax.tree_util.tree_map(np.asarray, variables)

    def walk(tree, in_stats):
        for k, v in tree.items():
            if isinstance(v, dict):
                if k == "batchnorm":
                    if in_stats:
                        v["mean"] = rng.normal(size=v["mean"].shape).astype(np.float32)
                        v["var"] = rng.uniform(0.5, 3.0, v["var"].shape).astype(np.float32)
                    else:
                        v["scale"] = rng.uniform(0.5, 2.0, v["scale"].shape).astype(np.float32)
                else:
                    walk(v, in_stats)

    walk(variables["params"], False)
    walk(variables["batch_stats"], True)
    return variables


@functools.lru_cache(maxsize=None)
def reference_variables(arch, num_shared=1, seed=0):
    model, kw = reference_model(arch, num_shared)
    probe = jnp.zeros((1, 64, FEAT), jnp.float32)
    variables = model.init(jax.random.PRNGKey(7), probe, train=False, **kw)
    return model, kw, randomize_bn(variables, np.random.default_rng(seed))


def _flat(out):
    if isinstance(out, dict):
        return {k: _flat(v) for k, v in out.items() if k != "am_context"}
    if isinstance(out, Stream) or hasattr(out, "x"):
        return np.asarray(out.x.detach().numpy() if isinstance(out.x, torch.Tensor) else out.x)
    if isinstance(out, torch.Tensor):
        return out.detach().numpy()
    return np.asarray(out)


def assert_forward_close(jmodel, jvars, tmodel, kw, frame_level=False, seed=3):
    x = np.random.default_rng(seed).normal(size=(2, 64, FEAT)).astype(np.float32)
    want = _flat(jmodel.apply(jvars, jnp.asarray(x), train=False, **kw))
    with torch.no_grad():
        got = _flat(tmodel(torch.from_numpy(x), **kw))
        exact = _flat(copy.deepcopy(tmodel).double()(torch.from_numpy(x).double(), **kw))
    if not isinstance(want, dict):
        want, got, exact = {"out": want}, {"out": got}, {"out": exact}
    assert set(got) == set(want)
    for k in want:
        scale = max(1.0, float(np.abs(want[k]).max()))
        err = np.abs(got[k] - want[k]).max() / scale
        if frame_level or k in FRAME_KEYS:
            assert err <= FWD_TOL, (k, err)
        else:
            assert err <= POOLED_TOL, (k, err)
            ref_err = np.abs(want[k] - exact[k]).max() / scale
            assert np.abs(got[k] - exact[k]).max() / scale <= FWD_TOL + 2 * ref_err, k


CASES = [("am", 1), ("v2", 1), ("v3", 1), ("v4", 1), ("v5", 1), ("v3", 2), ("v5", 2)]


@pytest.mark.parametrize("arch,num_shared", CASES)
def test_export_bytes_equal_and_import_exact(tmp_path, arch, num_shared):
    _, kw, variables = reference_variables(arch, num_shared)
    ref_raw, port_raw = str(tmp_path / "ref.raw"), str(tmp_path / "port.raw")
    R.export_kaldi_raw(variables, arch, ref_raw)
    P.export_kaldi_raw(state_dict_from_flax(variables), arch, port_raw)
    data = open(port_raw, "rb").read()
    assert data == open(ref_raw, "rb").read()

    jmodel2, jvars2, ref_arch = R.import_kaldi_raw(ref_raw)
    tmodel, state, arch2 = P.import_kaldi_raw(port_raw, device="cpu")
    assert arch2 == ref_arch == arch
    assert dataclasses.asdict(tmodel.cfg) == dataclasses.asdict(jmodel2.cfg)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jvars2))
    assert set(state) == set(want)
    for k in want:
        assert torch.equal(state[k], want[k]), k
    assert not tmodel.training
    assert_forward_close(jmodel2, jvars2, tmodel, kw, frame_level=arch == "am")

    # a model exports what its state_dict does: the round trip is a fixed point
    again = str(tmp_path / "again.raw")
    P.export_kaldi_raw(tmodel, arch, again)
    R.export_kaldi_raw(jvars2, arch, ref_raw)
    assert open(again, "rb").read() == open(ref_raw, "rb").read()


def _trained_like(variables):
    """Batch-norm statistics a trained model reaches: units with (near) zero
    running variance under a scale above 1, which Kaldi's target-RMS-1
    batch norm cannot hold (s^2 > (v + 1e-3) / 1e-3)."""
    variables = copy.deepcopy(variables)

    def walk(params, stats):
        for k, v in params.items():
            if k == "batchnorm":
                stats[k]["var"][::3] = 0.0
                v["scale"][::3] = 1.5
            elif isinstance(v, dict) and k in stats:
                walk(v, stats[k])

    walk(variables["params"], variables["batch_stats"])
    return variables


@pytest.mark.parametrize("arch", ["am", "v2"])
def test_export_folds_large_scales_into_target_rms(tmp_path, arch):
    """Where the reference refuses to export (a negative folded variance),
    the port writes target RMS 2^k; both packages import the file to the
    same weights, and the network computes what the original did."""
    jmodel, kw, variables = reference_variables(arch)
    variables = _trained_like(variables)
    with pytest.raises(R.Nnet3ParseError, match="too large"):
        R.export_kaldi_raw(variables, arch, str(tmp_path / "ref.raw"))
    path = str(tmp_path / "port.raw")
    P.export_kaldi_raw(state_dict_from_flax(variables), arch, path)
    rms = {c.scalar_float("TargetRms") for c in P.read_nnet3_raw(path).components.values()
           if c.type == "BatchNormComponent"}
    assert rms == {2.0}
    _, jvars, _ = R.import_kaldi_raw(path)
    tmodel, state, _ = P.import_kaldi_raw(path, device="cpu")
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jvars))
    assert all(torch.equal(state[k], want[k]) for k in want)
    assert_forward_close(jmodel, variables, tmodel, kw, frame_level=arch == "am")


def test_export_refuses_a_negative_scale(tmp_path):
    _, _, variables = reference_variables("am")
    variables = copy.deepcopy(variables)
    variables["params"]["frames"]["tdnn2"]["batchnorm"]["scale"][0] = -0.5
    with pytest.raises(P.Nnet3ParseError, match="<= 0"):
        P.export_kaldi_raw(state_dict_from_flax(variables), "am", str(tmp_path / "x.raw"))


def test_epsilon_target_rms_folding_matches(tmp_path):
    """A file whose batch norms carry another epsilon and target RMS
    imports to the reference's weights exactly."""
    _, _, variables = reference_variables("v2")
    p1 = str(tmp_path / "a.raw")
    P.export_kaldi_raw(state_dict_from_flax(variables), "v2", p1)
    nnet = P.read_nnet3_raw(p1)
    for comp in nnet.components.values():
        if comp.type == "BatchNormComponent":
            eps = comp.scalar_float("Epsilon")
            comp.fields["StatsVar"] = comp.vector("StatsVar") + (eps - 7e-3)
            comp.fields["Epsilon"] = P._Scalar(struct.pack("<f", 7e-3))
            comp.fields["TargetRms"] = P._Scalar(struct.pack("<f", 0.5))
    p2 = str(tmp_path / "b.raw")
    P.write_nnet3_raw(nnet, p2)
    _, jvars, _ = R.import_kaldi_raw(p2)
    _, state, _ = P.import_kaldi_raw(p2, device="cpu")
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jvars))
    assert all(torch.equal(state[k], want[k]) for k in want)


def test_mdl_wrapper_matches(tmp_path):
    """A final.mdl (TransitionModel + the wrapped <Nnet3> + trailer)."""
    _, _, variables = reference_variables("v2")
    raw = str(tmp_path / "v2.raw")
    P.export_kaldi_raw(state_dict_from_flax(variables), "v2", raw)
    tm = (b"<TransitionModel> <Junk> \x04" + struct.pack("<i", 3)
          + b"\x00\x01\x02 </TransitionModel> ")
    trailer = b"<LeftContext> \x04" + struct.pack("<i", 7)
    mdl = str(tmp_path / "final.mdl")
    with open(mdl, "wb") as f:
        f.write(b"\x00B" + tm + open(raw, "rb").read()[2:] + trailer)
    _, jvars, arch = R.import_kaldi_raw(mdl)
    _, state, arch2 = P.import_kaldi_raw(mdl, device="cpu")
    assert arch == arch2 == "v2"
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jvars))
    assert all(torch.equal(state[k], want[k]) for k in want)


def test_detect_arch_names_match():
    def nn(mod, names):
        comps = {f"{n}.affine": mod.KaldiComponent(f"{n}.affine", "X", {}) for n in names}
        comps["output.affine"] = mod.KaldiComponent("output.affine", "X", {})
        return mod.KaldiNnet([], comps, list(comps))

    for names in (["tdnn1", "tdnn2", "tdnn6", "tdnn7"], ["tdnn1", "tdnn5"],
                  ["tdnn1", "tdnn2_am", "tdnn2_xvec"],
                  ["tdnn1", "tdnn5", "tdnn1_xvec", "tdnn7_xvec"],
                  ["tdnn1_share", "tdnn2_am", "tdnn2_xvec"]):
        assert P.detect_arch(nn(P, names)) == R.detect_arch(nn(R, names))
    with pytest.raises(R.Nnet3ParseError):
        R.detect_arch(R.KaldiNnet([], {}, []))
    with pytest.raises(P.Nnet3ParseError, match="classify"):
        P.detect_arch(P.KaldiNnet([], {}, []))


# ------------------------------------------------------- rejections and fuzz


def _both_raise(path, match=None, reader="read_nnet3_raw"):
    with pytest.raises(R.Nnet3ParseError):
        getattr(R, reader)(path)
    with pytest.raises(P.Nnet3ParseError, match=match):
        getattr(P, reader)(path, **({"device": "cpu"} if reader == "import_kaldi_raw" else {}))


def test_text_mdl_and_nnet2_files_rejected(tmp_path):
    p = tmp_path / "text.raw"
    p.write_text("<Nnet3>\ninput-node name=input dim=23\n")
    _both_raise(str(p), "binary")
    p = tmp_path / "final.mdl"
    p.write_bytes(b"\x00B<TransitionModel> junk </TransitionModel> <Nnet> ")
    _both_raise(str(p), "nnet2")
    p = tmp_path / "nnet2.mdl"
    p.write_bytes(b"\x00B<Nnet> junk")
    _both_raise(str(p), "nnet2")


def _exported(tmp_path):
    _, _, variables = reference_variables("v2")
    path = str(tmp_path / "x.raw")
    P.export_kaldi_raw(state_dict_from_flax(variables), "v2", path)
    return path


def test_unsupported_graphs_rejected(tmp_path):
    path = _exported(tmp_path)
    nnet = P.read_nnet3_raw(path)
    pool = next(c for c in nnet.components.values() if c.type == "StatisticsPoolingComponent")
    pool.fields["NumLogCountFeatures"] = P._Scalar(struct.pack("<i", 1))
    p2 = str(tmp_path / "logcount.raw")
    P.write_nnet3_raw(nnet, p2)
    _both_raise(p2, "log-count", "import_kaldi_raw")

    nnet = P.read_nnet3_raw(path)
    nnet.components["tdnn4.affine"].fields["LinearParams"] = np.zeros((16, 99), np.float32)
    p3 = str(tmp_path / "bad.raw")
    P.write_nnet3_raw(nnet, p3)
    _both_raise(p3, None, "import_kaldi_raw")


def test_unfilled_parameter_is_loud(tmp_path, monkeypatch):
    """A parameter the layer maps do not cover raises instead of keeping
    its initial value (the reference's NaN template)."""
    path = _exported(tmp_path)
    maps = P._arch_maps
    monkeypatch.setattr(P, "_arch_maps", lambda arch, nnet=None: maps(arch, nnet)[1:])
    with pytest.raises(P.Nnet3ParseError, match="unfilled.*tdnn1"):
        P.import_kaldi_raw(path, device="cpu")


def test_import_needs_a_gpu_unless_told(tmp_path, monkeypatch):
    path = _exported(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        P.import_kaldi_raw(path)


def test_truncation_fuzz_matches(tmp_path):
    data = open(_exported(tmp_path), "rb").read()
    rng = np.random.default_rng(11)
    cuts = sorted(set(list(range(0, 200, 17)) + [len(data) - 2]
                      + list(rng.integers(0, len(data) - 1, size=40))))
    p2 = str(tmp_path / "cut.raw")
    for cut in cuts:
        with open(p2, "wb") as f:
            f.write(data[:cut])
        _both_raise(p2)


def _parsed(mod, path):
    """A parse's full content, or the error class's name."""
    try:
        nnet = mod.read_nnet3_raw(path)
    except mod.Nnet3ParseError as e:
        return "negative length" if str(e).startswith("negative length") else "Nnet3ParseError"
    except MemoryError:
        return "MemoryError"

    def value(v):
        if isinstance(v, np.ndarray):
            return (v.dtype.str, v.shape, v.tobytes())
        return getattr(v, "raw", v)

    return (nnet.config_lines, nnet.component_order,
            {n: (c.type, {k: value(v) for k, v in c.fields.items()})
             for n, c in nnet.components.items()})


def test_byte_corruption_fuzz_matches(tmp_path):
    data = bytearray(open(_exported(tmp_path), "rb").read())
    rng = np.random.default_rng(12)
    p2 = str(tmp_path / "corrupt.raw")
    negative = 0
    for _ in range(60):
        pos = int(rng.integers(2, len(data)))
        old = data[pos]
        data[pos] = int(rng.integers(0, 256))
        with open(p2, "wb") as f:
            f.write(bytes(data))
        got = _parsed(P, p2)
        if got == "negative length":
            negative += 1  # the reference's reader would crawl backwards here
        else:
            assert got == _parsed(R, p2), pos
        data[pos] = old
    assert negative < 5


def test_negative_size_field_raises(tmp_path):
    """A matrix whose row count reads negative raises at once."""
    path = _exported(tmp_path)
    data = open(path, "rb").read()
    at = data.index(b"FM ") + 3  # the first matrix's row count: size byte + int32
    bad = data[:at + 1] + struct.pack("<i", -(2 ** 28)) + data[at + 5:]
    p2 = tmp_path / "neg.raw"
    p2.write_bytes(bad)
    with pytest.raises(P.Nnet3ParseError, match="negative length"):
        P.read_nnet3_raw(str(p2))
