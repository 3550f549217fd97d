"""`sepi_tpu_torch.utils.nnet2_io` (the Kaldi nnet2 `final.mdl` importer
of the DNN/i-vector AM) against `sepi_tpu.utils.nnet2_io`.

The hand-written byte streams of tests/test_nnet2_import.py (copied
builders) and the repo's fixture `tests/fixtures/kaldi_wire/final_nnet2.mdl`
go through both importers.  Held: the same config and priors, the port's
`state_dict` equal to the bridged reference variables (exact: the
`FixedAffineComponent` fold runs in float64 in both), posteriors of
`nnet2_posteriors` within 1e-5 of the reference's and of an independent
float64 numpy forward within its test's 2e-3/2e-4, and the reference's
rejection and truncation cases raising the same error class.
"""

import dataclasses
import os
import struct
import types

import jax
import numpy as np
import pytest
import torch

from sepi_tpu.recipes.nnet2_recipe import nnet2_posteriors as ref_posteriors
from sepi_tpu.utils import nnet2_io as R
from sepi_tpu_torch.bridge import nnet2_state_dict_from_flax
from sepi_tpu_torch.recipes.nnet2_recipe import nnet2_posteriors
from sepi_tpu_torch.utils import nnet2_io as P

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "kaldi_wire", "final_nnet2.mdl")
POST_TOL = 1e-5


def _tok(t):
    return t.encode() + b" "


def _i32(v):
    return b"\x04" + struct.pack("<i", v)


def _f32(v):
    return b"\x04" + struct.pack("<f", v)


def _f64(v):
    return b"\x08" + struct.pack("<d", v)


def _fv(x):
    x = np.asarray(x, np.float32)
    return _tok("FV") + _i32(x.shape[0]) + x.tobytes()


def _dv(x):
    x = np.asarray(x, np.float64)
    return _tok("DV") + _i32(x.shape[0]) + x.tobytes()


def _fm(x):
    x = np.asarray(x, np.float32)
    return _tok("FM") + _i32(x.shape[0]) + _i32(x.shape[1]) + x.tobytes()


def _ivec(v):
    # Kaldi WriteIntegerVector framing (io-funcs-inl.h): elem-size char,
    # then the count as a RAW little-endian int32 (no size-prefix byte).
    v = np.asarray(v, np.int32)
    return b"\x04" + struct.pack("<i", v.shape[0]) + v.tobytes()


def _splice(in_dim, context):
    return (_tok("<SpliceComponent>") + _tok("<InputDim>") + _i32(in_dim)
            + _tok("<Context>") + _ivec(context)
            + _tok("<ConstComponentDim>") + _i32(0)
            + _tok("</SpliceComponent>"))


def _fixed_affine(w, b):
    return (_tok("<FixedAffineComponent>") + _tok("<LinearParams>") + _fm(w)
            + _tok("<BiasParams>") + _fv(b) + _tok("</FixedAffineComponent>"))


def _affine(w, b):
    t = "AffineComponentPreconditionedOnline"
    return (_tok(f"<{t}>") + _tok("<LearningRate>") + _f32(0.0015)
            + _tok("<LinearParams>") + _fm(w) + _tok("<BiasParams>") + _fv(b)
            + _tok("<RankIn>") + _i32(20) + _tok("<RankOut>") + _i32(80)
            + _tok("<UpdatePeriod>") + _i32(4)
            + _tok("<NumSamplesHistory>") + _f32(2000.0)
            + _tok("<Alpha>") + _f32(4.0)
            + _tok("<MaxChangePerSample>") + _f32(0.075)
            + _tok(f"</{t}>"))


def _pnorm(in_dim, out_dim, p=2.0):
    return (_tok("<PnormComponent>") + _tok("<InputDim>") + _i32(in_dim)
            + _tok("<OutputDim>") + _i32(out_dim) + _tok("<P>") + _f64(p)
            + _tok("</PnormComponent>"))


def _nonlin(name, dim):
    return (_tok(f"<{name}>") + _tok("<Dim>") + _i32(dim)
            + _tok("<ValueSum>") + _dv(np.zeros(dim))
            + _tok("<DerivSum>") + _dv(np.zeros(dim))
            + _tok("<Count>") + _f64(0.0) + _tok(f"</{name}>"))


def _build_mdl(tmp_path, rng, feat=6, lda_out=12, pnorm_out=4, group=3,
               senones=9, with_tm=True):
    """Two pnorm layers: splice(-2..2)+LDA+affine, splice(-1,2)+affine."""
    hid = pnorm_out * group
    w_lda = rng.normal(size=(lda_out, 5 * feat)) * 0.3
    b_lda = rng.normal(size=lda_out) * 0.1
    w0 = rng.normal(size=(hid, lda_out)) * 0.3
    b0 = rng.normal(size=hid) * 0.1
    w1 = rng.normal(size=(hid, 2 * pnorm_out)) * 0.3
    b1 = rng.normal(size=hid) * 0.1
    w_out = rng.normal(size=(senones, pnorm_out)) * 0.3
    b_out = rng.normal(size=senones) * 0.1
    priors = rng.dirichlet(np.ones(senones))

    body = b""
    if with_tm:
        body += (_tok("<TransitionModel>") + _tok("<Junk>") + _i32(7)
                 + b"\x01\x02\x03 " + _tok("</TransitionModel>"))
    body += _tok("<Nnet>") + _tok("<NumComponents>") + _i32(9)
    body += _tok("<Components>")
    body += _splice(feat, [-2, -1, 0, 1, 2])
    body += _fixed_affine(w_lda, b_lda)
    body += _affine(w0, b0)
    body += _pnorm(hid, pnorm_out)
    body += _nonlin("NormalizeComponent", pnorm_out)
    body += _splice(pnorm_out, [-1, 2])
    body += _affine(w1, b1)
    body += _pnorm(hid, pnorm_out)
    body += _nonlin("NormalizeComponent", pnorm_out)
    # output affine + softmax are also components; fix the count
    body += _affine(w_out, b_out)
    body += _nonlin("SoftmaxComponent", senones)
    body = body.replace(_tok("<NumComponents>") + _i32(9),
                        _tok("<NumComponents>") + _i32(11), 1)
    body += _tok("</Components>") + _tok("</Nnet>") + _fv(priors)
    p = tmp_path / "final.mdl"
    p.write_bytes(b"\x00B" + body)
    weights = dict(w_lda=w_lda, b_lda=b_lda, w0=w0, b0=b0, w1=w1, b1=b1,
                   w_out=w_out, b_out=b_out, priors=priors)
    return p, weights


def _ref_forward(feats, wt, pnorm_out=4):
    """Independent numpy nnet2 semantics: splice/affine/pnorm/normalize."""

    def splice(x, ctx):
        lo, hi = -min(ctx), max(ctx)
        t = x.shape[0] - lo - hi
        return np.concatenate([x[lo + c : lo + c + t] for c in ctx], axis=1)

    def pnorm_norm(x):
        g = x.reshape(x.shape[0], pnorm_out, -1)
        y = np.sqrt(np.sum(g * g, axis=-1))
        rms = np.sqrt(np.mean(y * y, axis=-1, keepdims=True))
        return y / np.maximum(rms, 1e-20)

    x = splice(feats, [-2, -1, 0, 1, 2])
    x = x @ wt["w_lda"].T + wt["b_lda"]
    x = pnorm_norm(x @ wt["w0"].T + wt["b0"])
    x = splice(x, [-1, 2])
    x = pnorm_norm(x @ wt["w1"].T + wt["b1"])
    logits = x @ wt["w_out"].T + wt["b_out"]
    e = np.exp(logits - logits.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def assert_imports_equal(path, feats):
    jmodel, jvars, jcfg, jpriors = R.import_kaldi_nnet2(path)
    model, state, cfg, priors = P.import_kaldi_nnet2(path, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (priors is None) == (jpriors is None)
    if priors is not None:
        np.testing.assert_array_equal(priors, jpriors)
    want = nnet2_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jvars))
    assert set(state) == set(want)
    for k in want:
        assert torch.equal(state[k], want[k]), k
    assert not model.training
    got = nnet2_posteriors(model, None, feats, device="cpu")
    ref = ref_posteriors(jmodel, types.SimpleNamespace(params=jvars["params"], batch_stats=None),
                         feats)
    for u in feats:
        assert got[u].shape == ref[u].shape == (feats[u].shape[0], cfg.num_senones)
        assert np.abs(got[u] - ref[u]).max() <= POST_TOL, u
    return model, got


def test_fixture_import_matches():
    rng = np.random.default_rng(0)
    feats = {f"u{i}": rng.normal(size=(12 + 7 * i, 6)).astype(np.float32) for i in range(4)}
    assert_imports_equal(FIXTURE, feats)


@pytest.mark.parametrize("with_tm", [True, False])
def test_built_model_matches_and_forwards(tmp_path, with_tm):
    rng = np.random.default_rng(1)
    p, wt = _build_mdl(tmp_path, rng, with_tm=with_tm)
    feats = {f"u{i}": rng.normal(size=(15 + i, 6)).astype(np.float32) for i in range(3)}
    model, post = assert_imports_equal(str(p), feats)
    assert model.cfg.context == (3, 4) and model.cfg.group_size == 3
    # the model's own forward against the independent float64 semantics
    x = rng.normal(size=(20, 6)).astype(np.float32)
    with torch.no_grad():
        logits = model(torch.from_numpy(x[None]))["logits"][0].double().numpy()
    got = np.exp(logits - logits.max(axis=-1, keepdims=True))
    got /= got.sum(axis=-1, keepdims=True)
    want = _ref_forward(x.astype(np.float64), wt)
    assert got.shape == want.shape == (13, 9)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def _both_raise(path, match):
    with pytest.raises(R.Nnet2ParseError, match=match):
        R.import_kaldi_nnet2(path)
    with pytest.raises(P.Nnet2ParseError, match=match):
        P.import_kaldi_nnet2(path, device="cpu")


def test_rejections_match(tmp_path):
    p = tmp_path / "x.raw"
    p.write_bytes(b"\x00B" + _tok("<Nnet3>"))
    _both_raise(str(p), "nnet3")
    p2 = tmp_path / "t.mdl"
    p2.write_bytes(b"<Nnet> text")
    _both_raise(str(p2), "binary magic")

    rng = np.random.default_rng(3)
    p, _ = _build_mdl(tmp_path, rng)
    p3 = tmp_path / "p3.mdl"
    p3.write_bytes(p.read_bytes().replace(_f64(2.0), _f64(3.0)))
    _both_raise(str(p3), "P=3")

    data = p.read_bytes()
    extra = _fixed_affine(rng.normal(size=(9, 9)), rng.normal(size=9))
    softmax_at = data.rfind(_tok("<SoftmaxComponent>"))
    patched = (data[:softmax_at] + extra + data[softmax_at:]).replace(
        _tok("<NumComponents>") + _i32(11), _tok("<NumComponents>") + _i32(12), 1)
    p4 = tmp_path / "trail.mdl"
    p4.write_bytes(patched)
    _both_raise(str(p4), "trailing FixedAffine")


def _outcome(fn, path):
    try:
        model, state, cfg, priors = fn(path)
    except ValueError as e:  # both parse errors derive from ValueError
        return type(e).__name__
    return cfg.num_senones, None if priors is None else priors.tobytes()


def test_truncation_outcomes_match(tmp_path):
    rng = np.random.default_rng(5)
    p, _ = _build_mdl(tmp_path, rng)
    data = p.read_bytes()
    cuts = sorted({1, 2, 3, 7} | set(int(x) for x in np.linspace(4, len(data) - 2, 50)))
    trunc = str(tmp_path / "trunc.mdl")
    for cut in cuts:
        with open(trunc, "wb") as f:
            f.write(data[:cut])
        assert _outcome(lambda q: P.import_kaldi_nnet2(q, device="cpu"), trunc) == _outcome(
            R.import_kaldi_nnet2, trunc), cut


def test_import_needs_a_gpu_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        P.import_kaldi_nnet2(FIXTURE)
