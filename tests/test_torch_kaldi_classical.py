"""The port's classical Kaldi files against the JAX package's: final.dubm,
final.ubm and final.ie written byte for byte as the reference writes them
(the i-vector extractor in both its exact and its mean-column export),
each package reading the other's files, and the golden fixtures
(tests/fixtures/kaldi_wire) read to the reference's arrays: the readers
compute in float64 on the host in both packages, so the arrays are
compared exactly."""

import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepi_tpu.classical.gmm import DiagGmm as RefDiag
from sepi_tpu.classical.gmm import FullGmm as RefFull
from sepi_tpu.classical.ivector import IvectorExtractor as RefExt
from sepi_tpu.utils import kaldi_models as ref_km
from sepi_tpu_torch.classical.gmm import DiagGmm, FullGmm
from sepi_tpu_torch.classical.ivector import IvectorExtractor
from sepi_tpu_torch.utils import kaldi_models

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "kaldi_wire")
GOLDEN = {"final.dubm": ("read_diag_ubm", ("weights", "means", "vars")),
          "final.ubm": ("read_full_ubm", ("weights", "means", "covars")),
          "final.ie": ("read_ivector_extractor", ("t", "whitener", "means"))}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _models(seed=0, k=5, d=4, m=3):
    rng = np.random.default_rng(seed)
    w = rng.dirichlet(np.ones(k)).astype(np.float32)
    mu = rng.normal(size=(k, d)).astype(np.float32)
    v = rng.uniform(0.5, 2.0, size=(k, d)).astype(np.float32)
    a = rng.normal(size=(k, d, d)) * 0.4
    cov = (a @ a.transpose(0, 2, 1) + np.eye(d)).astype(np.float32)
    chol = np.linalg.cholesky(cov.astype(np.float64))
    whit = np.stack([np.linalg.inv(c) for c in chol]).astype(np.float32)
    t = rng.normal(size=(k, d, m)).astype(np.float32)
    return dict(diag=(w, mu, v), full=(w, mu, cov), ext=(t, whit, mu))


def _pair(kind, arrays):
    ref_cls = {"diag": RefDiag, "full": RefFull, "ext": RefExt}[kind]
    cls = {"diag": DiagGmm, "full": FullGmm, "ext": IvectorExtractor}[kind]
    return ref_cls(*(jnp.asarray(a) for a in arrays)), cls(*(torch.tensor(a) for a in arrays))


@pytest.mark.parametrize("kind,writer,reader", [
    ("diag", "write_diag_ubm", "read_diag_ubm"),
    ("full", "write_full_ubm", "read_full_ubm"),
])
def test_ubm_files_equal_the_reference(tmp_path, kind, writer, reader):
    ref_model, model = _pair(kind, _models()[kind])
    p, r = str(tmp_path / "port"), str(tmp_path / "ref")
    getattr(kaldi_models, writer)(p, model)
    getattr(ref_km, writer)(r, ref_model)
    assert _read(p) == _read(r)
    assert kaldi_models.sniff_kaldi_object(p) == ref_km.sniff_kaldi_object(r)
    back = getattr(kaldi_models, reader)(r, device="cpu")
    ref_back = getattr(ref_km, reader)(p)
    for f in ("weights", "means", "vars" if kind == "diag" else "covars"):
        np.testing.assert_array_equal(getattr(back, f).numpy(), np.asarray(getattr(ref_back, f)))


@pytest.mark.parametrize("colinear", [True, False])
def test_ivector_extractor_file_equals_the_reference(tmp_path, colinear):
    """The exact export (means colinear with T's first raw column, as for
    an imported model) and the mean-column export (a natively trained
    model), each byte for byte, with the same metadata."""
    t, whit, mu = _models()["ext"]
    if colinear:
        t_raw0 = np.stack([np.linalg.solve(whit[i].astype(np.float64), t[i, :, 0])
                           for i in range(t.shape[0])])
        mu = (37.5 * t_raw0).astype(np.float32)
    ref_model, model = _pair("ext", (t, whit, mu))
    p, r = str(tmp_path / "port.ie"), str(tmp_path / "ref.ie")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        meta = kaldi_models.write_ivector_extractor(p, model)
        ref_meta = ref_km.write_ivector_extractor(r, ref_model)
    assert _read(p) == _read(r)
    assert meta.mean_column_added == ref_meta.mean_column_added == (not colinear)
    assert meta.prior_offset == ref_meta.prior_offset
    back, bmeta = kaldi_models.read_ivector_extractor(r, device="cpu")
    ref_back, _ = ref_km.read_ivector_extractor(p)
    for f in ("t", "whitener", "means"):
        np.testing.assert_array_equal(getattr(back, f).numpy(), np.asarray(getattr(ref_back, f)))
    assert bmeta.prior_offset == meta.prior_offset


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_goldens_read_to_the_reference_arrays(name):
    reader, fields = GOLDEN[name]
    path = os.path.join(FIXTURES, name)
    got = getattr(kaldi_models, reader)(path, device="cpu")
    ref = getattr(ref_km, reader)(path)
    if name == "final.ie":
        (got, meta), (ref, ref_meta) = got, ref
        assert meta.prior_offset == ref_meta.prior_offset
        np.testing.assert_array_equal(meta.w_vec, ref_meta.w_vec)
    for f in fields:
        a = getattr(got, f)
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(ref, f)))
    assert kaldi_models.sniff_kaldi_object(path) == ref_km.sniff_kaldi_object(path)


def test_golden_values_and_rewrite(tmp_path):
    """The goldens against their known parameters (expected.npz), and a
    read-then-write of each reproduces the reference's rewrite."""
    exp = np.load(os.path.join(FIXTURES, "expected.npz"))
    dubm = kaldi_models.read_diag_ubm(os.path.join(FIXTURES, "final.dubm"), device="cpu")
    np.testing.assert_allclose(dubm.vars.numpy(), exp["dubm_vars"], rtol=1e-6)
    ubm = kaldi_models.read_full_ubm(os.path.join(FIXTURES, "final.ubm"), device="cpu")
    np.testing.assert_allclose(ubm.covars.numpy(), exp["ubm_covars"], rtol=1e-5, atol=1e-6)
    for name, writer in (("final.dubm", "write_diag_ubm"), ("final.ubm", "write_full_ubm")):
        model = getattr(kaldi_models, GOLDEN[name][0])(os.path.join(FIXTURES, name), device="cpu")
        ref_model = getattr(ref_km, GOLDEN[name][0])(os.path.join(FIXTURES, name))
        getattr(kaldi_models, writer)(str(tmp_path / "p"), model)
        getattr(ref_km, writer)(str(tmp_path / "r"), ref_model)
        assert _read(str(tmp_path / "p")) == _read(str(tmp_path / "r"))
    ext, meta = kaldi_models.read_ivector_extractor(os.path.join(FIXTURES, "final.ie"),
                                                    device="cpu")
    ref_ext, ref_meta = ref_km.read_ivector_extractor(os.path.join(FIXTURES, "final.ie"))
    kaldi_models.write_ivector_extractor(str(tmp_path / "p.ie"), ext, meta)
    ref_km.write_ivector_extractor(str(tmp_path / "r.ie"), ref_ext, ref_meta)
    assert _read(str(tmp_path / "p.ie")) == _read(str(tmp_path / "r.ie"))


def test_readers_refuse_the_wrong_object():
    with pytest.raises(kaldi_models.KaldiModelError, match="expected <FullGMM>"):
        kaldi_models.read_full_ubm(os.path.join(FIXTURES, "final.dubm"), device="cpu")
