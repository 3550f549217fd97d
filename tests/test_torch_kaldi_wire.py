"""The port's Kaldi wire layer against the JAX package's: ark/scp tables
through each package's binding of native/kaldi_io.cc, and the backend's
PLDA, vector and matrix files, byte for byte; each package reads the
other's files, and the port's readers agree with the golden fixtures."""

import os

import numpy as np
import pytest
import torch

from sepi_tpu.backend.plda import Plda as RefPlda
from sepi_tpu.utils import kaldi_io as ref_io
from sepi_tpu.utils import kaldi_models as ref_km
from sepi_tpu.utils import nnet3 as ref_nnet3
from sepi_tpu_torch import build
from sepi_tpu_torch.backend.plda import Plda
from sepi_tpu_torch.utils import kaldi_io, kaldi_models
from sepi_tpu_torch.utils.nnet3 import Nnet3ParseError, _Reader, _Scalar, _Writer

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "kaldi_wire")


def _fx(name):
    return os.path.join(FIXTURES, name)


@pytest.fixture(scope="module")
def exp():
    return np.load(_fx("expected.npz"))


def _entries(rng):
    return [
        ("matrix", "put_matrix", "uttA", rng.standard_normal((7, 5)).astype(np.float32)),
        ("compressed", "put_compressed_matrix", "uttB",
         (100 * rng.standard_normal((9, 4))).astype(np.float32)),
        ("compressed2", "put_compressed_matrix2", "uttC",
         rng.standard_normal((6, 3)).astype(np.float32)),
        ("vector", "put_vector", "uttD", rng.standard_normal(11).astype(np.float32)),
        ("int_vector", "put_int_vector", "uttE", rng.integers(0, 500, 13).astype(np.int32)),
    ]


def _write(mod, d, entries):
    ark, scp = os.path.join(d, "t.ark"), os.path.join(d, "t.scp")
    with mod.ArkWriter(ark, scp) as w:
        for _, method, key, x in entries:
            getattr(w, method)(key, x)
    return ark, scp


def test_ark_writer_bytes_equal_the_reference(tmp_path):
    entries = _entries(np.random.default_rng(0))
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    ark_p, scp_p = _write(kaldi_io, str(tmp_path / "port"), entries)
    ark_r, scp_r = _write(ref_io, str(tmp_path / "ref"), entries)
    assert open(ark_p, "rb").read() == open(ark_r, "rb").read()
    offs_p = [(k, off) for k, (_, off) in kaldi_io.read_scp(scp_p)]
    offs_r = [(k, off) for k, (_, off) in ref_io.read_scp(scp_r)]
    assert offs_p == offs_r and [k for k, _ in offs_p] == [e[2] for e in entries]
    # the port builds its own library, never into the reference's build dir
    assert build.host_library_path("kaldi_io").exists()
    assert "native" not in str(build.host_library_path("kaldi_io").parent)


@pytest.mark.parametrize("kind", ["matrix", "compressed", "compressed2", "vector",
                                  "int_vector"])
def test_ark_entries_read_back_in_both_packages(tmp_path, kind):
    entries = _entries(np.random.default_rng(1))
    ark, scp = _write(kaldi_io, str(tmp_path), entries)
    table = dict(kaldi_io.read_scp(scp))
    _, _, key, x = next(e for e in entries if e[0] == kind)
    path, off = table[key]
    reader = {"vector": "read_vector", "int_vector": "read_int_vector"}.get(kind, "read_matrix")
    got = getattr(kaldi_io, reader)(path, off)
    ref = getattr(ref_io, reader)(path, off)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == ref.dtype
    if kind in ("matrix", "vector", "int_vector"):
        np.testing.assert_array_equal(got, x)
    else:  # lossy formats: within the quantization step of the range
        step = (x.max() - x.min()) / (255 if kind == "compressed" else 65535)
        assert np.abs(got - x).max() <= 2 * step


def _plda(rng, d=6):
    a = rng.standard_normal((d, d))
    return rng.standard_normal(d), a @ a.T + d * np.eye(d), np.abs(rng.standard_normal(d))


@pytest.mark.parametrize("what", ["plda", "vector", "vector_double", "matrix",
                                  "matrix_double"])
def test_model_files_bytes_equal_and_cross_read(tmp_path, what):
    rng = np.random.default_rng(2)
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    if what == "plda":
        mean, transform, psi = _plda(rng)
        kaldi_models.write_plda(port, Plda(mean, transform, psi))
        ref_km.write_plda(ref, RefPlda(mean, transform, psi))
    elif what.startswith("vector"):
        x = rng.standard_normal(9)
        kaldi_models.write_kaldi_vector_file(port, x, double=what.endswith("double"))
        ref_km.write_kaldi_vector_file(ref, x, double=what.endswith("double"))
    else:
        x = rng.standard_normal((4, 7))
        kaldi_models.write_kaldi_matrix_file(port, x, double=what.endswith("double"))
        ref_km.write_kaldi_matrix_file(ref, x, double=what.endswith("double"))
    assert open(port, "rb").read() == open(ref, "rb").read()
    if what == "plda":
        a, b = kaldi_models.read_plda(ref), ref_km.read_plda(port)
        for f in ("mean", "transform", "psi"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert isinstance(a, Plda)
    elif what.startswith("vector"):
        np.testing.assert_array_equal(kaldi_models.read_kaldi_vector_file(ref),
                                      ref_km.read_kaldi_vector_file(port))
    else:
        np.testing.assert_array_equal(kaldi_models.read_kaldi_matrix_file(ref),
                                      ref_km.read_kaldi_matrix_file(port))


def test_golden_backend_files(tmp_path, exp):
    p = kaldi_models.read_plda(_fx("plda"))
    np.testing.assert_allclose(p.mean, exp["plda_mean"])
    np.testing.assert_allclose(p.transform, exp["plda_transform"])
    np.testing.assert_allclose(p.psi, exp["plda_psi"])
    np.testing.assert_allclose(kaldi_models.read_kaldi_vector_file(_fx("mean.vec")),
                               exp["mean_vec"])
    np.testing.assert_allclose(kaldi_models.read_kaldi_matrix_file(_fx("transform.mat")),
                               exp["transform_mat"])
    # the writers reproduce the golden bytes
    kaldi_models.write_plda(str(tmp_path / "p"),
                            Plda(exp["plda_mean"], exp["plda_transform"], exp["plda_psi"]))
    kaldi_models.write_kaldi_vector_file(str(tmp_path / "v"), exp["mean_vec"], double=True)
    kaldi_models.write_kaldi_matrix_file(str(tmp_path / "m"), exp["transform_mat"],
                                         double=True)
    for ours, golden in (("p", "plda"), ("v", "mean.vec"), ("m", "transform.mat")):
        assert open(tmp_path / ours, "rb").read() == open(_fx(golden), "rb").read()
    with pytest.raises(kaldi_models.KaldiModelError):
        kaldi_models.read_plda(_fx("mean.vec"))


def test_golden_tables(exp):
    feats = {k: off for k, (_, off) in kaldi_io.read_scp(_fx("feats.scp"))}
    ark = _fx("feats.ark")
    np.testing.assert_allclose(kaldi_io.read_matrix(ark, feats["utt_fm"]), exp["feats_utt_fm"])
    np.testing.assert_allclose(kaldi_io.read_matrix(ark, feats["utt_dm"]), exp["feats_utt_dm"],
                               rtol=1e-6)
    np.testing.assert_allclose(kaldi_io.read_matrix(ark, feats["utt_cm"]), exp["feats_utt_cm"],
                               rtol=1e-5, atol=1e-5)
    ali = {k: off for k, (_, off) in kaldi_io.read_scp(_fx("ali.scp"))}
    for utt in ("utt_a", "utt_b"):
        np.testing.assert_array_equal(kaldi_io.read_int_vector(_fx("ali.ark"), ali[utt]),
                                      exp[f"ali_{utt}"])


def test_stream_primitives_round_trip():
    fields = [("Dim", 7, "int"), ("Scale", 0.25, "float"), ("Eps", 1e-9, "double"),
              ("Flag", True, "bool"), ("V", np.arange(3, dtype=np.float32), "vector"),
              ("M", np.ones((2, 2)), "matrix")]
    w, ref_w = _Writer(), ref_nnet3._Writer()
    for f in fields:
        w.field(*f)
        ref_w.field(*f)
    assert w.getvalue() == ref_w.getvalue()
    eps = ref_nnet3._Reader(w.getvalue())
    for tok in ("<Dim>", "<Scale>", "<Eps>"):
        eps.expect_token(tok)
        value = eps.sniff_value()
    r = _Reader(w.getvalue())
    r.expect_token("<Dim>")
    assert r.read_int32() == 7
    r.expect_token("<Scale>")
    assert r.read_float() == 0.25
    r.expect_token("<Eps>")
    got = r.sniff_value()
    assert isinstance(got, _Scalar) and got.as_float == value.as_float == 1e-9
    r.expect_token("<Flag>")
    assert r.sniff_value() is True
    r.expect_token("<V>")
    np.testing.assert_array_equal(r.sniff_value(), np.arange(3))
    r.expect_token("<M>")
    np.testing.assert_array_equal(r.read_matrix(), np.ones((2, 2)))
    with pytest.raises(Nnet3ParseError):
        r.read_token()
