"""The port's stage cache and feature store against the JAX package's:
`config_key` strings, run-then-load stages, cache hits of feature-store
stages, and stores that each package writes and the other opens, header
bytes included."""

import os

import numpy as np
import pytest
import torch

from sepi_tpu import config as ref_config
from sepi_tpu.data.featstore import FeatStore as RefFeatStore
from sepi_tpu.utils import artifacts as ref_artifacts
from sepi_tpu_torch import config
from sepi_tpu_torch.data.featstore import FeatStore
from sepi_tpu_torch.utils import artifacts

torch.set_num_threads(2)


def _feats(seed=0, n=5, d=23):
    rng = np.random.default_rng(seed)
    return {f"u{i}": rng.standard_normal((20 + 7 * i, d)).astype(np.float32)
            for i in range(n)}


@pytest.mark.parametrize("objs", [
    [{"b": [1, 2.5, "x"], "a": {"z": (3, 4), "y": None}}],
    [("t", (1, (2, 3))), {"k": np.arange(12, dtype=np.float32).reshape(3, 4)}],
    ["name", np.array([1, 2], np.int64), {"nested": {"arr": np.ones((2, 2))}}],
])
def test_config_key_equals_the_reference(objs):
    assert artifacts.config_key(objs) == ref_artifacts.config_key(objs)
    assert artifacts.config_key(*objs) == ref_artifacts.config_key(*objs)


@pytest.mark.parametrize("name", ["AlignConfig", "TrainConfig", "FrontendConfig"])
def test_config_key_of_configs_equals_the_reference(name):
    assert (artifacts.config_key(getattr(config, name)())
            == ref_artifacts.config_key(getattr(ref_config, name)()))


def test_stage_runs_then_loads(tmp_path):
    cache = artifacts.ArtifactCache(str(tmp_path))
    calls, lines = [], []
    arrays = {"feats": _feats(1, 3), "ali": {"u0": np.arange(4, dtype=np.int32)}}

    def fn():
        calls.append(1)
        return arrays

    out = cache.stage("s", [1, "k"], fn, log=lines.append)
    again = cache.stage("s", [1, "k"], fn, log=lines.append)
    assert len(calls) == 1 and "running" in lines[0] and "cached" in lines[1]
    for got in (out, again):
        np.testing.assert_array_equal(got["feats"]["u2"], arrays["feats"]["u2"])
        np.testing.assert_array_equal(got["ali"]["u0"], arrays["ali"]["u0"])
    # the reference's cache reads the port's artifact under the same key
    ref = ref_artifacts.ArtifactCache(str(tmp_path))
    key = ref_artifacts.config_key([1, "k"])
    assert ref.has("s", key)
    np.testing.assert_array_equal(ref.load("s", key)[0]["feats"]["u1"], arrays["feats"]["u1"])


def test_stage_store_hits_the_cache(tmp_path):
    cache = artifacts.ArtifactCache(str(tmp_path))
    feats, calls, lines = _feats(2), [], []

    def gen():
        calls.append(1)
        yield from feats.items()

    a = cache.stage_store("feats", ["x"], gen, log=lines.append)
    b = cache.stage_store("feats", ["x"], gen, log=lines.append)
    assert len(calls) == 1 and lines[1].startswith("[feats] cached")
    for store in (a, b):
        assert isinstance(store, FeatStore) and list(store) == list(feats)
        for u, f in feats.items():
            np.testing.assert_array_equal(store[u], f)
    row = b["u1"]
    assert not row.flags.writeable  # mmap rows are read-only views
    np.testing.assert_array_equal(torch.tensor(np.ascontiguousarray(row)).numpy(), feats["u1"])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_featstore_opens_in_the_other_package(tmp_path, writer):
    feats = _feats(3)
    prefix = str(tmp_path / "s")
    other = str(tmp_path / "o")
    if writer == "port":
        FeatStore.write(prefix, feats)
        RefFeatStore.write(other, feats)
        opened = RefFeatStore.open(prefix)
    else:
        RefFeatStore.write(prefix, feats)
        FeatStore.write(other, feats)
        opened = FeatStore.open(prefix)
    assert list(opened) == list(feats) and len(opened) == len(feats)
    for u, f in feats.items():
        np.testing.assert_array_equal(opened[u], f)
    for suffix in (".npy", ".json"):
        assert open(prefix + suffix, "rb").read() == open(other + suffix, "rb").read()


def test_featstore_stream_edge_cases(tmp_path):
    empty = FeatStore.write_stream(str(tmp_path / "e"), iter(()))
    assert len(empty) == 0
    with pytest.raises(ValueError, match="duplicate"):
        FeatStore.write_stream(str(tmp_path / "d"), [("a", np.zeros((2, 3))),
                                                     ("a", np.zeros((2, 3)))])
    assert not os.path.exists(str(tmp_path / "d.npy.tmp"))
    with pytest.raises(ValueError, match="dim"):
        FeatStore.write_stream(str(tmp_path / "w"), [("a", np.zeros((2, 3))),
                                                     ("b", np.zeros((2, 4)))])
