"""A mesh over part of the world: three gloo ranks on the CPU, and
`make_mesh(devices=[1, 2])` or `devices=[0, 2]`.

The mesh's ranks run `create_train_state` (each seeded differently but
the mesh's first), 3 momentum-SGD data-parallel steps of a narrow x-vector
on global batches, and an `ArtifactCache` stage, and are held against a
2-rank world running the same: the same parameters (bit for bit: the
same two shards, reduced over a group of two), the same objf, and one
writer, the mesh's first rank.  The rank left out is handed the mesh and
must raise, naming itself, from every helper instead of waiting in a
collective; every rank must finish within `RANK_TIMEOUT_S`.
"""

import numpy as np
import pytest
import torch

from sepi_tpu_torch.models import TdnnSpec, XVectorConfig
from torch_dist import run_ranks

torch.set_num_threads(2)

XCFG = XVectorConfig(feat_dim=8, num_speakers=4, embed_dim=16,
                     frame_specs=(TdnnSpec(16, (-2, -1, 0, 1, 2)), TdnnSpec(32, (0,))))
SUBSETS = {"1-2": [1, 2], "0-2": [0, 2]}


def _inputs(devices, workdir):
    rng = np.random.default_rng(17)
    batches = [(rng.normal(size=(8, 20, 8)).astype(np.float32),
                (np.arange(8) % 4).astype(np.int64)) for _ in range(3)]
    return {"xcfg": XCFG, "batches": batches, "devices": devices,
            "artifacts": str(workdir / "artifacts")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    wd = tmp_path_factory.mktemp("world")
    out["world"] = run_ranks(2, "subset", wd, _inputs(None, wd))
    for name, devices in SUBSETS.items():
        wd = tmp_path_factory.mktemp(f"subset{name}")
        out[name] = run_ranks(3, "subset", wd, _inputs(devices, wd))
    return out


def test_world_run_is_the_reference(runs):
    a, b = runs["world"]
    assert a["member"] and b["member"] and a["primary"] and not b["primary"]
    assert a["wrote"] and not b["wrote"]
    assert np.isfinite(a["objf"]).all() and a["objf"] == b["objf"]


@pytest.mark.parametrize("name", sorted(SUBSETS))
def test_subset_mesh_trains_like_the_world(runs, name):
    world = runs["world"][0]
    members = [r for r in runs[name] if r["member"]]
    assert len(members) == 2
    for r in members:
        assert r["objf"] == world["objf"]
        for k, v in world["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)


@pytest.mark.parametrize("name", sorted(SUBSETS))
def test_subset_mesh_has_one_writer(runs, name):
    """The mesh's first rank alone runs and writes the stage; every member
    reads back what it wrote."""
    first = SUBSETS[name][0]
    writers = [rank for rank, r in enumerate(runs[name]) if r.get("wrote")]
    primaries = [rank for rank, r in enumerate(runs[name]) if r.get("primary")]
    assert writers == [first] and primaries == [first]
    for rank in SUBSETS[name]:
        saved = runs[name][rank]["saved"]
        for k, v in runs[name][first]["state"].items():
            np.testing.assert_array_equal(saved[k], v, err_msg=k)


@pytest.mark.parametrize("name", sorted(SUBSETS))
def test_rank_outside_the_mesh_raises(runs, name):
    (outside,) = [rank for rank in range(3) if rank not in SUBSETS[name]]
    r = runs[name][outside]
    assert not r["member"]
    for helper, msg in r["raised"].items():
        assert msg is not None and f"rank {outside} is outside the mesh" in msg, (helper, msg)
