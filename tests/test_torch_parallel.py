"""The port's mesh and multi-process runtime (`sepi_tpu_torch.parallel`)
on the CPU, against `sepi_tpu.parallel` where the reference defines the
answer.

- make_mesh at world size 1: shape (1, 1), dim names (data, model); the
  placements of the reference's P(), P("data"), P(None, "data");
- local_batch_slice, host_shard_dataset (equal to the reference's with
  explicit host_index / host_count), assemble_global_batch;
- initialize: an explicit 2-process request that cannot reach its
  coordinator raises within seconds; nccl on the CPU is refused, and
  launch never puts two NCCL ranks on one card;
- a batch the data axis does not divide raises in the step, the
  extractor and local_batch_slice on 2 ranks (the counterpart of
  tests/test_train.py::test_mesh_extraction_rejects_indivisible_batch);
- dryrun_multichip on 2 gloo ranks.
"""

import dataclasses
import datetime
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sepi_tpu.config import MeshConfig as JMeshConfig
from sepi_tpu.data.manifest import Dataset as JDataset
from sepi_tpu.data.manifest import Utterance as JUtterance
from sepi_tpu.parallel.mesh import host_shard_dataset as jhost_shard
from sepi_tpu_torch.config import MeshConfig, TrainConfig
from sepi_tpu_torch.data.manifest import Dataset, Utterance
from sepi_tpu_torch.models import TdnnSpec, XVector, XVectorConfig
from sepi_tpu_torch.parallel import (assemble_global_batch, batch_sharded, host_shard_dataset,
                                     initialize, is_primary, local_batch_slice, make_mesh,
                                     replicated, superbatch_sharded)
from sepi_tpu_torch.parallel.dryrun import dryrun_multichip, launch
from sepi_tpu_torch.parallel.mesh import local_shard
from sepi_tpu_torch.recipes.pipeline import training_device
from torch_dist import cpu_world_mesh, free_port, run_ranks

torch.set_num_threads(2)


def test_mesh_config_matches_the_reference():
    assert dataclasses.asdict(MeshConfig()) == dataclasses.asdict(JMeshConfig())


def test_make_mesh_at_world_size_one():
    with pytest.raises(RuntimeError, match="initialise"):
        make_mesh()
    with cpu_world_mesh() as mesh:
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
        assert mesh.device_type == "cpu"
        assert dist.get_backend() == "gloo" and is_primary()
        with pytest.raises(ValueError, match="divisible"):
            make_mesh(model_parallel_size=2)
    assert not dist.is_initialized()


def test_placements_match_the_reference_specs():
    from torch.distributed.tensor import Replicate, Shard

    with cpu_world_mesh() as mesh:
        assert replicated(mesh) == (Replicate(), Replicate())  # P()
        assert batch_sharded(mesh) == (Shard(0), Replicate())  # P("data")
        assert superbatch_sharded(mesh) == (Shard(1), Replicate())  # P(None, "data")


def test_local_batch_slice_and_global_batch():
    assert local_batch_slice(8) == slice(0, 8)
    with cpu_world_mesh() as mesh:
        assert local_batch_slice(8, mesh) == slice(0, 8)
        x = torch.arange(12.0).reshape(6, 2)
        g = assemble_global_batch(x, mesh)
        assert tuple(g.shape) == (6, 2)
        assert torch.equal(local_shard(g, mesh), x)
        assert torch.equal(local_shard(x, mesh), x)
        pair = assemble_global_batch((x.numpy(), {"y": x}), mesh)
        assert torch.equal(pair[1]["y"].to_local(), x)


def test_host_shard_dataset_matches_the_reference():
    utts = [(f"u{i:02d}", f"s{i % 3}") for i in range(11)]
    ds = Dataset([Utterance(u, s) for u, s in utts])
    jds = JDataset([JUtterance(u, s) for u, s in utts])
    for count in (1, 2, 3, 4):
        shards = [host_shard_dataset(ds, host_index=i, host_count=count).utt_ids
                  for i in range(count)]
        assert shards == [jhost_shard(jds, host_index=i, host_count=count).utt_ids
                          for i in range(count)]
        assert sorted(u for s in shards for u in s) == [u for u, _ in utts]
    assert host_shard_dataset(ds).utt_ids == ds.utt_ids  # no world: all of it


def test_initialize_refuses_an_unreachable_coordinator():
    """An explicit 2-process request whose coordinator never answers raises
    (never a disconnected 1-process run), within the timeout it was given."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="refusing to run unconnected"):
        initialize(f"127.0.0.1:{free_port()}", 2, 1, device="cpu",
                   timeout=datetime.timedelta(seconds=3))
    assert time.monotonic() - t0 < 30
    assert not dist.is_initialized()


def test_backend_is_never_switched():
    with pytest.raises(ValueError, match="nccl"):
        initialize(device="cpu", backend="nccl")
    assert not dist.is_initialized()
    # two ranks on fewer cards than ranks: NCCL would refuse; launch says so
    # instead of choosing gloo
    with pytest.raises(ValueError, match="gloo"):
        launch(2, dryrun_multichip, (2, "cuda"), device="cuda")


def test_training_device_follows_the_mesh():
    with cpu_world_mesh() as mesh:
        assert training_device(TrainConfig(), mesh, "cpu") == torch.device("cpu")
        with pytest.raises(ValueError, match="mesh"):
            training_device(TrainConfig(), mesh, "cuda")


XCFG = XVectorConfig(feat_dim=8, num_speakers=4, embed_dim=16,
                     frame_specs=(TdnnSpec(16, (-2, -1, 0, 1, 2)), TdnnSpec(32, (0,))))


@pytest.fixture(scope="module")
def indivisible(tmp_path_factory):
    rng = np.random.default_rng(0)
    init = {k: v.numpy() for k, v in XVector(XCFG).state_dict().items()}
    return run_ranks(2, "indivisible", tmp_path_factory.mktemp("indivisible"), {
        "xcfg": XCFG, "xinit": init,
        "feats": rng.normal(size=(8, 20, 8)).astype(np.float32),
        "labels": (np.arange(8) % 4).astype(np.int64)})


@pytest.mark.parametrize("where", ["step", "extract", "slice"])
def test_indivisible_batch_raises(indivisible, where):
    for r in indivisible:
        assert r[where] is not None and "divisible" in r[where], r


def test_dryrun_multichip_on_two_cpu_ranks():
    launch(2, dryrun_multichip, (2, "cpu"), device="cpu", timeout_s=180)
