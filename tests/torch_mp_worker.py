"""One rank of the port's multi-process tests (no JAX in this process).

    python torch_mp_worker.py RANK NPROC PORT WORKDIR MODE

Joins a gloo world on the CPU, builds the (data, model) mesh, runs MODE's
port computations on the inputs the parent pickled to WORKDIR/inputs.pkl
(global batches and bridged weights; every rank gets the same), and
pickles its results to WORKDIR/rank<RANK>.pkl for the parent to hold
against the JAX package's sharded functions.  Modes:
- main: the x-vector, v5 xvec and am DP steps on global batches, the
  same x-vector step with rank-local batch-norm moments (a planted
  fault), Trainer supersteps on local shards, finalize_batch_stats and
  create_train_state over the mesh, sharded extraction, the sharded GMM
  E-step and PLDA scoring, global batch assembly and host shards;
- pad: the GMM and PLDA functions alone (3 ranks: the padding paths);
- indivisible: a batch the data axis does not divide, in the step, the
  extractor and local_batch_slice;
- run_v2: a tiny run_v2 with the mesh, counting each rank's file writes;
- subset: create_train_state, DP steps and an artifact stage on the mesh
  over ``inputs["devices"]`` (the world when None); a rank outside that
  mesh records what each helper raised when handed it.
"""

import contextlib
import datetime
import os
import pickle
import sys

import numpy as np
import torch

torch.set_num_threads(1)
RANK, NPROC, PORT, WORKDIR, MODE = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                    sys.argv[4], sys.argv[5])

from sepi_tpu_torch.config import ExtractConfig, OptimizerConfig  # noqa: E402
from sepi_tpu_torch.parallel import (assemble_global_batch, host_shard_dataset,  # noqa: E402
                                     initialize, is_primary, local_batch_slice, make_mesh,
                                     shutdown)
from sepi_tpu_torch.train import TrainState, build_optimizer  # noqa: E402
from sepi_tpu_torch.train import trainer as port_trainer  # noqa: E402


def _np_state(model):
    return {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}


def _state(model_cls, cfg, init, total_steps=100):
    model = model_cls(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    chain, _ = build_optimizer(OptimizerConfig(preconditioner="none"), total_steps)
    return chain, TrainState(model, chain.init(dict(model.named_parameters())))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def mode_main(inp, mesh):
    from sepi_tpu_torch.backend.device import plda_score_matrix_sharded
    from sepi_tpu_torch.data import ChunkBatch
    from sepi_tpu_torch.data.manifest import Dataset, Utterance
    from sepi_tpu_torch.extract import EmbeddingExtractor
    from sepi_tpu_torch.models import CombinedCVector, XVector
    from sepi_tpu_torch.train import (Trainer, create_train_state, finalize_batch_stats,
                                      make_am_step, make_superstep, make_xvec_step)

    out = {}
    # one x-vector DP step on the global batch
    chain, st = _state(XVector, inp["xcfg"], inp["xinit"])
    m = make_xvec_step(chain, mesh=mesh)(st, _t(inp["feats"]), _t(inp["labels"]), 1.0)
    out["xstep"] = {"objf": float(m["objf"]), "state": _np_state(st.model)}
    # calibration over the mesh from that state
    finalize_batch_stats(st, [inp["calib"]], mesh=mesh)
    out["finalize"] = _np_state(st.model)

    # the planted fault: the same step with rank-local batch-norm moments
    chain, st = _state(XVector, inp["xcfg"], inp["xinit"])
    real = port_trainer.sync_batch_norm
    port_trainer.sync_batch_norm = lambda model, group: contextlib.nullcontext()
    try:
        m = make_xvec_step(chain, mesh=mesh)(st, _t(inp["feats"]), _t(inp["labels"]), 1.0)
    finally:
        port_trainer.sync_batch_norm = real
    out["fault"] = {"objf": float(m["objf"]), "state": _np_state(st.model)}

    # the v5 combined c-vector: an xvec step, then an am step
    chain, st = _state(CombinedCVector, inp["ccfg"], inp["cinit"])
    m1 = make_xvec_step(chain, {"task": "xvec"}, mesh)(st, _t(inp["cfeats"]),
                                                       _t(inp["clabels"]), 1.0)
    s1 = _np_state(st.model)
    m2 = make_am_step(chain, {"task": "am"}, mesh)(st, _t(inp["cfeats"]),
                                                   _t(inp["am_labels"]), 1.0)
    out["v5"] = {"xvec_objf": float(m1["objf"]), "xvec_state": s1,
                 "am_objf": float(m2["objf"]), "am_state": _np_state(st.model)}

    # Trainer supersteps: each rank feeds its shard of every batch
    chain, st = _state(XVector, inp["xcfg"], inp["xinit"])
    tr = Trainer(steps={"xvec": make_xvec_step(chain, mesh=mesh)}, state=st, log_every=10**9,
                 supersteps={"xvec": make_superstep(chain, mesh=mesh)}, steps_per_dispatch=4,
                 mesh=mesh)
    sl = local_batch_slice(inp["seq"][0][0].shape[0], mesh)
    tr.run(iter([ChunkBatch(f[sl], l[sl], f.shape[1], "xvec") for f, l in inp["seq"]]),
           num_steps=len(inp["seq"]))
    out["trainer"] = {"steps": tr.state.step, "state": _np_state(tr.state.model)}

    # ranks seeded differently start from the primary's weights
    xs = create_train_state(XVector(inp["xcfg"]), chain, 7 + RANK, torch.device("cpu"), mesh=mesh)
    out["broadcast"] = _np_state(xs.model)

    # sharded extraction
    model = XVector(inp["ecfg"])
    model.load_state_dict({k: torch.from_numpy(v) for k, v in inp["einit"].items()})
    ext = EmbeddingExtractor(model, inp["extract_cfg"], min_frames=inp["ecfg"].min_frames,
                             device="cpu", mesh=mesh)
    out["emb"] = ext.extract_utterances(inp["utts"])

    out.update(_gmm_plda(inp, mesh, plda_score_matrix_sharded))

    # a global batch from local shards, and a reduction over it
    full = inp["full"]
    g = assemble_global_batch(full[local_batch_slice(full.shape[0], mesh)], mesh)
    out["global_shape"] = tuple(g.shape)
    out["global_mean"] = float(g.full_tensor().mean())
    ds = Dataset([Utterance(f"u{i:02d}", f"s{i % 3}") for i in range(10)])
    out["host_shard"] = host_shard_dataset(ds).utt_ids
    return out


def _gmm_plda(inp, mesh, score_sharded):
    from sepi_tpu_torch.backend.plda import Plda
    from sepi_tpu_torch.classical.gmm import DiagGmm, accumulate_stats_sharded

    gmm = DiagGmm(*(torch.from_numpy(inp["gmm"][k]) for k in ("weights", "means", "vars")))
    stats = []
    for kw in inp["gmm_kwargs"]:
        s = accumulate_stats_sharded(gmm, inp["frames"], mesh, chunk=256, **kw)
        stats.append(tuple(a.numpy() for a in (s.gamma, s.first, s.second)))
    plda = Plda(**inp["plda"])
    llr = score_sharded(plda, inp["enroll"], inp["test"], mesh, inp["num_utts"])
    return {"gmm": stats, "plda": llr.numpy()}


def mode_pad(inp, mesh):
    from sepi_tpu_torch.backend.device import plda_score_matrix_sharded

    return _gmm_plda(inp, mesh, plda_score_matrix_sharded)


def mode_indivisible(inp, mesh):
    from sepi_tpu_torch.extract import EmbeddingExtractor
    from sepi_tpu_torch.models import XVector
    from sepi_tpu_torch.train import make_xvec_step

    out = {}
    chain, st = _state(XVector, inp["xcfg"], inp["xinit"])
    step = make_xvec_step(chain, mesh=mesh)
    for name, fn in {
        "step": lambda: step(st, _t(inp["feats"][:7]), _t(inp["labels"][:7]), 1.0),
        "extract": lambda: EmbeddingExtractor(XVector(inp["xcfg"]), ExtractConfig(batch_size=7),
                                              device="cpu", mesh=mesh),
        "slice": lambda: local_batch_slice(7, mesh),
    }.items():
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def mode_run_v2(inp, mesh):
    from sepi_tpu_torch.data import featstore, make_synthetic_corpus
    from sepi_tpu_torch.recipes import drivers, pipeline
    from sepi_tpu_torch.utils import ArkWriter, kaldi_models, logging

    writes = {}

    def counted(owner, name, label):
        fn = getattr(owner, name)

        def wrapper(*a, **kw):
            writes[label] = writes.get(label, 0) + 1
            return fn(*a, **kw)
        setattr(owner, name, wrapper)

    counted(ArkWriter, "__init__", "ark")
    counted(kaldi_models, "write_plda", "plda")
    counted(logging.MetricsLogger, "__init__", "metrics")
    counted(pipeline, "save_checkpoint", "checkpoint")
    counted(featstore.FeatStore, "write_stream", "store")
    corpus = make_synthetic_corpus(**inp["corpus"])
    enroll = {s: us[:1] for s, us in corpus.dataset.spk2utt.items()}
    res = drivers.run_v2(corpus.dataset, corpus.audio, corpus.dataset, {}, corpus.trials, enroll,
                         inp["workdir"], mesh=mesh, device="cpu", **inp["kwargs"])
    return {"writes": writes, "scores": res.scores, "eer": res.pooled.eer,
            "primary": is_primary()}


def mode_subset(inp, mesh):
    from sepi_tpu_torch.models import XVector
    from sepi_tpu_torch.parallel.multihost import barrier
    from sepi_tpu_torch.train import create_train_state, make_xvec_step
    from sepi_tpu_torch.utils.artifacts import ArtifactCache

    chain, _ = build_optimizer(OptimizerConfig(preconditioner="none"), 100)
    cpu = torch.device("cpu")
    if mesh.get_coordinate() is None:
        raised = {}
        for name, fn in {
            "create_train_state": lambda: create_train_state(XVector(inp["xcfg"]), chain, 7,
                                                             cpu, mesh=mesh),
            "step": lambda: make_xvec_step(chain, mesh=mesh),
            "barrier": lambda: barrier(mesh),
            "is_primary": lambda: is_primary(mesh),
            "artifacts": lambda: ArtifactCache(inp["artifacts"], mesh).stage(
                "params", {}, lambda: {}),
        }.items():
            try:
                fn()
                raised[name] = None
            except ValueError as e:
                raised[name] = str(e)
        return {"member": False, "raised": raised}
    # the mesh's first rank seeds 7, the others elsewhere: all start from seed 7
    seed = 7 if is_primary(mesh) else 100 + RANK
    st = create_train_state(XVector(inp["xcfg"]), chain, seed, cpu, mesh=mesh)
    step = make_xvec_step(chain, mesh=mesh)
    objf = [float(step(st, _t(f), _t(lab), 1.0)["objf"]) for f, lab in inp["batches"]]
    ran = []

    def write():
        ran.append(RANK)
        return _np_state(st.model)

    saved = ArtifactCache(inp["artifacts"], mesh).stage("params", {"steps": len(objf)}, write)
    return {"member": True, "primary": is_primary(mesh), "objf": objf,
            "state": _np_state(st.model), "wrote": bool(ran), "saved": saved}


def main():
    initialize(f"127.0.0.1:{PORT}", NPROC, RANK, device="cpu",
               timeout=datetime.timedelta(seconds=60))
    try:
        with open(os.path.join(WORKDIR, "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        mesh = make_mesh(devices=inp.get("devices"))
        out = globals()[f"mode_{MODE}"](inp, mesh)
        path = os.path.join(WORKDIR, f"rank{RANK}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".tmp", path)
    finally:
        shutdown()
    print(f"rank {RANK}: PASS", flush=True)


if __name__ == "__main__":
    main()
