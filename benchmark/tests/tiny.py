"""Small sizes of the benchmark's cells, for the CPU tests (widths cut,
which no configuration in BENCHMARK.json may do)."""

import json
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
for p in (REPO, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

X_ARCH = {"frames": {"prefix": "frames", "layers": [[16, [-2, -1, 0, 1, 2]], [16, [-2, 0, 2]],
                                                    [16, [-3, 0, 3]], [16, [0]], [24, [0]]]}}
C_ARCH = {"shared": {"prefix": "shared", "layers": [[16, [-2, -1, 0, 1, 2]]]},
          "am_branch": {"prefix": "am_branch",
                        "layers": [[16, [-2, 0, 2]], [16, [-3, 0, 3]]] + [[16, [0]]] * 4},
          "xvec_branch": {"prefix": "xvec_branch",
                          "layers": [[16, [-2, 0, 2]], [16, [-3, 0, 3]], [16, [0]]]},
          "am": {"prefix": "am.frames", "layers": [[20, [-2, -1, 0, 1, 2]], [20, [-1, 0, 1]],
                                                   [20, [-1, 0, 1]], [20, [-3, 0, 3]],
                                                   [8, [-6, -3, 0]]]}}
SERVE = {"warmup_shards": 1, "pool_utts": 4, "shard_utts": 4,
         "duration_s": {"min": 2.0, "max": 5.0}, "check": {"utts": 3, "requests": 3},
         "backend": {"lda_dim": 6, "enrolled": 5}}
XVEC = {"num_speakers": 10, "embed_dim": 8, "arch": X_ARCH, "extract": {"chunk_size": 200}}
CVEC = {"num_speakers": 10, "num_senones": 12, "embed_dim": 8, "hidden_dim": 16, "pool_dim": 24,
        "arch": C_ARCH, "extract": {"chunk_size": 200},
        "train": {"batch_size": 8, "am_batch_size": 16, "steps_per_dispatch": 2,
                  "chunks": {"min_chunk_len": 40, "max_chunk_len": 80, "num_buckets": 3}}}
# the x-vector trained as cvector_v5 trains its xvec task (its train section
# without the am keys), at the small sizes
XTRAIN = dict(XVEC, train=dict(
    {k: v for k, v in json.load(open(f"{BENCH}/configs/cvector_v5.json"))["train"].items()
     if k not in ("am_batch_size", "am_lr_factor", "frames_per_eg")},
    batch_size=4, steps_per_dispatch=2,
    chunks={"min_chunk_len": 40, "max_chunk_len": 80, "num_buckets": 3}))
XTRAIN_MIX = {"speakers": 10, "utts_per_speaker": 3, "frames_per_utt": 120, "num_steps": 1000}
OVERRIDES = {
    "xvector_v2.extract": {"config": XVEC, "traffic": SERVE},
    "xvector_v2.verify": {"config": XVEC, "traffic": SERVE},
    "cvector_v5.extract": {"config": CVEC, "traffic": SERVE},
    # the CPU's bf16 convolutions round otherwise than cuDNN's, and these nets
    # are 16 wide: here the first steps' loss and gradient norm read 2.6e-3 and
    # 2.1e-2 from the reference, the fp8 control 1.5e-2 and 0.16; the window's
    # units, from a state that depends on how many steps the short window
    # took, read up to 3e-3, 9.7e-2 and 1.4e-2 (the card's readings and limits
    # are in PERF.md)
    "cvector_v5.train": {"config": CVEC, "traffic": {"speakers": 10, "utts_per_speaker": 3,
                                                     "frames_per_utt": 120, "num_steps": 1000},
                         "limits": {"limits": {"loss_first_rel_gap": 6e-3,
                                               "grad_norm_first_rel_gap": 8e-2,
                                               "window_grad_norm_max": 0.2,
                                               "window_change_median_leaf_gap": 5e-2}}},
}
SEED = 3000000001  # above 2**31: a run's seed may be larger than 32 bits hold


def run(cell, trace=0, controls=(), seconds=0.3, **kw):
    """run.main on the CPU at the cell's small size: (rc, result)."""
    import run as bench_run

    overrides = kw.pop("overrides") if "overrides" in kw else OVERRIDES[cell]
    return bench_run.main(["--workload", cell, "--seed", str(kw.pop("seed", SEED)),
                           "--seconds", str(seconds), "--trace", str(trace)],
                          device="cpu", overrides=overrides, controls=controls, **kw)


def execute(cell, controls=(), seconds=0.3, seed=SEED):
    """run.execute on the CPU at the cell's small size: the cell's Outcome."""
    import run as bench_run

    args = bench_run.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds)])
    return bench_run.execute(args, device="cpu", overrides=OVERRIDES[cell], controls=controls)[3]
