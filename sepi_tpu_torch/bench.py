"""Headline measurement of the port: extraction throughput, the bf16
training steps and PLDA scoring on the card, in `bench.py`'s JSON line.

    python -m sepi_tpu_torch.bench [--device cuda]

The port's counterpart of the repository's top-level `bench.py`: the same
work at the same shapes, through the port's own entry points.
- `bench_extraction`: 16 x 100 s of 8 kHz noise, `FrontendConfig()`
  (dither 1.0, seeds from `ops.dither.utt_seeds`), `FeatureExtractor.mfcc`
  (one launch of the MFCC kernel) -> `energy_vad` -> `sliding_cmvn` ->
  `select_voiced_frames` -> the float32 V2 x-vector with 5000 speakers in
  eval mode, `embedding_a`, under `device.fp32_math()`.  Headline metric:
  audio-seconds per second; ``vs_baseline`` against `bench.py`'s own
  1000 audio-s/s anchor (its assumed Kaldi-CPU host, not a device number).
- `bench_training`: the V2 step of `XVector(cfg, dtype="bfloat16")` at 64
  x 200 x 23 under `build_optimizer(OptimizerConfig(), 1000)`, the K = 16
  superstep, the v5 pair (`CombinedCVector` in bf16, 5000 speakers and
  4000 senones: an am step on 128 x (8 + context) frames, then an xvec
  step on the V2 batch) and the K = 8 pair superstep.
- `bench_plda_scoring`: `plda_score_matrix_device` on 4096 x 4096 trials
  of a synthetic, well-conditioned 150-dim `Plda`.

How it times: eager PyTorch as users run it (no CUDA graph, no
`torch.compile`; `bench.py`'s on-device loop has no CUDA counterpart).
After ``Shapes.warmup`` calls, each of ``repeats`` runs times its stage's
calls back to back between two `torch.cuda.synchronize()` calls on the
host clock; the line reports the median run, and the quartiles and the
number of runs go to standard error.

Each stage holds what it timed before it reports a number, and a check
that misses its limit raises `BenchCheckFailed`: the MFCC of the bench
batch against `mfcc_fused_reference` within 2e-3, the embeddings finite
and (16, 512), every training objective finite and every parameter
moved, and a 256 x 256 block of the trial matrix against the float64 host
scores.  A stage that raises ends the run with a non-zero exit, after the
line is printed with an ``"error"`` key; a run that succeeds prints
`bench.py`'s keys, every value set, plus ``"device"``: the card's name
and power limit as `nvidia-smi` gives them.

Stages take ``device=`` (default "cuda"; with no usable GPU a CUDA request
raises, it never falls back to the CPU) and ``shapes=`` (default
`bench.py`'s; the CPU tests pass small ones).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .config import CmvnConfig, FrontendConfig, OptimizerConfig, VadConfig
from .device import DeviceLike, fp32_math, resolve_device
from .models import V2_XVECTOR, CombinedConfig, XVectorConfig

REPEATS = 10  # timed runs per measurement
SEED = 0  # bench.py's np.random.default_rng(0)
SR = 8000
BASELINE = 1000.0  # audio-s/s: bench.py's 10x an assumed 100x-realtime Kaldi-CPU host
MFCC_TOL = 2e-3  # max |kernel - plain| of the cepstra, chip_smoke.py phase 3
PLDA_BLOCK = 256  # the corner of the trial matrix held against the float64 host scores
PLDA_RTOL = 1e-3  # |card - float64| <= 1e-3 |float64| + 1e-3 x scale, tests/test_backend_device.py


@dataclasses.dataclass(frozen=True)
class Shapes:
    """What each stage runs; the defaults are `bench.py`'s."""

    utts: int = 16  # extraction batch (bench.py:79)
    secs: float = 100.0  # seconds per utterance
    xvector: XVectorConfig = dataclasses.replace(V2_XVECTOR, num_speakers=5000)
    chunks: int = 64  # V2 training batch (bench.py:162)
    chunk_frames: int = 200
    superstep: int = 16  # K of the V2 superstep (bench.py:179)
    combined: CombinedConfig = CombinedConfig(num_speakers=5000, num_senones=4000)
    am_chunks: int = 128  # v5 am batch (bench.py:196)
    am_frames: int = 8  # label frames per am chunk
    pair_superstep: int = 8  # K of the v5 pair superstep (bench.py:218)
    plda_dim: int = 150  # bench.py:247-248
    plda_models: int = 4096
    plda_tests: int = 4096
    # calls per timed run: bench.py's fori_loop lengths
    extract_iters: int = 10
    step_iters: int = 20
    superstep_iters: int = 4
    plda_iters: int = 10
    warmup: int = 2  # untimed calls before the timed runs (after any checked call)


class BenchCheckFailed(RuntimeError):
    """A stage's output missed its limit."""


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise BenchCheckFailed(what)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class Timing:
    """Milliseconds per call of each timed run of ``iters`` calls."""

    ms: List[float]
    iters: int

    @property
    def median(self) -> float:
        return float(np.median(self.ms))

    def describe(self, per: int = 1, unit: str = "call") -> str:
        q1, q2, q3 = (q / per for q in np.percentile(self.ms, [25, 50, 75]))
        return (f"median {q2:.3f} ms/{unit}, quartiles {q1:.3f}-{q3:.3f} over R={len(self.ms)} "
                f"runs of {self.iters} calls")


def time_calls(fn: Callable, dev: torch.device, iters: int, repeats: int, warmup: int):
    """(Timing, the last call's result): ``warmup`` calls, then ``repeats``
    runs of ``iters`` back-to-back calls, each run between two
    synchronizes on the host clock."""
    for _ in range(warmup):
        fn()
    _sync(dev)
    ms, out = [], None
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3 / iters)
    return Timing(ms, iters), out


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as `nvidia-smi` gives them ("cpu"
    for a CPU run)."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


# ------------------------------------------------------------------ extraction


@dataclasses.dataclass
class ExtractionRun:
    samples: np.ndarray  # (utts, secs * SR) float32, drawn from the stage's generator
    model: torch.nn.Module  # the float32 x-vector, eval mode, on the device
    embeddings: torch.Tensor  # embedding_a of the checked call
    mfcc_err: float  # max |FeatureExtractor.mfcc - mfcc_fused_reference| of the checked call
    timing: Timing
    audio_s_per_s: float


def bench_extraction(rng: np.random.Generator, device: DeviceLike = "cuda",
                     shapes: Shapes = Shapes(), repeats: int = REPEATS) -> ExtractionRun:
    """The headline: the full extraction chain, audio-seconds/s."""
    from .models import XVector, lecun_normal_init
    from .ops import FeatureExtractor, energy_vad, select_voiced_frames, sliding_cmvn
    from .ops.dither import utt_seeds
    from .ops.framing import num_frames
    from .ops.mfcc_cuda import mfcc_fused_reference

    dev = resolve_device(device)
    batch, n = shapes.utts, int(SR * shapes.secs)
    fcfg, vcfg, ccfg = FrontendConfig(), VadConfig(), CmvnConfig()
    t_max = int(num_frames(n, fcfg))
    model = XVector(shapes.xvector)
    lecun_normal_init(model, 0)
    model = model.to(dev).eval()
    seeds = utt_seeds([f"bench{i}" for i in range(batch)])
    samples_np = rng.normal(size=(batch, n)).astype(np.float32) * 3000.0
    samples = torch.from_numpy(samples_np).to(dev)
    lengths = torch.full((batch,), n, dtype=torch.int32, device=dev)
    fe = FeatureExtractor(fcfg, device=dev)

    def extract():
        feats, mask = fe.mfcc(samples, lengths, t_max, utt_seeds=seeds)
        voiced = energy_vad(feats[..., 0], mask, vcfg)
        normed = sliding_cmvn(feats, mask, ccfg)
        sel, sel_mask = select_voiced_frames(normed, voiced)
        return model(sel, frame_mask=sel_mask)["embedding_a"], feats, mask

    with fp32_math(), torch.no_grad():
        emb, feats, mask = extract()
        want, want_mask = mfcc_fused_reference(
            samples, lengths, fcfg, t_max, torch.from_numpy(seeds).to(dev))
        err = float((feats - want).abs().max())
        _require(bool(torch.equal(mask, want_mask)) and err <= MFCC_TOL,
                 f"extraction: MFCC off its plain version by {err:.3e} (limit {MFCC_TOL}) "
                 f"or masks differ")
        _require(tuple(emb.shape) == (batch, shapes.xvector.embed_dim)
                 and bool(torch.isfinite(emb).all()),
                 f"extraction: embeddings {tuple(emb.shape)}, finite "
                 f"{bool(torch.isfinite(emb).all())}")
        del want, feats
        timing, _ = time_calls(lambda: extract()[0], dev, shapes.extract_iters, repeats,
                               shapes.warmup)
    rate = batch * shapes.secs / (timing.median / 1e3)
    _log(f"# extraction {batch}x{shapes.secs:.0f} s on {dev}: {timing.describe(unit='batch')}; "
         f"{rate:.1f} audio-s/s; MFCC vs plain {err:.3e} (limit {MFCC_TOL}), embeddings "
         f"{tuple(emb.shape)} finite")
    return ExtractionRun(samples_np, model, emb, err, timing, rate)


# -------------------------------------------------------------------- training


@dataclasses.dataclass
class TrainingRun:
    v2_init: Dict[str, torch.Tensor]  # the V2 model's initial state_dict
    v2_batch: Tuple[np.ndarray, np.ndarray]  # (feats, labels) of the single steps
    v2_state: object  # TrainState after the single steps
    v2_metrics: Dict[str, torch.Tensor]  # the last single step's metrics
    timings: Dict[str, Timing]  # v2, v2_superstep, v5_pair, v5_superstep (per call)
    objf: Dict[str, float]  # each measurement's last objective


def _snapshot(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _check_trained(name: str, state, init: Dict[str, torch.Tensor], metrics) -> float:
    """Every metric finite, every parameter moved from ``init``, parameters
    float32 under a bf16 model; the last objective."""
    from .models import compute_dtype

    bad = [k for k, v in metrics.items() if not bool(torch.isfinite(v).all())]
    still = [n for n, p in state.model.named_parameters() if torch.equal(p, init[n])]
    dtypes = {p.dtype for p in state.model.parameters()}
    _require(not bad and not still and dtypes == {torch.float32}
             and compute_dtype(state.model) == torch.bfloat16,
             f"training {name}: non-finite {bad}, unmoved {still[:4]}, parameter dtypes "
             f"{dtypes}, compute dtype {compute_dtype(state.model)}")
    return float(metrics["objf"].reshape(-1)[-1])


def bench_training(rng: np.random.Generator, extra: dict, device: DeviceLike = "cuda",
                   shapes: Shapes = Shapes(), repeats: int = REPEATS,
                   opt_cfg: Optional[OptimizerConfig] = None) -> TrainingRun:
    """The bf16 V2 step, the K = 16 superstep, the v5 am+xvec pair and the
    K = 8 pair superstep, into ``extra`` as `bench.py` names them.  Each
    superstep and the pair start from their model's initial state, as
    `bench.py`'s functional loops do."""
    from .models import CombinedCVector, XVector
    from .train import (build_optimizer, create_train_state, make_am_step, make_superstep,
                        make_xvec_step)

    dev = resolve_device(device)
    cfg, v5_cfg = shapes.xvector, shapes.combined
    tb, t, k, k5 = shapes.chunks, shapes.chunk_frames, shapes.superstep, shapes.pair_superstep
    tx, _ = build_optimizer(opt_cfg or OptimizerConfig(), 1000)

    def put(a):
        return torch.from_numpy(a).to(dev)

    feats_np = rng.normal(size=(tb, t, cfg.feat_dim)).astype(np.float32)
    labels_np = rng.integers(0, cfg.num_speakers, size=tb).astype(np.int32)
    feats_v2, labels_v2 = put(feats_np), put(labels_np)
    # bf16 compute in the caller's model alone (no autocast); TF32 off as
    # in the trainers
    with fp32_math():
        state_v2 = create_train_state(XVector(cfg, dtype="bfloat16"), tx, 1, dev)
        init_v2 = _snapshot(state_v2.model)
        state_sup = state_v2.clone()
        step = make_xvec_step(tx)
        t_v2, m_v2 = time_calls(lambda: step(state_v2, feats_v2, labels_v2, 1.0), dev,
                                shapes.step_iters, repeats, shapes.warmup)

        sstep = make_superstep(tx)
        feats_s = put(rng.normal(size=(k, tb, t, cfg.feat_dim)).astype(np.float32))
        labels_s = put(rng.integers(0, cfg.num_speakers, size=(k, tb)).astype(np.int32))
        ones = torch.ones(k, device=dev)
        t_sup, m_sup = time_calls(lambda: sstep(state_sup, feats_s, labels_s, ones), dev,
                                  shapes.superstep_iters, repeats, shapes.warmup)
        del feats_s

        al, ar = v5_cfg.am_context
        ab, al_frames = shapes.am_chunks, shapes.am_frames
        feats_am = put(rng.normal(size=(ab, al_frames + al + ar, v5_cfg.feat_dim))
                       .astype(np.float32))
        labels_am = put(rng.integers(0, v5_cfg.num_senones, size=(ab, al_frames))
                        .astype(np.int32))
        state_v5 = create_train_state(CombinedCVector(v5_cfg, dtype="bfloat16"), tx, 2, dev)
        init_v5 = _snapshot(state_v5.model)
        state_v5s = state_v5.clone()
        am_step = make_am_step(tx, {"task": "am"})
        xv_step = make_xvec_step(tx, {"task": "xvec"})

        def pair():
            m_am = am_step(state_v5, feats_am, labels_am, 1.0)
            m_xv = xv_step(state_v5, feats_v2, labels_v2, 1.0)
            return m_am, m_xv

        t_v5, m_v5 = time_calls(pair, dev, shapes.step_iters, repeats, shapes.warmup)

        # the pair superstep over K5 copies of each batch, staged once
        am_sstep = make_superstep(tx, {"task": "am"})
        xv_sstep = make_superstep(tx, {"task": "xvec"})

        def stack(x):
            return x.unsqueeze(0).expand(k5, *x.shape).contiguous()

        fa_s, la_s, fx_s, lx_s = (stack(x) for x in (feats_am, labels_am, feats_v2, labels_v2))
        w5 = torch.ones(k5, device=dev)

        def super_pair():
            return (am_sstep(state_v5s, fa_s, la_s, w5), xv_sstep(state_v5s, fx_s, lx_s, w5))

        t_v5s, m_v5s = time_calls(super_pair, dev, shapes.superstep_iters, repeats,
                                  shapes.warmup)
    _sync(dev)

    objf = {"v2": _check_trained("v2 step", state_v2, init_v2, m_v2),
            "v2_superstep": _check_trained("v2 superstep", state_sup, init_v2, m_sup)}
    for name, st, ms in (("v5_pair", state_v5, m_v5), ("v5_superstep", state_v5s, m_v5s)):
        for task, m in zip(("am", "xvec"), ms):
            objf[f"{name}_{task}"] = _check_trained(f"{name} {task}", st, init_v5, m)

    frames_s = tb * t * 0.01  # 10 ms frames -> audio seconds
    dt_v2, dt_sup = t_v2.median, t_sup.median / k
    dt_v5, dt_v5s = t_v5.median, t_v5s.median / k5
    extra["v2_train_ms_per_step"] = round(dt_v2, 3)
    extra["v2_train_audio_s_per_s"] = round(frames_s / (dt_v2 / 1e3), 1)
    # bench.py's names, whatever K the shapes give
    extra["v2_superstep16_ms_per_step"] = round(dt_sup, 3)
    extra["v2_superstep16_audio_s_per_s"] = round(frames_s / (dt_sup / 1e3), 1)
    extra["v5_multitask_ms_per_step_pair"] = round(dt_v5, 3)
    extra["v5_superstep8_ms_per_step_pair"] = round(dt_v5s, 3)
    _log(f"# v2 train bf16 {tb}x{t} on {dev}: {t_v2.describe(unit='step')}")
    _log(f"# v2 superstep K={k}: {t_sup.describe(per=k, unit='step')}")
    _log(f"# v5 multitask pair (am {ab}x{al_frames} + xvec {tb}x{t}): "
         f"{t_v5.describe(unit='pair')}")
    _log(f"# v5 pair superstep K={k5}: {t_v5s.describe(per=k5, unit='pair')}")
    _log("# training checks: objectives finite, every parameter moved, float32 parameters "
         "under bf16 compute; last objf " + ", ".join(f"{n} {v:.4f}" for n, v in objf.items()))
    return TrainingRun(init_v2, (feats_np, labels_np), state_v2, m_v2,
                       {"v2": t_v2, "v2_superstep": t_sup, "v5_pair": t_v5,
                        "v5_superstep": t_v5s}, objf)


# ---------------------------------------------------------------- PLDA scoring


@dataclasses.dataclass
class PldaRun:
    plda: object  # backend.Plda
    models: np.ndarray
    tests: np.ndarray
    scores: torch.Tensor  # the checked (M, N) matrix
    block_err: float  # max(|card - float64| - rtol |float64|) / scale over the block
    timing: Timing
    trials_per_s: float


def bench_plda_scoring(rng: np.random.Generator, extra: dict, device: DeviceLike = "cuda",
                       shapes: Shapes = Shapes(), repeats: int = REPEATS) -> PldaRun:
    """On-device PLDA trial scoring throughput (trials/s)."""
    from .backend import Plda, plda_score_matrix, plda_score_matrix_device

    dev = resolve_device(device)
    dim, n_models, n_tests = shapes.plda_dim, shapes.plda_models, shapes.plda_tests
    # a synthetic but well-conditioned PLDA model (bench.py:251-256)
    q = np.linalg.qr(rng.normal(size=(dim, dim)))[0]
    plda = Plda(mean=rng.normal(size=dim), transform=q, psi=rng.uniform(0.1, 5.0, dim))
    models = rng.normal(size=(n_models, dim)).astype(np.float32)
    tests = rng.normal(size=(n_tests, dim)).astype(np.float32)
    md, td = torch.from_numpy(models).to(dev), torch.from_numpy(tests).to(dev)

    def score():
        return plda_score_matrix_device(plda, md, td, device=dev)

    scores = score()
    blk = min(PLDA_BLOCK, n_models, n_tests)
    want = plda_score_matrix(plda, models[:blk], tests[:blk])
    got = scores[:blk, :blk].double().cpu().numpy()
    scale = float(np.abs(want).max())
    err = float(np.max(np.abs(got - want) - PLDA_RTOL * np.abs(want)) / scale)
    _require(tuple(scores.shape) == (n_models, n_tests) and err <= PLDA_RTOL,
             f"plda: {tuple(scores.shape)} scores, the {blk} x {blk} block off float64 by "
             f"{err:.3e} of its scale (limit {PLDA_RTOL})")
    timing, _ = time_calls(score, dev, shapes.plda_iters, repeats, shapes.warmup)
    rate = n_models * n_tests / (timing.median / 1e3)
    extra["plda_trials_per_s"] = round(rate, 0)
    _log(f"# plda scoring {n_models}x{n_tests}x{dim} on {dev}: {timing.describe()}; "
         f"{rate / 1e6:.0f}M trials/s; {blk}x{blk} block vs float64 {err:.3e} of scale "
         f"{scale:.1f} (limit {PLDA_RTOL})")
    return PldaRun(plda, models, tests, scores, err, timing, rate)


# ------------------------------------------------------------------------ main


def main(device: DeviceLike = "cuda", repeats: int = REPEATS,
         shapes: Shapes = Shapes()) -> Tuple[dict, dict]:
    """Run the three stages in `bench.py`'s order, print its JSON line and
    return (the line, each stage's run).  A stage that raises, or misses a
    check, prints the line with an ``"error"`` key and raises."""
    dev = resolve_device(device)
    result = {
        "metric": "xvector_extraction_throughput",
        "value": None,
        "unit": "audio_seconds_per_second_per_chip",
        "vs_baseline": None,
        "extra": {},
    }
    rng = np.random.default_rng(SEED)
    runs = {}
    try:
        runs["extraction"] = ext = bench_extraction(rng, dev, shapes, repeats)
        result["value"] = round(ext.audio_s_per_s, 1)
        result["vs_baseline"] = round(ext.audio_s_per_s / BASELINE, 3)
        runs["training"] = bench_training(rng, result["extra"], dev, shapes, repeats)
        runs["plda"] = bench_plda_scoring(rng, result["extra"], dev, shapes, repeats)
        result["device"] = card_line(dev)
    except Exception as e:  # report the failure on the line, then fail the run
        result["error"] = f"{type(e).__name__}: {e}"
        print(json.dumps(result), flush=True)
        raise
    print(json.dumps(result), flush=True)
    return result, runs


def cli(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="'cpu' runs on the CPU (slow at "
                                                    "the bench's shapes)")
    args = p.parse_args(argv)
    main(device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
