#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sepi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; a failing phase raises and the script exits
non-zero:
  1. environment: torch, the card's name and power limit; TF32 off.
  2. build every kernel from sepi_tpu_torch/csrc with nvcc (sm_90a), one
     nvcc process per source, all started together.
  3. each kernel against its plain PyTorch version on the card, with
     kernel / plain / library-call times (CUDA events):
     - the MFCC at the extraction path's shapes (16 x 100 s, and a small
       ragged batch with utterances shorter than the tail window), and
       the wide 16 kHz / 40-mel configuration, dithered and undithered;
       both bounds (fp32 CUDA cores, and the 3xTF32 tensor-core product
       the kernel uses) and the kernel-to-library ratio;
     - the Viterbi at B=32 x T=1024 x S in {256, 512}, at B=128 x
       T=1024 x S=256, at B=32 x T=2048 x S=144 with ragged lengths, on a
       tie-heavy case, and at
       S in {128, 1024, 1100} with skips 1 and 8 and lengths 1, 2 and
       ragged; per-step microseconds.
  4. the extraction path at full width: synthetic corpus ->
     prepare_features_nosil -> extract_and_score (full-size V2 x-vector,
     seeded random weights) -> backend_eval, with the kernels' launch
     counts read around it and a CPU run of the same path on part of the
     corpus as the reference.
  5. extraction throughput at the bench shape (MFCC -> VAD -> CMVN ->
     select -> x-vector embedding), audio-seconds/s.
  6. the s5 aligner path at full width: phonetic corpus (128 utterances
     of 8-16 words) -> prepare_features_phonetic -> run_s5 (4096-leaf
     budget, LDA+MLLT, fMLLR SAT) -> select_voiced_ali, with the launch
     counts read around it; then the Viterbi held against its plain
     version on a batch the path gave it, and 8 utterances re-aligned
     on the CPU with the final model as the reference.
  7. v2 training:
     a. the step time at the reference's training bench shape (full-size
        V2 x-vector, 5000 speakers, 64 chunks x 200 frames x 23, default
        OptimizerConfig = Muon, fp32, TF32 off): single steps and a K=16
        superstep, audio-seconds/s, the optimizer's share of a step
        against forward+backward, peak memory;
     b. the path at full width: synthetic corpus (32 speakers x 8 x 8 s)
        -> prepare_features_nosil -> train_xvector_model (default
        TrainConfig, 300 steps, checkpoints, held-out auto) ->
        extract_and_score -> backend_eval, with the MFCC's launch count
        read around it; scored in-domain (the training speakers' own
        trials, as phase 4) and on 200 unseen speakers (2 x 2 s each,
        backend trained on the training corpus), each beside the same path
        with phase 4's seeded random weights.  In-domain the trained EER
        must be no worse than the random weights' (both reach 0% on this
        corpus, so "below" cannot show); the unseen speakers' EERs are
        printed, not held (near chance for both);
     c. the card against the CPU: the same initial weights and the same
        3 sampler batches, 3 momentum-SGD steps each side held by the
        trajectory measure, and one default (Muon) step held entry by
        entry wherever the two gradients agree to 1%, the Muon matrix in l2.
  8. the phonetic c-vector systems: a. step times at full width; b. phase
     6's labels -> AM pretraining -> v3/v4/v5 trainers -> extraction and
     scoring beside the initial weights; c. the card against the CPU.
  9. the recipe drivers on corpus-v2 audio (the gauntlet's CI_SCALE_V2
     domain; unseen eval speakers, 1-3 enrollment utterances each):
     run_v2 with augmentation and PLDA adaptation, run_v3 running the s5
     stage, run_v4 and run_v5 loading it from their stage caches, all at
     the drivers' default widths; per-driver and per-stage wall seconds,
     the kernels' launch counts around the phase, the MFCC held against
     its plain version on every batch the phase fed it, the Viterbi on
     the largest batch of each (T, S, skip) the s5 stage gave it, the
     reverberation's FFT on the card against the CPU's, every system's
     unseen-speaker EER beside its initial weights' (v2's must be below),
     and the Kaldi-format files read back equal to what the run held.
 10. the v1 i-vector systems on phase 9's corpus: a. run_v1 at full width
     (UbmConfig(), IvectorConfig(), LDA 200, phase 9's mean-only
     adaptation), its unseen-speaker EER below the same backend's on
     i-vectors of the random initial T with the trained UBM, seconds per
     stage and per inner step, peak memory; b. the DNN/i-vector variant:
     paired features, pseudo_senone_alignments(hires, 4000),
     train_nnet2_am(Nnet2Config(), 300 steps), run_v1 with
     nnet2_posteriors; c. the card against the CPU: one full-width
     E-step (log-likelihoods against a float64 evaluation), the i-vector
     posterior of 16 utterances, and train_v1_frontend (K=64, M=32) and
     nnet2_posteriors with TF32 turned on. Every MFCC batch of 10a/10b
     (C = 20 and hires C = 40) is held against the plain version.
 11. bf16 compute and the on-device backend: a. bf16 step times at the
     reference bench's shapes (the V2 step and K=16 superstep, the v5
     am and xvec steps) beside 7a/8a's float32 ones, with top kernels,
     idle share and peak memory; b. the full-width V2 x-vector in bf16 on
     the card against the CPU (one forward, 3 momentum-SGD steps) within
     limits set from bf16's unit roundoff; c. run_v2 with
     TrainConfig(compute_dtype="bfloat16") on phase 9's corpus and
     settings, its unseen-speaker EER below the initial weights' and
     every MFCC batch held against the plain version; d. the device PLDA
     trial matrix at bench.py's 4096 x 4096 x 150 against float64, LDA and
     PLDA training and backend_eval(device_scoring=True) on phase 9's
     embeddings against the host, and streaming_embed on a 60,000-frame
     stream against whole-utterance pooling.
 12. the command line on the card, in-process through `cli.main(argv)`:
     a. phase 9's corpus v2 written as Kaldi data dirs of WAVs (train with
        `text` and one `segments` cut, enroll, eval, trials, lexicon, MUSAN
        and RIR trees) with the port's own writers; b. `v2` at the default
        widths with phase 9's steps and augmentation; c. `v3` through the
        s5 stage with `--fmllr`; each EER below its initial weights' under
        the same backend, seconds per stage; d. export-kaldi of b's final
        checkpoint, `python -m sepi_tpu_torch import-kaldi` in a process of
        its own, 64 eval embeddings within 1e-4 of the trained model's, the
        model b evaluated, exported from the card, byte-equal to a host
        export of the checkpoint-tail average it was combined from under
        its recomputed batch-norm statistics, the imported forward and the nnet2 fixture's posteriors on the card
        within 1e-4 of the CPU's, the Kaldi fixtures through import-kaldi/export-kaldi; e. the
        gauntlet (`--scale ci --variants v2,v5 --bootstrap 200`) with the
        reference's pins (0.05 < EER(v2) < 0.30, EER(v5) <= EER(v2) - 0.02).
        Every MFCC batch within 2e-3 of the plain version, the largest
        Viterbi batch of each (T, S, skip) with equal backpointers; wall
        seconds against a 200 s budget.
 13. the device mesh (`sepi_tpu_torch.parallel`), its ranks spawned as
     processes with a timeout: a. one rank over NCCL: dryrun_multichip(1)
     and a full-width V2 DP step at 64 x 200 against the plain step, with
     the median ms of each; b. two ranks sharing the card over gloo (NCCL
     refuses a shared device): 3 momentum-SGD DP steps against one
     process's steps on the global batch within rtol = atol = 2e-4, the
     ranks bit-equal, a planted fault (batch-norm moments rank-local) that
     must read above the limit, and the step ms; c. sharded extraction of
     16 x 100 s, GMM statistics at 2048 x 60 (gselect 20, 2^17 frames) and
     the PLDA trial matrix at 4096 x 4096 x 150, each against its
     single-card function; d. run_v2 with a 2-rank mesh on phase 9's corpus
     at phase 9's settings, the primary writing, its unseen-speaker EER
     below phase 9's initial weights'.  Wall seconds against a 150 s
     budget.
 14. the parity slice: a. the five MFCC presets under spectral_mode="auto"
     on 4 x 3 s (dithered) through the kernel, each with its launch count
     (> 0) and its error against the plain version, and three configs
     outside the kernel's gate (raw_energy=False, frame_shift_ms=9.125,
     frame shift > frame length), dithered and not, through the stepwise
     route on the card (no launch) against the CPU within 1e-3; b. a mesh
     over ranks 1 and 2 of a 3-rank gloo world sharing the card:
     create_train_state and 13b's 3 DP steps against a 2-rank world's at
     13b's limit, within a 120 s process limit, the mesh's first rank the
     one artifact writer, rank 0 raising when handed the mesh; c.
     graft_entry.entry() (full-size V2, 5000 speakers, 8 x 300 x 23) on the
     card against the CPU within 1e-4 of the embedding's scale, and its
     forward's median ms.  Wall seconds against a 60 s budget.
 15. the port's headline measurement, `sepi_tpu_torch.bench.main`, in-process
     at bench.py's shapes with R = 10 timed runs per measurement: 16 x 100 s
     of dithered audio through FeatureExtractor.mfcc, VAD, CMVN, select and
     the full-size V2 (5000 speakers); the bf16 V2 step, its K = 16
     superstep, the v5 am+xvec pair and its K = 8 superstep; the PLDA trial
     matrix at 4096 x 4096 x 150.  Its own checks (the MFCC within 2e-3 of the
     plain version, embeddings finite, every objective finite and every
     parameter moved, a 256 x 256 block of the trial matrix against float64)
     raise on a miss; its JSON line, bench.py's keys and the card, is printed
     on a line of its own, and the MFCC's launches are counted around it.
     Wall seconds against a 60 s budget.  Every stage runs as captured CUDA
     graphs (the training steps, the extraction chain, the scoring; the
     inference replay count is held > 0); each one's eager median
     (capture=False) is printed beside it.
 16. the captured training step (`train.graphs`), run before phase 15: a.
     20 captured steps against 20 eager ones (capture=False) from the same
     state under cudnn.deterministic, every parameter, buffer, optimizer
     tensor and metric torch.equal, for the fp32 V2 with Muon and with
     momentum SGD, the bf16 V2 and the bf16 v5 am+xvec pair at the bench's
     shapes and widths, and the Trainer's path (staged batches of two
     chunk lengths, K = 4 supersteps, loss weights, held-out evaluation)
     with the factories' default against capture=False; b. the K = 16
     superstep (two replays) against 32
     eager steps, bit-equal; c. a new capture after clone() and after
     load_checkpoint, each bit-equal to eager, and a planted stale replay
     (the first graph run after opt_state is replaced) that must differ;
     d. determinism off, 3 momentum-SGD steps within TRAJ_TOL; e. the
     device idle share, device ops and host launch calls per call of the
     eager and the captured bf16 V2 step and v5 pair (torch.profiler);
     the captures, replays, live graphs and peak memory.  Wall seconds
     against a 60 s budget.  Phases 9 and 11c print and hold their replay
     counts (> 0) and peak memory: the drivers train through graphs.
 17. the compiled serving path (`sepi_tpu_torch.graphs.CallGraphs`), run
     after phase 16, every graph against capture=False under
     cudnn.deterministic: a. EmbeddingExtractor over a corpus whose chunks
     fill every bucket of the ladder (25 ... 10000 frames), the full-width
     V2 in fp32 and bf16, a capturing and a replayed pass bit-equal; new
     weights by load_state_dict (the graphs kept, no capture), then the
     model moved onto new storage (a capture per bucket), and a planted
     stale replay (a graph bound to the replaced weights) that must
     differ; b. the frontend chain (MFCC -> VAD -> [deltas] -> CMVN),
     dithered, undithered, with the v1 deltas and on the stepwise route:
     features, voiced masks and frame counts equal, every MFCC batch of the
     captured runs (the replayed ones too) within 2e-3 of the plain
     version, the launches counted through the replays; c. the eval step,
     fp32 and bf16; d. the bench's scoring (4096 x 4096 x 150) and
     extraction chain (16 x 100 s) programs; e. eager against captured per
     call at the 32 x 25, 32 x 400 and 32 x 10000 buckets and the bench
     chain (torch.profiler): device ms, idle share, device ops and host
     launch calls; captures, replays, live graphs, peak memory.  Wall
     seconds against a 60 s budget.  Phases 4, 9 and 15 print and hold
     their inference replays (> 0): extraction and the frontend run as
     graph replays.
 18. the MFA-Conformer's attention score kernel (`ops.relpos_softmax`, Triton)
     on the main path, run after phase 15: a. the published model (seeded
     random weights, TF32 off) on a full 32-row 10,000-frame bucket through
     EmbeddingExtractor eagerly, every score call of every block (the query
     blocks the model hands the kernel, 384 x 4,997 wide) held within 1e-6
     of `relpos_softmax_reference` on the same inputs; b. the same bucket
     captured and replayed, the kernel's launches counted from 0 around
     each call (the replay's must be one a block and query block), the
     embeddings against 18a's within the cell's 5e-5, the memory peak; c.
     the kernel, its plain version and its byte bound (12 bytes a score)
     timed with CUDA events at the query blocks of the 10,000-, 3,200- and
     400-frame buckets.  Its record is the third of the kernels line.
     Wall seconds against a 60 s budget.
The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}, whose count is the one card the
run used (the script shows its ranks that card alone).  Without a CUDA device the
script exits non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published dense peaks by card: (fp32 FLOP/s outside the tensor cores,
# memory bytes/s, TF32 tensor-core FLOP/s), NVIDIA data sheets.  Matched
# on the device name.
PEAKS = (
    ("H100 PCIe", 51.2e12, 2.0e12, 378e12),
    ("H100 NVL", 60.0e12, 3.9e12, 417.5e12),
    ("H100", 67.0e12, 3.35e12, 495e12),  # SXM
)
TOL = 2e-3  # max abs error of a kernel against its plain version (cepstra)
TRAIN_B, TRAIN_T, TRAIN_K = 64, 200, 16  # bench.py:160-191
TRAIN_STEPS = 300
TRAJ_TOL = 1e-3  # ||p_card - p_cpu|| / ||p_cpu - p_init|| over all parameters after 3 steps
UNSEEN_SPEAKERS = 200
MUON_L2_TOL = 1e-3  # the Muon matrix after one step, card vs CPU (l2 over the step)
# max |card - CPU| of a reverberated copy over the dry signal's RMS: each
# float32 FFT of up to 2^17 points lies within 2e-6 of the float64 result
REVERB_RTOL = 1e-5
SR = 8000
BENCH_B, BENCH_SECS = 16, 100.0


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    """The card's name and power limit, as `nvidia-smi` gives them."""
    import torch

    from sepi_tpu_torch.bench import card_line

    return card_line(torch.device("cuda"))


def peaks(name: str):
    for key, flops, bw, tf32 in PEAKS:
        if key in name:
            return key, flops, bw, tf32
    raise RuntimeError(f"no published peak for {name!r}")


def time_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    """Median of ``iters`` CUDA-event timings of ``fn()`` after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def random_xvector(cfg, seed: int, device):
    """An XVector with weights from a seeded torch.Generator and
    non-trivial batch-norm statistics."""
    import torch

    from sepi_tpu_torch.models import XVector

    model = XVector(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("batchnorm.weight"):
                p.copy_(0.5 + torch.rand(p.shape, generator=g))
            elif name.endswith("batchnorm.bias"):
                continue  # fixed at zero
            elif p.ndim > 1:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=g) / fan_in ** 0.5)
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + 1.5 * torch.rand(buf.shape, generator=g))
    return model.to(device).eval()


def phase_environment():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    key, flops, bw, tf32 = peaks(name)
    log(f"phase 1 environment: torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; card {smi}; device {name!r} x"
        f"{torch.cuda.device_count()}; peaks ({key}) fp32 {flops / 1e12:.1f} TFLOP/s, "
        f"TF32 tensor cores {tf32 / 1e12:.1f} TFLOP/s, "
        f"memory {bw / 1e12:.2f} TB/s; tf32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn {torch.backends.cudnn.allow_tf32}")
    return {"smi": smi, "name": name, "peak_flops": flops, "peak_bw": bw, "peak_tf32": tf32}


def phase_build():
    from sepi_tpu_torch import build

    t0 = time.perf_counter()
    logs = build.build()
    secs = time.perf_counter() - t0
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  {name}: {line.strip()}")
    log(f"phase 2 build: {sorted(logs)} built in {secs:.1f} s")


def _mfcc_inputs(b, lengths, n, seed, device):
    import numpy as np
    import torch

    from sepi_tpu_torch.ops.dither import utt_seeds

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((b, n), generator=g, device=device) * 3000.0
    idx = torch.arange(n, device=device)[None, :]
    lens = torch.as_tensor(np.asarray(lengths, np.int32), device=device)
    x = x * (idx < lens[:, None])
    seeds = torch.as_tensor(utt_seeds([f"bench{i}" for i in range(b)]), device=device)
    return x.contiguous(), lens, seeds


WIDE = dict(sample_rate=16000, num_mel_bins=40, num_ceps=40, low_freq=40.0,
            high_freq=-200.0, use_energy=False)  # hires 16 kHz, two 64-bin passes more


def phase_kernels(env, device="cuda"):
    """The MFCC kernel against its plain version; times; both bounds."""
    import torch

    from sepi_tpu_torch.config import FrontendConfig
    from sepi_tpu_torch.ops import mfcc_cuda
    from sepi_tpu_torch.ops.framing import num_frames

    cfg = FrontendConfig()
    n = int(SR * BENCH_SECS)
    t = int(num_frames(n, cfg))
    x, lens, seeds = _mfcc_inputs(BENCH_B, [n] * BENCH_B, n, 0, device)
    worst = 0.0
    cases = [("bench 16x100s", cfg, x, lens, seeds, t)]
    rn = int(3.0 * SR)
    # 207 samples: every frame a tail frame; 100 and 41: shorter than the tail window
    rx, rl, rs = _mfcc_inputs(5, [rn, int(1.83 * SR), 207, 100, 41], rn, 1, device)
    cases.append(("ragged 3s/1.83s/207/100/41", cfg, rx, rl, rs, int(num_frames(rn, cfg))))
    wide = FrontendConfig(**WIDE)
    wn = 10 * wide.sample_rate
    wx, wl, ws = _mfcc_inputs(4, [wn, int(0.37 * wn), 399, 81], wn, 3, device)
    cases.append(("hires16k 4x10s ragged", wide, wx, wl, ws, int(num_frames(wn, wide))))
    for label, ci, xi, li, si, ti in cases:
        for dithered in (True, False):
            sd = si if dithered else None
            out_k, m_k = mfcc_cuda.mfcc_fused(xi, li, ci, ti, sd)
            out_p, m_p = mfcc_cuda.mfcc_fused_reference(xi, li, ci, ti, sd)
            torch.cuda.synchronize()
            if not torch.equal(m_k, m_p):
                raise AssertionError(f"mfcc {label}: masks differ")
            if not bool(torch.isfinite(out_k).all()):
                raise AssertionError(f"mfcc {label}: non-finite output")
            err = float((out_k - out_p).abs().max())
            log(f"  mfcc {label} dither={dithered}: max abs err {err:.3e} "
                f"(cepstra span {float(out_p.min()):.1f}..{float(out_p.max()):.1f})")
            if not err <= TOL:
                raise AssertionError(f"mfcc {label} dither={dithered}: {err} > {TOL}")
            worst = max(worst, err)

    c = mfcc_cuda._consts(cfg, x.device)
    scratch = torch.empty((BENCH_B, t, cfg.num_ceps), device=x.device)
    mask = torch.empty((BENCH_B, t), dtype=torch.bool, device=x.device)
    ms = time_ms(lambda: mfcc_cuda.mfcc_fused(x, lens, cfg, t, seeds))
    kernel_ms = time_ms(lambda: mfcc_cuda._launch(x, lens, seeds, cfg, t, c, scratch, mask))
    plain_ms = time_ms(lambda: mfcc_cuda.mfcc_fused_reference(x, lens, cfg, t, seeds))
    frames = mfcc_cuda._padded_signal(x, cfg, (t - 1) * cfg.frame_shift + cfg.frame_length)
    frames = frames.unfold(1, cfg.frame_length, cfg.frame_shift).reshape(-1, cfg.frame_length)
    frames = frames.contiguous()
    library_ms = time_ms(lambda: torch.matmul(frames, c.basis))
    km, mel, ceps = c.mel.shape[0], cfg.num_mel_bins, cfg.num_ceps
    flops = 2 * BENCH_B * t * (cfg.frame_length * 2 * km + km * mel + mel * ceps)
    # samples and lengths/seeds read once; cepstra and mask written once
    nbytes = BENCH_B * n * 4 + BENCH_B * t * ceps * 4 + BENCH_B * t + BENCH_B * 8
    t_fp32 = flops / env["peak_flops"] * 1e3
    t_3xtf32 = 3 * flops / env["peak_tf32"] * 1e3
    t_bytes = nbytes / env["peak_bw"] * 1e3
    rec = {
        "name": "mfcc_fused", "route": "cuda",
        "source": "sepi_tpu_torch/csrc/mfcc.cu",
        "replaces": "sepi_tpu/ops/mfcc_pallas.py:105",
        "launches": 0, "max_abs_err": worst,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_3xtf32, t_bytes),
        "bound_by": "operations" if t_3xtf32 >= t_bytes else "bytes",
        "library_ms": library_ms,
        "kernel_only_ms": kernel_ms,
        "bound_fp32_ms": max(t_fp32, t_bytes),
        "bound_bytes_ms": t_bytes,
    }
    log(f"phase 3 kernels: mfcc_fused 16x100s dithered: wrapper {ms:.3f} ms "
        f"(kernel alone {kernel_ms:.3f} ms, one launch), plain {plain_ms:.3f} ms, "
        f"DFT GEMM (torch.matmul) {library_ms:.3f} ms, wrapper/library "
        f"{ms / library_ms:.2f}x; bounds: 3xTF32 operations {t_3xtf32:.3f} ms "
        f"(3 x {flops / 1e9:.2f} GFLOP at {env['peak_tf32'] / 1e12:.0f} TFLOP/s, binds), "
        f"fp32 operations {t_fp32:.3f} ms, bytes {t_bytes:.3f} ms ({nbytes / 1e6:.1f} MB); "
        f"kernel at {100 * t_3xtf32 / kernel_ms:.1f}% of its bound; "
        f"max abs err {worst:.3e} <= {TOL}")
    return rec


def phase_main_path(device="cuda", num_speakers=16, utts_per_speaker=6,
                    model_cfg=None, cpu_check_utts=8):
    """prepare_features_nosil -> extract_and_score -> backend_eval."""
    import numpy as np
    import torch

    from sepi_tpu_torch import graphs
    from sepi_tpu_torch.config import FrontendConfig
    from sepi_tpu_torch.data import make_synthetic_corpus
    from sepi_tpu_torch.models import V2_XVECTOR
    from sepi_tpu_torch.ops import mfcc_cuda
    from sepi_tpu_torch.recipes import backend_eval, extract_and_score, prepare_features_nosil

    if model_cfg is None:
        model_cfg = dataclasses.replace(V2_XVECTOR, num_speakers=5000)
    model = random_xvector(model_cfg, seed=0, device=device)
    corpus = make_synthetic_corpus(num_speakers=num_speakers,
                                   utts_per_speaker=utts_per_speaker, seed=0)
    frontend = FrontendConfig()
    spk2utt = corpus.dataset.spk2utt
    enroll = {s: us[:1] for s, us in spk2utt.items()}

    mfcc_cuda.mfcc_fused.launches = 0
    graphs.reset_counts()
    t0 = time.perf_counter()
    nosil = prepare_features_nosil(corpus.audio, frontend, device=device)
    embs = extract_and_score(model, None, nosil, min_frames=model_cfg.min_frames,
                             device=device)
    result, _ = backend_eval(embs, corpus.dataset, corpus.trials, enroll)
    secs = time.perf_counter() - t0
    launches = mfcc_cuda.mfcc_fused.launches
    problems = []
    graph_counts = _graph_counts(device, "the main path", problems, inference=True)
    if problems:
        raise AssertionError("phase 4: " + "; ".join(problems))

    if len(embs) != len(corpus.audio):
        raise AssertionError(f"{len(embs)} embeddings for {len(corpus.audio)} utterances")
    emb = np.stack([embs[u] for u in sorted(embs)])
    if emb.shape[1] != model_cfg.embed_dim or not np.isfinite(emb).all():
        raise AssertionError(f"embeddings: shape {emb.shape}, finite {np.isfinite(emb).all()}")
    for k, v in result.as_dict().items():
        if not np.isfinite(v):
            raise AssertionError(f"backend_eval {k} = {v}")
    if device != "cpu" and launches <= 0:
        raise AssertionError("the main path never launched the MFCC kernel")

    # the same path on the CPU (plain versions) for part of the corpus
    sub = sorted(corpus.audio)[:cpu_check_utts]
    cpu_model = random_xvector(model_cfg, seed=0, device="cpu")
    nosil_cpu = prepare_features_nosil({u: corpus.audio[u] for u in sub}, frontend,
                                       device="cpu")
    same = [u for u in sub if nosil_cpu[u].shape == nosil[u].shape]
    if len(same) < 0.75 * len(sub):
        raise AssertionError(f"voiced frame counts differ from the CPU run: "
                             f"{len(sub) - len(same)} of {len(sub)}")
    feat_err = max(float(np.abs(nosil_cpu[u] - nosil[u]).max()) for u in same)
    embs_cpu = extract_and_score(cpu_model, None, {u: nosil_cpu[u] for u in same},
                                 min_frames=model_cfg.min_frames, device="cpu")
    emb_rel = max(float(np.abs(embs_cpu[u] - embs[u]).max() / np.abs(embs_cpu[u]).max())
                  for u in same)
    if not (feat_err <= 1e-2 and emb_rel <= 1e-3):
        raise AssertionError(f"device vs CPU: features {feat_err:.3e}, "
                             f"embeddings rel {emb_rel:.3e}")
    r = result.as_dict()
    log(f"phase 4 main path: {len(corpus.audio)} utts -> {len(embs)} embeddings "
        f"{emb.shape} finite, EER {r['eer_pct']:.3f}% minDCF08 {r['min_dcf08']:.4f} "
        f"minDCF10 {r['min_dcf10_x1000'] / 1000:.4f} ({r['num_target']} target / "
        f"{r['num_nontarget']} nontarget trials; random weights) in {secs:.2f} s; "
        f"mfcc_fused launches {launches}; {_fmt_graphs(graph_counts)}; vs CPU on "
        f"{len(same)}/{len(sub)} utts: features max abs {feat_err:.2e}, embeddings max rel "
        f"{emb_rel:.2e}")
    return {"launches": launches, "graphs": graph_counts}


def phase_throughput(env, device="cuda", batch=BENCH_B, secs=BENCH_SECS, iters=5):
    """MFCC -> VAD -> CMVN -> select -> x-vector embedding at the bench shape."""
    import torch

    from sepi_tpu_torch.config import CmvnConfig, FrontendConfig, VadConfig
    from sepi_tpu_torch.models import V2_XVECTOR
    from sepi_tpu_torch.ops import (FeatureExtractor, energy_vad, select_voiced_frames,
                                    sliding_cmvn)

    model = random_xvector(dataclasses.replace(V2_XVECTOR, num_speakers=5000), 1, device)
    fe = FeatureExtractor(FrontendConfig(), device=device)
    n = int(SR * secs)
    x, lens, seeds = _mfcc_inputs(batch, [n] * batch, n, 2, device)
    seeds_np = seeds.cpu().numpy()
    vcfg, ccfg = VadConfig(), CmvnConfig()
    stages = ("mfcc", "vad", "cmvn", "select", "xvector")

    def extract(events=None):
        def mark(i):
            if events is not None:
                events[i].record()
        mark(0)
        feats, mask = fe.mfcc(x, lens, utt_seeds=seeds_np)
        mark(1)
        voiced = energy_vad(feats[..., 0], mask, vcfg)
        mark(2)
        normed = sliding_cmvn(feats, mask, ccfg)
        mark(3)
        sel, sel_mask = select_voiced_frames(normed, voiced)
        mark(4)
        emb = model(sel, frame_mask=sel_mask)["embedding_a"]
        mark(5)
        return emb

    with torch.no_grad():
        for _ in range(2):
            emb = extract()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(emb).all()) or emb.shape != (batch, 512):
            raise AssertionError(f"throughput embeddings: {tuple(emb.shape)}")
        torch.cuda.reset_peak_memory_stats()
        per_stage = {s: [] for s in stages}
        t0 = time.perf_counter()
        for _ in range(iters):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            extract(ev)
            torch.cuda.synchronize()
            for i, s in enumerate(stages):
                per_stage[s].append(ev[i].elapsed_time(ev[i + 1]))
        dt = (time.perf_counter() - t0) / iters
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rate = batch * secs / dt
    split = ", ".join(f"{s} {statistics.median(v):.2f}" for s, v in per_stage.items())
    log(f"phase 5 throughput: {rate:.1f} audio-seconds/s ({dt * 1e3:.2f} ms per "
        f"{batch}x{secs:.0f} s batch, host clock, {iters} iterations) on "
        f"{env['smi']}; stage ms (CUDA events, median): {split}; "
        f"peak memory {peak_gb:.2f} GB")


VITERBI_ATOL = 1e-4  # live delta (reference > -1e29) of the kernel vs its plain version
VITERBI_LIVE = -1e29
VITERBI_REPLACES = "sepi_tpu/align/viterbi_pallas.py:51"
S5_AGREE = 0.995  # share of frames the CPU re-alignment must reproduce


def _viterbi_inputs(b, t, s, t_len, seed, device, ties=False, skip=4):
    """Random emissions and random skip arcs, as tests/test_align.py builds
    them; or a tie-heavy case (integer emissions, equal arc log-probs)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    trans = np.full((b, 3, s), -1e30, np.float32)
    if ties:
        emit = rng.integers(-3, 1, size=(b, t, s)).astype(np.float32)
        trans[:, 0, :] = trans[:, 1, 1:] = trans[:, 2, skip:] = -1.0
    else:
        emit = rng.standard_normal(size=(b, t, s), dtype=np.float32)
        trans[:, 0, :] = np.log(0.6)
        trans[:, 1, 1:] = np.log(0.4)
        trans[:, 2, skip:] = np.where(rng.random((b, s - skip)) < 0.3, np.log(0.2), -1e30)
    return (torch.as_tensor(emit, device=device),
            torch.as_tensor(np.asarray(t_len, np.int32), device=device),
            torch.as_tensor(trans, device=device))


def _viterbi_check(label, emit, t_len, trans, skip=4) -> float:
    """Kernel vs plain version: backpointers equal over every state, live
    delta within VITERBI_ATOL, dead delta equal.  Returns the live max abs error."""
    import torch

    from sepi_tpu_torch.align import viterbi_cuda

    bp, d = viterbi_cuda.viterbi_batch(emit, t_len, trans, skip)
    bp_r, d_r = viterbi_cuda.viterbi_batch_reference(emit, t_len, trans, skip)
    torch.cuda.synchronize()
    if bp.shape != bp_r.shape or not torch.equal(bp, bp_r):
        bad = int((bp != bp_r).sum()) if bp.shape == bp_r.shape else -1
        raise AssertionError(f"viterbi {label}: {bad} backpointers differ")
    live = d_r > VITERBI_LIVE
    err = float((d - d_r)[live].abs().max()) if bool(live.any()) else 0.0
    if not err <= VITERBI_ATOL or not torch.equal(d[~live], d_r[~live]):
        raise AssertionError(f"viterbi {label}: live delta err {err} (limit {VITERBI_ATOL}) "
                             f"or dead delta differs")
    log(f"  viterbi {label}: {tuple(emit.shape)}, bps equal over all "
        f"{bp.numel()} entries ({int((bp == 1).sum())} advance, {int((bp == 2).sum())} skip), "
        f"live delta max abs err {err:.3e} <= {VITERBI_ATOL}")
    return err


def _viterbi_timing(env, emit, t_len, trans, skip=4):
    """Kernel and plain-version times (CUDA events) and the bound of this call."""
    import torch

    from sepi_tpu_torch.align import viterbi_cuda

    b, t, s = emit.shape
    ms = time_ms(lambda: viterbi_cuda.viterbi_batch(emit, t_len, trans, skip))
    plain_ms = time_ms(lambda: viterbi_cuda.viterbi_batch_reference(emit, t_len, trans, skip),
                       iters=3, warmup=1)
    live_steps = int((t_len.to(torch.int64).clamp(1, t) - 1).sum())
    # emissions read once over the live rows (plus emit[b,0,0]), the
    # transitions and lengths once; bps and delta written once
    nbytes = 4 * (live_steps * s + b) + 4 * 3 * b * s + 4 * b + b * (t - 1) * s + 4 * b * s
    ops = 7 * live_steps * s  # 4 adds and 3 compares per state and live step
    t_bytes = nbytes / env["peak_bw"] * 1e3
    t_ops = ops / env["peak_flops"] * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "step_us": 1e3 * ms / max(t - 1, 1),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "live_steps": live_steps}


def phase_viterbi(env, device="cuda"):
    """The Viterbi kernel against its plain version at the reference's
    alignment-benchmark shapes, ragged, tie-heavy, and across the warp
    kernel's layouts (K = 4 with skip 8, S not a multiple of 32, S = 1024)
    and the block kernel (S > 1024); times; bound; per-step microseconds."""
    import numpy as np

    rng = np.random.default_rng(7)
    ragged = [2048, 1500, 777, 2] + rng.integers(1, 2049, size=28).tolist()
    short = [1024, 1, 2] + rng.integers(1, 1025, size=13).tolist()
    cases = {  # label: (inputs, skip, timed)
        "32x1024x256": (_viterbi_inputs(32, 1024, 256, [1024] * 32, 3, device), 4, True),
        "32x1024x512": (_viterbi_inputs(32, 1024, 512, [1024] * 32, 0, device), 4, True),
        # four times the batch: one warp per utterance, so it should cost about the same
        "128x1024x256": (_viterbi_inputs(128, 1024, 256, [1024] * 128, 8, device), 4, True),
        "32x2048x144 ragged": (_viterbi_inputs(32, 2048, 144, ragged, 1, device), 4, True),
        "32x1024x512 tie-heavy": (_viterbi_inputs(32, 1024, 512, [1024] * 32, 2, device,
                                                  ties=True), 4, False),
        "16x1024x128 skip8 ragged": (_viterbi_inputs(16, 1024, 128, short, 4, device,
                                                     skip=8), 8, False),
        "16x1024x1024 skip1 ragged": (_viterbi_inputs(16, 1024, 1024, short, 5, device,
                                                      skip=1), 1, False),
        "16x1024x1100 skip8 ragged": (_viterbi_inputs(16, 1024, 1100, short, 6, device,
                                                      skip=8), 8, False),
    }
    worst = 0.0
    timed = {}
    for label, (args, skip, timeit) in cases.items():
        worst = max(worst, _viterbi_check(label, *args, skip=skip))
        if timeit:
            timed[label] = _viterbi_timing(env, *args, skip=skip)
    split = "; ".join(f"{k}: kernel {v['ms']:.4f} ms ({v['step_us']:.4f} us a step), "
                      f"plain {v['plain_ms']:.3f} ms, bound {v['bound_ms']:.4f} ms "
                      f"({v['bound_by']}, {v['bytes'] / 1e6:.1f} MB)"
                      for k, v in timed.items())
    log(f"phase 3 kernels: viterbi_batch {split}; max abs err {worst:.3e}; library_ms null: "
        f"no single PyTorch call computes a banded Viterbi")
    return {"max_abs_err": worst, "cases": timed}


class _MfccCapture:
    """Every `FeatureExtractor.mfcc` batch of a block, kept with its output,
    whether it ran eagerly or as a replay of a captured frontend (kept
    after each replay, `graphs.on_replay`); `check()` then holds each
    against the plain version.  The frontend graphs kept across calls
    (`pipeline._KEPT`) are let go on entry and on exit, so the block
    captures its own, under its hooks, and none outlives it."""

    def __init__(self):
        from sepi_tpu_torch.ops.features import FeatureExtractor

        self.cls, self.batches = FeatureExtractor, []

    def __enter__(self):
        from sepi_tpu_torch import graphs
        from sepi_tpu_torch.recipes import pipeline

        pipeline._KEPT.clear()
        self.orig, self.replayed = self.cls.mfcc, 0
        cap = self

        def mfcc(fe, samples, lengths=None, max_frames=None, utt_seeds=None):
            feats, mask = cap.orig(fe, samples, lengths, max_frames, utt_seeds)
            args = (samples, lengths, max_frames, utt_seeds, feats, mask)

            def keep(replay=False):
                # a captured batch's tensors are the graph's: copied after each replay
                cap.batches.append((fe,) + tuple(x.clone() if hasattr(x, "clone") else x
                                                 for x in args))
                cap.replayed += replay

            if not graphs.on_replay(lambda: keep(replay=True)):
                keep()
            return feats, mask

        self.cls.mfcc = mfcc
        return self

    def __exit__(self, *exc):
        from sepi_tpu_torch.recipes import pipeline

        self.cls.mfcc = self.orig
        pipeline._KEPT.clear()

    def check(self, problems, label):
        """{num_ceps: (batches, max abs err)} over the captured batches."""
        import torch

        from sepi_tpu_torch.ops import mfcc_cuda

        out = {}
        kernel_wrapper = mfcc_cuda.mfcc_fused
        mfcc_cuda.mfcc_fused = mfcc_cuda.mfcc_fused_reference
        try:
            for fe, x, lens, t_max, seeds, out_k, m_k in self.batches:
                out_p, m_p = self.orig(fe, x, lens, t_max, seeds)
                err = float((out_k - out_p).abs().max())
                if not (torch.equal(m_k, m_p) and bool(torch.isfinite(out_k).all())
                        and err <= TOL):
                    problems.append(f"{label}: mfcc C={fe.cfg.num_ceps} batch "
                                    f"{tuple(x.shape)} max abs err {err}")
                n, e = out.get(fe.cfg.num_ceps, (0, 0.0))
                out[fe.cfg.num_ceps] = (n + 1, max(e, err))
        finally:
            mfcc_cuda.mfcc_fused = kernel_wrapper
        self.batches.clear()
        return out


def phase_s5(env, device="cuda", num_speakers=16, utts_per_speaker=8,
             words_per_utt=(8, 16), cfg=None, cpu_check_utts=8):
    """make_phonetic_corpus -> prepare_features_phonetic -> run_s5 ->
    select_voiced_ali, then the checks against the plain versions."""
    import numpy as np

    from sepi_tpu_torch.align import mono, tied, viterbi_cuda
    from sepi_tpu_torch.config import AlignConfig
    from sepi_tpu_torch.data import make_phonetic_corpus
    from sepi_tpu_torch.ops import mfcc_cuda
    from sepi_tpu_torch.recipes import prepare_features_phonetic, run_s5, select_voiced_ali

    cfg = cfg or AlignConfig(lda_mllt=True, fmllr=True)
    corpus = make_phonetic_corpus(num_speakers=num_speakers, utts_per_speaker=utts_per_speaker,
                                  words_per_utt=words_per_utt, seed=0)
    utt2spk = {u.utt_id: u.spk_id for u in corpus.dataset}

    # keep references to every MFCC batch, to the final re-alignment's
    # inputs and to the largest Viterbi batch, for the checks after the run
    captured = {}
    orig_viterbi, orig_align = mono.viterbi_batch, tied.align_graphs

    def capture_viterbi(emit, t_len, trans, skip=4):
        if "viterbi" not in captured or emit.numel() > captured["viterbi"][0].numel():
            captured["viterbi"] = (emit.clone(), t_len.clone(), trans.clone(), skip)
        return orig_viterbi(emit, t_len, trans, skip)

    def capture_align(model, graphs, features, *args, **kw):
        captured["align"] = (model, graphs, features)
        return orig_align(model, graphs, features, *args, **kw)

    marks = []

    def stage(msg):
        marks.append((time.perf_counter() - t0, msg))
        log(f"  [{marks[-1][0]:8.2f} s] {msg}")

    mono.viterbi_batch, tied.align_graphs = capture_viterbi, capture_align
    try:
        with _MfccCapture() as cap:
            mfcc_cuda.mfcc_fused.launches = 0
            viterbi_cuda.viterbi_batch.launches = 0
            t0 = time.perf_counter()
            feats = prepare_features_phonetic(corpus.audio, device=device)
            stage("[smoke] features done")
            res = run_s5(feats.full, corpus.transcripts, corpus.lexicon, cfg, log=stage,
                         utt2spk=utt2spk, device=device)
            voiced_ali = select_voiced_ali(res.alignments, feats.voiced)
            secs = time.perf_counter() - t0
            launches = {"mfcc_fused": mfcc_cuda.mfcc_fused.launches,
                        "viterbi_batch": viterbi_cuda.viterbi_batch.launches}
    finally:
        mono.viterbi_batch, tied.align_graphs = orig_viterbi, orig_align
    stage("[smoke] run_s5 + select_voiced_ali done")

    frames = {u: f.shape[0] for u, f in feats.full.items()}
    if sorted(res.alignments) != sorted(frames) or sorted(frames) != sorted(corpus.audio):
        raise AssertionError(f"{len(res.alignments)} alignments for {len(frames)} utterances")
    for u, a in res.alignments.items():
        if len(a) != frames[u] or a.min() < 0 or a.max() >= res.num_senones:
            raise AssertionError(f"{u}: {len(a)} labels for {frames[u]} frames, "
                                 f"ids {a.min()}..{a.max()} of {res.num_senones}")
    if sorted(voiced_ali) != sorted(feats.nosil) or any(
            len(voiced_ali[u]) != feats.nosil[u].shape[0] for u in voiced_ali):
        raise AssertionError("select_voiced_ali: labels and nosil features disagree")
    if device != "cpu" and min(launches.values()) <= 0:
        raise AssertionError(f"the s5 path did not launch every kernel: {launches}")

    def at(prefix):
        return next(t for t, m in marks if m.startswith(prefix))

    bounds = [("features", at("[smoke] features")), ("mono EM", at("[tied] collecting")),
              ("tree", at("[s5] tied tree"))]
    if cfg.lda_mllt:
        bounds.append(("LDA+MLLT", [t for t, m in marks if m.startswith("[s5] MLLT")][-1]))
    bounds.append(("refine", at("[s5] alignment shift")))
    if cfg.fmllr:
        bounds += [("fMLLR estimate", at("[s5] fMLLR")), ("SAT re-align", secs)]
    stages, prev = [], 0.0
    for name, t in bounds:
        stages.append(f"{name} {t - prev:.2f}")
        prev = t

    # every MFCC batch of the path against the plain version: the same
    # FeatureExtractor call, with the plain version in the kernel's place
    n_mfcc, shapes, problems = len(cap.batches), sorted({tuple(c[1].shape) for c in cap.batches}), []
    mfcc_err = max(e for _, e in cap.check(problems, "the s5 path").values())
    if problems:
        raise AssertionError("; ".join(problems))
    log(f"  mfcc at the s5 path's {n_mfcc} batches {shapes}: max abs err {mfcc_err:.3e} <= {TOL}")

    # one more alignment pass on the final inputs, timing the host backtrace
    model, graphs, af = captured["align"]
    bt = [0.0]
    orig_bt = mono._backtrace

    def timed_backtrace(*args):
        tb = time.perf_counter()
        out = orig_bt(*args)
        bt[0] += time.perf_counter() - tb
        return out

    mono._backtrace = timed_backtrace
    try:
        tp = time.perf_counter()
        again = mono.align_graphs(model, graphs, af, device=device)
        pass_secs = time.perf_counter() - tp
    finally:
        mono._backtrace = orig_bt
    repeat = sum(int(np.sum(again[u] == res.alignments[u])) for u in again)
    total = sum(frames.values())

    # the reference: the final model and graphs on the CPU, plain versions
    sub = sorted(graphs)[:cpu_check_utts]
    cpu = mono.align_graphs(model, {u: graphs[u] for u in sub}, {u: af[u] for u in sub},
                            device="cpu")
    same = sum(int(np.sum(cpu[u] == res.alignments[u])) for u in sub)
    n_sub = sum(frames[u] for u in sub)
    exact = sum(bool(np.array_equal(cpu[u], res.alignments[u])) for u in sub)
    if same < S5_AGREE * n_sub or repeat < S5_AGREE * total:
        raise AssertionError(f"re-alignment agrees on {same}/{n_sub} frames (CPU), "
                             f"{repeat}/{total} (repeat on {device})")
    t_pads = sorted({mono._bucket_len(n) for n in frames.values()})
    log(f"phase 6 s5 path: {len(frames)} utts ({total} frames, T buckets {t_pads}) -> "
        f"{res.num_senones} senones (budget {cfg.num_leaves}), {len(voiced_ali)} voiced "
        f"label streams; {secs:.2f} s wall (stages: {', '.join(stages)}); launches {launches}; "
        f"shift per refine round {[round(x, 4) for x in res.frames_shifted]}; one alignment "
        f"pass {pass_secs:.3f} s of which host backtrace {bt[0]:.3f} s "
        f"({100 * bt[0] / pass_secs:.1f}%), repeat agrees on {repeat}/{total} frames; "
        f"CPU re-alignment of {len(sub)} utts agrees on {same}/{n_sub} frames "
        f"({100 * same / n_sub:.3f}%), {exact}/{len(sub)} utts frame for frame")

    out = {"launches": launches, "mfcc_err": mfcc_err, "corpus": corpus, "nosil": feats.nosil,
           "ali": voiced_ali, "num_senones": res.num_senones}
    if device != "cpu":
        emit, t_len, trans, skip = captured["viterbi"]
        err = _viterbi_check("s5 batch", emit, t_len, trans, skip)
        timing = _viterbi_timing(env, emit, t_len, trans, skip)
        log(f"  viterbi at the s5 path's largest batch {tuple(emit.shape)}: kernel "
            f"{timing['ms']:.4f} ms ({timing['step_us']:.4f} us a step), plain {timing['plain_ms']:.3f} ms, bound "
            f"{timing['bound_ms']:.4f} ms ({timing['bound_by']}, {timing['bytes'] / 1e6:.1f} MB, "
            f"{timing['live_steps']} live steps x S)")
        out.update(viterbi_err=err, viterbi_shape=list(emit.shape), viterbi_timing=timing)
    return out


def _train_state(model_cfg, device, opt_cfg=None, seed=0, total_steps=1000, dtype="float32"):
    """A seeded (Flax-style) x-vector computing in ``dtype`` and its
    optimizer chain on ``device``."""
    from sepi_tpu_torch.config import OptimizerConfig
    from sepi_tpu_torch.models import XVector, lecun_normal_init
    from sepi_tpu_torch.train import TrainState, build_optimizer

    model = XVector(model_cfg, dtype=dtype)
    lecun_normal_init(model, seed)
    model.to(device)
    chain, _ = build_optimizer(opt_cfg or OptimizerConfig(), total_steps)
    return chain, TrainState(model, chain.init(dict(model.named_parameters())))


def _profile_steps(fn, n=3, top=8):
    """torch.profiler over ``n`` calls of ``fn`` after a warm-up: the top
    kernels by device time (name, ms, calls), the summed device time of all
    kernels and the host wall time of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.device_time / 1e3, c + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return [(name[:60], t, c) for name, (t, c) in ranked], busy_ms, wall_ms


def phase_train_step(env, device="cuda"):
    """7a: step time at the reference's training bench shape."""
    import torch

    from sepi_tpu_torch.models import V2_XVECTOR
    from sepi_tpu_torch.train import make_superstep, make_xvec_step
    from sepi_tpu_torch.train.optim import apply_updates, newton_schulz
    from sepi_tpu_torch.train.trainer import _softmax_xent

    cfg = dataclasses.replace(V2_XVECTOR, num_speakers=5000)
    chain, state = _train_state(cfg, device)
    step, sstep = make_xvec_step(chain), make_superstep(chain)
    g = torch.Generator(device=device).manual_seed(0)
    feats = torch.randn((TRAIN_K, TRAIN_B, TRAIN_T, cfg.feat_dim), generator=g, device=device)
    labels = torch.randint(0, cfg.num_speakers, (TRAIN_K, TRAIN_B), generator=g, device=device,
                           dtype=torch.int32)
    ones = torch.ones(TRAIN_K, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    single_ms = time_ms(lambda: step(state, feats[0], labels[0], 1.0), iters=20, warmup=3)
    super_ms = time_ms(lambda: sstep(state, feats, labels, ones), iters=3, warmup=1) / TRAIN_K
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    m = step(state, feats[1], labels[1], 1.0)
    if not all(bool(torch.isfinite(v)) for v in m.values()):
        raise AssertionError(f"bench-shape step: non-finite metrics {m}")

    params = state.params()

    def fwd_bwd():
        state.model.train()
        loss = _softmax_xent(state.model(feats[0])["logits"], labels[0]).mean()
        return torch.autograd.grad(loss, list(params.values()))

    fb_ms = time_ms(fwd_bwd)
    grads = dict(zip(params, fwd_bwd()))
    opt_ms = time_ms(lambda: apply_updates(params, chain.update(grads, state.opt_state, params)))
    ns_ms = time_ms(lambda: newton_schulz(grads["segment.output.weight"].T))
    torch.backends.cudnn.benchmark = True  # cuDNN's own algorithm search, for comparison
    try:
        fb_bench_ms = time_ms(fwd_bwd)
    finally:
        torch.backends.cudnn.benchmark = False
    top, busy_ms, wall_ms = _profile_steps(lambda: step(state, feats[2], labels[2], 1.0))
    rate = TRAIN_B * TRAIN_T * 0.01 / (single_ms / 1e3)
    log(f"  7a torch.profiler over 3 single steps on {env['smi']}: device busy "
        f"{busy_ms:.3f} ms of {wall_ms:.3f} ms wall ({100 * (1 - busy_ms / wall_ms):.1f}% idle); top kernels "
        f"by device time (ms, calls): " + "; ".join(f"{n} {t:.3f} ({c})" for n, t, c in top))
    log(f"phase 7a train step: full-size V2 x-vector (5000 speakers), {TRAIN_B} x {TRAIN_T} x "
        f"{cfg.feat_dim}, OptimizerConfig() (muon), fp32, TF32 off, on {env['smi']}: "
        f"single step {single_ms:.3f} ms (median of 20, CUDA events), K={TRAIN_K} superstep "
        f"{super_ms:.3f} ms a step (median of 3); {rate:.1f} audio-seconds/s at the single "
        f"step; forward+backward {fb_ms:.3f} ms, optimizer chain {opt_ms:.3f} ms "
        f"({100 * opt_ms / (fb_ms + opt_ms):.1f}% of the two; Newton-Schulz on the 512 x 5000 "
        f"output {ns_ms:.3f} ms); forward+backward with cudnn.benchmark on {fb_bench_ms:.3f} "
        f"ms; peak memory {peak_gb:.2f} GB")
    return {"single_ms": single_ms, "super_ms": super_ms, "fb_ms": fb_ms, "opt_ms": opt_ms,
            "ns_ms": ns_ms, "peak_gb": peak_gb}


def phase_train_path(env, device="cuda", num_speakers=32, utts_per_speaker=8,
                     duration_sec=8.0, num_steps=TRAIN_STEPS, model_cfg=None, train_cfg=None):
    """7b: synthetic corpus -> features -> train_xvector_model ->
    extract_and_score -> backend_eval, against the same path with phase
    4's seeded random weights."""
    import shutil

    import numpy as np
    import torch

    from sepi_tpu_torch.config import TrainConfig
    from sepi_tpu_torch.data import make_synthetic_corpus
    from sepi_tpu_torch.ops import mfcc_cuda
    from sepi_tpu_torch.recipes import (backend_eval, extract_and_score, pipeline,
                                        prepare_features_nosil, train_xvector_model)
    from sepi_tpu_torch.train.checkpoint import latest_checkpoint

    corpus = make_synthetic_corpus(num_speakers=num_speakers, utts_per_speaker=utts_per_speaker,
                                   duration_sec=duration_sec, seed=1)
    unseen = make_synthetic_corpus(num_speakers=UNSEEN_SPEAKERS, utts_per_speaker=2,
                                   duration_sec=2.0, seed=2, name="unseen")
    enroll = {s: us[:1] for s, us in corpus.dataset.spk2utt.items()}
    enroll_u = {s: us[:1] for s, us in unseen.dataset.spk2utt.items()}
    ckpt = os.path.join(ROOT, "build", "smoke_train", "ckpt")
    shutil.rmtree(os.path.dirname(ckpt), ignore_errors=True)
    hist = []
    secs = {}
    orig_finalize = pipeline.finalize_batch_stats

    def timed_finalize(*args, **kw):
        t = time.perf_counter()
        out = orig_finalize(*args, **kw)
        if device != "cpu":
            torch.cuda.synchronize()
        secs["calibration"] = time.perf_counter() - t
        return out

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    mfcc_cuda.mfcc_fused.launches = 0
    pipeline.finalize_batch_stats = timed_finalize
    try:
        t0 = time.perf_counter()
        nosil = prepare_features_nosil(corpus.audio, device=device)
        sync()
        secs["features"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        model, state, label_map = train_xvector_model(
            nosil, corpus.dataset, model_cfg, train_cfg or TrainConfig(), num_steps=num_steps,
            log=lambda n, task, m: hist.append((n, task, m)), checkpoint_dir=ckpt, device=device)
        sync()
        secs["training"] = time.perf_counter() - t0 - secs["calibration"]
        latest = latest_checkpoint(ckpt)
        nosil_u = prepare_features_nosil(unseen.audio, device=device)
        t0 = time.perf_counter()
        embs = extract_and_score(model, None, {**nosil, **nosil_u},
                                 min_frames=model.cfg.min_frames, device=device)
        secs["extraction"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        result, _ = backend_eval(embs, corpus.dataset, corpus.trials, enroll)
        secs["backend"] = time.perf_counter() - t0
        result_u, _ = backend_eval(embs, corpus.dataset, unseen.trials, enroll_u)
        launches = mfcc_cuda.mfcc_fused.launches
    finally:
        pipeline.finalize_batch_stats = orig_finalize
        shutil.rmtree(os.path.dirname(ckpt), ignore_errors=True)

    rand = random_xvector(model.cfg, seed=0, device=device)
    embs_r = extract_and_score(rand, None, {**nosil, **nosil_u}, min_frames=model.cfg.min_frames,
                               device=device)
    result_r, _ = backend_eval(embs_r, corpus.dataset, corpus.trials, enroll)
    result_ur, _ = backend_eval(embs_r, corpus.dataset, unseen.trials, enroll_u)

    lengths = sorted(f.shape[0] for f in nosil.values())
    valid = {}
    for n, task, m in hist:
        if task == "valid:xvec":
            valid.setdefault(n, []).append(m["objf"])
    valid_objf = [(n, float(np.mean(v))) for n, v in sorted(valid.items())]
    values = [v for _, _, m in hist for v in m.values()]
    r, rr = result.as_dict(), result_r.as_dict()
    u, ur = result_u.as_dict(), result_ur.as_dict()
    problems = []
    if device != "cpu" and launches <= 0:
        problems.append("the training path never launched the MFCC kernel")
    if latest != num_steps:
        problems.append(f"latest checkpoint {latest}, expected {num_steps}")
    if len(valid_objf) < 2 or not valid_objf[-1][1] > valid_objf[0][1]:
        problems.append(f"held-out objf did not rise: {valid_objf}")
    if not np.all(np.isfinite(values)) or not all(np.isfinite(v) for v in
                                                  list(r.values()) + list(u.values())):
        problems.append("non-finite metric")
    if not r["eer_pct"] <= rr["eer_pct"]:
        problems.append(f"in-domain: trained EER {r['eer_pct']}% above random-weight "
                        f"{rr['eer_pct']}%")
    train_recs = [(n, m["objf"], m["accuracy"]) for n, task, m in hist if task == "xvec"]
    log(f"phase 7b train path on {env['smi'] if env else device}: {len(corpus.audio)} utts "
        f"({num_speakers} speakers, voiced frames {lengths[0]}..{lengths[-1]}) -> "
        f"{len(label_map)}-speaker V2 x-vector, {num_steps} steps of TrainConfig(); "
        f"mfcc_fused launches {launches}; latest checkpoint {latest}; train (step, objf, acc) "
        f"{[(n, round(o, 4), round(a, 4)) for n, o, a in train_recs]}; held-out objf "
        f"{[(n, round(o, 4)) for n, o in valid_objf]}; in-domain EER {r['eer_pct']:.3f}% "
        f"minDCF08 {r['min_dcf08']:.4f} minDCF10 {r['min_dcf10_x1000'] / 1000:.4f} (random "
        f"weights: EER {rr['eer_pct']:.3f}% minDCF08 {rr['min_dcf08']:.4f}; "
        f"{r['num_target']} target / {r['num_nontarget']} nontarget trials); "
        f"{UNSEEN_SPEAKERS} unseen speakers: EER {u['eer_pct']:.3f}% minDCF08 "
        f"{u['min_dcf08']:.4f} (random weights: EER {ur['eer_pct']:.3f}% minDCF08 "
        f"{ur['min_dcf08']:.4f}; {u['num_target']} target / {u['num_nontarget']} nontarget "
        f"trials); wall s: "
        + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
        + f"; {num_steps / secs['training']:.2f} steps/s")
    if problems:
        raise AssertionError("phase 7b: " + "; ".join(problems))
    return {"launches": launches, "nosil": nosil, "dataset": corpus.dataset, "secs": secs,
            "eer": r["eer_pct"], "eer_random": rr["eer_pct"], "eer_unseen": u["eer_pct"],
            "eer_unseen_random": ur["eer_pct"]}


def _flat(model):
    return {n: p.detach().cpu().double() for n, p in model.named_parameters()}


def _start_grads(model, batch, device):
    """The loss gradient of ``model`` on ``batch`` (train mode), on the
    host, without touching the model's state."""
    import copy

    import torch

    from sepi_tpu_torch.train.trainer import _softmax_xent

    model = copy.deepcopy(model).train()
    params = dict(model.named_parameters())
    loss = _softmax_xent(model(torch.from_numpy(batch.feats).to(device))["logits"],
                         torch.from_numpy(batch.labels).to(device)).mean()
    grads = torch.autograd.grad(loss, list(params.values()))
    return {n: g.detach().cpu().double() for n, g in zip(params, grads)}


def _norm(tensors) -> float:
    import torch

    return float(torch.sqrt(sum(torch.sum(t * t) for t in tensors)))


def phase_train_agreement(env, nosil, dataset, device="cuda", model_cfg=None, batch_size=32):
    """7c: the same weights and batches on the card and on the CPU."""
    import torch

    from sepi_tpu_torch.config import ChunkConfig, OptimizerConfig
    from sepi_tpu_torch.data import ChunkSampler
    from sepi_tpu_torch.models import V2_XVECTOR
    from sepi_tpu_torch.train import make_xvec_step

    label_map = dataset.speaker_label_map()
    cfg = model_cfg or dataclasses.replace(V2_XVECTOR, num_speakers=len(label_map))
    sampler = ChunkSampler(nosil, dataset, ChunkConfig(), batch_size, seed=7)
    batches = [sampler.sample_batch() for _ in range(3)]
    out = {}
    for name, opt, n_steps in (("none", OptimizerConfig(preconditioner="none"), 3),
                               ("muon", OptimizerConfig(), 1)):
        chain_d, state_d = _train_state(cfg, device, opt, seed=3)
        chain_c, state_c = _train_state(cfg, "cpu", opt, seed=3)
        p0 = _flat(state_c.model)
        if name == "muon":  # both gradients at the start: where their signs differ
            grads = {dev: _start_grads(st.model, batches[0], dev)
                     for dev, st in ((device, state_d), ("cpu", state_c))}
        metrics = []
        for b in batches[:n_steps]:
            md = make_xvec_step(chain_d)(state_d, torch.from_numpy(b.feats).to(device),
                                         torch.from_numpy(b.labels).to(device), 1.0)
            mc = make_xvec_step(chain_c)(state_c, torch.from_numpy(b.feats),
                                         torch.from_numpy(b.labels), 1.0)
            metrics.append((float(md["objf"]), float(mc["objf"])))
        pd, pc = _flat(state_d.model), _flat(state_c.model)
        if name == "none":
            err = _traj(pd, pc, p0)
            worst = max((float(torch.linalg.norm(pd[k] - pc[k])
                               / torch.linalg.norm(pc[k] - p0[k])), k) for k in pc)
            ok = err <= TRAJ_TOL
            out[name] = err
            msg = (f"3 momentum-SGD steps: ||p_card - p_cpu|| / ||p_cpu - p_init|| over all "
                   f"parameters {err:.3e} (largest for one parameter {worst[0]:.3e}, {worst[1]})")
        else:
            # Adam's first update is ~1.47 lr g / (|g| + 1e-8): where the two
            # gradients do not agree to 1% (a true gradient of ~0 under
            # rounding noise) or |g| nears Adam's eps, the entry can take
            # any step in [-1.47 lr, 1.47 lr]; everywhere else it must agree.  The
            # Muon matrix is held in l2: Newton-Schulz maps small singular
            # values up by as much as 3.4445^5, so the two gradients' small
            # differences grow there (tests/test_torch_gpu.py holds the
            # chain on identical gradients entry by entry)
            worst, flipped, ambiguous, muon_rel = 0.0, 0, 0, 0.0
            for k in pc:
                gd, gc = grads[device][k], grads["cpu"][k]
                if gc.ndim == 2:
                    muon_rel = float(torch.linalg.norm(pd[k] - pc[k])
                                     / torch.linalg.norm(pc[k] - p0[k]))
                    continue
                stepsz = float((pc[k] - p0[k]).abs().max())
                firm = ((gd - gc).abs() <= 1e-2 * gc.abs()) & (gc.abs() >= 1e-6)
                diff = (pd[k] - pc[k]).abs()
                if bool(firm.any()):
                    worst = max(worst, float(diff[firm].max()) / stepsz)
                ambiguous += int((~firm).sum())
                flipped += int((diff > 1e-3 * stepsz).sum())
            total = sum(v.numel() for k, v in pc.items() if v.ndim != 2)
            ok = worst <= 1e-3 and flipped < 0.01 * total and muon_rel <= MUON_L2_TOL
            out[name] = worst
            out["muon_l2"] = muon_rel
            msg = (f"1 Muon step: Adam entries whose gradients agree to 1% (|g| >= 1e-6) within "
                   f"{worst:.3e} of the step; {ambiguous} of {total} Adam entries with "
                   f"gradients apart by more than 1% or below 1e-6, {flipped} off by more "
                   f"than 1e-3 of the step; the Muon matrix ||p_card - p_cpu|| / "
                   f"||p_cpu - p_init|| {muon_rel:.3e} (limit {MUON_L2_TOL})")
        log(f"  7c {name} on {env['smi'] if env else device}: {msg}; objf card/cpu "
            f"{[(round(a, 6), round(b, 6)) for a, b in metrics]}")
        if not ok:
            raise AssertionError(f"phase 7c {name}: card and CPU disagree: {msg}")
    log(f"phase 7c train card vs CPU on {env['smi'] if env else device}: full-width V2 x-vector "
        f"({len(label_map)} speakers), 3 sampler batches of {batch_size} chunks, seed 3: "
        f"momentum SGD {out['none']:.3e} <= {TRAJ_TOL}; Muon step: Adam entries on "
        f"agreeing gradients {out['muon']:.3e} <= 1e-3, the Muon matrix {out['muon_l2']:.3e} "
        f"<= {MUON_L2_TOL}")
    return out


CV_SPEAKERS, CV_SENONES = 5000, 4000  # 8a: phase 7a's speakers, the tri6a_4k width
AM_B, AM_L = 256, 8  # TrainConfig().am_batch_size, frames_per_eg
CV_AM_STEPS, CV_STEPS = 200, 300
CV_UNSEEN = 50  # unseen speakers x 2 utterances scored beside the in-domain trials


def _cvector(kind, num_speakers, num_senones=CV_SENONES, dtype="float32"):
    """A full-width phonetic model computing in ``dtype`` and its
    optimizer's subtree factors."""
    from sepi_tpu_torch.models import cvector as cv

    am = cv.AmConfig(num_senones=num_senones)
    if kind == "am":
        return cv.AmNet(am, dtype=dtype), None
    if kind == "v3":
        return cv.MultitaskCVector(cv.MultitaskConfig(num_speakers=num_speakers,
                                                      num_senones=num_senones),
                                   dtype=dtype), None
    if kind == "v4":
        return (cv.AdaptedXVector(cv.AdaptedConfig(num_speakers=num_speakers, am=am), dtype=dtype),
                {"am": 0.2})
    return cv.CombinedCVector(cv.CombinedConfig(num_speakers=num_speakers,
                                                num_senones=num_senones, am=am),
                              dtype=dtype), {"am": 0.1}


def _cvector_state(kind, device, num_speakers, opt_cfg=None, seed=0, lr_factors=None,
                   graft_from=None, dtype="float32"):
    """A seeded (Flax-style) phonetic model computing in ``dtype`` on
    ``device``, the AM grafted for v4/v5, and its optimizer chain."""
    from sepi_tpu_torch.config import OptimizerConfig
    from sepi_tpu_torch.models import lecun_normal_init
    from sepi_tpu_torch.train import TrainState, build_optimizer, graft_subtree

    model, factors = _cvector(kind, num_speakers, dtype=dtype)
    lecun_normal_init(model, seed)
    if graft_from is not None:
        graft_subtree(model, graft_from, "am")
    model.to(device)
    chain, _ = build_optimizer(opt_cfg or OptimizerConfig(), 1000,
                               lr_factors=factors if lr_factors is None else lr_factors)
    return chain, TrainState(model, chain.init(dict(model.named_parameters())))


def _cv_steps(kind, chain):
    from sepi_tpu_torch.train import make_am_step, make_xvec_step

    if kind == "am":
        return {"am": make_am_step(chain)}
    if kind == "v4":
        return {"xvec": make_xvec_step(chain)}
    return {"am": make_am_step(chain, {"task": "am"}),
            "xvec": make_xvec_step(chain, {"task": "xvec"})}


def phase_cvector_steps(env, device="cuda"):
    """8a: step times of the AM net and the v3/v4/v5 c-vectors at full
    width (4000 senones, 5000 speakers), default OptimizerConfig (Muon)."""
    import torch

    g = torch.Generator(device=device).manual_seed(0)
    am_ctx, v3_ctx = (13, 7), (7, 7)
    cases = [("am", "am", AM_L + sum(am_ctx)), ("v3", "am", AM_L + sum(v3_ctx)),
             ("v3", "xvec", TRAIN_T), ("v4", "xvec", TRAIN_T), ("v5", "am", AM_L + sum(v3_ctx)),
             ("v5", "xvec", TRAIN_T)]
    torch.cuda.reset_peak_memory_stats()
    out, lines = {}, []
    for kind in ("am", "v3", "v4", "v5"):
        chain, state = _cvector_state(kind, device, CV_SPEAKERS)
        steps = _cv_steps(kind, chain)
        for k, task, t in cases:
            if k != kind:
                continue
            if task == "am":
                b = AM_B
                labels = torch.randint(0, CV_SENONES, (b, AM_L), generator=g, device=device,
                                       dtype=torch.int32)
            else:
                b = TRAIN_B
                labels = torch.randint(0, CV_SPEAKERS, (b,), generator=g, device=device,
                                       dtype=torch.int32)
            feats = torch.randn((b, t, 23), generator=g, device=device)
            step = steps[task]
            ms = time_ms(lambda: step(state, feats, labels, 1.0), iters=20, warmup=3)
            m = step(state, feats, labels, 1.0)
            if not all(bool(torch.isfinite(v)) for v in m.values()):
                raise AssertionError(f"8a {kind} {task}: non-finite metrics {m}")
            top, busy_ms, wall_ms = _profile_steps(lambda: step(state, feats, labels, 1.0),
                                                   top=5)
            frames = b * (AM_L if task == "am" else t)
            rate = frames * 0.01 / (ms / 1e3)
            out[f"{kind} {task}"] = {"ms": ms, "audio_s_per_s": rate,
                                     "idle": 1 - busy_ms / wall_ms}
            lines.append(f"{kind} {task} {b} x {t} x 23: {ms:.3f} ms, {rate:.1f} audio-s/s "
                         f"({'label frames' if task == 'am' else 'chunk frames'}), device idle "
                         f"{100 * (1 - busy_ms / wall_ms):.1f}% under the profiler")
            log(f"  8a {kind} {task} torch.profiler over 3 steps: device busy {busy_ms:.3f} ms "
                f"of {wall_ms:.3f} ms wall; top kernels (ms, calls): "
                + "; ".join(f"{n} {tk:.3f} ({c})" for n, tk, c in top))
        del state, chain
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"phase 8a c-vector steps on {env['smi']}: AmConfig() ({CV_SENONES} senones), "
        f"V3/V4/V5 defaults with {CV_SPEAKERS} speakers, OptimizerConfig() (muon; v4 am x0.2, "
        f"v5 am x0.1), fp32, TF32 off, median of 20 (CUDA events): " + "; ".join(lines)
        + f"; peak memory {peak_gb:.2f} GB")
    return out


def _eer_pair(model, kw, min_frames, feats, corpus, unseen, device):
    """In-domain and unseen-speaker results of one model on the same trials."""
    from sepi_tpu_torch.recipes import backend_eval, extract_and_score

    embs = extract_and_score(model, None, feats, min_frames=min_frames, model_kwargs=kw,
                             device=device)
    enroll = {s: us[:1] for s, us in corpus.dataset.spk2utt.items()}
    enroll_u = {s: us[:1] for s, us in unseen.dataset.spk2utt.items()}
    ind = backend_eval(embs, corpus.dataset, corpus.trials, enroll)[0].as_dict()
    uns = backend_eval(embs, corpus.dataset, unseen.trials, enroll_u)[0].as_dict()
    return ind, uns


def phase_cvector_path(env, s5, device="cuda", train_cfg=None, am_steps=CV_AM_STEPS,
                       num_steps=CV_STEPS, unseen_speakers=CV_UNSEEN, num_senones=CV_SENONES):
    """8b: phase 6's s5 labels -> train_am_model -> v3/v4/v5 trainers ->
    extract_and_score -> backend_eval, each system beside the same model
    with its initial weights."""
    import shutil

    import numpy as np
    import torch

    from sepi_tpu_torch.align import viterbi_cuda
    from sepi_tpu_torch.config import TrainConfig
    from sepi_tpu_torch.data import FrameSampler, make_phonetic_corpus
    from sepi_tpu_torch.models import lecun_normal_init
    from sepi_tpu_torch.models import cvector as cv
    from sepi_tpu_torch.ops import mfcc_cuda
    from sepi_tpu_torch.recipes import (auto_heldout, heldout_split, prepare_features_nosil,
                                        train_adapted_model, train_am_model,
                                        train_combined_model, train_multitask_model)
    from sepi_tpu_torch.train import graft_subtree, make_eval_step
    from sepi_tpu_torch.train.checkpoint import latest_checkpoint

    train_cfg = train_cfg or TrainConfig()
    corpus, nosil, ali, leaves = s5["corpus"], s5["nosil"], s5["ali"], s5["num_senones"]
    ds = corpus.dataset
    n_spk = len(ds.speakers)
    root = os.path.join(ROOT, "build", "smoke_cvector")
    shutil.rmtree(root, ignore_errors=True)
    hist = {k: [] for k in ("am", "v3", "v4", "v5")}
    secs = {}

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    def logger(kind):
        return lambda n, task, m: hist[kind].append((n, task, m))

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        sync()
        secs[name] = time.perf_counter() - t0
        return out

    # the held-out utterances every trainer splits off: the AM never sees them either
    _, valid_ds = heldout_split(ds, auto_heldout(ds, None))
    held = set(valid_ds.utt_ids)
    am_cfg = cv.AmConfig(num_senones=num_senones)
    v3cfg = cv.MultitaskConfig(num_speakers=n_spk, num_senones=num_senones)
    v4cfg = cv.AdaptedConfig(num_speakers=n_spk, am=am_cfg)
    v5cfg = cv.CombinedConfig(num_speakers=n_spk, num_senones=num_senones, am=am_cfg)
    unseen = make_phonetic_corpus(num_speakers=unseen_speakers, utts_per_speaker=2,
                                  words_per_utt=(8, 16), seed=5, spk_prefix="unseen")
    mfcc_cuda.mfcc_fused.launches = 0
    viterbi_cuda.viterbi_batch.launches = 0
    try:
        am_model, am_state = timed("am", lambda: train_am_model(
            {u: f for u, f in nosil.items() if u not in held},
            {u: a for u, a in ali.items() if u not in held}, am_cfg, train_cfg, am_steps,
            log=logger("am"), device=device))
        ckpt = lambda k: os.path.join(root, k, "ckpt")  # noqa: E731
        v3, _ = timed("v3", lambda: train_multitask_model(
            nosil, ali, ds, v3cfg, train_cfg, num_steps, log=logger("v3"),
            checkpoint_dir=ckpt("v3"), device=device))
        v4, _ = timed("v4", lambda: train_adapted_model(
            nosil, ds, am_model, am_state, v4cfg, train_cfg, num_steps, log=logger("v4"),
            checkpoint_dir=ckpt("v4"), device=device))
        v5, _ = timed("v5", lambda: train_combined_model(
            nosil, ali, ds, am_model, am_state, v5cfg, train_cfg, num_steps, log=logger("v5"),
            checkpoint_dir=ckpt("v5"), device=device))
        latest = {k: latest_checkpoint(ckpt(k)) for k in ("v3", "v4", "v5")}
        nosil_u = timed("unseen features", lambda: prepare_features_nosil(unseen.audio,
                                                                          device=device))
        feats = {**nosil, **nosil_u}
        systems = {"v3": (v3, {"task": "xvec"}, sum(v3cfg.xvec_context) + 1),
                   "v4": (v4, None, sum(v4cfg.context) + 1),
                   "v5": (v5, {"task": "xvec"}, sum(v5cfg.xvec_context) + 1)}
        t0 = time.perf_counter()
        results = {k: _eer_pair(m, kw, mf, feats, corpus, unseen, device)
                   for k, (m, kw, mf) in systems.items()}
        secs["extraction + backend"] = time.perf_counter() - t0
        launches = {"mfcc_fused": mfcc_cuda.mfcc_fused.launches,
                    "viterbi_batch": viterbi_cuda.viterbi_batch.launches}
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # the same models with their initial weights (the grafted AM included)
    initial = {}
    for k, (m, kw, mf) in systems.items():
        m0 = type(m)(m.cfg)
        lecun_normal_init(m0, train_cfg.seed)
        if k != "v3":
            graft_subtree(m0, am_model, "am")
        initial[k] = _eer_pair(m0.to(device), kw, mf, feats, corpus, unseen, device)

    # the AM on frames of the held-out utterances
    fs = FrameSampler({u: nosil[u] for u in held}, {u: ali[u] for u in held}, AM_L, AM_B,
                      seed=1, context=am_cfg.context)
    hb = fs.sample_batch()
    am_eval = {k: float(v) for k, v in make_eval_step()(am_state, hb.feats, hb.labels).items()}
    chance = 1.0 / leaves

    problems = []
    values = [v for h in hist.values() for _, _, m in h for v in m.values()]
    values += [v for r in results.values() for d in r for v in d.values()]
    values += list(am_eval.values())
    if not np.all(np.isfinite(values)):
        problems.append("non-finite objective or metric")
    if not am_eval["accuracy"] >= 3 * chance:
        problems.append(f"AM held-out frame accuracy {am_eval['accuracy']:.4f} < 3 x chance "
                        f"{chance:.4f}")
    for k in systems:
        if not results[k][0]["eer_pct"] <= initial[k][0]["eer_pct"]:
            problems.append(f"{k}: in-domain EER {results[k][0]['eer_pct']}% above its initial "
                            f"weights' {initial[k][0]['eer_pct']}%")
    if any(v != num_steps for v in latest.values()):
        problems.append(f"latest checkpoints {latest}, expected {num_steps}")
    for k in ("v3", "v5"):
        if not {"valid:am", "valid:xvec"} <= {t for _, t, _ in hist[k]}:
            problems.append(f"{k}: no held-out record for each task")

    def last(kind, task):
        recs = [m for _, t, m in hist[kind] if t == task]
        return recs[-1] if recs else {}

    valid = "; ".join(
        f"{k} " + ", ".join(f"{t} objf {last(k, 'valid:' + t).get('objf', float('nan')):.4f} "
                            f"acc {last(k, 'valid:' + t).get('accuracy', float('nan')):.4f}"
                            for t in (("am", "xvec") if k != "v4" else ("xvec",)))
        for k in ("v3", "v4", "v5"))
    combine = {k: (round(last(k, "combine").get("objf_last", float("nan")), 4),
                   round(last(k, "combine").get("objf_combined", float("nan")), 4))
               for k in ("v3", "v4", "v5")}
    am_train = last("am", "am")
    eers = "; ".join(
        f"{k} in-domain EER {results[k][0]['eer_pct']:.3f}% minDCF08 "
        f"{results[k][0]['min_dcf08']:.4f} (initial weights {initial[k][0]['eer_pct']:.3f}%), "
        f"unseen EER {results[k][1]['eer_pct']:.3f}% (initial {initial[k][1]['eer_pct']:.3f}%)"
        for k in systems)
    lengths = sorted(f.shape[0] for f in nosil.values())
    log(f"phase 8b c-vector path on {env['smi'] if env else device}: phase 6's {len(nosil)} "
        f"utts ({n_spk} speakers, voiced frames {lengths[0]}..{lengths[-1]}, {leaves} s5 "
        f"leaves) -> AmConfig(num_senones={num_senones}) {am_steps} steps, then V3/V4/V5 "
        f"{num_steps} steps each of TrainConfig() with held-out batches ({len(held)} utts) "
        f"and checkpoints (latest {latest}); launches {launches}; AM train objf "
        f"{am_train.get('objf', float('nan')):.4f} acc {am_train.get('accuracy', float('nan')):.4f}, "
        f"held-out frame accuracy {am_eval['accuracy']:.4f} objf {am_eval['objf']:.4f} "
        f"(chance 1/{leaves} = {chance:.4f}, bound 3x = {3 * chance:.4f}); held-out: {valid}; "
        f"combine objf (last, combined) {combine}; {eers} ({results['v3'][0]['num_target']} "
        f"target / {results['v3'][0]['num_nontarget']} nontarget in-domain trials, "
        f"{results['v3'][1]['num_target']} / {results['v3'][1]['num_nontarget']} unseen); "
        f"wall s: " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    if problems:
        raise AssertionError("phase 8b: " + "; ".join(problems))
    return {"launches": launches, "am_model": am_model, "secs": secs,
            "eer": {k: results[k][0]["eer_pct"] for k in systems},
            "eer_initial": {k: initial[k][0]["eer_pct"] for k in systems}}


def _traj(pd, pc, p0) -> float:
    return _norm([pd[k] - pc[k] for k in pc]) / _norm([pc[k] - p0[k] for k in pc])


def _cv_run(kind, device, n_spk, opt, graft, seq, dtype=None):
    """``seq`` of (task, batch) steps of a seeded phonetic model on
    ``device`` (``dtype`` float64 for a host reference); returns the
    parameters before and after, on the host in float64, and the objfs."""
    import torch

    chain, st = _cvector_state(kind, device, n_spk, opt, seed=3, graft_from=graft)
    if dtype is not None:
        st.model.to(dtype)
        st.opt_state = chain.init(dict(st.model.named_parameters()))
    p0, steps, objf = _flat(st.model), _cv_steps(kind, chain), []
    for task, b in seq:
        f = torch.from_numpy(b.feats).to(device)
        m = steps[task](st, f if dtype is None else f.to(dtype),
                        torch.from_numpy(b.labels).to(device), 1.0)
        objf.append(round(float(m["objf"]), 6))
    return p0, _flat(st.model), objf


def phase_cvector_agreement(env, s5, am_model, device="cuda", xvec_batch=TRAIN_B, am_batch=AM_B,
                            chunk_len=TRAIN_T):
    """8c: the same weights and batches on the card and on the CPU
    (momentum SGD, 3 interleaved steps of v3 and of v5, at the path's batch
    sizes), and a frozen graft (v4, am x0, shrink off, Muon) over 10 steps
    on the card.  On a disagreement a float64 CPU run says which side is off."""
    import copy

    import torch

    from sepi_tpu_torch.config import ChunkConfig, OptimizerConfig
    from sepi_tpu_torch.data import ChunkSampler, FrameSampler

    nosil, ali, ds = s5["nosil"], s5["ali"], s5["corpus"].dataset
    n_spk = len(ds.speakers)
    xs = ChunkSampler(nosil, ds, ChunkConfig(), xvec_batch, seed=7)
    fs = FrameSampler(nosil, ali, AM_L, am_batch, seed=7, context=(7, 7))
    seq = [("am", fs.sample_batch()), ("xvec", xs.sample_batch(chunk_len)),
           ("am", fs.sample_batch())]
    am_cpu = copy.deepcopy(am_model).cpu()
    sgd = OptimizerConfig(preconditioner="none")
    out, msgs = {}, []
    for kind in ("v3", "v5"):
        v5 = kind == "v5"
        _, pd, od = _cv_run(kind, device, n_spk, sgd, am_model if v5 else None, seq)
        p0, pc, oc = _cv_run(kind, "cpu", n_spk, sgd, am_cpu if v5 else None, seq)
        err = _traj(pd, pc, p0)
        sq = {k: float(torch.sum((pd[k] - pc[k]) ** 2)) for k in pc}
        top = sorted(sq, key=sq.get, reverse=True)[:3]
        out[kind] = err
        msg = (f"{kind} am/xvec/am {err:.3e} (largest shares of the difference: "
               + ", ".join(f"{k} {100 * sq[k] / max(sum(sq.values()), 1e-300):.1f}%" for k in top)
               + f"; objf card {od}, cpu {oc})")
        if not err <= TRAJ_TOL:
            _, p64, _ = _cv_run(kind, "cpu", n_spk, sgd, am_cpu if v5 else None, seq,
                                torch.float64)
            raise AssertionError(f"phase 8c: card and CPU apart: {msg}; against a float64 CPU "
                                 f"run: card {_traj(pd, p64, p0):.3e}, CPU {_traj(pc, p64, p0):.3e}")
        msgs.append(msg)
    # a frozen graft stays frozen: am x0, shrink off, the default Muon chain
    frozen = OptimizerConfig(proportional_shrink=0.0)
    chain, st = _cvector_state("v4", device, n_spk, frozen, seed=3, lr_factors={"am": 0.0},
                               graft_from=am_model)
    step = _cv_steps("v4", chain)["xvec"]
    x0 = {n: p.detach().clone() for n, p in st.model.xvec_branch.named_parameters()}
    for _ in range(10):
        b = xs.sample_batch()
        step(st, torch.from_numpy(b.feats).to(device), torch.from_numpy(b.labels).to(device), 1.0)
    src = am_model.state_dict()
    same = all(torch.equal(p, src[n]) for n, p in st.model.am.named_parameters())
    moved = not all(torch.equal(p, x0[n]) for n, p in st.model.xvec_branch.named_parameters())
    if not (same and moved):
        raise AssertionError(f"phase 8c frozen graft: AM unchanged {same}, x-vector branch "
                             f"moved {moved}")
    log(f"phase 8c c-vector card vs CPU on {env['smi'] if env else device}: full-width models "
        f"({n_spk} speakers, {CV_SENONES} senones), seed 3, momentum SGD, batches of {am_batch} "
        f"frame egs and {xvec_batch} chunks of {chunk_len}: ||p_card - p_cpu|| / "
        f"||p_cpu - p_init|| "
        + "; ".join(msgs) + f" (limit {TRAJ_TOL}); v4 with am x0 and shrink off: the grafted AM "
        f"bit-identical to the pretrained one after 10 Muon steps on the card, the x-vector "
        f"branch moved")
    return out


P9_TRAIN, P9_EVAL, P9_ADAPT = (60, 16), (48, 8), (40, 4)  # speakers, utterances per speaker
P9_V2_STEPS, P9_STEPS, P9_AM_STEPS = 400, 300, 200
# the gauntlet's corpus-v2 domain (CI_SCALE_V2): no stationary speaker tilt
P9_CORPUS = dict(words_per_utt=(3, 7), tilt_strength=0.06, f0_jitter=0.12,
                 noise_snr_db=(8.0, 20.0), channel_strength=0.15, long_utt_frac=0.25,
                 phone_seed=11)
# v2's PLDA adaptation re-centres on the in-domain mean only: on this corpus
# the covariance interpolation costs EER at every size (docs/BENCHMARKS.md)
P9_ADAPT_BACKEND = dict(adapt_within_covar_scale=0.0, adapt_between_covar_scale=0.0)


def corpus_v2(train=P9_TRAIN, evaluation=P9_EVAL, adapt=P9_ADAPT):
    """Phases 9 and 10's corpora (speakers, utterances per speaker): train,
    unseen eval with 1-3 enrollment utterances per speaker and the rest as
    tests, and an unlabelled adaptation set."""
    from sepi_tpu_torch.data import make_phonetic_corpus_v2

    trn = make_phonetic_corpus_v2(num_speakers=train[0], utts_per_speaker=train[1], seed=100,
                                  spk_prefix="trn", channel_seed=500, name="p9_train",
                                  **P9_CORPUS)
    evl = make_phonetic_corpus_v2(num_speakers=evaluation[0], utts_per_speaker=evaluation[1],
                                  seed=101, spk_prefix="evl", channel_seed=600,
                                  name="p9_eval", **P9_CORPUS)
    adp = make_phonetic_corpus_v2(num_speakers=adapt[0], utts_per_speaker=adapt[1], seed=102,
                                  spk_prefix="adp", channel_seed=600, name="p9_adapt",
                                  **P9_CORPUS)
    enroll = {s: us[:1 + i % 3] for i, (s, us) in enumerate(sorted(evl.dataset.spk2utt.items()))}
    enrolled = {u for us in enroll.values() for u in us}
    trials = [t for t in evl.trials if t.test not in enrolled]
    return {"train": trn, "eval": evl, "adapt": adp, "enroll": enroll, "trials": trials}


def _p9_augments(trn):
    """Phase 9's augmentation of the training corpus (two synthetic RIRs,
    seeded noise, music and babble), for run_v2 in phases 9 and 11c."""
    import numpy as np

    from sepi_tpu_torch.data.augment import synthetic_rir
    from sepi_tpu_torch.recipes import drivers

    rng = np.random.default_rng(9)
    return drivers.AugmentOptions(
        rirs=[synthetic_rir(seed=3), synthetic_rir(rt60=0.5, seed=4)],
        noises={"noise": [(rng.standard_normal(16000) * 800).astype(np.float32)
                          for _ in range(4)],
                "music": [(rng.standard_normal(24000) * 600).astype(np.float32)
                          for _ in range(4)],
                "babble": [(rng.standard_normal(12000) * 1500).astype(np.float32)
                           for _ in range(8)]},
        subset=len(trn.dataset), seed=1)


class _Tee:
    """stdout that is also kept, to read the drivers' stage lines back."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, s):
        self.lines.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def _graph_counts(device, what, problems, inference=False) -> dict:
    """The graphs' counts since `graphs.reset_counts()` (every graph, and
    the inference graphs alone under ``infer_``), the graphs live now and
    the peak memory since the last reset; a path on the card that replayed
    no graph (with ``inference``, no inference graph) is a problem."""
    import torch

    from sepi_tpu_torch import graphs

    out = dict(graphs.counts, live=graphs.live_graphs(),
               infer_captures=graphs.call_counts["captures"],
               infer_replays=graphs.call_counts["replays"],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9 if device != "cpu" else 0.0)
    if device != "cpu" and out["replays"] <= 0:
        problems.append(f"{what} replayed no captured graph: {out}")
    if device != "cpu" and inference and out["infer_replays"] <= 0:
        problems.append(f"{what} replayed no inference graph: {out}")
    return out


def _fmt_graphs(c) -> str:
    return (f"graphs: {c['captures']} captures, {c['replays']} replays ({c['infer_captures']} "
            f"and {c['infer_replays']} of them inference), {c['live']} graphs live after, "
            f"peak memory {c['peak_gb']:.2f} GB")


def phase_driver_path(env, device="cuda", train=P9_TRAIN, evaluation=P9_EVAL, adapt=P9_ADAPT,
                      v2_steps=P9_V2_STEPS, num_steps=P9_STEPS, am_steps=P9_AM_STEPS,
                      train_cfg=None, configs=None, align_cfg=None, workdir=None,
                      keep_s5=False):
    """Phase 9: the recipe drivers run_v2 (augmentation and PLDA
    adaptation) and run_v3/v4/v5 (the s5 stage inside run_v3, cached for
    v4 and v5) on corpus-v2 audio, each system beside the same model at
    its initial weights on unseen speakers; the drivers' Kaldi-format
    files read back equal to what the run held.  ``configs`` maps a
    driver to narrow model configs for a CPU rehearsal; None keeps each
    driver's default widths.  ``workdir`` (default build/smoke_drivers) is
    emptied first and removed after; with ``keep_s5``, v3's s5 and feature
    stage files move to ``<workdir>_s5`` for phase 11c, which removes it."""
    import contextlib
    import glob
    import shutil

    import numpy as np
    import torch

    from sepi_tpu_torch.align import mono, viterbi_cuda
    from sepi_tpu_torch.config import AlignConfig, BackendConfig, TrainConfig
    from sepi_tpu_torch.data import augment
    from sepi_tpu_torch.metrics.det import compute_det, split_scores_by_trials
    from sepi_tpu_torch.models import lecun_normal_init
    from sepi_tpu_torch.ops import mfcc_cuda
    from sepi_tpu_torch.recipes import drivers, pipeline
    from sepi_tpu_torch.train import graphs
    from sepi_tpu_torch.utils import kaldi_models, read_scp, read_vector

    train_cfg = train_cfg or TrainConfig()
    align_cfg = align_cfg or AlignConfig()
    configs = configs or {}
    root = workdir or os.path.join(ROOT, "build", "smoke_drivers")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    corpus = corpus_v2(train, evaluation, adapt)
    trn, evl, adp = corpus["train"], corpus["eval"], corpus["adapt"]
    enroll, trials = corpus["enroll"], corpus["trials"]
    augments = _p9_augments(trn)
    corpus_secs = time.perf_counter() - t0

    def wd(name):
        return os.path.join(root, name)

    common = dict(train_cfg=train_cfg, device=device)
    phonetic = dict(common, transcripts=trn.transcripts, lexicon=trn.lexicon,
                    align_cfg=align_cfg, num_steps=num_steps)
    runs = {
        "v2": lambda: drivers.run_v2(
            trn.dataset, trn.audio, evl.dataset, evl.audio, trials, enroll, wd("v2"),
            num_steps=v2_steps, augments=augments, adapt_dataset=adp.dataset,
            adapt_audio=adp.audio, backend_cfg=BackendConfig(**P9_ADAPT_BACKEND),
            **configs.get("v2", {}), **common),
        "v3": lambda: drivers.run_v3(trn.dataset, trn.audio, evl.audio, trials, enroll,
                                     wd("v3"), **configs.get("v3", {}), **phonetic),
        "v4": lambda: drivers.run_v4(trn.dataset, trn.audio, evl.audio, trials, enroll,
                                     wd("v4"), am_steps=am_steps, **configs.get("v4", {}),
                                     **phonetic),
        "v5": lambda: drivers.run_v5(trn.dataset, trn.audio, evl.audio, trials, enroll,
                                     wd("v5"), am_steps=am_steps, **configs.get("v5", {}),
                                     **phonetic),
    }

    # what the drivers hand to extraction and to the backend, every MFCC
    # batch, and the largest Viterbi batch of each (T, S, skip)
    calls = {}
    captured = {"viterbi": {}}
    orig_x, orig_b = pipeline.extract_and_score, pipeline.backend_eval
    orig_viterbi = mono.viterbi_batch

    def cap_x(model, state, features, extract_cfg, min_frames, model_kwargs=None, mesh=None,
              device="cuda"):
        out = orig_x(model, state, features, extract_cfg, min_frames, model_kwargs, mesh, device)
        calls[current].setdefault("extract", []).append(
            (model, features, extract_cfg, min_frames, model_kwargs, out))
        return out

    def cap_b(*args, **kw):
        out = orig_b(*args, **kw)
        calls[current]["backend"] = (args, kw, out)
        return out

    def cap_viterbi(emit, t_len, trans, skip=4):
        key = (emit.shape[1], emit.shape[2], skip)
        held = captured["viterbi"].get(key)
        if held is None or emit.shape[0] > held[0].shape[0]:
            captured["viterbi"][key] = (emit.clone(), t_len.clone(), trans.clone(), skip)
        return orig_viterbi(emit, t_len, trans, skip)

    results, wall, tee = {}, {}, _Tee(sys.stdout)
    pipeline.extract_and_score, pipeline.backend_eval = cap_x, cap_b
    mono.viterbi_batch = cap_viterbi
    try:
        mfcc_cuda.mfcc_fused.launches = 0
        viterbi_cuda.viterbi_batch.launches = 0
        graphs.reset_counts()
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        with contextlib.redirect_stdout(tee), _MfccCapture() as cap:
            for current in ("v2", "v3", "v4", "v5"):
                calls[current] = {}
                if current in ("v4", "v5"):  # one s5 run: v3's stage files, content-keyed
                    os.makedirs(wd(current))
                    for f in glob.glob(wd("v3") + "/s5_feats_ali-*") + glob.glob(
                            wd("v3") + "/feats_*"):
                        shutil.copy(f, wd(current))
                tc = time.perf_counter()
                results[current] = runs[current]()
                wall[current] = time.perf_counter() - tc
        launches = {"mfcc_fused": mfcc_cuda.mfcc_fused.launches,
                    "viterbi_batch": viterbi_cuda.viterbi_batch.launches}
    finally:
        pipeline.extract_and_score, pipeline.backend_eval = orig_x, orig_b
        mono.viterbi_batch = orig_viterbi
    out_text = "".join(tee.lines)

    problems = []
    graph_counts = _graph_counts(device, "the driver path", problems, inference=True)
    if device != "cpu" and min(launches.values()) <= 0:
        problems.append(f"the driver path did not launch every kernel: {launches}")
    if out_text.count("[s5_feats_ali] running") != 1 or out_text.count(
            "[s5_feats_ali] cached") != 2:
        problems.append("the s5 stage did not run once in v3 and load from its cache in v4/v5")

    # the MFCC kernel on every corpus-v2 batch the path gave it, against its plain version
    mfcc_shapes = sorted({tuple(c[1].shape) for c in cap.batches})
    n_mfcc = len(cap.batches)
    mfcc_err = max(e for _, e in cap.check(problems, "corpus-v2 batch").values())

    # the Viterbi kernel on the largest batch of each (T, S, skip) of the s5
    # stage: every warp-kernel layout (K) and skip the path ran
    viterbi_err, viterbi_shapes = 0.0, sorted(captured["viterbi"])
    if device != "cpu":
        for (t, s, skip), args in sorted(captured["viterbi"].items()):
            viterbi_err = max(viterbi_err, _viterbi_check(
                f"driver-path batch T={t} S={s} skip {skip}", *args))

    # the reverberation's float32 FFT on the device against the CPU's
    dry = next(iter(trn.audio.values()))
    reverb_err = 0.0
    for rir in augments.rirs:
        wet_d = augment.reverberate(dry, rir, device=device)
        wet_c = augment.reverberate(dry, rir, device="cpu")
        reverb_err = max(reverb_err, float(np.abs(wet_d - wet_c).max() / np.sqrt(
            np.mean(np.square(dry, dtype=np.float64)))))
    if not reverb_err <= REVERB_RTOL:
        problems.append(f"reverberate on {device} vs the CPU: {reverb_err} of the dry RMS")

    # each system at its initial weights: the driver's extraction and backend calls again
    initial, files = {}, {}
    for k, c in calls.items():
        model = c["extract"][0][0]
        m0 = type(model)(model.cfg)
        lecun_normal_init(m0, train_cfg.seed)
        m0 = m0.to(device).eval()
        embs0 = [orig_x(m0, None, f, ec, mf, kw, device=device)
                 for _, f, ec, mf, kw, _ in c["extract"]]
        args, kw, _ = c["backend"]
        if len(embs0) > 1:
            kw = dict(kw, adapt_vectors=np.stack(list(embs0[1].values())))
        initial[k] = orig_b(embs0[0], *args[1:], **kw)[0]

        # the files the driver wrote, read back against what it held
        embs, art = args[0], c["backend"][2][1]
        w = wd(k)
        table = dict(read_scp(os.path.join(w, "xvector.scp")))
        exact = set(table) == set(embs) and all(
            np.array_equal(read_vector(*table[u]), embs[u]) for u in embs)
        plda = kaldi_models.read_plda(os.path.join(w, "backend", "plda"))
        exact &= all(np.array_equal(getattr(plda, f), getattr(art["plda"], f))
                     for f in ("mean", "transform", "psi"))
        exact &= np.array_equal(kaldi_models.read_kaldi_vector_file(
            os.path.join(w, "backend", "mean.vec")), art["mean"])
        exact &= np.array_equal(kaldi_models.read_kaldi_matrix_file(
            os.path.join(w, "backend", "transform.mat")), art["lda"].projection)
        pairs = [(t.model, t.test, t.target) for t in trials if (t.model, t.test) in art["scores"]]
        curve = compute_det(*split_scores_by_trials(art["scores"], pairs))
        det = np.loadtxt(os.path.join(w, "det_pooled.txt"))
        exact &= det.shape == (min(len(curve.p_fa), 2000), 4) and os.path.getsize(
            os.path.join(w, "det_pooled.svg")) > 0
        n_utts = len(embs)
        if not exact:
            problems.append(f"{k}: the written files do not read back equal to the run's")
        files[k] = n_utts

    res = {k: r.pooled for k, r in results.items()}
    values = [v for r in list(res.values()) + list(initial.values()) for v in r.as_dict().values()]
    if not np.all(np.isfinite(values)):
        problems.append("non-finite result")
    if not res["v2"].eer < initial["v2"].eer:
        problems.append(f"v2: unseen-speaker EER {100 * res['v2'].eer:.3f}% not below its "
                        f"initial weights' {100 * initial['v2'].eer:.3f}%")
    systems = "; ".join(
        f"{k} EER {100 * res[k].eer:.3f}% minDCF08 {res[k].min_dcf08:.4f} (initial weights "
        f"{100 * initial[k].eer:.3f}%, {initial[k].min_dcf08:.4f}) in {wall[k]:.2f} s ("
        + ", ".join(f"{s} {v:.2f}" for s, v in results[k].seconds.items()) + f"); {files[k]} "
        f"embeddings" for k in res)
    log(f"phase 9 driver path on {env['smi'] if env else device}: corpus v2 (gauntlet "
        f"CI_SCALE_V2 domain) train {train[0]} speakers x {train[1]} "
        f"({len(trn.audio)} utts), unseen eval {evaluation[0]} x {evaluation[1]}, adapt "
        f"{adapt[0]} x {adapt[1]}, built in {corpus_secs:.2f} s; {res['v2'].num_target} target "
        f"/ {res['v2'].num_nontarget} nontarget unseen-speaker trials (1-3 enrollment utts); "
        f"v2 {v2_steps} steps with {augments.subset} augmented copies and PLDA adaptation "
        f"({P9_ADAPT_BACKEND}), "
        f"v3/v4/v5 {num_steps} steps (AM {am_steps}), "
        f"{'narrow widths' if configs else 'default widths'} and {train_cfg}, s5 ({align_cfg}) "
        f"run once in v3 and loaded from its stage cache by v4/v5; {systems}; launches {launches}; "
        f"{_fmt_graphs(graph_counts)}; "
        f"mfcc on the phase's {n_mfcc} batches {mfcc_shapes} max abs err {mfcc_err:.3e} <= {TOL}; "
        f"viterbi on the largest batch of each (T, S, skip) {viterbi_shapes}: backpointers "
        f"equal, live delta max abs err {viterbi_err:.3e} <= {VITERBI_ATOL}; reverberate on "
        f"{device} vs the CPU {reverb_err:.3e} of the dry RMS <= {REVERB_RTOL}; "
        f"xvector.scp, backend/{{mean.vec,transform.mat,plda}} and det_pooled.{{txt,svg}} "
        f"read back equal (initial weights: each model's initialisation from the trainer's "
        f"seed, no AM graft); wall s: " + ", ".join(f"{k} {v:.2f}" for k, v in wall.items()))
    stage = root + "_s5"
    shutil.rmtree(stage, ignore_errors=True)
    if keep_s5:
        os.makedirs(stage)
        for f in glob.glob(wd("v3") + "/s5_feats_ali-*") + glob.glob(wd("v3") + "/feats_*"):
            shutil.move(f, stage)
    shutil.rmtree(root, ignore_errors=True)
    if problems:
        raise AssertionError("phase 9: " + "; ".join(problems))
    return {"launches": launches, "mfcc_err": mfcc_err, "viterbi_err": viterbi_err,
            "viterbi_shapes": viterbi_shapes, "graphs": graph_counts,
            "eer": {k: r.eer for k, r in res.items()},
            "eer_initial": {k: r.eer for k, r in initial.items()},
            "corpus": corpus, "v2_model": calls["v2"]["extract"][0][0],
            "v2_backend": calls["v2"]["backend"],
            "v3_run": dict(args=(trn.dataset, trn.audio, evl.audio, trials, enroll),
                           kw=dict(configs.get("v3", {}), **phonetic), stage=stage)}


P10_SENONES, P10_NNET2_STEPS = 4000, 300  # Nnet2Config() senones; the reference's default steps
# 10c, the card against the CPU (float32 on both; the sums run in other orders).
# Full-covariance log-likelihoods are held against a float64 evaluation on
# the CPU, each side within kappa_max * 2^-24 of the largest |value|: the
# first-order error of a float32 inverse Cholesky factor of covariances whose
# largest condition number is kappa_max.
V1_POST_ATOL = 1e-3  # gselect posteriors: an ll error of 1e-4 moves a posterior ~1e-4
V1_STATS_RTOL = 1e-3  # E-step statistics, of each array's largest |entry|
V1_IVEC_RTOL = 1e-6  # posterior i-vectors: float64 from equal inputs, cast to float32
V1_FRONTEND_RTOL = 1e-3  # train_v1_frontend end to end at K=64, M=32: UBM and T
V1_COS = 0.999  # i-vectors of the two extractors, per utterance
# nnet2 log-posteriors: float32 logits agree to ~1e-6; TF32 products (10-bit
# mantissas) would move them by ~1e-3
NNET2_LOGPOST_ATOL = 1e-4


class _StepTimes:
    """Wall seconds of the v1 recipe's inner steps (the card synchronised
    around each), by wrapping `recipes.ivector_recipe`'s names."""

    NAMES = ("train_diag_ubm", "train_full_ubm", "full_gmm_from_posteriors",
             "stats_from_features", "train_ivector_extractor", "extract_ivectors")

    def __init__(self, device):
        self.device, self.seconds = device, {}

    def __enter__(self):
        import torch

        from sepi_tpu_torch.recipes import ivector_recipe

        self.mod, self.orig = ivector_recipe, {n: getattr(ivector_recipe, n) for n in self.NAMES}

        def wrap(name, fn):
            def timed(*args, **kw):
                if self.device != "cpu":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                if self.device != "cpu":
                    torch.cuda.synchronize()
                self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
                return out
            return timed

        for n, fn in self.orig.items():
            setattr(self.mod, n, wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.mod, n, fn)

    def __str__(self):
        return ", ".join(f"{k} {v:.2f}" for k, v in self.seconds.items())


def _fmt_mfcc(checked) -> str:
    return ", ".join(f"C={c}: {n} batches max abs err {e:.3e}" for c, (n, e) in sorted(checked.items()))


def _peak_gb(device) -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 1e9 if device != "cpu" else float("nan")


def phase_v1_path(env, corpus, device="cuda", ubm_cfg=None, iv_cfg=None, lda_dim=200):
    """Phase 10a: run_v1, the GMM/i-vector system, at full width
    (`UbmConfig()`, `IvectorConfig()`, LDA 200, phase 9's mean-only PLDA
    adaptation) on phase 9's corpus v2; the same backend on i-vectors of
    `init_extractor`'s random T with the trained UBM must score worse on
    the unseen speakers."""
    import shutil

    import numpy as np
    import torch

    from sepi_tpu_torch.classical.ivector import init_extractor
    from sepi_tpu_torch.config import BackendConfig, IvectorConfig, UbmConfig
    from sepi_tpu_torch.ops import mfcc_cuda
    from sepi_tpu_torch.recipes import drivers, ivector_recipe, pipeline

    ubm_cfg, iv_cfg = ubm_cfg or UbmConfig(), iv_cfg or IvectorConfig()
    trn, evl, adp = corpus["train"], corpus["eval"], corpus["adapt"]
    root = os.path.join(ROOT, "build", "smoke_v1")
    shutil.rmtree(root, ignore_errors=True)
    calls = {"extract": []}
    orig_f, orig_e = ivector_recipe.train_v1_frontend, ivector_recipe.extract_v1_ivectors
    orig_b = pipeline.backend_eval

    def cap_f(*args, **kw):
        calls["frontend"] = orig_f(*args, **kw)
        return calls["frontend"]

    def cap_e(ubm, ext, features, cfg, num_gselect, posteriors=None):
        calls["extract"].append((features, num_gselect, posteriors))
        return orig_e(ubm, ext, features, cfg, num_gselect, posteriors=posteriors)

    def cap_b(*args, **kw):
        calls["backend"] = (args, kw, orig_b(*args, **kw))
        return calls["backend"][2]

    problems = []
    ivector_recipe.train_v1_frontend, ivector_recipe.extract_v1_ivectors = cap_f, cap_e
    pipeline.backend_eval = cap_b
    try:
        with _MfccCapture() as cap, _StepTimes(device) as steps:
            if device != "cpu":
                torch.cuda.reset_peak_memory_stats()
            mfcc_cuda.mfcc_fused.launches = 0
            t0 = time.perf_counter()
            res = drivers.run_v1(trn.dataset, trn.audio, evl.audio, corpus["trials"],
                                 corpus["enroll"], root, ubm_cfg=ubm_cfg, iv_cfg=iv_cfg,
                                 backend_cfg=BackendConfig(lda_dim=lda_dim, **P9_ADAPT_BACKEND),
                                 adapt_audio=adp.audio, device=device)
            wall = time.perf_counter() - t0
            launches = mfcc_cuda.mfcc_fused.launches
            peak = _peak_gb(device)
    finally:
        ivector_recipe.train_v1_frontend, ivector_recipe.extract_v1_ivectors = orig_f, orig_e
        pipeline.backend_eval = orig_b
    mfcc = cap.check(problems, "10a")

    # the same backend on i-vectors of the random T with the trained UBM
    ubm, ext = calls["frontend"]
    t0 = time.perf_counter()
    ext0 = init_extractor(ubm, iv_cfg.ivector_dim, seed=0)
    (f_main, ng, p_main), (f_adapt, _, p_adapt) = calls["extract"]
    iv0 = orig_e(ubm, ext0, f_main, iv_cfg, ng, posteriors=p_main)
    a0 = orig_e(ubm, ext0, f_adapt, iv_cfg, ng, posteriors=p_adapt)
    args, kw, _ = calls["backend"]
    random_t = orig_b(iv0, *args[1:], **dict(kw, adapt_vectors=np.stack(list(a0.values()))))[0]
    random_secs = time.perf_counter() - t0
    r = res.pooled
    if device != "cpu" and launches <= 0:
        problems.append("10a: run_v1 launched no MFCC kernel")
    if not all(np.isfinite(v) for v in list(r.as_dict().values()) + list(
            random_t.as_dict().values())):
        problems.append("10a: non-finite result")
    if not r.eer < random_t.eer:
        problems.append(f"10a: trained-T EER {100 * r.eer:.3f}% not below random-T "
                        f"{100 * random_t.eer:.3f}%")
    feats_train = {u: np.array(f_main[u]) for u in trn.dataset.utt_ids if u in f_main}
    log(f"phase 10a run_v1 (GMM/i-vector) on {env['smi'] if env else device}: "
        f"{ubm_cfg}, {iv_cfg}, LDA {lda_dim}, PLDA adaptation {P9_ADAPT_BACKEND}; corpus v2 "
        f"train {len(trn.audio)} utts ({sum(f.shape[0] for f in feats_train.values())} voiced "
        f"frames), unseen eval {len(evl.audio)}, adapt {len(adp.audio)}; {len(iv0)} i-vectors; "
        f"wall {wall:.2f} s: " + ", ".join(f"{k} {v:.2f}" for k, v in res.seconds.items())
        + f" (inside: {steps}); mfcc launches {launches}; unseen-speaker EER "
        f"{100 * r.eer:.3f}% minDCF08 {r.min_dcf08:.4f} ({r.num_target} target / {r.num_nontarget} nontarget) against "
        f"random T {100 * random_t.eer:.3f}% minDCF08 {random_t.min_dcf08:.4f} (extraction and "
        f"backend {random_secs:.2f} s); peak memory {peak:.2f} GB; {_fmt_mfcc(mfcc)} "
        f"<= {TOL}")
    shutil.rmtree(root, ignore_errors=True)
    if problems:
        raise AssertionError("phase 10a: " + "; ".join(problems))
    return {"launches": launches, "mfcc": mfcc, "ubm": ubm, "ext": ext, "feats": feats_train,
            "eer": r.eer, "eer_random": random_t.eer, "iv_cfg": iv_cfg, "ubm_cfg": ubm_cfg}


def phase_v1_dnn_path(env, corpus, device="cuda", nnet2_cfg=None, num_steps=P10_NNET2_STEPS,
                      train_cfg=None, ubm_cfg=None, iv_cfg=None, lda_dim=200):
    """Phase 10b: the DNN/i-vector variant: paired sid/hires features ->
    `pseudo_senone_alignments(hires, num_senones)` -> `train_nnet2_am`
    (`Nnet2Config()`, the reference's 300 steps and optimizer) ->
    `run_v1(posterior_provider=nnet2_posteriors)`."""
    import functools
    import shutil

    import numpy as np
    import torch

    from sepi_tpu_torch.config import BackendConfig, IvectorConfig, UbmConfig
    from sepi_tpu_torch.models import Nnet2Config
    from sepi_tpu_torch.ops import mfcc_cuda
    from sepi_tpu_torch.recipes import (drivers, nnet2_posteriors, prepare_paired_features,
                                        pseudo_senone_alignments, train_nnet2_am)

    cfg = nnet2_cfg or Nnet2Config()
    ubm_cfg, iv_cfg = ubm_cfg or UbmConfig(), iv_cfg or IvectorConfig()
    trn, evl, adp = corpus["train"], corpus["eval"], corpus["adapt"]
    root = os.path.join(ROOT, "build", "smoke_v1_dnn")
    shutil.rmtree(root, ignore_errors=True)
    logs = []

    def logger(n, task, metrics):
        logs.append((time.perf_counter(), n, task, dict(metrics)))

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    problems = []
    with _MfccCapture() as cap:
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        mfcc_cuda.mfcc_fused.launches = 0
        t = [time.perf_counter()]
        _, hires = prepare_paired_features(trn.audio, device=device)
        sync()
        t.append(time.perf_counter())
        ali = pseudo_senone_alignments(hires, cfg.num_senones, device=device)
        t.append(time.perf_counter())
        model, state = train_nnet2_am(hires, ali, cfg, train_cfg, num_steps=num_steps,
                                      log=logger, device=device)
        sync()
        t.append(time.perf_counter())
        provider = functools.partial(nnet2_posteriors, model, state, device=device)
        with _StepTimes(device) as steps:
            res = drivers.run_v1(trn.dataset, trn.audio, evl.audio, corpus["trials"],
                                 corpus["enroll"], root, ubm_cfg=ubm_cfg, iv_cfg=iv_cfg,
                                 backend_cfg=BackendConfig(lda_dim=lda_dim, **P9_ADAPT_BACKEND),
                                 adapt_audio=adp.audio, posterior_provider=provider,
                                 device=device)
        t.append(time.perf_counter())
        launches = mfcc_cuda.mfcc_fused.launches
        peak = _peak_gb(device)
    mfcc = cap.check(problems, "10b")
    train_logs = [x for x in logs if x[2] == "am"]
    step_ms = (1e3 * (train_logs[-1][0] - train_logs[0][0]) / (train_logs[-1][1] - train_logs[0][1])
               if len(train_logs) > 1 else float("nan"))
    r = res.pooled
    if device != "cpu" and launches <= 0:
        problems.append("10b: the DNN/i-vector path launched no MFCC kernel")
    if not np.all(np.isfinite(list(r.as_dict().values()))):
        problems.append("10b: non-finite result")
    last = train_logs[-1][3] if train_logs else {}
    log(f"phase 10b run_v1 (DNN/i-vector) on {env['smi'] if env else device}: labels "
        f"pseudo_senone_alignments(hires, {cfg.num_senones}) on {len(hires)} utts "
        f"({sum(h.shape[0] for h in hires.values())} frames) in {t[2] - t[1]:.2f} s; "
        f"train_nnet2_am {cfg.pnorm_output_dim * cfg.group_size} -> {cfg.pnorm_output_dim} x "
        f"{len(cfg.specs)} layers, {cfg.num_senones} senones, {num_steps} steps in "
        f"{t[3] - t[2]:.2f} s ({step_ms:.2f} ms a step between logs; last log objf "
        f"{last.get('objf', float('nan')):.4f} accuracy {last.get('accuracy', float('nan')):.4f}, "
        f"chance {1 / cfg.num_senones:.5f}); paired features {t[1] - t[0]:.2f} s; run_v1 "
        f"{t[4] - t[3]:.2f} s: " + ", ".join(f"{k} {v:.2f}" for k, v in res.seconds.items())
        + f" (inside: {steps}); mfcc launches {launches}; unseen-speaker EER {100 * r.eer:.3f}% minDCF08 "
        f"{r.min_dcf08:.4f}; peak memory {peak:.2f} GB; {_fmt_mfcc(mfcc)} <= {TOL}")
    shutil.rmtree(root, ignore_errors=True)
    if problems:
        raise AssertionError("phase 10b: " + "; ".join(problems))
    hires_few = {u: hires[u] for u in sorted(hires)[:4]}
    return {"launches": launches, "mfcc": mfcc, "eer": r.eer, "model": model,
            "hires": hires_few, "step_ms": step_ms}


def _log_gap(p, q) -> float:
    """max |log p - log q| of two posterior arrays."""
    import numpy as np

    return float(np.abs(np.log(np.maximum(p, 1e-30)) - np.log(np.maximum(q, 1e-30))).max())


def _rel_err(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / a.abs().max().clamp(min=1e-30))


def phase_v1_agreement(env, v1, dnn, device="cuda", frames=4096, utts=16, small_k=64, small_m=32,
                       frontend_utts=200):
    """Phase 10c: the card against the CPU, under PyTorch's default TF32
    flags (cuDNN TF32 on): one full-width E-step, `posterior_ivectors` on
    16 utterances at the trained extractor's width, and two entry points
    with TF32 on for both matmuls and cuDNN, held end to end:
    `train_v1_frontend` at K=64, M=32 and `nnet2_posteriors` with 10b's
    model."""
    import copy

    import numpy as np
    import torch

    from sepi_tpu_torch.classical.gmm import accumulate_stats, gselect_posteriors
    from sepi_tpu_torch.classical.ivector import IvectorStats, posterior_ivectors, stats_from_features
    from sepi_tpu_torch.config import IvectorConfig, UbmConfig
    from sepi_tpu_torch.recipes import extract_v1_ivectors, nnet2_posteriors, train_v1_frontend

    ubm, ext, feats = v1["ubm"], v1["ext"], v1["feats"]
    ubm_cfg, iv_cfg = v1["ubm_cfg"], v1["iv_cfg"]
    cpu = torch.device("cpu")
    problems, msgs = [], []
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)

    def hold(label, value, limit, bigger_is_worse=True):
        msgs.append(f"{label} {value:.3e} (limit {limit})")
        if not (value <= limit if bigger_is_worse else value >= limit):
            problems.append(f"{label} {value} against {limit}")

    try:
        # PyTorch's defaults: TF32 off for matmuls, on for cuDNN
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
        names = sorted(feats)
        x = np.concatenate([feats[u] for u in names])[:frames]
        ubm_c = ubm.to(cpu)
        xd, xc = torch.as_tensor(x, device=ubm.means.device), torch.as_tensor(x)
        ll_d, ll_c = ubm.log_likes(xd), ubm_c.log_likes(xc)
        ubm64 = type(ubm_c)(*(a.double() for a in (ubm_c.weights, ubm_c.means, ubm_c.covars)))
        ll64 = ubm64.log_likes(xc.double())
        eig = torch.linalg.eigvalsh(ubm64.covars)
        ll_tol = float((eig[:, -1] / eig[:, 0]).max()) * 2.0 ** -24
        hold("E-step log-likes, card vs float64", _rel_err(ll64, ll_d), ll_tol)
        hold("E-step log-likes, CPU vs float64", _rel_err(ll64, ll_c), ll_tol)
        msgs.append(f"E-step log-likes card vs CPU {_rel_err(ll_c, ll_d):.3e}")
        pd = gselect_posteriors(ubm.log_likes(xd), ubm_cfg.full_gselect, iv_cfg.min_post)
        pc = gselect_posteriors(ubm_c.log_likes(xc), ubm_cfg.full_gselect, iv_cfg.min_post)
        hold("gselect posteriors max abs", float((pd.cpu() - pc).abs().max()), V1_POST_ATOL)
        sd = accumulate_stats(ubm, xd, num_gselect=ubm_cfg.full_gselect, full=True)
        sc = accumulate_stats(ubm_c, xc, num_gselect=ubm_cfg.full_gselect, full=True)
        for f in ("gamma", "first", "second"):
            hold(f"full stats {f}", _rel_err(getattr(sc, f), getattr(sd, f)), V1_STATS_RTOL)
        _, st = stats_from_features(ext, ubm, {u: feats[u] for u in names[:utts]}, iv_cfg,
                                    ubm_cfg.full_gselect)
        wd, cd = posterior_ivectors(ext, st, iv_cfg.posterior_scale)
        wc, cc = posterior_ivectors(ext.to(cpu), IvectorStats(st.n.cpu(), st.f.cpu()),
                                    iv_cfg.posterior_scale)
        hold(f"posterior_ivectors ({utts} utts) mean", _rel_err(wc, wd), V1_IVEC_RTOL)
        hold(f"posterior_ivectors ({utts} utts) cov", _rel_err(cc, cd), V1_IVEC_RTOL)

        # entry points with TF32 turned on for matmuls and cuDNN
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = True, True
        sub = {u: feats[u] for u in names[:frontend_utts]}
        # two T iterations, as the CPU parity tests: T is determined only up to
        # near-flat directions, and each EM iteration carries the rounding on
        k_cfg = UbmConfig(num_gauss=small_k)
        m_cfg = IvectorConfig(ivector_dim=small_m, num_iters=2)
        ubm_d, ext_d = train_v1_frontend(sub, k_cfg, m_cfg, device=device)
        if (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) != (True, True):
            problems.append("train_v1_frontend did not restore the caller's TF32 flags")
        ubm_h, ext_h = train_v1_frontend(sub, k_cfg, m_cfg, device="cpu")
        for f in ("weights", "means", "covars"):
            hold(f"train_v1_frontend UBM {f}", _rel_err(getattr(ubm_h, f), getattr(ubm_d, f)),
                 V1_FRONTEND_RTOL)
        hold("train_v1_frontend T", _rel_err(ext_h.t, ext_d.t), V1_FRONTEND_RTOL)
        iv_d = extract_v1_ivectors(ubm_d, ext_d, sub, m_cfg)
        iv_h = extract_v1_ivectors(ubm_h, ext_h, sub, m_cfg)
        cos = min(float(np.dot(iv_d[u], iv_h[u]) / np.linalg.norm(iv_d[u]) /
                        np.linalg.norm(iv_h[u])) for u in sub)
        hold("train_v1_frontend i-vector cosine min", cos, V1_COS, bigger_is_worse=False)
        model = dnn["model"]
        model_c = copy.deepcopy(model).to(cpu)
        post_d = nnet2_posteriors(model, None, dnn["hires"], device=device)
        post_h = nnet2_posteriors(model_c, None, dnn["hires"], device="cpu")
        hold("nnet2_posteriors log max abs", max(_log_gap(post_d[u], post_h[u])
                                                 for u in post_h), NNET2_LOGPOST_ATOL)
        # the same forward outside the entry point, TF32 on: what the repair prevents
        with torch.no_grad():
            u = sorted(dnn["hires"])[0]
            l, r = model.cfg.context
            h = np.pad(dnn["hires"][u], ((l, r), (0, 0)), mode="edge")[None]
            raw = torch.softmax(model(torch.as_tensor(h, device=device))["logits"], -1)[0]
            tf32_gap = _log_gap(raw.cpu().numpy(), post_h[u])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    log(f"phase 10c v1 card vs CPU on {env['smi'] if env else device}: {frames} frames at "
        f"K={ubm.num_comp}, D={ubm.dim}, gselect {ubm_cfg.full_gselect}, and {utts} utts at "
        f"M={ext.ivector_dim} under PyTorch's default flags (cuDNN TF32 on); train_v1_frontend "
        f"(K={small_k}, M={small_m}, {len(sub)} utts, {k_cfg.num_iters_init}+"
        f"{k_cfg.num_iters_full} UBM and {m_cfg.num_iters} T iterations) and nnet2_posteriors "
        f"({len(dnn['hires'])} utts) with TF32 on for matmuls and cuDNN: " + "; ".join(msgs)
        + f"; the nnet2 forward outside the entry point with TF32 on: log max abs "
        f"{tf32_gap:.3e} (not held)")
    if problems:
        raise AssertionError("phase 10c: " + "; ".join(problems))

# 11: bf16 compute and the on-device backend.  bf16 keeps 8 bits of
# mantissa: unit roundoff u = 2^-8.  The card and the CPU round the same
# bf16 products at different places (cuDNN's and oneDNN's accumulation
# order, a fused bias), so an entry may differ by an ulp and the difference
# carries through the layers above.
BF16_U = 2.0 ** -8
BF16_OUT_TOL = 4 * BF16_U  # 11b: max |card - CPU| of the embedding / logits over the CPU's max
# 11b's parameter gate: ||p_card - p_cpu|| / ||p_cpu - p_init|| after 3
# momentum-SGD steps, the proportional shrink off so that the change is the
# gradients' alone.  bf16 moves a weight gradient far more than u: at the
# random initialisation it is a sum that mostly cancels, and two correct bf16
# runs (cuDNN's and oneDNN's) part by 7e-2 of the update at 16 chunks of 5000
# speakers (tools/bf16_probe.py).  Batches of 256 chunks from 16 speakers add
# up coherent gradients, so the rounding falls to a few percent of them.  The
# limit sits between that reading and a planted card fault's, the card's
# gradients scaled by 0.9, which 11b runs too and must read above it.
BF16_TRAJ_TOL = 16 * BF16_U
P11B_BATCH, P11B_SPEAKERS, P11B_FAULT = 256, 16, 0.9
P11_BUDGET_S = 60.0  # phase 11's wall, reported against this budget
PLDA_DIM, PLDA_MODELS, PLDA_TESTS = 150, 4096, 4096  # bench.py:246-267
PLDA_RTOL = 1e-3  # tests/test_backend_device.py:50: atol 1e-3 x scale, rtol 1e-3
STREAM_FRAMES, STREAM_CHUNK = 60000, 10000  # a 10-minute stream
STREAM_TOL = 2e-3  # tests/test_e2e.py:117-138


def _rate(frames, ms) -> float:
    return frames * 0.01 / (ms / 1e3)


def phase_bf16_steps(env, fp32_v2, fp32_cv, device="cuda"):
    """11a: bf16 step times at the reference bench's shapes, beside the
    same run's float32 ones (phases 7a and 8a)."""
    import torch

    from sepi_tpu_torch.models import V2_XVECTOR, compute_dtype
    from sepi_tpu_torch.train import make_superstep, make_xvec_step

    g = torch.Generator(device=device).manual_seed(0)
    out, lines = {}, []

    def measure(name, fn, frames, per_call, iters, warmup, fp32_ms):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(fn, iters=iters, warmup=warmup) / per_call
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        top, busy_ms, wall_ms = _profile_steps(fn, n=1 if per_call > 1 else 3, top=5)
        idle = 1 - busy_ms / wall_ms
        out[name] = {"ms": ms, "fp32_ms": fp32_ms, "audio_s_per_s": _rate(frames, ms),
                     "idle": idle, "peak_gb": peak_gb}
        lines.append(f"{name} {ms:.3f} ms ({_rate(frames, ms):.1f} audio-s/s; fp32 "
                     f"{fp32_ms:.3f} ms, {fp32_ms / ms:.2f}x), idle {100 * idle:.1f}%, peak "
                     f"{peak_gb:.2f} GB")
        log(f"  11a {name} torch.profiler: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms "
            f"wall; top kernels (ms, calls): "
            + "; ".join(f"{n} {t:.3f} ({c})" for n, t, c in top))

    cfg = dataclasses.replace(V2_XVECTOR, num_speakers=CV_SPEAKERS)
    chain, state = _train_state(cfg, device, dtype="bfloat16")
    step, sstep = make_xvec_step(chain), make_superstep(chain)
    feats = torch.randn((TRAIN_K, TRAIN_B, TRAIN_T, cfg.feat_dim), generator=g, device=device)
    labels = torch.randint(0, cfg.num_speakers, (TRAIN_K, TRAIN_B), generator=g, device=device,
                           dtype=torch.int32)
    ones = torch.ones(TRAIN_K, device=device)
    frames = TRAIN_B * TRAIN_T
    measure("V2 step", lambda: step(state, feats[0], labels[0], 1.0), frames, 1, 20, 3,
            fp32_v2["single_ms"])
    measure(f"V2 K={TRAIN_K} superstep", lambda: sstep(state, feats, labels, ones), frames,
            TRAIN_K, 3, 1, fp32_v2["super_ms"])
    m = step(state, feats[1], labels[1], 1.0)
    bad = [k for k, v in m.items() if not bool(torch.isfinite(v))]
    if compute_dtype(state.model) != torch.bfloat16 or any(
            p.dtype != torch.float32 for p in state.model.parameters()) or bad:
        raise AssertionError(f"11a V2: non-finite {bad} or parameters not float32")
    del state, chain, feats

    chain, state = _cvector_state("v5", device, CV_SPEAKERS, dtype="bfloat16")
    steps = _cv_steps("v5", chain)
    for task, b, t in (("am", AM_B, AM_L + 14), ("xvec", TRAIN_B, TRAIN_T)):
        n_cls, lab_shape = (CV_SENONES, (b, AM_L)) if task == "am" else (CV_SPEAKERS, (b,))
        f = torch.randn((b, t, 23), generator=g, device=device)
        lab = torch.randint(0, n_cls, lab_shape, generator=g, device=device, dtype=torch.int32)
        st = steps[task]
        measure(f"v5 {task}", lambda: st(state, f, lab, 1.0),
                b * (AM_L if task == "am" else t), 1, 20, 3, fp32_cv[f"v5 {task}"]["ms"])
        m = st(state, f, lab, 1.0)
        if not all(bool(torch.isfinite(v)) for v in m.values()):
            raise AssertionError(f"11a v5 {task}: non-finite metrics {m}")
    del state, chain
    log(f"phase 11a bf16 steps on {env['smi']}: full-size V2 x-vector ({CV_SPEAKERS} speakers, "
        f"{TRAIN_B} x {TRAIN_T} x 23) and v5 CombinedConfig() ({CV_SPEAKERS} speakers, "
        f"{CV_SENONES} senones; am {AM_B} x {AM_L} label frames, xvec {TRAIN_B} x {TRAIN_T}), "
        f"compute_dtype bfloat16 (parameters, batch norm and logits float32), "
        f"OptimizerConfig() (muon), CUDA-event medians (single steps of 20, supersteps of 3; "
        f"fp32 from 7a/8a of this run): " + "; ".join(lines))
    return out


def p11b_batches(cfg, batch=P11B_BATCH, speakers=P11B_SPEAKERS):
    """11b's three batches of ``batch`` chunks, labels drawn from
    ``speakers`` speakers (0, or more than the model has: from all)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(11)
    pool = (rng.choice(cfg.num_speakers, size=speakers, replace=False)
            if 0 < speakers < cfg.num_speakers else None)
    out = []
    for _ in range(3):
        labels = (rng.integers(0, cfg.num_speakers, size=batch) if pool is None
                  else rng.choice(pool, size=batch)).astype(np.int32)
        offsets = rng.normal(size=(cfg.num_speakers // 100 + 1, cfg.feat_dim)) * 1.5
        feats = rng.normal(size=(batch, TRAIN_T, cfg.feat_dim)) + offsets[labels // 100][:, None]
        out.append((torch.from_numpy(feats.astype(np.float32)), torch.from_numpy(labels)))
    return out


def p11b_run(cfg, device, dtype, batches, weight=1.0, hold=None, shrink=0.0):
    """3 momentum-SGD steps of a seeded x-vector on ``batches``; ``weight``
    scales every gradient (1.0: none), ``hold`` names a parameter put back
    after each step.  Returns the state and the initial parameters."""
    from sepi_tpu_torch.config import OptimizerConfig
    from sepi_tpu_torch.train import make_xvec_step

    opt = OptimizerConfig(preconditioner="none", proportional_shrink=shrink)
    chain, st = _train_state(cfg, device, opt, seed=3, dtype=dtype)
    p0 = _flat(st.model)
    step, objf = make_xvec_step(chain), []
    for f, lab in batches:
        param = dict(st.model.named_parameters()).get(hold)
        kept = None if param is None else param.detach().clone()
        objf.append(round(float(step(st, f.to(device), lab.to(device), weight)["objf"]), 5))
        if param is not None:
            param.data.copy_(kept)
    return st, p0, objf


def phase_bf16_agreement(env, device="cuda", batch=P11B_BATCH, model_cfg=None):
    """11b: the full-width V2 x-vector (``model_cfg`` narrows it for a CPU
    rehearsal) in bf16 on the card and on the CPU from the same weights
    and batches: one eval-mode forward, then 3 momentum-SGD steps, and the
    same steps on the card with a planted fault (gradients x 0.9)."""
    import torch

    from sepi_tpu_torch.models import V2_XVECTOR

    cfg = model_cfg or dataclasses.replace(V2_XVECTOR, num_speakers=CV_SPEAKERS)
    batches = p11b_batches(cfg, batch)
    t0 = time.perf_counter()
    with torch.no_grad():  # the forward from the initial weights
        od = _train_state(cfg, device, seed=3, dtype="bfloat16")[1].model.eval()(
            batches[0][0].to(device))
        oc = _train_state(cfg, "cpu", seed=3, dtype="bfloat16")[1].model.eval()(batches[0][0])
    sd, p0, objf_d = p11b_run(cfg, device, "bfloat16", batches)
    sc, _, objf_c = p11b_run(cfg, "cpu", "bfloat16", batches)
    sf = p11b_run(cfg, device, "bfloat16", batches, weight=P11B_FAULT)[0]
    errs = {}
    for key in ("embedding_a", "logits"):
        if od[key].dtype != oc[key].dtype:
            raise AssertionError(f"11b {key}: card {od[key].dtype}, CPU {oc[key].dtype}")
        c = oc[key].float()
        errs[key] = float((od[key].float().cpu() - c).abs().max() / c.abs().max())
    pc = _flat(sc.model)
    errs["parameters"] = _traj(_flat(sd.model), pc, p0)
    errs["fault"] = _traj(_flat(sf.model), pc, p0)
    secs = time.perf_counter() - t0
    ok = (errs["embedding_a"] <= BF16_OUT_TOL and errs["logits"] <= BF16_OUT_TOL
          and errs["parameters"] <= BF16_TRAJ_TOL < errs["fault"]
          and all(p.dtype == torch.float32 for p in sd.model.parameters()))
    msg = (f"embedding_a (bf16) {errs['embedding_a']:.3e}, logits (float32) "
           f"{errs['logits']:.3e} of the CPU's max (limit {BF16_OUT_TOL:.4e} = 4 u, u = 2^-8); "
           f"after 3 momentum-SGD steps (shrink off) ||p_card - p_cpu|| / ||p_cpu - p_init|| "
           f"{errs['parameters']:.3e} (limit {BF16_TRAJ_TOL:.4e} = 16 u), the planted fault "
           f"(card gradients x {P11B_FAULT}) {errs['fault']:.3e} (must exceed the limit); "
           f"objf card {objf_d}, CPU {objf_c}")
    log(f"phase 11b bf16 card vs CPU on {env['smi'] if env else device}: "
        f"{'full-width V2' if model_cfg is None else 'narrow'} x-vector ({cfg.num_speakers} "
        f"speakers), {batch} x {TRAIN_T} x 23 from {P11B_SPEAKERS} speakers, seed 3: {msg}; "
        f"{secs:.1f} s")
    if not ok:
        raise AssertionError(f"phase 11b: card and CPU disagree in bf16: {msg}")
    return errs


def phase_bf16_driver(env, drv, device="cuda", v2_steps=P9_V2_STEPS, train_cfg=None,
                      configs=None, workdir=None):
    """11c: run_v2 with phase 9's TrainConfig in bf16 (``compute_dtype=
    "bfloat16"``) on phase 9's corpus v2 and settings; its unseen-speaker
    EER beside phase 9's float32 one and below the initial weights'
    (phase 9's gate).  Then run_v3 in bf16 with phase 9's settings from
    phase 9's s5 stage files (``keep_s5``; the Viterbi kernel does not run
    again), its EER below its initial weights'.  ``train_cfg`` and
    ``configs`` (run_v2's model_cfg) are phase 9's for a CPU rehearsal;
    ``workdir`` (default build/smoke_bf16) is emptied first and removed
    after."""
    import contextlib
    import glob
    import io
    import shutil

    import torch

    from sepi_tpu_torch.config import BackendConfig, TrainConfig
    from sepi_tpu_torch.models import compute_dtype
    from sepi_tpu_torch.ops import mfcc_cuda
    from sepi_tpu_torch.recipes import drivers, pipeline
    from sepi_tpu_torch.train import graphs

    corpus = drv["corpus"]
    trn, evl, adp = corpus["train"], corpus["eval"], corpus["adapt"]
    wd = os.path.join(workdir or os.path.join(ROOT, "build", "smoke_bf16"), "v2")
    shutil.rmtree(os.path.dirname(wd), ignore_errors=True)
    dtypes = []
    orig_x = pipeline.extract_and_score

    def cap_x(model, *args, **kw):
        dtypes.append(compute_dtype(model))
        return orig_x(model, *args, **kw)

    problems = []
    bf16 = (train_cfg or TrainConfig()).replace(compute_dtype="bfloat16")
    v3 = drv["v3_run"]
    wd3 = os.path.join(os.path.dirname(wd), "v3")
    os.makedirs(wd3)
    for f in glob.glob(v3["stage"] + "/*"):
        shutil.copy(f, wd3)
    text = io.StringIO()
    pipeline.extract_and_score = cap_x
    try:
        mfcc_cuda.mfcc_fused.launches = 0
        graphs.reset_counts()
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        with contextlib.redirect_stdout(text), _MfccCapture() as cap:
            t0 = time.perf_counter()
            res = drivers.run_v2(
                trn.dataset, trn.audio, evl.dataset, evl.audio, corpus["trials"],
                corpus["enroll"], wd, num_steps=v2_steps, augments=_p9_augments(trn),
                adapt_dataset=adp.dataset, adapt_audio=adp.audio,
                backend_cfg=BackendConfig(**P9_ADAPT_BACKEND), train_cfg=bf16,
                device=device, **(configs or {}))
            wall = time.perf_counter() - t0
            res3 = drivers.run_v3(*v3["args"], wd3, **dict(v3["kw"], train_cfg=bf16))
            wall3 = time.perf_counter() - t0 - wall
        launches = mfcc_cuda.mfcc_fused.launches
    finally:
        pipeline.extract_and_score = orig_x
        shutil.rmtree(os.path.dirname(wd), ignore_errors=True)
        shutil.rmtree(v3["stage"], ignore_errors=True)
    out = text.getvalue()
    graph_counts = _graph_counts(device, "the bf16 driver path", problems)
    if out.count("[s5_feats_ali] cached") != 1 or "[s5_feats_ali] running" in out:
        problems.append("bf16 run_v3 did not load phase 9's s5 stage from its cache")
    if device != "cpu" and launches <= 0:
        problems.append("the bf16 driver path never launched the MFCC kernel")
    n_mfcc = len(cap.batches)
    mfcc_err = max(e for _, e in cap.check(problems, "bf16 driver batch").values())
    if not dtypes or any(d != torch.bfloat16 for d in dtypes):
        problems.append(f"extraction ran models of dtype {dtypes}, not bfloat16")
    r = res.pooled
    eer, eer32, eer0 = 100 * r.eer, 100 * drv["eer"]["v2"], 100 * drv["eer_initial"]["v2"]
    if not r.eer < drv["eer_initial"]["v2"]:
        problems.append(f"bf16 v2 unseen-speaker EER {eer:.3f}% not below the initial "
                        f"weights' {eer0:.3f}%")
    r3 = res3.pooled
    eer3, eer3_32, eer3_0 = (100 * r3.eer, 100 * drv["eer"]["v3"],
                             100 * drv["eer_initial"]["v3"])
    if not r3.eer < drv["eer_initial"]["v3"]:
        problems.append(f"bf16 v3 unseen-speaker EER {eer3:.3f}% not below the initial "
                        f"weights' {eer3_0:.3f}%")
    log(f"phase 11c run_v2 in bf16 on {env['smi'] if env else device}: phase 9's corpus v2 and "
        f"settings ({v2_steps} steps, augmentation, mean-only PLDA adaptation), "
        f"TrainConfig(compute_dtype='bfloat16'): unseen-speaker EER {eer:.3f}% minDCF08 "
        f"{r.min_dcf08:.4f} (phase 9 float32 {eer32:.3f}%, initial weights {eer0:.3f}%; "
        f"{r.num_target} target / {r.num_nontarget} nontarget) in {wall:.2f} s ("
        + ", ".join(f"{k} {v:.2f}" for k, v in res.seconds.items())
        + f"); run_v3 in bf16 from phase 9's s5 stage: EER {eer3:.3f}% minDCF08 "
        f"{r3.min_dcf08:.4f} (phase 9 float32 {eer3_32:.3f}%, initial weights {eer3_0:.3f}%) "
        f"in {wall3:.2f} s (" + ", ".join(f"{k} {v:.2f}" for k, v in res3.seconds.items())
        + f"); extraction dtypes {sorted({str(d) for d in dtypes})}; mfcc_fused launches "
        f"{launches}, {n_mfcc} batches max abs err {mfcc_err:.3e} <= {TOL}; "
        f"{_fmt_graphs(graph_counts)}")
    if problems:
        raise AssertionError("phase 11c: " + "; ".join(problems))
    return {"launches": launches, "mfcc_err": mfcc_err, "eer": r.eer, "eer_v3": r3.eer,
            "wall": wall, "wall_v3": wall3, "graphs": graph_counts}


def phase_device_backend(env, drv, device="cuda", dims=(PLDA_DIM, PLDA_MODELS, PLDA_TESTS),
                         stream=(STREAM_FRAMES, STREAM_CHUNK)):
    """11d: the on-device backend.  The trial matrix at the bench's shape
    against float64; LDA and PLDA training on phase 9's embeddings against
    the host's; backend_eval with device_scoring=True against phase 9's
    host scoring; streaming_embed on a long stream against
    whole-utterance pooling."""
    import numpy as np
    import torch

    from sepi_tpu_torch.backend import (Plda, compute_lda, compute_lda_device,
                                        length_normalize, plda_score_matrix,
                                        plda_score_matrix_device, subtract_global_mean,
                                        train_plda, train_plda_device)
    from sepi_tpu_torch.config import ExtractConfig
    from sepi_tpu_torch.extract import streaming_embed
    from sepi_tpu_torch.recipes import backend_eval, extract_and_score

    problems, parts = [], []

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    # the (M, N) trial matrix at bench.py's shape and synthetic PLDA
    dim, n_models, n_tests = dims
    rng = np.random.default_rng(0)
    q = np.linalg.qr(rng.normal(size=(dim, dim)))[0]
    plda = Plda(mean=rng.normal(size=dim), transform=q, psi=rng.uniform(0.1, 5.0, dim))
    models = rng.normal(size=(n_models, dim)).astype(np.float32)
    tests = rng.normal(size=(n_tests, dim)).astype(np.float32)
    md, td = (torch.from_numpy(a).to(device) for a in (models, tests))
    got = plda_score_matrix_device(plda, md, td, device=device).cpu().numpy()
    t0 = time.perf_counter()
    want = plda_score_matrix(plda, models, tests)
    host_s = time.perf_counter() - t0
    scale = float(np.abs(want).max())
    err = float(np.max(np.abs(got - want) - PLDA_RTOL * np.abs(want)) / scale)
    if not err <= PLDA_RTOL:
        problems.append(f"device trial matrix off float64 by {err:.3e} of the scale")
    if device != "cpu":
        ms = time_ms(lambda: plda_score_matrix_device(plda, md, td, device=device))
        gflop = 2 * 2 * n_models * n_tests * dim / 1e9
        mbytes = 4 * (n_models * dim + n_tests * dim + n_models * n_tests) / 1e6
        bound = max(gflop * 1e9 / env["peak_flops"], mbytes * 1e6 / env["peak_bw"]) * 1e3
        parts.append(f"plda_score_matrix_device {n_models} x {n_tests} x {dim}: {ms:.3f} ms "
                     f"(median of 10, CUDA events), {n_models * n_tests / (ms / 1e3):.4e} "
                     f"trials/s; bound {bound:.3f} ms (fp32 operations, {gflop:.2f} GFLOP; "
                     f"bytes {mbytes:.1f} MB); float64 host plda_score_matrix {host_s:.3f} s; "
                     f"|card - float64| - {PLDA_RTOL} |float64| at most {err:.3e} of the scale "
                     f"{scale:.1f} (limit {PLDA_RTOL})")

    # LDA and PLDA training on phase 9's v2 embeddings, as backend_eval feeds them
    args, kw, (host_res, host_art) = drv["v2_backend"]
    embs, train_ds, bcfg = args[0], args[1], args[4]
    ids = [u for u in train_ds.utt_ids if u in embs]
    x = np.stack([embs[u] for u in ids])
    labels = [train_ds[u].spk_id for u in ids]
    centered, _ = subtract_global_mean(x)
    lda_dim = min(bcfg.lda_dim, x.shape[1] - 1, len(set(labels)) - 1)
    # the leading directions, held row by row (later ones may be near-degenerate)
    top = min(10, lda_dim)
    t0 = time.perf_counter()
    lda_h = compute_lda(centered, labels, top)
    lda_host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lda_d = compute_lda_device(centered, labels, top, device=device)
    lda_dev_s = time.perf_counter() - t0
    cos = min(abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))
              for a, b in zip(lda_h.projection, lda_d.projection))
    mean_err = float(np.abs(lda_d.mean - lda_h.mean).max())
    if not (cos >= 1 - 1e-3 and mean_err <= 1e-4):
        problems.append(f"compute_lda_device: row cosine {cos}, mean {mean_err}")
    lda = compute_lda(centered, labels, lda_dim)
    xp = length_normalize(lda(centered + lda.mean))
    t0 = time.perf_counter()
    plda_h = train_plda(xp, labels, bcfg.plda_iters)
    plda_host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plda_d = train_plda_device(xp, labels, bcfg.plda_iters, device=device)
    plda_dev_s = time.perf_counter() - t0
    psi_err = float(np.max(np.abs(plda_d.psi - plda_h.psi) - 0.05 * np.abs(plda_h.psi)))
    q = len(xp) // 4  # a quarter of the vectors as models, the rest as tests
    s_h = plda_score_matrix(plda_h, xp[:q], xp[q:])
    s_d = plda_score_matrix(plda_d, xp[:q], xp[q:])
    s_err = float(np.max(np.abs(s_d - s_h) - 0.02 * np.abs(s_h)) / np.abs(s_h).max())
    if not (psi_err <= 0.05 and s_err <= 0.02):
        problems.append(f"train_plda_device: psi {psi_err}, scores {s_err}")
    parts.append(
        f"on phase 9's {len(ids)} v2 training embeddings ({len(set(labels))} speakers): "
        f"compute_lda_device ({top} dims) rows cosine >= {cos:.6f} (limit 1 - 1e-3), mean "
        f"{mean_err:.2e} (1e-4), {lda_dev_s:.3f} s on {device} against {lda_host_s:.3f} s "
        f"float64 host; train_plda_device ({lda_dim} dims, {bcfg.plda_iters} iterations) psi "
        f"|dev - host| - 0.05 |host| at most {psi_err:.3e} (0.05), trial scores {s_err:.3e} of "
        f"the scale (0.02), {plda_dev_s:.3f} s against {plda_host_s:.3f} s")

    # backend_eval with device scoring against phase 9's host scoring
    t0 = time.perf_counter()
    dev_res, dev_art = backend_eval(*args[:4], dataclasses.replace(bcfg, device_scoring=True),
                                    **dict(kw, device=device))
    eval_s = time.perf_counter() - t0
    keys = sorted(host_art["scores"])
    hs = np.array([host_art["scores"][k] for k in keys])
    ds = np.array([dev_art["scores"][k] for k in keys])
    sc_err = float(np.abs(ds - hs).max() / np.abs(hs).max())
    one_trial = 1.0 / min(host_res.num_target, host_res.num_nontarget)
    if not (abs(dev_res.eer - host_res.eer) <= one_trial and sc_err <= 2e-3):
        problems.append(f"backend_eval device scoring: EER {dev_res.eer} against {host_res.eer}, "
                        f"scores {sc_err}")
    parts.append(f"backend_eval(device_scoring=True) on phase 9's v2 embeddings: EER "
                 f"{100 * dev_res.eer:.4f}% against the host's {100 * host_res.eer:.4f}% (one "
                 f"trial {100 * one_trial:.4f}%), scores {sc_err:.3e} of the scale (2e-3), "
                 f"{len(keys)} trials in {eval_s:.3f} s")

    # streaming_embed on a long stream against whole-utterance pooling
    frames, chunk = stream
    model = drv["v2_model"]
    feats = np.random.default_rng(12).normal(size=(frames, model.cfg.feat_dim)).astype(np.float32)
    streaming_embed(model, feats[:2 * chunk], chunk=chunk, device=device)  # warm-up
    sync()
    t0 = time.perf_counter()
    streamed = streaming_embed(model, feats, chunk=chunk, device=device)
    stream_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    whole = extract_and_score(model, None, {"stream": feats},
                              ExtractConfig(chunk_size=frames, batch_size=1),
                              model.cfg.min_frames, device=device)["stream"]
    whole_s = time.perf_counter() - t0
    st_err = float(np.max(np.abs(streamed - whole) - STREAM_TOL * np.abs(whole)))
    if not (streamed.dtype == np.float32 and st_err <= STREAM_TOL):
        problems.append(f"streaming_embed off whole-utterance pooling: {st_err}")
    parts.append(f"streaming_embed on {frames} frames ({frames / 6000:.0f} min) with chunk "
                 f"{chunk}: {stream_s:.3f} s ({frames * 0.01 / stream_s:.1f} audio-s/s), "
                 f"whole-utterance extract_and_score {whole_s:.3f} s; |streamed - whole| - "
                 f"{STREAM_TOL} |whole| at most {st_err:.3e} (limit {STREAM_TOL})")
    log(f"phase 11d on-device backend on {env['smi'] if env else device}: " + "; ".join(parts))
    if problems:
        raise AssertionError("phase 11d: " + "; ".join(problems))
    return {"plda_err": err, "eer_dev": dev_res.eer, "eer_host": host_res.eer}



# 12: the command line on the card.  The round trip through Kaldi's nnet3
# format folds each batch norm's scale into the written variance in float64
# and reads it back in float32: one rounding per layer, so the round-tripped
# embeddings sit ~1e-6 of their scale from the trained model's.
P12_BUDGET_S = 200.0  # phase 12's wall, reported against this budget
P12_EMBED_UTTS = 64
INTEROP_TOL = 1e-4  # round-tripped embeddings vs the trained model's, of the embedding scale
P12_CARD_TOL = 1e-4  # nnet3 forward and nnet2 posteriors on the card vs the CPU (TF32 off)
P12_BOOTSTRAP = 200
GAUNTLET_V2_WINDOW = (0.05, 0.30)  # tests/test_gauntlet.py:57-70
GAUNTLET_V5_MARGIN = 0.02


def _write_kaldi_corpus(root, corpus):
    """Phase 9's corpus v2 as Kaldi data dirs of WAVs (the port's own
    writers): train (with `text`, and one utterance cut from a longer
    recording by a `segments` row), enroll (each eval speaker's enrollment
    utterances), eval (the rest), the trials and the lexicon; and phase
    9's augmentation pools as MUSAN-style and RIR WAV trees."""
    import numpy as np

    from sepi_tpu_torch.data import Dataset, save_trials, write_kaldi_dir, write_wav

    trn, evl = corpus["train"], corpus["eval"]
    wavs = os.path.join(root, "wav")
    os.makedirs(wavs)

    def put(name, ds, audio, segment=None):
        utts = []
        for u in ds:
            p = os.path.join(wavs, f"{u.utt_id}.wav")
            x = audio[u.utt_id]
            if u.utt_id == segment:
                # 0.5 s of silence on each side; the row cuts the utterance back out
                pad = np.zeros(4000, np.float32)
                write_wav(p, np.concatenate([pad, x, pad]), SR)
                utts.append(u.replace(wav=p, recording=f"rec-{u.utt_id}", start=0.5,
                                      end=0.5 + len(x) / SR))
            else:
                write_wav(p, x, SR)
                utts.append(u.replace(wav=p))
        d = os.path.join(root, name)
        write_kaldi_dir(Dataset(utts, name), d)
        return d

    # an utterance whose length is a whole number of segments-file steps
    # (0.01 s = 80 samples), so the cut gives back exactly its samples
    segment = next(u for u in trn.dataset.utt_ids if len(trn.audio[u]) % 80 == 0)
    dirs = {"train": put("train", trn.dataset, trn.audio, segment)}
    enrolled = {u for us in corpus["enroll"].values() for u in us}
    dirs["enroll"] = put("enroll", evl.dataset.filter(lambda u: u.utt_id in enrolled),
                         evl.audio)
    dirs["eval"] = put("eval", evl.dataset.filter(lambda u: u.utt_id not in enrolled),
                       evl.audio)
    dirs["trials"] = os.path.join(root, "trials")
    save_trials(corpus["trials"], dirs["trials"])
    dirs["text"] = os.path.join(dirs["train"], "text")
    with open(dirs["text"], "w") as f:
        for u in sorted(trn.transcripts):
            f.write(f"{u} {' '.join(trn.transcripts[u])}\n")
    dirs["lexicon"] = os.path.join(root, "lexicon.txt")
    with open(dirs["lexicon"], "w") as f:
        for w in sorted(trn.lexicon.pron):
            f.write(f"{w} {' '.join(trn.lexicon.pron[w])}\n")
    aug = _p9_augments(trn)
    dirs["musan"] = os.path.join(root, "musan")
    for kind, sub in (("noise", "noise"), ("music", "music"), ("babble", "speech")):
        os.makedirs(os.path.join(dirs["musan"], sub))
        for i, x in enumerate(aug.noises[kind]):
            write_wav(os.path.join(dirs["musan"], sub, f"{sub}{i}.wav"), x, SR)
    dirs["rirs"] = os.path.join(root, "rirs")
    os.makedirs(dirs["rirs"])
    for i, rir in enumerate(aug.rirs):
        write_wav(os.path.join(dirs["rirs"], f"rir{i}.wav"), rir * 20000.0, SR)
    dirs["aug_subset"] = aug.subset
    return dirs, segment


def phase_cli(env, corpus, device="cuda", v2_steps=P9_V2_STEPS, v3_steps=P9_STEPS,
              bootstrap=P12_BOOTSTRAP, configs=None, embed_utts=P12_EMBED_UTTS, pins=True):
    """Phase 12: the command line, in-process through `cli.main(argv)` as a
    user types it.  12a writes phase 9's corpus to Kaldi data dirs; 12b runs
    `v2` and 12c `v3` (s5 stage with fMLLR) on them at the drivers' default
    widths, each beside its initial weights under the same backend; 12d
    exports 12b's final checkpoint to a Kaldi `final.raw`, imports it back
    with a `python -m sepi_tpu_torch` process and holds the embeddings, the
    export's bytes and the card against the CPU, then takes the repo's Kaldi
    fixtures through import-kaldi/export-kaldi; 12e runs the gauntlet at
    ``--scale ci`` (v2 and v5, paired bootstrap) and holds the reference's
    pins, which are calibrated for that scale.  Every MFCC batch and the
    largest Viterbi batch of each (T, S, skip) are held against the plain
    versions.  ``configs`` maps a driver to narrow model configs for a CPU
    rehearsal (None keeps the default widths the command line uses);
    ``pins`` holds the gauntlet's calibrated window, which a rehearsal that
    swaps in a tiny CI_SCALE does not reach."""
    import contextlib
    import shutil

    import numpy as np

    from sepi_tpu_torch import cli
    from sepi_tpu_torch.align import mono, viterbi_cuda
    from sepi_tpu_torch.config import ExtractConfig, TrainConfig
    from sepi_tpu_torch.data import read_wav
    from sepi_tpu_torch.models import lecun_normal_init
    from sepi_tpu_torch.ops import mfcc_cuda
    from sepi_tpu_torch.recipes import drivers, gauntlet, pipeline

    configs = configs or {}
    root = os.path.join(ROOT, "build", "smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    problems, wall = [], {}
    dev = ["--device", str(device)]
    t0 = time.perf_counter()

    # 12a: the Kaldi data directories
    dirs, segment = _write_kaldi_corpus(os.path.join(root, "data"), corpus)
    ds, audio = cli._load_corpus(dirs["train"], SR)
    padded, _ = read_wav(ds[segment].wav)
    if not (np.array_equal(audio[segment], padded[4000:-4000])
            and len(audio[segment]) == len(corpus["train"].audio[segment])
            and ds[segment].recording == f"rec-{segment}"):
        problems.append(f"12a: {segment}'s segments row did not cut its samples back out")
    if set(audio) != set(corpus["train"].audio):
        problems.append("12a: the train dir does not read back every utterance")
    wall["12a"] = time.perf_counter() - t0

    data = ["--train-data", dirs["train"], "--enroll-data", dirs["enroll"],
            "--eval-data", dirs["eval"], "--trials", dirs["trials"]]

    # what the drivers hand to extraction and the backend, their results,
    # every MFCC batch and the largest Viterbi batch of each (T, S, skip)
    calls, results, captured = {}, {}, {}
    orig_x, orig_b = pipeline.extract_and_score, pipeline.backend_eval
    orig_viterbi = mono.viterbi_batch
    orig_run = {k: getattr(drivers, k) for k in ("run_v2", "run_v3")}
    orig_gauntlet = gauntlet.run_gauntlet
    current = [None]

    def cap_x(model, state, features, extract_cfg=ExtractConfig(), min_frames=15,
              model_kwargs=None, mesh=None, device="cuda"):
        out = orig_x(model, state, features, extract_cfg, min_frames, model_kwargs, mesh, device)
        calls.setdefault(current[0], {}).setdefault("extract", []).append(
            (model, features, extract_cfg, min_frames, model_kwargs, out))
        return out

    def cap_b(*args, **kw):
        out = orig_b(*args, **kw)
        calls.setdefault(current[0], {})["backend"] = (args, kw, out)
        return out

    def cap_viterbi(emit, t_len, trans, skip=4):
        key = (emit.shape[1], emit.shape[2], skip)
        held = captured.get(key)
        if held is None or emit.shape[0] > held[0].shape[0]:
            captured[key] = (emit.clone(), t_len.clone(), trans.clone(), skip)
        return orig_viterbi(emit, t_len, trans, skip)

    def keep(name):
        def run(*args, **kw):
            kw.update(configs.get(name, {}))
            out = orig_run[name](*args, **kw)
            results[current[0]] = out
            return out
        return run

    def keep_gauntlet(*args, **kw):
        out = orig_gauntlet(*args, **kw)
        results["gauntlet"] = out
        return out

    tee = _Tee(sys.stdout)
    pipeline.extract_and_score, pipeline.backend_eval = cap_x, cap_b
    mono.viterbi_batch = cap_viterbi
    for name in orig_run:
        setattr(drivers, name, keep(name))
    gauntlet.run_gauntlet = keep_gauntlet
    try:
        mfcc_cuda.mfcc_fused.launches = 0
        viterbi_cuda.viterbi_batch.launches = 0
        with contextlib.redirect_stdout(tee), _MfccCapture() as cap:
            # 12b: v2 with phase 9's steps and augmentation pools, from WAV trees
            current[0] = "v2"
            tb = time.perf_counter()
            rc = cli.main(["v2", *data, "--workdir", os.path.join(root, "v2"),
                           "--num-steps", str(v2_steps), "--musan-dir", dirs["musan"],
                           "--rirs-dir", dirs["rirs"], "--aug-subset", str(dirs["aug_subset"]),
                           *dev])
            wall["12b"] = time.perf_counter() - tb
            if rc != 0:
                problems.append(f"12b: v2 exited {rc}")
            # 12c: v3 through the s5 stage with the speaker-adaptive pass
            current[0] = "v3"
            tc = time.perf_counter()
            rc = cli.main(["v3", *data, "--workdir", os.path.join(root, "v3"),
                           "--num-steps", str(v3_steps), "--text", dirs["text"],
                           "--lexicon", dirs["lexicon"], "--fmllr", *dev])
            wall["12c"] = time.perf_counter() - tc
            if rc != 0:
                problems.append(f"12c: v3 exited {rc}")
            launches_bc = {"mfcc_fused": mfcc_cuda.mfcc_fused.launches,
                           "viterbi_batch": viterbi_cuda.viterbi_batch.launches}

            # 12d: Kaldi interop, then 12e, outside the capture hooks
            pipeline.extract_and_score, pipeline.backend_eval = orig_x, orig_b
            for name, fn in orig_run.items():
                setattr(drivers, name, fn)
            td = time.perf_counter()
            interop = _p12_interop(env, root, calls, device, dev, problems, embed_utts)
            wall["12d"] = time.perf_counter() - td

            # 12e: the gauntlet through the command line
            current[0] = "gauntlet"
            te = time.perf_counter()
            rc = cli.main(["gauntlet", "--scale", "ci", "--variants", "v2,v5",
                           "--bootstrap", str(bootstrap), "--workdir",
                           os.path.join(root, "gauntlet"), *dev])
            wall["12e"] = time.perf_counter() - te
            if rc != 0:
                problems.append(f"12e: gauntlet exited {rc}")
        launches = {"mfcc_fused": mfcc_cuda.mfcc_fused.launches,
                    "viterbi_batch": viterbi_cuda.viterbi_batch.launches}
    finally:
        pipeline.extract_and_score, pipeline.backend_eval = orig_x, orig_b
        mono.viterbi_batch = orig_viterbi
        for name, fn in orig_run.items():
            setattr(drivers, name, fn)
        gauntlet.run_gauntlet = orig_gauntlet
    text = "".join(tee.lines)

    if device != "cpu" and min(launches_bc.values()) <= 0:
        problems.append(f"12b-12c did not launch every kernel: {launches_bc}")
    if device != "cpu" and launches["mfcc_fused"] <= launches_bc["mfcc_fused"]:
        problems.append("12d-12e launched no MFCC kernel")

    # 12b/12c: the reports, the files, and each system beside its initial weights
    initial, res = {}, {}
    for k in ("v2", "v3"):
        r = results.get(k)
        if r is None:
            problems.append(f"{k}: no result")
            continue
        res[k] = r.pooled
        w = os.path.join(root, k)
        if "pooled" not in r.report or r.report.strip() not in text:
            problems.append(f"{k}: the report was not printed")
        for f in ("xvector.scp", "det_pooled.svg", "metrics.jsonl"):
            if not os.path.exists(os.path.join(w, f)):
                problems.append(f"{k}: no {f} in the workdir")
        c = calls[k]
        model = c["extract"][0][0]
        m0 = type(model)(model.cfg)
        lecun_normal_init(m0, TrainConfig().seed)  # the command line's seed
        m0 = m0.to(device).eval()
        embs0 = [orig_x(m0, None, f, ec, mf, kw, device=device)
                 for _, f, ec, mf, kw, _ in c["extract"]]
        args, kw, _ = c["backend"]
        initial[k] = orig_b(embs0[0], *args[1:], **kw)[0]
        if not r.pooled.eer < initial[k].eer:
            problems.append(f"{k}: unseen-speaker EER {100 * r.pooled.eer:.3f}% not below its "
                            f"initial weights' {100 * initial[k].eer:.3f}%")

    # 12e: the reference's pins
    g = results.get("gauntlet", {})
    eer = {k: r.pooled.eer for k, r in g.items()}
    lo, hi = GAUNTLET_V2_WINDOW
    boot = [line.strip() for line in text.splitlines() if line.startswith("bootstrap:")]
    if set(eer) != {"v2", "v5"}:
        problems.append(f"12e: gauntlet results {sorted(eer)}")
    elif pins:
        if not lo < eer["v2"] < hi:
            problems.append(f"12e: v2 EER {eer['v2']:.4f} outside ({lo}, {hi})")
        if not eer["v5"] <= eer["v2"] - GAUNTLET_V5_MARGIN:
            problems.append(f"12e: v5 EER {eer['v5']:.4f} not {GAUNTLET_V5_MARGIN} below v2's "
                            f"{eer['v2']:.4f}")
    if bootstrap and not boot:
        problems.append("12e: no bootstrap line")

    # every MFCC batch of the phase against the plain version; the Viterbi
    # on the largest batch of each (T, S, skip)
    mfcc_shapes = sorted({tuple(b[1].shape) for b in cap.batches})
    n_mfcc = len(cap.batches)
    mfcc_err = max([e for _, e in cap.check(problems, "phase 12 batch").values()] + [0.0])
    viterbi_err, viterbi_shapes = 0.0, sorted(captured)
    if device != "cpu":
        for (t, s, skip), a in sorted(captured.items()):
            viterbi_err = max(viterbi_err, _viterbi_check(
                f"phase 12 batch T={t} S={s} skip {skip}", *a))
    captured.clear()

    total = time.perf_counter() - t0
    stages = "; ".join(f"{k} " + ", ".join(f"{s} {v:.2f}" for s, v in results[k].seconds.items())
                       for k in ("v2", "v3") if k in results)
    log(f"phase 12 command line on {env['smi'] if env else device}: 12a Kaldi dirs of corpus v2 "
        f"(train {len(audio)} WAVs, one cut by a segments row, enroll/eval/trials, text, "
        f"lexicon, MUSAN/RIR trees) in {wall['12a']:.2f} s; "
        + "; ".join(f"{k} EER {100 * res[k].eer:.3f}% minDCF08 {res[k].min_dcf08:.4f} (initial "
                    f"weights {100 * initial[k].eer:.3f}%) in {wall['12' + ('b' if k == 'v2' else 'c')]:.2f} s"
                    for k in res)
        + f"; seconds per stage: {stages}; 12d {interop['line']}; 12e gauntlet --scale ci "
        "v2,v5: " + ", ".join(f"{k} EER {100 * v:.3f}%" for k, v in eer.items())
        + f" (pins {lo} < v2 < {hi}, v5 <= v2 - {GAUNTLET_V5_MARGIN}); "
        + " | ".join(boot) + f"; launches 12b-12c {launches_bc}, whole phase {launches}; mfcc on "
        f"the phase's {n_mfcc} batches {mfcc_shapes[:4]}{'...' if len(mfcc_shapes) > 4 else ''} "
        f"max abs err {mfcc_err:.3e} <= {TOL}; viterbi on the largest batch of each (T, S, skip) "
        f"{viterbi_shapes}: backpointers equal, live delta max abs err {viterbi_err:.3e}; wall s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in wall.items())
        + f"; {total:.1f} s against its {P12_BUDGET_S:.0f} s budget "
        f"({'within' if total <= P12_BUDGET_S else 'over'})")
    shutil.rmtree(root, ignore_errors=True)
    if problems:
        raise AssertionError("phase 12: " + "; ".join(problems))
    return {"launches": launches, "launches_bc": launches_bc, "mfcc_err": mfcc_err,
            "viterbi_err": viterbi_err, "viterbi_shapes": viterbi_shapes,
            "eer": {k: r.eer for k, r in res.items()},
            "eer_initial": {k: r.eer for k, r in initial.items()}, "gauntlet": eer,
            "interop": interop, "wall": wall, "total": total}


def _p12_interop(env, root, calls, device, dev, problems, embed_utts):
    """12d: 12b's final checkpoint -> export-kaldi -> `python -m
    sepi_tpu_torch import-kaldi` -> embeddings against the trained model's;
    the export of the model 12b evaluated, taken from the card, against the
    checkpoints' exports; the imported model's forward and the nnet2
    fixture's posteriors on the card against the CPU; the Kaldi fixtures
    through import-kaldi/export-kaldi."""
    import glob
    import json

    import numpy as np
    import torch

    from sepi_tpu_torch import cli
    from sepi_tpu_torch.device import fp32_math
    from sepi_tpu_torch.models import Nnet2Config, Nnet2Multisplice
    from sepi_tpu_torch.models.tdnn import TdnnSpec
    from sepi_tpu_torch.recipes import nnet2_recipe, pipeline
    from sepi_tpu_torch.utils import nnet3
    from sepi_tpu_torch.utils.nnet3 import Nnet3ParseError

    fix = os.path.join(ROOT, "tests", "fixtures", "kaldi_wire")
    d = os.path.join(root, "interop")
    os.makedirs(d)
    ckpts = sorted(glob.glob(os.path.join(root, "v2", "ckpt", "ckpt_*.pt")),
                   key=lambda p: int(p.rsplit("_", 1)[1][:-3]))
    ckpt = ckpts[-1]
    raw = os.path.join(d, "final.raw")
    if cli.main(["export-kaldi", "--model", ckpt, "--arch", "v2", "--out", raw]) != 0:
        problems.append("12d: export-kaldi failed")
    state = cli.load_state_dict_file(ckpt)

    # the model 12b evaluated, exported from its tensors on the card, against
    # host exports of the checkpoints on disk.  The driver's checkpoint-tail
    # combination keeps the final checkpoint's parameters or a uniform
    # average of the last K (freshest first, train.checkpoint.
    # combine_checkpoints); then finalize_batch_stats recomputes the batch
    # norms' statistics, which no checkpoint holds.  So each candidate takes
    # the evaluated model's statistics, and one must give its bytes.
    live = calls["v2"]["extract"][0][0]
    live_raw, cand_raw = os.path.join(d, "live.raw"), os.path.join(d, "cand.raw")
    nnet3.export_kaldi_raw(live, "v2", live_raw)
    live_bytes = open(live_raw, "rb").read()
    names = [n for n, _ in live.named_parameters()]
    stats = {k: v.cpu() for k, v in live.state_dict().items() if k not in names}
    tail = [cli.load_state_dict_file(p) for p in reversed(ckpts[-10:])]
    evaluated = None
    for k, sd in enumerate(tail):
        avg = ({n: (avg[n] * k + sd[n]) / (k + 1) for n in names} if k
               else {n: sd[n] for n in names})
        nnet3.export_kaldi_raw({**avg, **stats}, "v2", cand_raw)
        if open(cand_raw, "rb").read() == live_bytes:
            evaluated = k + 1
            break
    if evaluated is None:
        problems.append(f"12d: the evaluated model's export equals no average of the last "
                        f"{len(tail)} checkpoints' parameters under its batch-norm statistics")

    # the import in a process of its own, as a user runs it
    env_vars = dict(os.environ, PYTHONPATH=ROOT)
    tp = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "sepi_tpu_torch", "import-kaldi", "--raw", raw,
                           "--out", os.path.join(d, "imp"), *dev],
                          cwd=ROOT, env=env_vars, capture_output=True, text=True, timeout=600)
    proc_s = time.perf_counter() - tp
    if proc.returncode != 0 or "imported v2 model" not in proc.stdout:
        problems.append(f"12d: python -m sepi_tpu_torch import-kaldi exited {proc.returncode}: "
                        f"{proc.stderr[-400:]}")
    meta = json.load(open(os.path.join(d, "imp", "meta.json")))
    imported = cli.load_state_dict_file(os.path.join(d, "imp", "model.pt"))

    # the trained model (the checkpoint's weights) and the imported one
    model = calls["v2"]["extract"][0][0]
    trained = type(model)(model.cfg)
    trained.load_state_dict(state)
    back = type(model)(model.cfg)
    back.load_state_dict(imported)
    if meta["arch"] != "v2" or meta["config"]["num_speakers"] != model.cfg.num_speakers:
        problems.append(f"12d: meta.json {meta['arch']} {meta['config']['num_speakers']}")
    _, feats, ec, mf, kw, _ = calls["v2"]["extract"][0]
    subset = {u: feats[u] for u in sorted(feats)[:embed_utts]}
    e_trained = pipeline.extract_and_score(trained.to(device).eval(), None, subset, ec, mf, kw,
                                           device=device)
    e_back = pipeline.extract_and_score(back.to(device).eval(), None, subset, ec, mf, kw,
                                        device=device)
    scale = max(float(np.abs(e).max()) for e in e_trained.values())
    emb_err = max(float(np.abs(e_back[u] - e_trained[u]).max()) for u in subset) / scale
    if not emb_err <= INTEROP_TOL:
        problems.append(f"12d: round-tripped embeddings {emb_err:.3e} of scale from the "
                        f"trained model's (limit {INTEROP_TOL})")

    # the imported model's forward on the card against the CPU
    x = torch.from_numpy(np.stack([f[:300] for f in list(subset.values())[:8]
                                   if len(f) >= 300] or [next(iter(subset.values()))]))
    with torch.no_grad(), fp32_math():
        fwd = back.to(device).eval()(x.to(device))["embedding_a"].cpu()
        fwd_cpu = back.cpu()(x)["embedding_a"]
    fwd_err = float((fwd - fwd_cpu).abs().max()) / max(1.0, float(fwd_cpu.abs().max()))
    if device != "cpu" and not fwd_err <= P12_CARD_TOL:
        problems.append(f"12d: imported nnet3 forward on the card {fwd_err:.3e} from the CPU's")

    # the repo's Kaldi fixtures through the command line; the one-block
    # final.raw is no v1-v5 graph, and both packages refuse it
    refused = None
    try:
        cli.main(["import-kaldi", "--raw", os.path.join(fix, "final.raw"),
                  "--out", os.path.join(d, "fx_raw"), *dev])
        problems.append("12d: the one-block fixture final.raw imported as a v1-v5 model")
    except Nnet3ParseError as e:
        refused = str(e).split(";")[0]
    if cli.main(["import-kaldi", "--raw", os.path.join(fix, "final_nnet2.mdl"),
                 "--out", os.path.join(d, "fx_nnet2"), *dev]) != 0:
        problems.append("12d: the nnet2 fixture did not import")
    n2meta = json.load(open(os.path.join(d, "fx_nnet2", "meta.json")))
    cfg = n2meta["config"]
    n2cfg = Nnet2Config(**dict(cfg, specs=tuple(TdnnSpec(s["dim"], tuple(s["offsets"]))
                                                for s in cfg["specs"])))
    n2state = cli.load_state_dict_file(os.path.join(d, "fx_nnet2", "model.pt"))
    rng = np.random.default_rng(12)
    n2feats = {f"u{i}": rng.normal(size=(50 + 37 * i, n2cfg.feat_dim)).astype(np.float32)
               for i in range(6)}
    post_d = nnet2_recipe.nnet2_posteriors(Nnet2Multisplice(n2cfg), n2state, n2feats,
                                           device=device)
    post_c = nnet2_recipe.nnet2_posteriors(Nnet2Multisplice(n2cfg), n2state, n2feats,
                                           device="cpu")
    post_err = max(float(np.abs(post_d[u] - post_c[u]).max()) for u in n2feats)
    if not post_err <= P12_CARD_TOL:
        problems.append(f"12d: nnet2 posteriors on {device} {post_err:.3e} from the CPU's")
    for name in ("final.ie", "plda"):
        out = os.path.join(d, f"fx_{name}")
        cli.main(["import-kaldi", "--raw", os.path.join(fix, name), "--out", out])
        cli.main(["export-kaldi", "--model", os.path.join(out, "model.npz"),
                  "--out", os.path.join(out, name)])
        cli.main(["import-kaldi", "--raw", os.path.join(out, name), "--out", out + "_back"])
        a, b = np.load(os.path.join(out, "model.npz")), np.load(os.path.join(out + "_back",
                                                                              "model.npz"))
        for k in a.files:
            if k != "kind" and not np.allclose(a[k], b[k], rtol=1e-6, atol=1e-6):
                problems.append(f"12d: {name} {k} changed over export-kaldi/import-kaldi")
    plda_exact = (open(os.path.join(d, "fx_plda", "plda"), "rb").read()
                  == open(os.path.join(fix, "plda"), "rb").read())
    if not plda_exact:
        problems.append("12d: the plda fixture did not export back to its bytes")
    line = (f"export-kaldi of {os.path.basename(ckpt)} -> final.raw ({os.path.getsize(raw)} "
            f"bytes; the evaluated model exported from {device} is byte-equal to a host "
            f"export of the {'final checkpoint' if evaluated == 1 else f'average of the last {evaluated} checkpoints'}"
            f" under its recomputed batch-norm statistics) -> `python -m sepi_tpu_torch "
            f"import-kaldi` ({proc_s:.1f} s) -> {len(subset)} eval embeddings {emb_err:.3e} of "
            f"scale from the trained model's (limit {INTEROP_TOL}); imported forward on "
            f"{device} vs CPU {fwd_err:.3e} (limit {P12_CARD_TOL}); fixtures: final.raw refused "
            f"as the reference refuses it ({refused}), final_nnet2.mdl posteriors on {device} vs "
            f"CPU {post_err:.3e}, final.ie and plda through import/export (plda bytes equal)")
    return {"line": line, "emb_err": emb_err, "fwd_err": fwd_err, "post_err": post_err,
            "process_s": proc_s, "evaluated": evaluated}


# 13: the device mesh on the card.  The ranks are processes of one world
# (`parallel.dryrun.launch`: spawned, killed at a timeout); two ranks share
# the one card over gloo, since NCCL refuses two ranks on one device, and
# NCCL runs at world size 1.
P13_BUDGET_S = 150.0  # phase 13's wall, reported against this budget
P13_TOL = 2e-4  # 13b: rtol = atol = 2e-4 on every parameter, the reference's
# Trainer tolerance (tests/multiproc_worker.py:107-132); a reading is the
# largest |p_2 - p_1| / (atol + rtol |p_1|), so the check holds at <= 1
P13_STEPS, P13_TIMED = 3, 10
P13_EXTRACT_TOL = 1e-5  # rtol = atol, tests/test_train.py:305-333
P13_GMM = dict(comps=2048, gselect=20, dim=60, frames=1 << 17)  # the v1 UBM's E-step
P13_GMM_TOL = 1e-4  # of each statistic's largest |entry|
P13_RANK_TIMEOUT_S = 600.0


def _p13_reading(got, want, tol=P13_TOL) -> float:
    """The largest |got - want| / (tol + tol |want|) over parameters."""
    return max(float(((got[k] - want[k]).abs() / (tol + tol * want[k].abs())).max())
               for k in want)


def _p13_ms(fn, dev, iters=P13_TIMED, warmup=2) -> float:
    """Median ms of ``fn()`` after ``warmup`` calls: CUDA events on the
    card, the wall clock on the CPU (a rehearsal)."""
    if dev.type == "cuda":
        return time_ms(fn, iters=iters, warmup=warmup)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t))
    return statistics.median(times)


def _p13_sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _p13_batches(cfg, n=P13_STEPS):
    """13a/13b's global batches: TRAIN_B chunks of TRAIN_T frames (11b's
    recipe: labels from 16 speakers, a per-speaker-group offset)."""
    return p11b_batches(cfg, batch=TRAIN_B)[:n]


def _p13a_rank(out, cfg):
    """13a, the one rank of an NCCL world: dryrun_multichip(1), then one
    full-width DP step against the plain step from the same weights, and
    the median ms of each."""
    import torch

    from sepi_tpu_torch.config import OptimizerConfig
    from sepi_tpu_torch.parallel import make_mesh
    from sepi_tpu_torch.parallel.dryrun import dryrun_multichip
    from sepi_tpu_torch.parallel.mesh import mesh_device
    from sepi_tpu_torch.train import make_xvec_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh()
    dev = mesh_device(mesh)
    t0 = time.perf_counter()
    dryrun_multichip(1, device=dev.type)
    dry_s = time.perf_counter() - t0
    opt = OptimizerConfig(preconditioner="none", proportional_shrink=0.0)
    (cm, sm), (cp, sp) = (_train_state(cfg, dev, opt, seed=3) for _ in range(2))
    f, lab = (t.to(dev) for t in _p13_batches(cfg, 1)[0])
    dp, plain = make_xvec_step(cm, mesh=mesh), make_xvec_step(cp)
    dp(sm, f, lab, 1.0)
    plain(sp, f, lab, 1.0)
    reading = _p13_reading(_flat(sm.model), _flat(sp.model))
    ms = {"dp": _p13_ms(lambda: dp(sm, f, lab, 1.0), dev),
          "plain": _p13_ms(lambda: plain(sp, f, lab, 1.0), dev)}
    with open(out, "w") as fh:
        json.dump({"dryrun_s": dry_s, "reading": reading, "ms": ms,
                   "backend": torch.distributed.get_backend()}, fh)


def _p13b_rank(out_dir, cfg):
    """13b, each of two ranks: P13_STEPS momentum-SGD DP steps from seed 3
    on the global batches, then the same with the batch-norm moments left
    rank-local (the planted fault), then the median step ms; each rank
    saves its parameters."""
    import contextlib

    import torch

    from sepi_tpu_torch.config import OptimizerConfig
    from sepi_tpu_torch.parallel import make_mesh
    from sepi_tpu_torch.parallel.mesh import mesh_device
    from sepi_tpu_torch.train import make_xvec_step
    from sepi_tpu_torch.train import trainer as port_trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh()
    dev = mesh_device(mesh)
    rank = torch.distributed.get_rank()
    batches = [(f.to(dev), lab.to(dev)) for f, lab in _p13_batches(cfg)]
    opt = OptimizerConfig(preconditioner="none", proportional_shrink=0.0)
    rec = {}
    for kind in ("dp", "fault"):
        chain, st = _train_state(cfg, dev, opt, seed=3)
        step = make_xvec_step(chain, mesh=mesh)
        real = port_trainer.sync_batch_norm
        if kind == "fault":
            port_trainer.sync_batch_norm = lambda model, group: contextlib.nullcontext()
        try:
            rec[kind] = [float(step(st, f, lab, 1.0)["objf"]) for f, lab in batches]
        finally:
            port_trainer.sync_batch_norm = real
        torch.save(_flat(st.model), os.path.join(out_dir, f"{kind}.{rank}.pt"))
    f, lab = batches[0]
    rec["ms"] = _p13_ms(lambda: step(st, f, lab, 1.0), dev)
    with open(os.path.join(out_dir, f"b.{rank}.json"), "w") as fh:
        json.dump(rec, fh)


def _p13c_inputs(device, small=False):
    """13c's inputs from seeds: 16 x 100 s of features and a seeded
    full-width V2 x-vector; 2^17 60-dim frames from a 2048-component mixture
    and its diag GMM; a 150-dim PLDA with 4096 x 4096 models and tests.
    ``small`` shrinks every size for a CPU rehearsal."""
    import numpy as np
    import torch

    from sepi_tpu_torch.backend.plda import Plda
    from sepi_tpu_torch.classical.gmm import DiagGmm
    from sepi_tpu_torch.models import V2_XVECTOR

    rng = np.random.default_rng(13)
    frames_per_utt = int(BENCH_SECS * 100) // (20 if small else 1)
    cfg = dataclasses.replace(V2_XVECTOR, num_speakers=CV_SPEAKERS)
    model = random_xvector(cfg, 5, device)
    feats = {f"u{i:02d}": rng.normal(size=(frames_per_utt, 23)).astype(np.float32)
             for i in range(BENCH_B)}
    g = dict(P13_GMM, frames=1 << 12, comps=64) if small else P13_GMM
    centers = rng.normal(size=(g["comps"], g["dim"])).astype(np.float32) * 2
    frames = (centers[rng.integers(0, g["comps"], g["frames"])]
              + rng.normal(size=(g["frames"], g["dim"]))).astype(np.float32)
    gmm = DiagGmm(torch.full((g["comps"],), 1.0 / g["comps"], device=device),
                  torch.from_numpy(centers + 0.3 * rng.normal(size=centers.shape).astype(
                      np.float32)).to(device),
                  torch.from_numpy((0.8 + 0.4 * rng.random(centers.shape)).astype(
                      np.float32)).to(device))
    d, m, n = (16, 64, 48) if small else (PLDA_DIM, PLDA_MODELS, PLDA_TESTS)
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    plda = Plda(mean=rng.normal(size=d) * 0.1, transform=q * (0.5 + rng.random(d))[:, None],
                psi=np.sort(rng.random(d) * 4)[::-1].copy())
    enroll = rng.normal(size=(m, d)).astype(np.float32)
    test = rng.normal(size=(n, d)).astype(np.float32)
    num_utts = rng.integers(1, 4, size=m).astype(np.float32)
    return {"model": model, "min_frames": cfg.min_frames, "feats": feats, "gmm": gmm,
            "frames": torch.from_numpy(frames).to(device), "gselect": g["gselect"],
            "plda": plda, "enroll": enroll, "test": test, "num_utts": num_utts}


def _p13c_rank(out_dir, small):
    """13c, each of two ranks: sharded extraction, GMM statistics and PLDA
    scoring on 13c's inputs, each timed after a warm-up; rank 0 saves
    the results."""
    import torch

    from sepi_tpu_torch.backend.device import plda_score_matrix_sharded
    from sepi_tpu_torch.classical.gmm import accumulate_stats_sharded
    from sepi_tpu_torch.config import ExtractConfig
    from sepi_tpu_torch.extract import EmbeddingExtractor
    from sepi_tpu_torch.parallel import make_mesh
    from sepi_tpu_torch.parallel.mesh import mesh_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh()
    dev = mesh_device(mesh)
    inp = _p13c_inputs(dev, small)
    ext = EmbeddingExtractor(inp["model"], ExtractConfig(), min_frames=inp["min_frames"],
                             mesh=mesh)
    calls = {
        "extract": lambda: ext.extract_utterances(inp["feats"]),
        "gmm": lambda: accumulate_stats_sharded(inp["gmm"], inp["frames"], mesh,
                                                num_gselect=inp["gselect"]),
        "plda": lambda: plda_score_matrix_sharded(inp["plda"], inp["enroll"], inp["test"], mesh,
                                                  inp["num_utts"]),
    }
    res, secs = {}, {}
    for name, fn in calls.items():
        fn()
        _p13_sync(dev)
        t = time.perf_counter()
        res[name] = fn()
        _p13_sync(dev)
        secs[name] = time.perf_counter() - t
    if torch.distributed.get_rank() == 0:
        s = res["gmm"]
        torch.save({"emb": res["extract"], "secs": secs, "plda": res["plda"].cpu(),
                    "gmm": [a.cpu() for a in (s.gamma, s.first, s.second)]},
                   os.path.join(out_dir, "c.pt"))


def _p13d_rank(out_dir, corpus_path, v2_steps, train_cfg, configs):
    """13d, each of two ranks: phase 9's run_v2 (augmentation, mean-only
    PLDA adaptation, ``v2_steps`` steps) with the mesh, reading the corpus
    the parent wrote; every MFCC batch of the primary held against the
    plain version; each rank's file writes counted."""
    import pickle

    import torch

    from sepi_tpu_torch.config import BackendConfig, TrainConfig
    from sepi_tpu_torch.data import featstore
    from sepi_tpu_torch.ops import mfcc_cuda
    from sepi_tpu_torch.parallel import make_mesh
    from sepi_tpu_torch.parallel.mesh import mesh_device
    from sepi_tpu_torch.recipes import drivers, pipeline
    from sepi_tpu_torch.utils import ArkWriter, kaldi_models

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh()
    dev = mesh_device(mesh)
    rank = torch.distributed.get_rank()
    with open(corpus_path, "rb") as fh:
        corpus = pickle.load(fh)
    trn, evl, adp = corpus["train"], corpus["eval"], corpus["adapt"]
    writes = {}

    def counted(owner, name, label):
        fn = getattr(owner, name)

        def wrapper(*a, **kw):
            writes[label] = writes.get(label, 0) + 1
            return fn(*a, **kw)
        setattr(owner, name, wrapper)

    counted(ArkWriter, "__init__", "ark")
    counted(kaldi_models, "write_plda", "plda")
    counted(pipeline, "save_checkpoint", "checkpoint")
    counted(featstore.FeatStore, "write_stream", "store")
    mfcc_cuda.mfcc_fused.launches = 0
    t0 = time.perf_counter()
    with _MfccCapture() as cap:
        res = drivers.run_v2(
            trn.dataset, trn.audio, evl.dataset, evl.audio, corpus["trials"], corpus["enroll"],
            os.path.join(out_dir, "run"), num_steps=v2_steps, augments=_p9_augments(trn),
            adapt_dataset=adp.dataset, adapt_audio=adp.audio,
            backend_cfg=BackendConfig(**P9_ADAPT_BACKEND), train_cfg=train_cfg or TrainConfig(),
            mesh=mesh, device=dev.type, **configs)
    secs = time.perf_counter() - t0
    launches = mfcc_cuda.mfcc_fused.launches
    problems = []
    checked = cap.check(problems, "13d") if dev.type == "cuda" else {}
    with open(os.path.join(out_dir, f"d.{rank}.json"), "w") as fh:
        json.dump({"eer": res.pooled.eer, "min_dcf08": res.pooled.min_dcf08, "secs": secs,
                   "seconds": res.seconds, "launches": launches, "writes": writes,
                   "mfcc": {str(k): v for k, v in checked.items()}, "problems": problems,
                   "num_scores": len(res.scores),
                   "scores_sum": float(sum(res.scores.values()))}, fh)


def mesh_steps(root, cfg, dev, ranks, backend, label, width, timing_note):
    """13b's check on ``ranks`` ranks over ``backend``: P13_STEPS DP steps
    against one process's steps on the global batch (the reading, limit 1),
    rank 0 bit-equal to every other rank, the planted fault above the
    limit, and each rank's median step ms.  Returns the readings, the step
    ms and the problems found."""
    import torch

    from sepi_tpu_torch.config import OptimizerConfig
    from sepi_tpu_torch.parallel.dryrun import launch
    from sepi_tpu_torch.train import make_xvec_step

    t = time.perf_counter()
    launch(ranks, _p13b_rank, (root, cfg), device=dev.type, backend=backend,
           timeout_s=P13_RANK_TIMEOUT_S)
    opt = OptimizerConfig(preconditioner="none", proportional_shrink=0.0)
    chain, st = _train_state(cfg, dev, opt, seed=3)
    step = make_xvec_step(chain)
    objf1 = [float(step(st, f.to(dev), lab.to(dev), 1.0)["objf"]) for f, lab in
             _p13_batches(cfg)]
    want = _flat(st.model)
    got = {k: torch.load(os.path.join(root, f"{k}.0.pt")) for k in ("dp", "fault")}
    equal = all(all(torch.equal(got["dp"][k], v) for k, v in torch.load(
        os.path.join(root, f"dp.{r}.pt")).items()) for r in range(1, ranks))
    recs = []
    for r in range(ranks):
        with open(os.path.join(root, f"b.{r}.json")) as fh:
            recs.append(json.load(fh))
    read_dp, read_fault = _p13_reading(got["dp"], want), _p13_reading(got["fault"], want)
    problems = []
    if not (read_dp <= 1.0 < read_fault and equal):
        problems.append(f"{label}: DP steps read {read_dp:.3e}, the fault {read_fault:.3e}, "
                        f"ranks bit-equal {equal}")
    ms = [r["ms"] for r in recs]
    log(f"phase 13b {label}: {P13_STEPS} momentum-SGD DP steps of the {width} at {TRAIN_B} x "
        f"{TRAIN_T} ({TRAIN_B // ranks} chunks a rank) against one process's steps on the "
        f"global batch: reading {read_dp:.3e} (limit 1: rtol = atol = {P13_TOL}, the "
        f"reference's Trainer tolerance); the ranks' parameters bit-equal {equal}; planted "
        f"fault (batch-norm moments rank-local) {read_fault:.3e} (must exceed 1); objf "
        f"{ranks} ranks {[round(x, 5) for x in recs[0]['dp']]}, 1 process "
        f"{[round(x, 5) for x in objf1]}, fault {[round(x, 5) for x in recs[0]['fault']]}; "
        f"median step " + " / ".join(f"{x:.3f}" for x in ms) + f" ms ({timing_note}); "
        f"{time.perf_counter() - t:.1f} s")
    return {"reading": read_dp, "fault": read_fault, "equal": equal, "ms": ms,
            "problems": problems}


def phase_mesh(env, drv, device="cuda", cfg=None, v2_steps=P9_V2_STEPS, train_cfg=None,
               configs=None, small=False, workdir=None):
    """Phase 13: the device mesh on the card.  13a one rank over NCCL
    (dryrun_multichip(1), a DP step against the plain step and their
    times); 13b two ranks sharing the card over gloo (3 DP steps against
    one process's steps on the global batch, the ranks bit-equal, a
    planted fault that must read above the limit, the step time); 13c the
    sharded extraction, GMM statistics and PLDA scoring against their
    single-card counterparts; 13d run_v2 on phase 9's corpus with a 2-rank
    mesh, its unseen-speaker EER below phase 9's initial weights'.  ``cfg``
    narrows the x-vector, ``small`` 13c's sizes and ``configs`` 13d's
    model, for a CPU rehearsal (``device="cpu"``: gloo everywhere)."""
    import pickle
    import shutil

    import numpy as np
    import torch

    from sepi_tpu_torch.backend.device import plda_score_matrix_device
    from sepi_tpu_torch.classical.gmm import accumulate_stats
    from sepi_tpu_torch.config import ExtractConfig
    from sepi_tpu_torch.extract import EmbeddingExtractor
    from sepi_tpu_torch.models import V2_XVECTOR
    from sepi_tpu_torch.parallel.dryrun import launch

    dev = torch.device(device)
    width = "full-width V2" if cfg is None else "narrow x-vector"
    cfg = cfg or dataclasses.replace(V2_XVECTOR, num_speakers=CV_SPEAKERS)
    root = workdir or os.path.join(ROOT, "build", "smoke_mesh")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    where = env["smi"] if env else device
    problems, wall = [], {}
    gloo = dict(device=device, backend="gloo", timeout_s=P13_RANK_TIMEOUT_S)

    # 13a: NCCL at world size 1
    t = time.perf_counter()
    launch(1, _p13a_rank, (os.path.join(root, "a.json"), cfg), device=device,
           backend=None if dev.type == "cuda" else "gloo", timeout_s=P13_RANK_TIMEOUT_S)
    with open(os.path.join(root, "a.json")) as fh:
        a = json.load(fh)
    wall["13a"] = time.perf_counter() - t
    if not a["reading"] <= 1.0:
        problems.append(f"13a: the DP step reads {a['reading']:.3e} against the plain step")
    log(f"phase 13a {a['backend']} world of 1 on {where}: dryrun_multichip(1) passed in "
        f"{a['dryrun_s']:.1f} s; {width} ({cfg.num_speakers} speakers) at {TRAIN_B} x "
        f"{TRAIN_T} x 23, momentum SGD: the DP step against the plain step from the same "
        f"weights reads {a['reading']:.3e} (limit 1, rtol = atol = {P13_TOL}); median step "
        f"{a['ms']['dp']:.3f} ms over the mesh, {a['ms']['plain']:.3f} ms plain (difference "
        f"{a['ms']['dp'] - a['ms']['plain']:+.3f} ms: the mesh machinery); {wall['13a']:.1f} s")

    # 13b: two ranks share the card over gloo, against one process's steps
    t = time.perf_counter()
    b = mesh_steps(root, cfg, dev, 2, "gloo", f"2 gloo ranks sharing one card on {where}", width,
                   "2 ranks sharing one card: overhead, not scaling")
    wall["13b"] = time.perf_counter() - t
    problems += b["problems"]

    # 13c: the sharded back-end work against the single-card functions
    t = time.perf_counter()
    launch(2, _p13c_rank, (root, small), **gloo)
    c = torch.load(os.path.join(root, "c.pt"), weights_only=False)
    inp = _p13c_inputs(dev, small)
    ext1 = EmbeddingExtractor(inp["model"], ExtractConfig(), min_frames=inp["min_frames"],
                              device=dev)
    calls = {
        "extract": lambda: ext1.extract_utterances(inp["feats"]),
        "gmm": lambda: accumulate_stats(inp["gmm"], inp["frames"], num_gselect=inp["gselect"]),
        "plda": lambda: plda_score_matrix_device(inp["plda"], inp["enroll"], inp["test"],
                                                 inp["num_utts"], device=dev),
    }
    single, one = {}, {}
    for name, fn in calls.items():  # timed after a warm-up, as the ranks time theirs
        fn()
        _p13_sync(dev)
        tc = time.perf_counter()
        one[name] = fn()
        _p13_sync(dev)
        single[name] = time.perf_counter() - tc
    emb1, s1, llr1 = one["extract"], one["gmm"], one["plda"]
    emb_ok = set(c["emb"]) == set(emb1) and all(
        np.allclose(c["emb"][u], emb1[u], rtol=P13_EXTRACT_TOL, atol=P13_EXTRACT_TOL)
        for u in emb1)
    emb_gap = max(float(np.abs(c["emb"][u] - emb1[u]).max()) for u in emb1)
    gmm_gaps = [float((a - b.cpu()).abs().max() / b.abs().max())
                for a, b in zip(c["gmm"], (s1.gamma, s1.first, s1.second))]
    frames = inp["frames"].shape[0]
    gamma_sum = float(c["gmm"][0].double().sum())
    llr1 = llr1.cpu()
    scale = float(llr1.abs().max())
    plda_ok = c["plda"].shape == llr1.shape and bool(torch.allclose(
        c["plda"], llr1, rtol=PLDA_RTOL, atol=PLDA_RTOL * scale))
    plda_gap = float((c["plda"] - llr1).abs().max() / scale)
    wall["13c"] = time.perf_counter() - t
    if not (emb_ok and max(gmm_gaps) <= P13_GMM_TOL and plda_ok
            and abs(gamma_sum - frames) <= 1e-5 * frames):
        problems.append(f"13c: extraction {emb_gap:.3e}, GMM {gmm_gaps}, sum(gamma) "
                        f"{gamma_sum} of {frames}, PLDA {plda_gap:.3e}")
    log(f"phase 13c sharded back end, 2 gloo ranks sharing one card on {where}, each against "
        f"its single-card function: extraction of {BENCH_B} utts x "
        f"{inp['feats']['u00'].shape[0]} frames (full-width V2, seeded weights) max abs gap "
        f"{emb_gap:.3e} (rtol = atol = {P13_EXTRACT_TOL}) in {c['secs']['extract']:.3f} s "
        f"(single card {single['extract']:.3f} s); GMM statistics, "
        f"{inp['gmm'].num_comp} components x {inp['frames'].shape[1]} dims, gselect "
        f"{inp['gselect']}, {frames} frames: gamma/first/second gaps "
        + "/".join(f"{g:.2e}" for g in gmm_gaps) + f" of each largest entry (limit "
        f"{P13_GMM_TOL}), sum(gamma) {gamma_sum:.3f} for {frames} frames, in "
        f"{c['secs']['gmm']:.3f} s (single card {single['gmm']:.3f} s); PLDA trial matrix "
        f"{tuple(llr1.shape)} x {inp['enroll'].shape[1]}: gap {plda_gap:.3e} of its scale "
        f"(rtol {PLDA_RTOL}, atol {PLDA_RTOL} x scale) in {c['secs']['plda']:.4f} s (single "
        f"card {single['plda']:.4f} s); {wall['13c']:.1f} s")

    # 13d: run_v2 on phase 9's corpus with a 2-rank mesh, the primary writing
    t = time.perf_counter()
    corpus_path = os.path.join(root, "corpus.pkl")
    with open(corpus_path, "wb") as fh:
        pickle.dump(drv["corpus"], fh)
    launch(2, _p13d_rank, (root, corpus_path, v2_steps, train_cfg, configs or {}), **gloo)
    ds = []
    for r in range(2):
        with open(os.path.join(root, f"d.{r}.json")) as fh:
            ds.append(json.load(fh))
    d0, d1 = ds
    init_eer, p9_eer = drv["eer_initial"]["v2"], drv["eer"]["v2"]
    wrote = os.path.exists(os.path.join(root, "run", "xvector.scp")) and os.path.exists(
        os.path.join(root, "run", "backend", "plda"))
    wall["13d"] = time.perf_counter() - t
    problems += d0["problems"] + d1["problems"]
    if not d0["eer"] < init_eer:
        problems.append(f"13d: EER {100 * d0['eer']:.3f}% not below the initial weights' "
                        f"{100 * init_eer:.3f}%")
    if not (wrote and d1["writes"] == {} and min(d0["writes"].values(), default=0) > 0
            and d0["eer"] == d1["eer"] and d0["scores_sum"] == d1["scores_sum"]):
        problems.append(f"13d: writes {d0['writes']} / {d1['writes']}, files {wrote}, EERs "
                        f"{d0['eer']} / {d1['eer']}")
    if dev.type == "cuda" and d0["launches"] <= 0:
        problems.append("13d: the MFCC kernel did not launch")
    log(f"phase 13d run_v2 with a 2-rank mesh (gloo, one card) on {where}: phase 9's corpus "
        f"and settings ({v2_steps} steps, augmentation, mean-only PLDA adaptation, "
        f"{'narrow widths' if configs else 'default widths'}), the primary writing: "
        f"unseen-speaker EER {100 * d0['eer']:.3f}% minDCF08 {d0['min_dcf08']:.4f} (phase 9, "
        f"one process: {100 * p9_eer:.3f}%; initial weights {100 * init_eer:.3f}%), the same on "
        f"both ranks; writes primary {d0['writes']}, other {d1['writes']}; MFCC launches "
        f"{d0['launches']} (primary) + {d1['launches']}, every batch against the plain version "
        f"{d0['mfcc']}; {d0['secs']:.1f} s in run_v2 ("
        + ", ".join(f"{k} {v:.2f}" for k, v in d0["seconds"].items())
        + f"); {wall['13d']:.1f} s")
    total = sum(wall.values())
    log(f"phase 13 wall on {where}: " + ", ".join(f"{k} {v:.1f} s" for k, v in wall.items())
        + f"; {total:.1f} s against its {P13_BUDGET_S:.0f} s budget "
        f"({'within' if total <= P13_BUDGET_S else 'over'})")
    shutil.rmtree(root, ignore_errors=True)
    if problems:
        raise AssertionError("phase 13: " + "; ".join(problems))
    mfcc_err = max([e for _, e in d0["mfcc"].values()], default=0.0)
    return {"launches": d0["launches"] + d1["launches"], "mfcc_err": mfcc_err,
            "readings": {"13a": a["reading"], "13b": b["reading"], "fault": b["fault"]},
            "ms": {"13a": a["ms"], "13b": b["ms"]}, "eer": d0["eer"], "wall": wall}


# 14: the parity slice, the paths that closed the port's last gaps to the
# reference: the five MFCC presets through the kernel, configs outside its
# gate through the stepwise route, a mesh over part of the world, and the
# counterpart of __graft_entry__.entry().
P14_BUDGET_S = 60.0  # phase 14's wall, reported against this budget
P14_RANK_TIMEOUT_S = 120.0  # 14b: each launch of ranks, killed after this
P14_PRESETS = ("MFCC_SRE_IVECTOR", "MFCC_SRE_XVECTOR", "MFCC_SNIP_EDGES", "MFCC_HIRES",
               "MFCC_ASR")
P14_OFF_GATE = {  # configs the fused MFCC's gate refuses
    "raw_energy=False": dict(raw_energy=False),
    "frame_shift_ms=9.125": dict(frame_shift_ms=9.125),
    "frame_shift>frame_length": dict(frame_length_ms=8.0, frame_shift_ms=10.0),
}
P14_FEAT_TOL = 1e-3  # stepwise features, card vs CPU (tests/test_torch_frontend.py)
P14_ENTRY_TOL = 1e-4  # entry()'s embedding, card vs CPU, of the embedding's scale
P14_SUBSET = [1, 2]  # 14b's mesh in a world of 3: rank 0 left out


def _p14_audio(device):
    """14a's batch: 4 x 3 s at 8 kHz (a 16 kHz preset reads it as 1.5 s),
    lengths 3, 2.2, 1.1 and 0.4 s, with per-utterance dither seeds."""
    n = int(3.0 * SR)
    return _mfcc_inputs(4, [n, int(2.2 * SR), int(1.1 * SR), int(0.4 * SR)], n, 14, device)


def phase_parity_frontend(env, device="cuda"):
    """14a: each MFCC preset under the default mode through the kernel (its
    launch count read around it, > 0 on the card) against the plain
    version; each config outside the gate through the stepwise route on
    ``device`` (no launch) against the same route on the CPU, dithered and
    undithered."""
    import torch

    from sepi_tpu_torch import config as tcfg
    from sepi_tpu_torch.ops import mfcc_cuda
    from sepi_tpu_torch.ops.features import FeatureExtractor
    from sepi_tpu_torch.ops.framing import num_frames

    dev = torch.device(device)
    x, lens, dev_seeds = _p14_audio(dev)
    seeds = dev_seeds.cpu().numpy()
    problems, presets, off = [], {}, {}
    for name in P14_PRESETS:
        cfg = getattr(tcfg, name)
        fe = FeatureExtractor(cfg, dev)
        mfcc_cuda.mfcc_fused.launches = 0
        feats, mask = fe.mfcc(x, lens, utt_seeds=seeds)
        launches = mfcc_cuda.mfcc_fused.launches
        tmax = int(num_frames(x.shape[1], cfg))
        want, wmask = mfcc_cuda.mfcc_fused_reference(x, lens, cfg, tmax, dev_seeds)
        err = float((feats - want).abs().max())
        presets[name] = (launches, err)
        if not (fe.fused and torch.equal(mask, wmask) and err <= TOL
                and bool(torch.isfinite(feats).all())):
            problems.append(f"14a {name}: fused {fe.fused}, error {err:.3e}")
        if dev.type == "cuda" and launches <= 0:
            problems.append(f"14a {name}: the MFCC kernel did not launch")
    cpu = (x.cpu(), lens.cpu(), seeds)
    for label, kw in P14_OFF_GATE.items():
        for dither in (1.0, 0.0):
            cfg = tcfg.FrontendConfig(dither=dither, **kw)
            fe = FeatureExtractor(cfg, dev)
            mfcc_cuda.mfcc_fused.launches = 0
            feats, mask = fe.mfcc(x, lens, utt_seeds=seeds)
            launches = mfcc_cuda.mfcc_fused.launches
            want, wmask = FeatureExtractor(cfg, "cpu").mfcc(cpu[0], cpu[1], utt_seeds=cpu[2])
            err = float((feats.cpu() - want).abs().max())
            off[f"{label} dither={dither}"] = (tuple(feats.shape), launches, err)
            if fe.fused or launches or not (torch.equal(mask.cpu(), wmask)
                                            and err <= P14_FEAT_TOL):
                problems.append(f"14a {label} dither={dither}: fused {fe.fused}, launches "
                                f"{launches}, error {err:.3e}")
    where = env["smi"] if env else device
    log(f"phase 14a MFCC presets under spectral_mode='auto' on {where}, 4 x 3 s dithered with "
        "seeds (launches, max abs err against the plain version, limit "
        f"{TOL}): " + "; ".join(f"{k} {n}, {e:.3e}" for k, (n, e) in presets.items())
        + f"; outside the kernel's gate, the stepwise route on {device} against the CPU's "
        f"(shape, launches, max abs err, limit {P14_FEAT_TOL}): "
        + "; ".join(f"{k} {s}, {n}, {e:.3e}" for k, (s, n, e) in off.items()))
    return {"launches": sum(n for n, _ in presets.values()),
            "mfcc_err": max(e for _, e in presets.values()),
            "stepwise_err": max(e for *_, e in off.values()), "problems": problems}


def _p14b_rank(out_dir, cfg, devices):
    """14b, each rank: the mesh over ``devices`` (the world when None).  A
    rank outside it is handed the mesh and must raise; the mesh's ranks run
    create_train_state (the mesh's first rank seeded 3, the others not),
    P13_STEPS momentum-SGD DP steps on 13b's batches and an artifact stage
    of the parameters, and save their parameters."""
    import torch

    from sepi_tpu_torch.config import OptimizerConfig
    from sepi_tpu_torch.models import XVector
    from sepi_tpu_torch.parallel import is_primary, make_mesh
    from sepi_tpu_torch.parallel.mesh import mesh_device
    from sepi_tpu_torch.train import build_optimizer, create_train_state, make_xvec_step
    from sepi_tpu_torch.utils.artifacts import ArtifactCache

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    mesh = make_mesh(devices=devices)
    rank = torch.distributed.get_rank()
    dev = mesh_device(mesh)
    chain, _ = build_optimizer(OptimizerConfig(preconditioner="none", proportional_shrink=0.0),
                               1000)
    rec = {"rank": rank, "member": mesh.get_coordinate() is not None}
    if not rec["member"]:
        try:
            create_train_state(XVector(cfg), chain, 3, dev, mesh=mesh)
            rec["raised"] = None
        except ValueError as e:
            rec["raised"] = str(e)
    else:
        primary = is_primary(mesh)
        st = create_train_state(XVector(cfg), chain, 3 if primary else 1000 + rank, dev,
                                mesh=mesh)
        step = make_xvec_step(chain, mesh=mesh)
        rec["objf"] = [float(step(st, f.to(dev), lab.to(dev), 1.0)["objf"])
                       for f, lab in _p13_batches(cfg)]
        wrote = []

        def params():
            wrote.append(rank)
            return {k: v.float().numpy() for k, v in _flat(st.model).items()}

        ArtifactCache(os.path.join(out_dir, "artifacts"), mesh).stage(
            "params", {"steps": P13_STEPS}, params)
        torch.save(_flat(st.model), os.path.join(out_dir, f"p.{rank}.pt"))
        rec.update(primary=primary, wrote=bool(wrote))
    rec["secs"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"r.{rank}.json"), "w") as fh:
        json.dump(rec, fh)


def phase_parity_mesh(env, root, device="cuda", cfg=None):
    """14b: three gloo ranks share the card, the mesh over ranks 1 and 2;
    their parameters against a 2-rank world's after the same steps, one
    writer, and rank 0 raising when handed the mesh."""
    import torch

    from sepi_tpu_torch.models import V2_XVECTOR
    from sepi_tpu_torch.parallel.dryrun import launch

    width = "full-width V2" if cfg is None else "narrow x-vector"
    cfg = cfg or dataclasses.replace(V2_XVECTOR, num_speakers=CV_SPEAKERS)
    recs, problems = {}, []
    for label, n, devices in (("subset", 3, P14_SUBSET), ("world", 2, None)):
        out = os.path.join(root, label)
        os.makedirs(out)
        t = time.perf_counter()
        launch(n, _p14b_rank, (out, cfg, devices), device=device, backend="gloo",
               timeout_s=P14_RANK_TIMEOUT_S)
        recs[label] = {"wall": time.perf_counter() - t, "ranks": []}
        for r in range(n):
            with open(os.path.join(out, f"r.{r}.json")) as fh:
                recs[label]["ranks"].append(json.load(fh))
    sub, world = recs["subset"]["ranks"], recs["world"]["ranks"]
    want = torch.load(os.path.join(root, "world", "p.0.pt"))
    got = {r: torch.load(os.path.join(root, "subset", f"p.{r}.pt")) for r in P14_SUBSET}
    reading = max(_p13_reading(g, want) for g in got.values())
    equal = all(torch.equal(g[k], v) for g in got.values() for k, v in want.items())
    a, b = (got[r] for r in P14_SUBSET)
    members_equal = all(torch.equal(a[k], b[k]) for k in a)
    writers = [r["rank"] for r in sub if r.get("wrote")]
    outside = sub[0]
    if not (reading <= 1.0 and members_equal and writers == [P14_SUBSET[0]]
            and not outside["member"]
            and outside["raised"] and "rank 0 is outside the mesh" in outside["raised"]
            and [r["rank"] for r in world if r.get("wrote")] == [0]):
        problems.append(f"14b: reading {reading:.3e}, the mesh's ranks bit-equal "
                        f"{members_equal}, writers {writers}, rank 0 {outside.get('raised')!r}")
    where = env["smi"] if env else device
    log(f"phase 14b a mesh over ranks {P14_SUBSET} of a 3-rank gloo world sharing one card on "
        f"{where}: create_train_state and {P13_STEPS} momentum-SGD DP steps of the {width} at "
        f"{TRAIN_B} x {TRAIN_T} against a 2-rank world's: reading {reading:.3e} (limit 1, "
        f"rtol = atol = {P13_TOL}), bit-equal to it {equal} (not required: cuDNN's weight gradients "
        f"may vary between processes), the mesh's two ranks bit-equal {members_equal}; objf subset "
        f"{[round(x, 5) for x in sub[1]['objf']]}, world {[round(x, 5) for x in world[0]['objf']]}; "
        f"artifact writers {writers} (the mesh's first rank); rank 0 raised: "
        f"{outside.get('raised')!r}; the 3 ranks finished in {recs['subset']['wall']:.1f} s "
        f"(limit {P14_RANK_TIMEOUT_S:.0f} s; each rank "
        + "/".join(f"{r['secs']:.1f}" for r in sub) + f" s), the world in "
        f"{recs['world']['wall']:.1f} s")
    return {"reading": reading, "equal": equal, "writers": writers, "problems": problems}


def phase_parity_entry(env, device="cuda", timed=10):
    """14c: graft_entry.entry() at full size on ``device`` against the same
    forward on the CPU, and the forward's median ms (CUDA events on the
    card, 3 warm-ups)."""
    import torch

    from sepi_tpu_torch.graft_entry import entry

    fwd, (model, feats) = entry(device=device)
    emb = fwd(model, feats)
    fwd_c, (model_c, feats_c) = entry(device="cpu")
    want = fwd_c(model_c, feats_c)
    scale = float(want.abs().max())
    gap = float((emb.cpu() - want).abs().max())
    ms = _p13_ms(lambda: fwd(model, feats), torch.device(device), iters=timed, warmup=3)
    problems = []
    if not (tuple(emb.shape) == (8, 512) and bool(torch.isfinite(emb).all())
            and gap <= P14_ENTRY_TOL * scale):
        problems.append(f"14c: shape {tuple(emb.shape)}, gap {gap:.3e} of scale {scale:.3e}")
    where = env["smi"] if env else device
    log(f"phase 14c graft_entry.entry() on {where}: the full-size V2 ({model.cfg.num_speakers} "
        f"speakers), embedding_a of {tuple(feats.shape)} features {tuple(emb.shape)}, against "
        f"the CPU's forward: max abs gap {gap:.3e} = {gap / scale:.3e} of its scale {scale:.3f} "
        f"(limit {P14_ENTRY_TOL}); forward median {ms:.3f} ms over {timed} after 3 warm-ups "
        f"({'CUDA events' if device != 'cpu' else 'wall clock'})")
    return {"gap": gap / scale, "ms": ms, "problems": problems}


def phase_parity(env, device="cuda", cfg=None, workdir=None, timed=10):
    """Phase 14: 14a the frontend (presets through the kernel, configs
    outside its gate through the stepwise route), 14b a mesh over part of
    the world, 14c the entry point.  ``cfg`` narrows 14b's x-vector for a
    CPU rehearsal (``device="cpu"``)."""
    import shutil

    root = workdir or os.path.join(ROOT, "build", "smoke_parity")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    wall = {}
    t = time.perf_counter()
    a = phase_parity_frontend(env, device)
    wall["14a"] = time.perf_counter() - t
    t = time.perf_counter()
    b = phase_parity_mesh(env, root, device, cfg)
    wall["14b"] = time.perf_counter() - t
    t = time.perf_counter()
    c = phase_parity_entry(env, device, timed)
    wall["14c"] = time.perf_counter() - t
    total = sum(wall.values())
    where = env["smi"] if env else device
    log(f"phase 14 wall on {where}: " + ", ".join(f"{k} {v:.1f} s" for k, v in wall.items())
        + f"; {total:.1f} s against its {P14_BUDGET_S:.0f} s budget "
        f"({'within' if total <= P14_BUDGET_S else 'over'})")
    shutil.rmtree(root, ignore_errors=True)
    problems = a["problems"] + b["problems"] + c["problems"]
    if problems:
        raise AssertionError("phase 14: " + "; ".join(problems))
    return {"launches": a["launches"], "mfcc_err": a["mfcc_err"],
            "stepwise_err": a["stepwise_err"], "reading": b["reading"], "equal": b["equal"],
            "entry_gap": c["gap"], "entry_ms": c["ms"], "wall": wall}


P16_BUDGET_S = 60.0  # phase 16's wall, reported against this budget
P16_STEPS = 20  # 16a: steps of each trajectory
P16_PROFILED = 5  # 16e: calls in each profiler window


def _p16_equal(got, want) -> list:
    """The names of the tensors that are not `torch.equal` between two
    lists of (name, tensor)."""
    import torch

    return [n for (n, a), (_, b) in zip(got, want) if not torch.equal(a, b)]


def _p16_tensors(state) -> list:
    """(name, tensor) of every tensor a step reads or writes."""
    from sepi_tpu_torch.train.graphs import state_tensors

    names = ([f"param {n}" for n, _ in state.model.named_parameters()]
             + [f"buffer {n}" for n, _ in state.model.named_buffers()])
    tensors = list(state_tensors(state))
    names += [f"opt {i}" for i in range(len(tensors) - len(names))]
    return list(zip(names, tensors))


def _p16_metrics(ms) -> list:
    return [(f"{i} {k}", v) for i, m in enumerate(ms) for k, v in m.items()]


def _p16_batches(device, n, b, t, classes, feat_dim=23, frames=None, seed=16):
    """``n`` seeded batches: feats (b, t, feat_dim) and int32 labels (b,)
    or (b, frames)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    shape = (b,) if frames is None else (b, frames)
    return [(torch.randn((b, t, feat_dim), generator=g, device=device),
             torch.randint(0, classes, shape, generator=g, device=device, dtype=torch.int32))
            for _ in range(n)]


def _p16_configs(device, v2_cfg, shapes, steps):
    """16a's configurations: (label, chain, initial state, [(task kwargs,
    batches)]), the entries stepped in turn; the bench's v5 pair last."""
    from sepi_tpu_torch.config import OptimizerConfig
    from sepi_tpu_torch.models import CombinedCVector, lecun_normal_init
    from sepi_tpu_torch.train import TrainState, build_optimizer

    out = []
    v2 = _p16_batches(device, steps, shapes.chunks, shapes.chunk_frames, v2_cfg.num_speakers,
                      v2_cfg.feat_dim)
    for label, opt, dtype in (("fp32 V2 muon", OptimizerConfig(), "float32"),
                              ("fp32 V2 momentum-SGD", OptimizerConfig(preconditioner="none"),
                               "float32"),
                              ("bf16 V2 muon", OptimizerConfig(), "bfloat16")):
        chain, state = _train_state(v2_cfg, device, opt, dtype=dtype)
        out.append((label, chain, state, [({}, v2)]))
    # two chunk lengths in turn through one step function: two graphs, one pool
    longer = _p16_batches(device, steps, shapes.chunks, shapes.chunk_frames * 3 // 2,
                          v2_cfg.num_speakers, v2_cfg.feat_dim, seed=20)
    chain, state = _train_state(v2_cfg, device, OptimizerConfig(), dtype="bfloat16")
    out.append((f"bf16 V2 muon, {shapes.chunk_frames} and {shapes.chunk_frames * 3 // 2} "
                f"frames in turn", chain, state, [({}, v2), ({}, longer)]))
    c = shapes.combined  # the bench's v5 state (bench_training)
    model = CombinedCVector(c, dtype="bfloat16")
    lecun_normal_init(model, 2)
    model.to(device)
    chain, _ = build_optimizer(OptimizerConfig(), 1000)
    state = TrainState(model, chain.init(dict(model.named_parameters())))
    al, ar = c.am_context
    am = _p16_batches(device, steps, shapes.am_chunks, shapes.am_frames + al + ar,
                      c.num_senones, c.feat_dim, frames=shapes.am_frames, seed=17)
    xv = _p16_batches(device, steps, shapes.chunks, shapes.chunk_frames, c.num_speakers,
                      c.feat_dim, seed=18)
    out.append(("bf16 v5 am+xvec pair", chain, state, [({"task": "am"}, am),
                                                        ({"task": "xvec"}, xv)]))
    return out


def _p16_trajectory(chain, state, tasks, steps):
    """``steps`` captured and eager steps (each task in turn) from clones
    of ``state``: (captured state, eager state, mismatched names, graphs)."""
    from sepi_tpu_torch.train import make_xvec_step

    sg, se = state.clone(), state.clone()
    fns = {}  # one step function per task: its shapes' graphs share one pool
    for kw, _ in tasks:
        key = tuple(sorted(kw.items()))
        if key not in fns:
            fns[key] = (make_xvec_step(chain, kw), make_xvec_step(chain, kw, capture=False))
    mg, me = [], []
    for i in range(steps):
        for kw, batches in tasks:
            g, e = fns[tuple(sorted(kw.items()))]
            f, lab = batches[i % len(batches)]
            mg.append(g(sg, f, lab, 1.0))
            me.append(e(se, f, lab, 1.0))
    bad = _p16_equal(_p16_tensors(sg), _p16_tensors(se)) + _p16_equal(_p16_metrics(mg),
                                                                       _p16_metrics(me))
    if sg.step != se.step or sg.opt_state["count"] != se.opt_state["count"]:
        bad.append(f"counts {sg.step}/{sg.opt_state['count']} vs {se.step}/"
                   f"{se.opt_state['count']}")
    return sg, se, bad, sum(len(g.graphs) for g, _ in fns.values())


def _p16_stale(chain, state, batches, root):
    """16c: recapture after `clone()` and `load_checkpoint`, each against
    the eager step; the keyed step after ``opt_state`` is replaced; then the
    planted stale replay (the first graph run against the replaced
    ``opt_state``), which must differ from the eager step."""
    from sepi_tpu_torch.train import load_checkpoint, make_xvec_step, save_checkpoint
    from sepi_tpu_torch.train.graphs import state_tensors

    step, eager = make_xvec_step(chain), make_xvec_step(chain, capture=False)
    a = state.clone()
    (f0, l0), (f1, l1) = batches[0], batches[1]
    for i in range(3):
        step(a, *batches[i % len(batches)], 1.0)
    first = next(iter(step.graphs.values()))
    save_checkpoint(a, root, a.step)
    for i in range(3):
        step(a, *batches[(i + 3) % len(batches)], 1.0)
    out, bad, held = {}, [], []
    for label, make in (("clone", a.clone), ("load_checkpoint", lambda: load_checkpoint(a, root))):
        s, r = make(), make()
        held += [s, r]  # alive: a freed state's addresses could be taken by the next one
        before = len(step.graphs)
        ms, mr = step(s, f1, l1, 1.0), eager(r, f1, l1, 1.0)
        diff = _p16_equal(_p16_tensors(s), _p16_tensors(r)) + _p16_equal(
            _p16_metrics([ms]), _p16_metrics([mr]))
        out[label] = "equal" if not diff else f"{len(diff)} differ"
        bad += [f"{label}: {d}" for d in diff]
        if len(step.graphs) != before + 1:
            bad.append(f"{label}: no new capture ({before} -> {len(step.graphs)} graphs)")
    # a's optimizer state replaced by the checkpoint's, its parameters loaded in place
    old_opt = a.opt_state  # kept alive: the stale graph still writes there
    loaded = load_checkpoint(a, root)
    a.opt_state = loaded.opt_state
    a.model.load_state_dict(loaded.model.state_dict())
    a.step = loaded.step
    ref = a.clone()
    eager(ref, f0, l0, 1.0)
    snapshot = [t.clone() for t in state_tensors(a)]
    count0 = a.opt_state["count"]
    step(a, f0, l0, 1.0)  # the keyed path: a new capture
    diff = _p16_equal(_p16_tensors(a), _p16_tensors(ref))
    out["replaced opt_state"] = "equal" if not diff else f"{len(diff)} differ"
    bad += [f"replaced opt_state: {d}" for d in diff]
    for t, s in zip(state_tensors(a), snapshot):
        t.copy_(s)
    a.step, a.opt_state["count"] = loaded.step, count0
    first.run(a, f0, l0, 1.0)  # the planted fault: the old graph, stale optimizer state
    stale = _p16_equal(_p16_tensors(a), _p16_tensors(ref))
    out["planted stale replay"] = f"{len(stale)} of {len(snapshot)} tensors differ"
    if not stale:
        bad.append("the planted stale replay matched the eager step: the check cannot fail")
    del old_opt
    return out, bad


def _p16_trainer(chain, state, shapes, v2_cfg, k=4):
    """The Trainer's path, captured (the factories' default) against
    ``capture=False`` from the same state: staged batches of two chunk
    lengths, runs of K same-shape batches as supersteps and the rest as
    single steps, loss weights, held-out evaluation in between.  Returns
    the names of the tensors and log records that differ."""
    import numpy as np

    from sepi_tpu_torch.data import ChunkBatch
    from sepi_tpu_torch.train import Trainer, make_eval_step, make_superstep, make_xvec_step

    rng = np.random.default_rng(21)
    b, t = shapes.chunks, shapes.chunk_frames

    def batch(frames):
        return ChunkBatch(rng.normal(size=(b, frames, v2_cfg.feat_dim)).astype(np.float32),
                          rng.integers(0, v2_cfg.num_speakers, size=b).astype(np.int32), frames)

    lengths = [t] * k + [t * 3 // 2] * k + [t] * (k - 1) + [t * 3 // 2] * 2
    stream = [(batch(n), 0.5 if i % 3 == 0 else 1.0) for i, n in enumerate(lengths)]
    valid = [batch(t)]
    runs = []
    for capture in (None, False):
        st = state.clone()
        trainer = Trainer(steps={"xvec": make_xvec_step(chain, capture=capture)}, state=st,
                          log_every=3, valid_batches=valid, eval_steps={"xvec": make_eval_step()},
                          eval_every=5, supersteps={"xvec": make_superstep(chain, capture=capture)},
                          steps_per_dispatch=k)
        trainer.run(iter(stream), num_steps=len(stream))
        runs.append((st, trainer.history))
    (sg, hg), (se, he) = runs
    bad = _p16_equal(_p16_tensors(sg), _p16_tensors(se))
    if hg != he:
        bad.append(f"log records {hg[:2]} vs {he[:2]}")
    return bad, len(stream)


def time_ms_host(fn, iters=20, warmup=2) -> float:
    """Median host-clock ms of ``fn()`` followed by a synchronize."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _launch_profile(fn, n=P16_PROFILED):
    """torch.profiler over ``n`` calls of ``fn`` after a warm-up call:
    device busy and wall ms, device ops and host launch/copy calls, each
    per call."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    device_ops = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in device_ops) / 1e3
    api = collections.Counter(e.name for e in events
                              if e.device_type == torch.autograd.DeviceType.CPU
                              and e.name.startswith("cu") and any(
                                  w in e.name for w in ("Launch", "Memcpy", "Memset")))
    return {"busy_ms": busy_ms / n, "wall_ms": wall_ms / n, "idle": 1 - busy_ms / wall_ms,
            "device_ops": len(device_ops) / n, "host_calls": sum(api.values()) / n,
            "graph_launches": sum(v for k, v in api.items() if "Graph" in k) / n}


def phase_graphs(env, device="cuda", v2_cfg=None, shapes=None, steps=P16_STEPS,
                 workdir=None):
    """Phase 16: the captured CE step and superstep against the eager step
    (``capture=False``).  a. trajectories of ``steps`` steps bit-equal
    under deterministic cuDNN: the fp32 V2 with Muon and with momentum
    SGD, the bf16 V2 (also at two chunk lengths in turn) and the bf16 v5
    am+xvec pair, at the bench's shapes, and the Trainer's path (staging,
    supersteps, weights, evaluation);
    b. the K-step superstep (two replays) against 2K eager steps; c.
    recapture after `clone()` and `load_checkpoint`, and a planted stale
    replay that must differ; d. determinism off, 3 momentum-SGD steps
    within TRAJ_TOL; e. the device idle share and launches per call of the
    eager and the captured bf16 V2 step and v5 pair (torch.profiler, on
    the card).  ``v2_cfg`` and ``shapes`` narrow it for a CPU rehearsal."""
    import shutil

    import torch

    from sepi_tpu_torch import bench
    from sepi_tpu_torch.device import fp32_math
    from sepi_tpu_torch.models import V2_XVECTOR
    from sepi_tpu_torch.train import graphs, make_superstep, make_xvec_step

    shapes = shapes or bench.Shapes()
    v2_cfg = v2_cfg or dataclasses.replace(V2_XVECTOR, num_speakers=CV_SPEAKERS)
    root = workdir or os.path.join(ROOT, "build", "smoke_graphs")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0, wall, problems, lines = time.perf_counter(), {}, [], []
    graphs.reset_counts()
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    cudnn = torch.backends.cudnn
    deterministic = cudnn.deterministic
    with fp32_math():
        cudnn.deterministic = True
        try:
            configs = _p16_configs(device, v2_cfg, shapes, steps)
            for label, chain, state, tasks in configs:
                _, _, bad, n = _p16_trajectory(chain, state, tasks, steps)
                lines.append(f"{label} {'equal' if not bad else 'DIFFERS ' + str(bad[:4])} "
                             f"({n} graphs)")
                problems += [f"16a {label}: {b}" for b in bad]
            _, chain, state, _ = configs[0]  # the fp32 V2 with Muon
            bad_t, n_t = _p16_trainer(chain, state, shapes, v2_cfg)
            lines.append(f"the Trainer ({n_t} staged batches of two lengths, K=4 supersteps, "
                         f"weights, held-out evaluation) "
                         f"{'equal' if not bad_t else 'DIFFERS ' + str(bad_t[:4])}")
            problems += [f"16a Trainer: {b}" for b in bad_t]
            wall["16a"] = time.perf_counter() - t0

            t = time.perf_counter()
            _, chain, state, _ = configs[2]  # the bf16 V2
            k = shapes.superstep
            batches = _p16_batches(device, 2 * k, shapes.chunks, shapes.chunk_frames,
                                   v2_cfg.num_speakers, v2_cfg.feat_dim, seed=19)
            sg, se = state.clone(), state.clone()
            sstep, eager = make_superstep(chain), make_xvec_step(chain, capture=False)
            ones = torch.ones(k, device=device)
            mg, me = [], []
            for half in (batches[:k], batches[k:]):
                f = torch.stack([b[0] for b in half])
                lab = torch.stack([b[1] for b in half])
                m = sstep(sg, f, lab, ones)
                mg += [{n: v[i] for n, v in m.items()} for i in range(k)]
                me += [eager(se, f[i], lab[i], ones[i]) for i in range(k)]
            bad_b = _p16_equal(_p16_tensors(sg), _p16_tensors(se)) + _p16_equal(
                _p16_metrics(mg), _p16_metrics(me))
            if len(sstep.graphs) != 1:
                bad_b.append(f"{len(sstep.graphs)} superstep graphs")
            problems += [f"16b: {b}" for b in bad_b]
            wall["16b"] = time.perf_counter() - t

            t = time.perf_counter()
            _, chain, state, tasks = configs[0]  # the fp32 V2 with Muon
            stale, bad_c = _p16_stale(chain, state, tasks[0][1], root)
            problems += [f"16c: {b}" for b in bad_c]
            wall["16c"] = time.perf_counter() - t
        finally:
            cudnn.deterministic = deterministic

        t = time.perf_counter()
        cudnn.deterministic = False
        try:
            _, chain, state, tasks = configs[1]  # momentum SGD, as 7c holds the card
            sg, se, _, _ = _p16_trajectory(chain, state, tasks, 3)
            reading_d = _traj(_flat(sg.model), _flat(se.model), _flat(state.model))
        finally:
            cudnn.deterministic = deterministic
        if not reading_d <= TRAJ_TOL:
            problems.append(f"16d: determinism off, captured vs eager {reading_d:.3e} > "
                            f"{TRAJ_TOL}")
        wall["16d"] = time.perf_counter() - t

        t = time.perf_counter()
        profiles = {}
        if device != "cpu":
            for label, idx in (("bf16 V2 step", 2), ("bf16 v5 pair", -1)):
                _, chain, state, tasks = configs[idx]
                for mode in ("eager", "captured"):
                    st = state.clone()
                    fns = [make_xvec_step(chain, kw, capture=None if mode == "captured"
                                          else False) for kw, _ in tasks]

                    def call():
                        for fn, (_, b) in zip(fns, tasks):
                            fn(st, *b[0], 1.0)

                    profiles[(label, mode)] = _launch_profile(call)
        wall["16e"] = time.perf_counter() - t
    counts = dict(graphs.counts, live=graphs.live_graphs())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if device != "cpu" else 0.0
    shutil.rmtree(root, ignore_errors=True)
    total = time.perf_counter() - t0
    where = env["smi"] if env else device
    prof = "; ".join(
        f"{label} {mode}: idle {100 * p['idle']:.1f}% (device busy {p['busy_ms']:.3f} of "
        f"{p['wall_ms']:.3f} ms a call), {p['device_ops']:.1f} device ops and "
        f"{p['host_calls']:.1f} host launch/copy calls a call ({p['graph_launches']:.1f} "
        f"graph launches)" for (label, mode), p in profiles.items()) or "not measured (CPU)"
    log(f"phase 16 graphs on {where}: 16a {steps} steps captured vs eager (capture=False), "
        f"cudnn.deterministic, TF32 off, bench shapes ({shapes.chunks} x {shapes.chunk_frames}; "
        f"am {shapes.am_chunks} x {shapes.am_frames}): " + "; ".join(lines)
        + f"; 16b K={shapes.superstep} superstep x 2 vs {2 * shapes.superstep} eager steps (bf16 "
        f"V2): {'equal' if not bad_b else 'DIFFERS ' + str(bad_b[:4])}; 16c "
        + ", ".join(f"{k} {v}" for k, v in stale.items())
        + f"; 16d determinism off, 3 momentum-SGD steps ||p_captured - p_eager|| / ||p_eager - "
        f"p_init|| {reading_d:.3e} (limit {TRAJ_TOL}); 16e torch.profiler over "
        f"{P16_PROFILED} calls after one: {prof}; captures {counts['captures']}, replays "
        f"{counts['replays']}, live graphs {counts['live']}, peak memory {peak_gb:.2f} GB; "
        f"wall " + ", ".join(f"{k} {v:.1f} s" for k, v in wall.items())
        + f"; {total:.1f} s against its {P16_BUDGET_S:.0f} s budget "
        f"({'within' if total <= P16_BUDGET_S else 'over'})")
    if problems:
        raise AssertionError("phase 16: " + "; ".join(problems[:12]))
    return {"profiles": profiles, "stale": stale, "reading_d": reading_d, "counts": counts,
            "peak_gb": peak_gb, "wall": total}


P17_BUDGET_S = 60.0  # phase 17's wall, reported against this budget
P17_BUCKETS = (25, 400, 10000)  # 17e: the smallest, a middle and the largest bucket
P17_FRONTEND_BATCH = 16  # 17b: prepare_features_*'s batch_size


def _p17_features(ladder, feat_dim, seed=17):
    """utt -> (T, feat_dim) features whose chunks fill every bucket of
    ``ladder`` (each bucket's own length and one just above the bucket
    below it), 36 more of the second bucket's length (two batches of 32:
    a replay within one pass), and one utterance of three chunks."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths, prev = [], 0
    for b in ladder:
        lengths += [b, max(prev + 1, ladder[0])]
        prev = b
    lengths += [ladder[1]] * 36 + [2 * ladder[-1] + 3 * ladder[0]]
    return {f"p17u{i:03d}": rng.standard_normal((n, feat_dim)).astype(np.float32)
            for i, n in enumerate(lengths)}


def _p17_diff(got, want) -> list:
    """The utterances whose embeddings are not equal."""
    import numpy as np

    return sorted(u for u in want if u not in got or not np.array_equal(got[u], want[u]))


def _p17_extraction(device, v2_cfg, ecfg, feats):
    """17a: `EmbeddingExtractor` captured (the default) against
    ``capture=False`` over every bucket, fp32 and bf16, a capturing pass and
    a replayed one; then (fp32) new weights by `load_state_dict` (no new
    capture), the model moved onto new storage and loaded again (a capture
    per bucket), and the planted stale replay: a graph of the old storage
    replayed, which must differ.  Returns (lines, problems, the fp32
    extractors, the planted reading)."""
    import numpy as np
    import torch

    from sepi_tpu_torch import graphs
    from sepi_tpu_torch.extract import EmbeddingExtractor, bucket_ladder
    from sepi_tpu_torch.models import XVector

    mf = v2_cfg.min_frames
    ladder = bucket_ladder(ecfg, mf)
    fp32 = random_xvector(v2_cfg, 17, device)
    bf16 = XVector(v2_cfg, dtype="bfloat16")
    bf16.load_state_dict(fp32.state_dict())
    lines, bad, pairs = [], [], {}
    for label, model in (("fp32", fp32), ("bf16", bf16.to(device).eval())):
        cap = EmbeddingExtractor(model, ecfg, min_frames=mf, device=device)
        eag = EmbeddingExtractor(model, ecfg, min_frames=mf, device=device, capture=False)
        pairs[label] = (cap, eag)
        want = eag.extract_utterances(feats)
        for run in ("capturing", "replayed"):
            d = _p17_diff(cap.extract_utterances(feats), want)
            bad += [f"17a {label} {run} pass: {len(d)} embeddings differ, e.g. {d[:3]}"] if d else []
        if len(cap.graphs.graphs) != len(ladder):
            bad.append(f"17a {label}: {len(cap.graphs.graphs)} graphs for {len(ladder)} buckets")
        lines.append(f"{label} {len(want)} utts over buckets {ladder[0]}..{ladder[-1]}")
    cap, eag = pairs["fp32"]
    steps = {}
    before = graphs.call_counts["captures"]
    fp32.load_state_dict(random_xvector(v2_cfg, 18, "cpu").state_dict())
    d = _p17_diff(cap.extract_utterances(feats), eag.extract_utterances(feats))
    steps["load_state_dict"] = (d, graphs.call_counts["captures"] - before)
    mid = ladder[len(ladder) // 2]
    # a graph's key: ((static, (the model's, the features', the mask's signature), flags), ident);
    # the middle bucket's graph, at its row rung
    old = next(g for key, g in cap.graphs.graphs.items() if key[0][1][1][0][1] == mid)
    shape = tuple(old.args[1].shape)
    fp32.to(torch.float64).to(torch.float32)  # new storage for every floating tensor
    fp32.load_state_dict(random_xvector(v2_cfg, 19, "cpu").state_dict())
    before = graphs.call_counts["captures"]
    d = _p17_diff(cap.extract_utterances(feats), eag.extract_utterances(feats))
    steps["moved"] = (d, graphs.call_counts["captures"] - before)
    for what, (d, n) in steps.items():
        want_n = 0 if what == "load_state_dict" else len(ladder)
        if d or n != want_n:
            bad.append(f"17a {what}: {len(d)} embeddings differ (e.g. {d[:3]}), {n} captures "
                       f"(expected {want_n})")
    if len(cap.graphs.graphs) != len(ladder):
        bad.append(f"17a moved: {len(cap.graphs.graphs)} graphs live for {len(ladder)} buckets")
    x = torch.from_numpy(np.random.default_rng(23).standard_normal(shape).astype(np.float32))
    m = torch.ones(shape[:2], dtype=torch.bool)
    stale = old.run([fp32, x, m])  # the planted fault: a graph bound to the replaced weights
    fresh = eag.graphs(fp32, x, m)
    rows = int((stale != fresh).any(-1).sum())
    planted = f"{rows} of {shape[0]} embeddings differ"
    if rows == 0:
        bad.append("17a: the planted stale replay matched the eager forward: the check cannot "
                   "fail")
    lines.append(", ".join(f"{k} {'equal' if not d else 'DIFFERS'} ({n} captures)"
                           for k, (d, n) in steps.items()) + f", planted stale replay {planted}")
    return lines, bad, pairs["fp32"], planted


def _p17_audio(n_same=64, n_odd=8, seed=17):
    """Amplitude-modulated noise: ``n_same`` utterances of 3.0-3.2 s (one
    padded shape: a capture, then replays) and ``n_odd`` of 1-6 s."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = list(rng.integers(int(3.0 * SR), int(3.2 * SR), n_same))
    lengths += list(rng.integers(SR, 6 * SR, n_odd))
    return {f"p17a{i:03d}": (rng.standard_normal(n) * 1000.0
                             * (1.2 + np.sin(np.arange(n) / 700.0))).astype(np.float32)
            for i, n in enumerate(lengths)}


def _p17_frontend(device, audio, batch=P17_FRONTEND_BATCH):
    """17b: `_frontend_batches` (MFCC -> VAD -> [deltas] -> CMVN) captured
    against ``capture=False``: dithered, undithered, with the v1 deltas and
    on the stepwise route; features, voiced masks and frame counts equal.
    The captured runs' MFCC batches, replayed ones included, held against
    the plain version; the MFCC launches counted through the replays.
    Returns (lines, problems, launches, max abs err)."""
    import numpy as np

    from sepi_tpu_torch.config import MFCC_SRE_IVECTOR, CmvnConfig, FrontendConfig, VadConfig
    from sepi_tpu_torch.ops import FeatureExtractor, mfcc_cuda
    from sepi_tpu_torch.ops.deltas import add_deltas
    from sepi_tpu_torch.recipes.pipeline import _frontend_batches

    cases = (("dithered", FrontendConfig(), "auto", 5, None),
             ("undithered", FrontendConfig(dither=0.0), "auto", None, None),
             ("deltas (v1)", MFCC_SRE_IVECTOR, "auto", None,
              lambda f, m: add_deltas(f, m, order=2)),
             ("stepwise dithered", FrontendConfig(), "slices", 5, None))
    lines, bad, launches, worst = [], [], 0, 0.0
    for label, cfg, mode, key, transform in cases:
        fe = FeatureExtractor(cfg, device, spectral_mode=mode)

        def run(capture):
            return list(_frontend_batches(audio, fe, VadConfig(), CmvnConfig(), key, batch,
                                          transform=transform, capture=capture))

        mfcc_cuda.mfcc_fused.launches = 0
        with _MfccCapture() as cap:
            got = run(None)
        n = mfcc_cuda.mfcc_fused.launches
        want = run(False)
        diff = [i for i, (g, w) in enumerate(zip(got, want))
                if g[0] != w[0] or not all(np.array_equal(a, b) for a, b in zip(g[1:], w[1:]))]
        if diff or len(got) != len(want):
            bad.append(f"17b {label}: batches {diff[:4]} of {len(want)} differ")
        expect = len(got) if fe.fused and device != "cpu" else 0
        if n != expect:
            bad.append(f"17b {label}: {n} MFCC launches for {len(got)} batches (expected {expect})")
        launches += n
        held = ""
        if fe.fused:
            replayed, kept = cap.replayed, len(cap.batches)
            err = max((e for _, e in cap.check(bad, f"17b {label}").values()), default=0.0)
            worst = max(worst, err)
            if kept != len(got) or replayed <= 0:
                bad.append(f"17b {label}: {kept} MFCC batches kept ({replayed} replayed) for "
                           f"{len(got)} batches")
            held = f", MFCC {kept} batches ({replayed} replayed) vs plain max abs {err:.3e}"
        lines.append(f"{label} {'equal' if not diff else 'DIFFERS'} ({len(got)} batches, "
                     f"{len({g[1].shape for g in got})} shapes, {n} launches{held})")
    return lines, bad, launches, worst


def _p17_eval(device, v2_cfg, shapes):
    """17c: `make_eval_step` captured (the default) against
    ``capture=False``, fp32 and bf16, two batch shapes each called twice:
    objf and accuracy equal.  Returns (lines, problems)."""
    import torch

    from sepi_tpu_torch.train import make_eval_step

    lines, bad = [], []
    b, t = shapes.chunks, shapes.chunk_frames
    batches = (_p16_batches(device, 2, b, t, v2_cfg.num_speakers, v2_cfg.feat_dim, seed=24)
               + _p16_batches(device, 2, b, t * 3 // 2, v2_cfg.num_speakers, v2_cfg.feat_dim,
                              seed=25))
    for dtype in ("float32", "bfloat16"):
        _, state = _train_state(v2_cfg, device, dtype=dtype)
        ev, ev_e = make_eval_step(), make_eval_step(capture=False)
        diff = []
        for i, (f, lab) in enumerate(batches):
            got, want = ev(state, f, lab), ev_e(state, f, lab)
            diff += [f"{i} {k}" for k in want if not torch.equal(got[k], want[k])]
        bad += [f"17c {dtype}: {d}" for d in diff]
        lines.append(f"{dtype} {'equal' if not diff else 'DIFFERS'} ({len(batches)} batches, "
                     f"{len(ev.graphs.graphs)} graphs)")
    return lines, bad


def _p17_bench_programs(device, shapes):
    """17d: the bench's two programs captured against the same functions
    called eagerly, three calls each: the scoring at its trial matrix and
    the extraction chain at its batch.  Returns (lines, problems, the
    chain's inputs for 17e)."""
    import numpy as np
    import torch

    from sepi_tpu_torch import bench
    from sepi_tpu_torch.config import FrontendConfig
    from sepi_tpu_torch.graphs import CallGraphs
    from sepi_tpu_torch.ops import FeatureExtractor
    from sepi_tpu_torch.ops.framing import num_frames

    lines, bad = [], []
    dim, m, n = shapes.plda_dim, shapes.plda_models, shapes.plda_tests
    rng = np.random.default_rng(26)
    q = np.linalg.qr(rng.normal(size=(dim, dim)))[0]
    inputs = [torch.from_numpy(np.asarray(a, np.float32)).to(device)
              for a in (rng.normal(size=dim), q, rng.uniform(0.1, 5.0, dim),
                        rng.normal(size=(m, dim)), rng.normal(size=(n, dim)))]
    scoring = bench.plda_scoring(torch.device(device))
    program = CallGraphs(scoring, device=device)
    diff = [i for i in range(3) if not torch.equal(program(*inputs), scoring(*inputs))]
    bad += [f"17d scoring call {i} differs" for i in diff]
    lines.append(f"scoring {m} x {n} x {dim} {'equal' if not diff else 'DIFFERS'}")

    cfg = FrontendConfig()
    samples = int(SR * shapes.secs)
    t_max = int(num_frames(samples, cfg))
    model = random_xvector(shapes.xvector, 1, device)
    x, lens, seeds = _mfcc_inputs(shapes.utts, [samples] * shapes.utts, samples, 2, device)
    chain = bench.extraction_chain(FeatureExtractor(cfg, device), t_max)
    program = CallGraphs(chain)
    diff = []
    with torch.no_grad():
        for i in range(3):
            got, want = program(model, x, lens, seeds), chain(model, x, lens, seeds)
            diff += [f"{i}.{j}" for j, (a, b) in enumerate(zip(got, want)) if not torch.equal(a, b)]
    bad += [f"17d extraction chain output {d} differs" for d in diff]
    lines.append(f"extraction chain {shapes.utts} x {shapes.secs:.0f} s "
                 f"{'equal' if not diff else 'DIFFERS'}")
    return lines, bad, (model, chain, program, x, lens, seeds)


def phase_serving(env, device="cuda", v2_cfg=None, ecfg=None, shapes=None, audio=None,
                  frontend_batch=P17_FRONTEND_BATCH, buckets=P17_BUCKETS):
    """Phase 17: the compiled serving path (`graphs.CallGraphs`) against the
    eager one (``capture=False``) under deterministic cuDNN: a. the
    extractor over every bucket, fp32 and bf16, weights loaded in place and
    moved, and a planted stale replay that must differ; b. the frontend
    chain, dithered, undithered, with deltas and stepwise; c. the eval
    step; d. the bench's scoring and extraction programs; e. (on the card)
    eager against captured per call at ``buckets`` and the bench chain:
    device ms, device ops and host launch calls (torch.profiler), the
    host-clock ms without the tracer, and the idle share against each.
    ``v2_cfg``, ``ecfg``, ``shapes``, ``audio`` and
    ``frontend_batch`` narrow it for a CPU rehearsal."""
    import numpy as np
    import torch

    from sepi_tpu_torch import bench, graphs
    from sepi_tpu_torch.config import ExtractConfig
    from sepi_tpu_torch.device import fp32_math
    from sepi_tpu_torch.models import V2_XVECTOR

    shapes = shapes or bench.Shapes()
    v2_cfg = v2_cfg or dataclasses.replace(V2_XVECTOR, num_speakers=CV_SPEAKERS)
    ecfg = ecfg or ExtractConfig()
    t0, wall, problems, lines = time.perf_counter(), {}, [], {}
    graphs.reset_counts()
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    cudnn = torch.backends.cudnn
    deterministic = cudnn.deterministic
    with fp32_math():
        cudnn.deterministic = True
        try:
            from sepi_tpu_torch.extract import bucket_ladder

            feats = _p17_features(bucket_ladder(ecfg, v2_cfg.min_frames), v2_cfg.feat_dim)
            lines["17a"], bad, (cap, eag), planted = _p17_extraction(device, v2_cfg, ecfg, feats)
            problems += bad
            wall["17a"] = time.perf_counter() - t0
            t = time.perf_counter()
            lines["17b"], bad, launches, mfcc_err = _p17_frontend(device, audio or _p17_audio(),
                                                           frontend_batch)
            problems += bad
            wall["17b"] = time.perf_counter() - t
            t = time.perf_counter()
            lines["17c"], bad = _p17_eval(device, v2_cfg, shapes)
            problems += bad
            wall["17c"] = time.perf_counter() - t
            t = time.perf_counter()
            lines["17d"], bad, chain_run = _p17_bench_programs(device, shapes)
            problems += bad
            wall["17d"] = time.perf_counter() - t
        finally:
            cudnn.deterministic = deterministic

        t = time.perf_counter()
        profiles = {}
        if device != "cpu":
            rng = np.random.default_rng(27)
            bs = ecfg.batch_size
            model, chain, program, x, lens, seeds = chain_run
            calls = {}
            for b in buckets:
                f = rng.standard_normal((bs, b, v2_cfg.feat_dim)).astype(np.float32)
                m = np.ones((bs, b), bool)
                calls[f"bucket {bs} x {b}"] = (lambda f=f, m=m: eag._embed(f, m),
                                               lambda f=f, m=m: cap._embed(f, m))
            calls[f"bench chain {shapes.utts} x {shapes.secs:.0f} s"] = (
                lambda: chain(model, x, lens, seeds), lambda: program(model, x, lens, seeds))
            with torch.no_grad():
                for label, fns in calls.items():
                    for mode, fn in zip(("eager", "captured"), fns):
                        p = profiles[(label, mode)] = _launch_profile(fn)
                        # the tracer's own cost a call is in p["wall_ms"]: the host
                        # clock without it, and the idle share against that
                        p["host_ms"] = time_ms_host(fn)
                        p["host_idle"] = 1 - p["busy_ms"] / p["host_ms"]
        wall["17e"] = time.perf_counter() - t
    counts = dict(graphs.counts, infer=dict(graphs.call_counts), live=graphs.live_graphs())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if device != "cpu" else 0.0
    total = time.perf_counter() - t0
    if device != "cpu" and counts["infer"]["replays"] <= 0:
        problems.append(f"phase 17 replayed no inference graph: {counts}")
    where = env["smi"] if env else device
    prof = "; ".join(
        f"{label} {mode}: {p['busy_ms']:.3f} device ms a call, host clock {p['host_ms']:.3f} "
        f"ms (idle {100 * p['host_idle']:.1f}%), traced {p['wall_ms']:.3f} ms (idle "
        f"{100 * p['idle']:.1f}%), {p['device_ops']:.1f} device ops, {p['host_calls']:.1f} host "
        f"launch/copy calls ({p['graph_launches']:.1f} graph launches)"
        for (label, mode), p in profiles.items()) or "not measured (CPU)"
    log(f"phase 17 serving graphs on {where}: captured vs eager (capture=False), "
        f"cudnn.deterministic, TF32 off: "
        + "; ".join(f"{k} " + ", ".join(v) for k, v in lines.items())
        + f"; 17e torch.profiler over {P16_PROFILED} calls after one: {prof}; captures "
        f"{counts['captures']} ({counts['infer']['captures']} inference), replays "
        f"{counts['replays']} ({counts['infer']['replays']} inference), live graphs "
        f"{counts['live']}, peak memory {peak_gb:.2f} GB; wall "
        + ", ".join(f"{k} {v:.1f} s" for k, v in wall.items())
        + f"; {total:.1f} s against its {P17_BUDGET_S:.0f} s budget "
        f"({'within' if total <= P17_BUDGET_S else 'over'})")
    if problems:
        raise AssertionError("phase 17: " + "; ".join(problems[:12]))
    return {"launches": launches, "mfcc_err": mfcc_err, "planted": planted, "counts": counts,
            "profiles": profiles, "peak_gb": peak_gb, "wall": total}


P15_BUDGET_S = 60.0  # phase 15's wall, reported against this budget
P15_REPEATS = 10  # timed runs per measurement


def phase_bench(env, device="cuda", repeats=P15_REPEATS, shapes=None):
    """Phase 15: `sepi_tpu_torch.bench.main` in-process (it prints its own
    JSON line), with the MFCC's launches counted from 0 around it.
    ``shapes`` narrows it for a CPU rehearsal (``device="cpu"``)."""
    import torch

    from sepi_tpu_torch import bench, graphs
    from sepi_tpu_torch.ops import mfcc_cuda

    shapes = shapes or bench.Shapes()
    t0 = time.perf_counter()
    mfcc_cuda.mfcc_fused.launches = 0
    graphs.reset_counts()
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    line, runs = bench.main(device=device, repeats=repeats, shapes=shapes)
    launches = mfcc_cuda.mfcc_fused.launches
    problems = []
    graph_counts = _graph_counts(device, "the bench", problems, inference=True)
    if problems:
        raise AssertionError("phase 15: " + "; ".join(problems))
    wall = time.perf_counter() - t0
    # the capturing call, the checked replay, then the captured and the eager
    # warm-ups and timed runs, one launch each
    calls = runs["extraction"].calls
    if device != "cpu" and launches != calls:
        raise AssertionError(f"phase 15: {launches} MFCC launches, {calls} extraction calls")
    ext, tr, pl = runs["extraction"], runs["training"], runs["plda"]
    where = env["smi"] if env else device
    log(f"phase 15 bench on {where}: {line['value']} audio-s/s ({ext.timing.median:.3f} ms a "
        f"{shapes.utts} x {shapes.secs:.0f} s batch), v2 bf16 step "
        f"{line['extra']['v2_train_ms_per_step']} ms, K={shapes.superstep} superstep "
        f"{line['extra']['v2_superstep16_ms_per_step']} ms a step, v5 pair "
        f"{line['extra']['v5_multitask_ms_per_step_pair']} ms, K={shapes.pair_superstep} pair "
        f"superstep {line['extra']['v5_superstep8_ms_per_step_pair']} ms a pair, PLDA "
        f"{line['extra']['plda_trials_per_s']:.4e} trials/s ({pl.timing.median:.3f} ms); medians "
        f"of R={repeats} timed runs (quartiles on stderr); checks: MFCC vs plain "
        f"{ext.mfcc_err:.3e} (limit {bench.MFCC_TOL}), embeddings {tuple(ext.embeddings.shape)} "
        f"finite, last objf " + ", ".join(f"{k} {v:.4f}" for k, v in tr.objf.items())
        + f", trial block vs float64 {pl.block_err:.3e} (limit {bench.PLDA_RTOL}); MFCC "
        f"launches {launches}; {_fmt_graphs(graph_counts)}; eager (capture=False) medians "
        f"extraction {ext.eager_timing.median:.3f} ms, "
        + ", ".join(f"{n} {t.median / per:.3f} ms" for (n, t), per in zip(
            tr.eager_timings.items(), (1, shapes.superstep, 1, shapes.pair_superstep)))
        + f", PLDA {pl.eager_timing.median:.3f} ms"
        + f"; {wall:.1f} s against its {P15_BUDGET_S:.0f} s budget "
        f"({'within' if wall <= P15_BUDGET_S else 'over'})")
    return {"launches": launches, "mfcc_err": ext.mfcc_err, "line": line, "wall": wall,
            "graphs": graph_counts}


P18_ROWS, P18_FRAMES = 32, 10000  # the largest bucket of ExtractConfig(), full
P18_MIN_FRAMES = 7  # the MFA-Conformer's shortest input
P18_BUCKETS = (10000, 3200, 400)  # 18c: the score kernel timed at these buckets' query blocks
RELPOS_TOL = 1e-6  # max abs error of a probability: each is in [0, 1], its exp within an ulp or two
P18_EMBED_RTOL = 5e-5  # captured vs eager embeddings, relative l2: the cell's limit
P18_BUDGET_S = 60.0  # phase 18's wall, reported against this budget


def random_conformer(cfg, seed: int, device):
    """An MfaConformer with weights from a seeded torch.Generator, the
    norms' scales and the batch norms' statistics away from 1 and 0, and
    the position biases u and v away from 0."""
    import torch

    from sepi_tpu_torch.models import MfaConformer

    model = MfaConformer(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim > 1:
                p.copy_(torch.randn(p.shape, generator=g) / p[0].numel() ** 0.5)
            elif name.endswith("weight"):
                p.copy_(0.5 + torch.rand(p.shape, generator=g))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + 1.5 * torch.rand(buf.shape, generator=g))
    return model.to(device).eval()


def _relpos_case(b, h, q, t, seed, device):
    """Seeded ``ac`` and, in the model's layout ((H, B, ...) transposed),
    ``bd`` of a query block; every third batch row has no valid key."""
    import torch

    g = torch.Generator().manual_seed(seed)
    ac = (4 * torch.randn((b, h, q, t), generator=g)).to(device)
    bd = (4 * torch.randn((h, b, q, q + t - 1), generator=g)).to(device).transpose(0, 1)
    lens = torch.tensor([(t, t // 2, 0)[i % 3] for i in range(b)], dtype=torch.int32,
                        device=device)
    return ac, bd, lens


def phase_conformer(env, device="cuda", cfg=None, rows=P18_ROWS, frames=P18_FRAMES,
                    ecfg=None, buckets=P18_BUCKETS):
    """Phase 18: the MFA-Conformer's attention score kernel on the main
    path.  a. a bucket of ``rows`` utterances of about ``frames`` frames
    through `EmbeddingExtractor` eagerly, every `relpos_softmax` call of
    every block held against `relpos_softmax_reference` on the same
    inputs (the query blocks the model hands it); b. the same utterances
    captured and then replayed, the kernel's launches counted from 0
    around each call and the replay's held to one a block and query
    block, the embeddings against 18a's, the memory peak; c. the kernel,
    its plain version and its byte bound timed at the query blocks of
    ``buckets`` at ``rows`` rows (CUDA events).  ``cfg`` and ``ecfg``
    narrow it for a CPU rehearsal (``device="cpu"``), where the score
    route is the plain one and nothing is timed."""
    import numpy as np
    import torch

    from sepi_tpu_torch.config import ExtractConfig
    from sepi_tpu_torch.extract import EmbeddingExtractor
    from sepi_tpu_torch.models import MfaConformerConfig
    from sepi_tpu_torch.models import conformer as C
    from sepi_tpu_torch.ops import relpos_softmax as R

    t0 = time.perf_counter()
    cfg = cfg or MfaConformerConfig()
    ecfg = ecfg or ExtractConfig(embedding_node="embedding")
    model = random_conformer(cfg, 18, device)
    g = np.random.default_rng(18)
    step = max(frames // (8 * rows), 1)  # every length in the one bucket of ``frames``
    feats = {f"u{i:02d}": g.standard_normal((frames - step * i, cfg.feat_dim)).astype(np.float32)
             for i in range(rows)}
    ts = C.subsampled_frames(frames)
    per_layer = -(-ts // C.query_rows(rows, cfg.num_heads, ts, C.ATTENTION_BLOCK_BYTES))
    want_launches = cfg.num_blocks * per_layer

    kernel, checked = C.relpos_softmax, []

    def held(ac, bd, lengths, scale):
        before = ac.clone()
        out = kernel(ac, bd, lengths, scale)
        want = R.relpos_softmax_reference(before, bd, lengths, scale)
        checked.append((tuple(ac.shape), bool(torch.isfinite(out).all()),
                        float((out - want).abs().max())))
        return out

    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    problems = []
    try:
        C.relpos_softmax = held
        try:
            eager = EmbeddingExtractor(model, ecfg, min_frames=P18_MIN_FRAMES, device=device,
                                       capture=False).extract_utterances(feats)
        finally:
            C.relpos_softmax = kernel
        err = max((e for _, _, e in checked), default=0.0)
        shapes = sorted({s for s, _, _ in checked})
        if len(checked) != want_launches:
            problems.append(f"18a: {len(checked)} score calls, want {want_launches}")
        if not all(f for _, f, _ in checked) or not err <= RELPOS_TOL:
            problems.append(f"18a: score max abs err {err:.3e} (limit {RELPOS_TOL}) or not finite")
        if device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        ext = EmbeddingExtractor(model, ecfg, min_frames=P18_MIN_FRAMES, device=device)
        launches = []
        for _ in range(2):
            R.relpos_softmax.launches = 0
            got = ext.extract_utterances(feats)
            launches.append(R.relpos_softmax.launches)
        peak_gb = _peak_gb(device)
        if device != "cpu" and (launches[1] != want_launches or launches[0] < want_launches):
            problems.append(f"18b: launches {launches} (capturing call, replay), want "
                            f"{want_launches} a call")
        gap = max(float(np.linalg.norm(got[k] - eager[k]) / np.linalg.norm(eager[k]))
                  for k in feats)
        if not gap <= P18_EMBED_RTOL:
            problems.append(f"18b: captured vs eager embeddings {gap:.3e} > {P18_EMBED_RTOL}")

        cases = []
        if device != "cpu":
            for bucket in buckets:
                t = C.subsampled_frames(bucket)
                q = C.query_rows(rows, cfg.num_heads, t, C.ATTENTION_BLOCK_BYTES)
                ac, bd, lens = _relpos_case(rows, cfg.num_heads, q, t, bucket, device)
                scale = 1.0 / math.sqrt(cfg.d_model // cfg.num_heads)
                want = R.relpos_softmax_reference(ac, bd, lens, scale)
                out = R.relpos_softmax(ac.clone(), bd, lens, scale)
                e = float((out - want).abs().max())
                if not bool(torch.isfinite(out).all()) or not e <= RELPOS_TOL:
                    problems.append(f"18c {tuple(ac.shape)}: max abs err {e:.3e} or not finite")
                del out, want
                # the kernel overwrites its input: each timed call reads the last one's probabilities
                ms = time_ms(lambda: R.relpos_softmax(ac, bd, lens, scale))
                plain_ms = time_ms(lambda: R.relpos_softmax_reference(ac, bd, lens, scale))
                bound_ms = 12.0 * ac.numel() / env["peak_bw"] * 1e3
                cases.append({"bucket": bucket, "shape": list(ac.shape), "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound_ms, "max_abs_err": e})
                err = max(err, e)
                del ac, bd
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    wall = time.perf_counter() - t0
    where = env["smi"] if env else device
    times = "; ".join(
        f"{c['shape'][0]} x {c['shape'][1]} x {c['shape'][2]} x {c['shape'][3]} (bucket "
        f"{c['bucket']}): kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, byte bound "
        f"{c['bound_ms']:.4f} ms ({100 * c['bound_ms'] / c['ms']:.1f}% of it)"
        for c in cases) or "not measured (CPU)"
    log(f"phase 18 MFA-Conformer score kernel on {where}: 18a {rows} utterances of "
        f"{frames - step * (rows - 1)}..{frames} frames, {len(checked)} score calls at "
        f"{shapes} held against the plain version, max abs err {err:.3e} (limit {RELPOS_TOL}); "
        f"18b relpos_softmax launches {launches[0]} (capturing call), {launches[1]} (replay), "
        f"{want_launches} a forward ({cfg.num_blocks} blocks x {per_layer} query blocks), "
        f"captured vs eager {gap:.3e}, peak memory {peak_gb:.2f} GB; 18c {times}; "
        f"{wall:.1f} s against its {P18_BUDGET_S:.0f} s budget "
        f"({'within' if wall <= P18_BUDGET_S else 'over'})")
    if problems:
        raise AssertionError("phase 18: " + "; ".join(problems))
    rec = {
        "name": "relpos_softmax", "route": "triton",
        "source": "sepi_tpu_torch/ops/relpos_softmax.py",
        "replaces": None,
        "launches": launches[0], "launches_replay": launches[1],
        "shapes_main_path": [list(s) for s in shapes],
        "max_abs_err": err,
        **{k: cases[0][k] if cases else None for k in ("ms", "plain_ms", "bound_ms", "shape")},
        "bound_by": "bytes", "library_ms": None,
        "cases": cases,
    }
    return {"record": rec, "peak_gb": peak_gb, "gap": gap, "wall": wall}


def main() -> int:
    # the smoke drives one card: its spawned ranks see that card alone
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = visible.split(",")[0] if visible else "0"
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import sepi_tpu_torch  # noqa: F401  (fails outside the repository)

    env = phase_environment()
    phase_build()
    mfcc = phase_kernels(env)
    vit = phase_viterbi(env)
    main_counts = phase_main_path()
    mfcc["launches"] = main_counts["launches"]
    phase_throughput(env)
    s5 = phase_s5(env)
    mfcc["launches_s5_path"] = s5["launches"]["mfcc_fused"]
    t7 = [time.perf_counter()]
    fp32_v2 = phase_train_step(env)
    t7.append(time.perf_counter())
    train = phase_train_path(env)
    mfcc["launches_train_path"] = train["launches"]
    t7.append(time.perf_counter())
    phase_train_agreement(env, train["nosil"], train["dataset"])
    t7.append(time.perf_counter())
    log(f"phase 7 wall on {env['smi']}: 7a {t7[1] - t7[0]:.1f} s, 7b {t7[2] - t7[1]:.1f} s, "
        f"7c {t7[3] - t7[2]:.1f} s")
    t8 = [time.perf_counter()]
    fp32_cv = phase_cvector_steps(env)
    t8.append(time.perf_counter())
    cvec = phase_cvector_path(env, s5)
    t8.append(time.perf_counter())
    phase_cvector_agreement(env, s5, cvec["am_model"])
    t8.append(time.perf_counter())
    log(f"phase 8 wall on {env['smi']}: 8a {t8[1] - t8[0]:.1f} s, 8b {t8[2] - t8[1]:.1f} s, "
        f"8c {t8[3] - t8[2]:.1f} s")
    t9 = time.perf_counter()
    drv = phase_driver_path(env, keep_s5=True)
    log(f"phase 9 wall on {env['smi']}: {time.perf_counter() - t9:.1f} s")
    t10 = [time.perf_counter()]
    v1 = phase_v1_path(env, drv["corpus"])
    t10.append(time.perf_counter())
    dnn = phase_v1_dnn_path(env, drv["corpus"])
    t10.append(time.perf_counter())
    phase_v1_agreement(env, v1, dnn)
    t10.append(time.perf_counter())
    log(f"phase 10 wall on {env['smi']}: 10a {t10[1] - t10[0]:.1f} s, 10b {t10[2] - t10[1]:.1f} s, "
        f"10c {t10[3] - t10[2]:.1f} s")
    t11 = [time.perf_counter()]
    phase_bf16_steps(env, fp32_v2, fp32_cv)
    t11.append(time.perf_counter())
    phase_bf16_agreement(env)
    t11.append(time.perf_counter())
    bf16 = phase_bf16_driver(env, drv)
    t11.append(time.perf_counter())
    phase_device_backend(env, drv)
    t11.append(time.perf_counter())
    wall11 = t11[-1] - t11[0]
    log(f"phase 11 wall on {env['smi']}: 11a {t11[1] - t11[0]:.1f} s, 11b {t11[2] - t11[1]:.1f} s, "
        f"11c {t11[3] - t11[2]:.1f} s, 11d {t11[4] - t11[3]:.1f} s; {wall11:.1f} s against its "
        f"{P11_BUDGET_S:.0f} s budget ({'within' if wall11 <= P11_BUDGET_S else 'over'})")
    cli_run = phase_cli(env, drv["corpus"])
    mesh_run = phase_mesh(env, drv)
    parity = phase_parity(env)
    phase_graphs(env)
    serving = phase_serving(env)
    bench_run = phase_bench(env)
    conformer = phase_conformer(env)
    # the c-vector path: its front half is phase 6's run (features, s5,
    # labels), its back half phase 8b (training, unseen-speaker features,
    # extraction, scoring); each counted from 0 around its own run
    cv_launches = {k: s5["launches"][k] + cvec["launches"][k] for k in s5["launches"]}
    log(f"c-vector path launches: phase 6 {s5['launches']} + phase 8b {cvec['launches']}")
    mfcc["launches_cvector_path"] = cv_launches["mfcc_fused"]
    mfcc["launches_driver_path"] = drv["launches"]["mfcc_fused"]
    mfcc["launches_v1_path"] = v1["launches"]
    mfcc["launches_v1_dnn_path"] = dnn["launches"]
    mfcc["launches_bf16_driver_path"] = bf16["launches"]
    mfcc["launches_cli_path"] = cli_run["launches"]["mfcc_fused"]
    mfcc["launches_mesh_path"] = mesh_run["launches"]
    mfcc["launches_parity_path"] = parity["launches"]
    mfcc["launches_bench_path"] = bench_run["launches"]
    mfcc["launches_serving_graphs"] = serving["launches"]
    mfcc["max_abs_err_v1_path"] = {f"C={c}": e for c, (_, e) in sorted(
        {**v1["mfcc"], **{c: (n, max(e, v1["mfcc"].get(c, (0, 0.0))[1]))
                          for c, (n, e) in dnn["mfcc"].items()}}.items())}
    mfcc["max_abs_err"] = max([mfcc["max_abs_err"], s5["mfcc_err"], drv["mfcc_err"],
                               bf16["mfcc_err"], cli_run["mfcc_err"], mesh_run["mfcc_err"],
                               parity["mfcc_err"], bench_run["mfcc_err"], serving["mfcc_err"]]
                              + [e for _, e in v1["mfcc"].values()]
                              + [e for _, e in dnn["mfcc"].values()])
    timing = s5["viterbi_timing"]
    vit_rec = {
        "name": "viterbi_batch", "route": "cuda",
        "source": "sepi_tpu_torch/csrc/viterbi.cu",
        "replaces": VITERBI_REPLACES,
        "launches": s5["launches"]["viterbi_batch"],
        "launches_cvector_path": cv_launches["viterbi_batch"],
        "launches_driver_path": drv["launches"]["viterbi_batch"],
        "shapes_driver_path": drv["viterbi_shapes"],
        "launches_cli_path": cli_run["launches"]["viterbi_batch"],
        "shapes_cli_path": cli_run["viterbi_shapes"],
        "max_abs_err": max(vit["max_abs_err"], s5["viterbi_err"], drv["viterbi_err"],
                           cli_run["viterbi_err"]),
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None,
        "shape": s5["viterbi_shape"],
        "cases": vit["cases"],
    }
    print(json.dumps({"kernels": [mfcc, vit_rec, conformer["record"]]}), flush=True)
    print(nvidia_smi_line(), flush=True)
    # CUDA_VISIBLE_DEVICES holds the one card the run used (set above)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
