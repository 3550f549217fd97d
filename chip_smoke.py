#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sepi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; a failing phase raises and the script exits
non-zero:
  1. environment: torch, the card's name and power limit; TF32 off.
  2. build every kernel from sepi_tpu_torch/csrc with nvcc (sm_90a).
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (16 x 100 s, and a small ragged batch), dithered
     and undithered; kernel / plain / library-call times (CUDA events).
  4. the main path at full width: synthetic corpus -> prepare_features_nosil
     -> extract_and_score (full-size V2 x-vector, seeded random weights)
     -> backend_eval, with the kernels' launch counts read around it and a
     CPU run of the same path on part of the corpus as the reference.
  5. extraction throughput at the bench shape (MFCC -> VAD -> CMVN ->
     select -> x-vector embedding), audio-seconds/s.
The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}.  Without a CUDA device the
script exits non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published dense peaks by card: (fp32 FLOP/s outside the tensor cores,
# memory bytes/s), NVIDIA data sheets.  Matched on the device name.
PEAKS = (
    ("H100 PCIe", 51.2e12, 2.0e12),
    ("H100 NVL", 60.0e12, 3.9e12),
    ("H100", 67.0e12, 3.35e12),  # SXM
)
TOL = 2e-3  # max abs error of a kernel against its plain version (cepstra)
SR = 8000
BENCH_B, BENCH_SECS = 16, 100.0


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def peaks(name: str):
    for key, flops, bw in PEAKS:
        if key in name:
            return key, flops, bw
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
    key, flops, bw = peaks(name)
    log(f"phase 1 environment: torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; card {smi}; device {name!r} x"
        f"{torch.cuda.device_count()}; peaks ({key}) fp32 {flops / 1e12:.1f} TFLOP/s, "
        f"memory {bw / 1e12:.2f} TB/s; tf32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn {torch.backends.cudnn.allow_tf32}")
    return {"smi": smi, "name": name, "peak_flops": flops, "peak_bw": bw}


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


def phase_kernels(env, device="cuda"):
    """The MFCC kernel against its plain version; times; bound."""
    import torch

    from sepi_tpu_torch.config import FrontendConfig
    from sepi_tpu_torch.ops import mfcc_cuda
    from sepi_tpu_torch.ops.framing import num_frames

    cfg = FrontendConfig()
    n = int(SR * BENCH_SECS)
    t = int(num_frames(n, cfg))
    x, lens, seeds = _mfcc_inputs(BENCH_B, [n] * BENCH_B, n, 0, device)
    worst = 0.0
    cases = [("bench 16x100s", x, lens, seeds, t)]
    rn = int(3.0 * SR)
    rx, rl, rs = _mfcc_inputs(3, [rn, int(1.83 * SR), 207], rn, 1, device)
    cases.append(("ragged 3s/1.83s/207", rx, rl, rs, int(num_frames(rn, cfg))))
    for label, xi, li, si, ti in cases:
        for dithered in (True, False):
            sd = si if dithered else None
            out_k, m_k = mfcc_cuda.mfcc_fused(xi, li, cfg, ti, sd)
            out_p, m_p = mfcc_cuda.mfcc_fused_reference(xi, li, cfg, ti, sd)
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
    t_valid = num_frames(lens, cfg).clamp(max=t).to(torch.int32)
    scratch = torch.empty((BENCH_B, t, cfg.num_ceps), device=x.device)
    ms = time_ms(lambda: mfcc_cuda.mfcc_fused(x, lens, cfg, t, seeds))
    kernel_ms = time_ms(lambda: mfcc_cuda._launch(x, t_valid, seeds, cfg, t, c, scratch))
    plain_ms = time_ms(lambda: mfcc_cuda.mfcc_fused_reference(x, lens, cfg, t, seeds))
    frames = mfcc_cuda._padded_signal(x, cfg, (t - 1) * cfg.frame_shift + cfg.frame_length)
    frames = frames.unfold(1, cfg.frame_length, cfg.frame_shift).reshape(-1, cfg.frame_length)
    frames = frames.contiguous()
    library_ms = time_ms(lambda: torch.matmul(frames, c.basis))
    km, mel, ceps = c.mel.shape[0], cfg.num_mel_bins, cfg.num_ceps
    flops = 2 * BENCH_B * t * (cfg.frame_length * 2 * km + km * mel + mel * ceps)
    nbytes = BENCH_B * n * 4 + BENCH_B * t * ceps * 4 + BENCH_B * 8
    t_ops = flops / env["peak_flops"] * 1e3
    t_bytes = nbytes / env["peak_bw"] * 1e3
    rec = {
        "name": "mfcc_fused", "route": "cuda",
        "source": "sepi_tpu_torch/csrc/mfcc.cu",
        "replaces": "sepi_tpu/ops/mfcc_pallas.py:105",
        "launches": 0, "max_abs_err": worst,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
        "kernel_only_ms": kernel_ms,
    }
    log(f"phase 3 kernels: mfcc_fused 16x100s dithered: wrapper {ms:.3f} ms "
        f"(kernel alone {kernel_ms:.3f} ms), plain {plain_ms:.3f} ms, "
        f"DFT GEMM (torch.matmul) {library_ms:.3f} ms, bound {rec['bound_ms']:.3f} ms "
        f"({rec['bound_by']}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); "
        f"max abs err {worst:.3e} <= {TOL}")
    return rec


def phase_main_path(device="cuda", num_speakers=16, utts_per_speaker=6,
                    model_cfg=None, cpu_check_utts=8):
    """prepare_features_nosil -> extract_and_score -> backend_eval."""
    import numpy as np
    import torch

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
    t0 = time.perf_counter()
    nosil = prepare_features_nosil(corpus.audio, frontend, device=device)
    embs = extract_and_score(model, None, nosil, min_frames=model_cfg.min_frames,
                             device=device)
    result, _ = backend_eval(embs, corpus.dataset, corpus.trials, enroll)
    secs = time.perf_counter() - t0
    launches = mfcc_cuda.mfcc_fused.launches

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
        f"mfcc_fused launches {launches}; vs CPU on {len(same)}/{len(sub)} utts: "
        f"features max abs {feat_err:.2e}, embeddings max rel {emb_rel:.2e}")
    return {"launches": launches}


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import sepi_tpu_torch  # noqa: F401  (fails outside the repository)

    env = phase_environment()
    phase_build()
    rec = phase_kernels(env)
    main_counts = phase_main_path()
    rec["launches"] = main_counts["launches"]
    phase_throughput(env)
    print(json.dumps({"kernels": [rec]}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
