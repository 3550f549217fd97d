"""Batch extraction: shards of utterances through the port's entry points.

One unit is one shard: ``shard_utts`` utterances of the pool, renamed
for the shard (so their dither seeds differ) and reshuffled, run as
`recipes/drivers.py` runs a corpus: `prepare_features_nosil` (MFCC ->
energy VAD -> sliding CMVN -> voiced frames), then `extract_and_score`
with the configuration's `ExtractConfig`, minimum frames and task.  A
closed loop, one shard at a time, until the window's seconds have
passed; the window ends when its last shard is done, and every shard in
it counts.  End to end: audio seconds of the window's shards (whole
durations, silence included) per second.

Set-up makes the weights and the pool on the device, then runs
``warmup_shards`` shards (every frontend batch shape a shard has: all
shards hold the same durations; the host's allocations settle over the
first shards) and one extraction over a chunk of every bucket length, so
the window meets no shape for the first time.

``correct``: after the window, a sample of the window's utterances drawn
from the seed, the longest among them, goes through the plain reference
(`reference.extract.embedding`, float64) from the same raw samples and
names; the number compared is the largest relative l2 gap between the
program's embedding and the reference's.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from harness import audio, serving
from harness.core import Check, Marks, Outcome, RunContext, Spans, limit
from harness.flops import embed_flops
from harness.profiling import Window
from reference.extract import chunks, embedding
from reference.frontend import num_frames

WARMUP_SHARD = 1 << 40  # the set-up shard's number: its names are no window shard's


def shard_audio(pool: List[np.ndarray], seed: int, shard: int) -> Tuple[Dict, List[int]]:
    """The shard's {name: samples} in its order, and the pool index of each."""
    order = np.random.default_rng([int(seed), int(shard)]).permutation(len(pool))
    names = {f"s{seed}-{shard}-{j}": pool[j] for j in order}
    return names, [int(j) for j in order]


def rel_gap(got: np.ndarray, want: torch.Tensor) -> float:
    want = want.double().cpu().numpy()
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want))


def run(ctx: RunContext) -> Outcome:
    from sepi_tpu_torch.device import fp32_math
    from sepi_tpu_torch.recipes.pipeline import extract_and_score, prepare_features_nosil

    cfg, tr, dev, kind = ctx.cell.config, ctx.cell.traffic, ctx.device, ctx.cell.model
    spans = Spans(record=ctx.trace)
    marks = Marks(ctx)
    e = serving.embedder(ctx)
    secs = audio.shuffled(audio.durations(tr["duration_s"], tr["pool_utts"]), ctx.sub_seed(2))
    marks("weights")
    pool = audio.make_pool(secs, tr["audio"], ctx.sub_seed(3), dev)
    marks("audio pool")
    sr = tr["audio"]["sample_rate"]
    n_shard = tr["shard_utts"]
    if n_shard != len(pool):
        raise ValueError("a shard holds the whole pool, reshuffled")

    def extract(feats: Dict) -> Dict:
        return extract_and_score(e.model, None, feats, e.ecfg, e.min_frames, e.kwargs, device=dev)

    def one_shard(names: Dict):
        with spans.span("frontend"):
            feats = prepare_features_nosil(names, e.fcfg, e.vcfg, e.ccfg, None,
                                           tr["frontend_batch"], device=dev)
        with spans.span("embed"):
            embs = extract(feats)
        return feats, embs

    # set-up: warm-up shards, then a chunk of every bucket length
    for w in range(tr["warmup_shards"]):
        one_shard(shard_audio(pool, ctx.seed, WARMUP_SHARD + w)[0])
    marks("warm-up shards")
    serving.warm_buckets(ctx, e, extract)
    marks("bucket ladder")
    gc.collect()
    spans.totals.clear()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    win = Window(dev, ctx.trace)
    setup_s = win.start() - ctx.process_start
    done: List[Tuple[int, List[int], Dict, Dict]] = []
    audio_s = frames = samples = embed_work = 0.0
    attempted = failed = 0
    shard = 0
    shard_s = []
    while True:
        t_shard = time.perf_counter()
        names, order = shard_audio(pool, ctx.seed, shard)
        feats, embs = one_shard(names)
        attempted += len(names)
        failed += sum(1 for n in names if n not in embs)
        done.append((shard, order, embs, {n: f.shape[0] for n, f in feats.items()}))
        del feats
        shard += 1
        shard_s.append(time.perf_counter() - t_shard)
        if win.elapsed() >= ctx.seconds:
            break
    window_s = win.stop()
    for _, order, _, voiced in done:
        for j in order:
            n = len(pool[j])
            audio_s, samples = audio_s + n / sr, samples + n
            frames += num_frames(n, cfg["frontend"])
        embed_work += sum(embed_flops(cfg, l, kind) for v in voiced.values()
                          for _, l in chunks(v, cfg["extract"]))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del e.model
    gc.collect()

    # correct: a sample of the window's utterances against the reference
    rng = np.random.default_rng([int(ctx.seed), 99])
    picks = [(int(s), int(i)) for s, i in zip(rng.integers(len(done), size=tr["check"]["utts"]),
                                               rng.integers(n_shard, size=tr["check"]["utts"]))]
    picks[0] = (picks[0][0], int(np.argmax([len(x) for x in pool])))  # the longest
    t_ref = time.perf_counter()
    gaps = {p: [] for p in ("ref",) + tuple(ctx.controls)}
    with fp32_math(), torch.no_grad():
        for s, j in picks:
            shard_i, _, embs, _ = done[s]
            name = f"s{ctx.seed}-{shard_i}-{j}"
            if name not in embs:
                gaps["ref"].append(float("inf"))
                continue
            want = embedding(pool[j], name, e.params, cfg, dev, "ref", model=kind)
            gaps["ref"].append(rel_gap(embs[name], want))
            for prec in ctx.controls:
                ctl = embedding(pool[j], name, e.params, cfg, dev, prec, model=kind)
                gaps[prec].append(rel_gap(ctl.double().cpu().numpy(), want))
    ref_s = time.perf_counter() - t_ref
    checks = [Check("embedding_rel_gap", max(gaps["ref"]), limit(ctx.cell, "embedding_rel_gap"))]
    work = {"audio_s": audio_s, "shards": shard, "mfcc_frames": frames, "samples": samples,
            "embed_flops": embed_work, "reference_s": ref_s, "shard_s": shard_s,
            "setup_marks": marks.marks, "host": win.host,
            "readings": {p: max(v) for p, v in gaps.items()}}
    return Outcome({"extract_audio_s_per_s": audio_s / window_s, "setup_s": setup_s},
                   attempted, failed, checks, window_s, setup_s, int(peak), work, spans,
                   win.summary)
