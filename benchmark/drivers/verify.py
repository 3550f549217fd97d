"""Verification as a service: one test segment per request, one client.

A request is one segment of the pool under a name of its own (so its
dither differs), scored against the speaker it claims among the
enrolled models: `prepare_features_nosil` on the one segment, then the
long-lived `EmbeddingExtractor` a service holds (built and warmed in
set-up) with the configuration's `ExtractConfig`, then `backend_eval`'s
scoring path: the scoring mean, LDA (`LdaTransform`), `length_normalize`
and `score_trials`' float64 PLDA LLR.  The LDA, the PLDA and the
enrolled models are synthetic and well conditioned, made from the seed.
Closed loop: the client sends the next request when the verdict is
back; each request is timed from send to score.  End to end: the median
and the 95th percentile of every request of the window.

Set-up makes the weights, the pool and the back end, sends one request
per frontend batch shape the pool holds, and runs the extractor over a
chunk of every bucket length.

``correct``: after the window, a sample of the window's requests drawn
from the seed, the longest segment among them, goes through the plain
reference (`reference.extract.embedding` in float64, then
`reference.backend`); the numbers compared are the largest relative l2
gap of the embeddings and the largest gap of the scores.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from harness import audio, serving
from harness.core import Check, Marks, Outcome, RunContext, Spans, limit
from harness.profiling import Window
from reference import backend as ref_backend
from reference.extract import embedding


def synthetic_backend(tr: Dict, emb_dim: int, seed: int) -> Dict:
    """A well-conditioned LDA and PLDA and the enrolled models' vectors
    (projected and length-normalised as `backend_eval` makes them)."""
    b = tr["backend"]
    rng = np.random.default_rng(int(seed))
    dim = b["lda_dim"]
    projection = np.linalg.qr(rng.normal(size=(emb_dim, dim)))[0].T  # (dim, emb_dim)
    mean = rng.normal(size=emb_dim) * 0.1
    q = np.linalg.qr(rng.normal(size=(dim, dim)))[0]
    psi = rng.uniform(b["psi"][0], b["psi"][1], dim)
    plda_mean = rng.normal(size=dim) * 0.1
    n = b["enrolled"]
    raw = rng.normal(size=(n, emb_dim))
    enroll = np.stack([ref_backend.project(r, mean, projection) for r in raw])
    counts = rng.integers(b["enroll_utts"][0], b["enroll_utts"][1] + 1, size=n)
    return {"projection": projection, "mean": mean, "transform": q, "psi": psi,
            "plda_mean": plda_mean, "enroll": enroll, "counts": counts}


def run(ctx: RunContext) -> Outcome:
    from sepi_tpu_torch import graphs
    from sepi_tpu_torch.backend.lda import LdaTransform
    from sepi_tpu_torch.backend.plda import Plda, score_trials
    from sepi_tpu_torch.backend.vector import length_normalize
    from sepi_tpu_torch.data.manifest import Trial
    from sepi_tpu_torch.device import fp32_math
    from sepi_tpu_torch.extract import EmbeddingExtractor
    from sepi_tpu_torch.recipes.pipeline import padded_audio_batches, prepare_features_nosil

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    spans = Spans(record=ctx.trace)
    marks = Marks(ctx)
    e = serving.embedder(ctx)
    extractor = EmbeddingExtractor(e.model, e.ecfg, min_frames=e.min_frames,
                                   model_kwargs=e.kwargs, device=dev)
    marks("weights")
    secs = audio.shuffled(audio.durations(tr["duration_s"], tr["pool_utts"]), ctx.sub_seed(2))
    pool = audio.make_pool(secs, tr["audio"], ctx.sub_seed(3), dev)
    be = synthetic_backend(tr, cfg["embed_dim"], ctx.sub_seed(5))
    lda = LdaTransform(projection=be["projection"], mean=np.zeros(cfg["embed_dim"]))
    plda = Plda(mean=be["plda_mean"], transform=be["transform"], psi=be["psi"])
    models = [f"spk{k}" for k in range(len(be["enroll"]))]
    enroll = dict(zip(models, be["enroll"]))
    counts = {m: int(c) for m, c in zip(models, be["counts"])}
    marks("audio pool and back end")

    def request(name: str, samples: np.ndarray, claim: str) -> tuple:
        with fp32_math():
            with spans.span("frontend"):
                feats = prepare_features_nosil({name: samples}, e.fcfg, e.vcfg, e.ccfg, None,
                                               tr["frontend_batch"], device=dev)
            with spans.span("embed"):
                emb = extractor.extract_utterances(feats)[name]
        with spans.span("score"):
            test = length_normalize(lda((np.asarray(emb, np.float64) - be["mean"])
                                        + lda.mean))
            s = score_trials(plda, {claim: enroll[claim]}, {name: test},
                             [Trial(claim, name, False)], counts)[(claim, name)]
        return emb, s

    # set-up: a request of every frontend batch shape, a chunk of every bucket
    shapes: Dict[int, int] = {}
    for j, x in enumerate(pool):
        width = next(padded_audio_batches({"u": x}, tr["frontend_batch"]))[1].shape[1]
        shapes.setdefault(width, j)
    for width, j in sorted(shapes.items()):
        request(f"warm{width}", pool[j], models[0])
    with fp32_math():
        serving.warm_buckets(ctx, e, extractor.extract_utterances)
    marks("warm-up")
    gc.collect()
    spans.totals.clear()
    rng = np.random.default_rng([int(ctx.seed), 1])

    win = Window(dev, ctx.trace)
    setup_s = win.start() - ctx.process_start
    captures0 = graphs.call_counts["captures"]
    lat: List[float] = []
    made: List[tuple] = []  # (name, pool index, claim, embedding, score)
    failed = 0
    i = 0
    order = np.random.default_rng([int(ctx.seed), 0]).permutation(len(pool))
    while win.elapsed() < ctx.seconds:
        if i and i % len(pool) == 0:
            order = np.random.default_rng([int(ctx.seed), i]).permutation(len(pool))
        j = int(order[i % len(pool)])
        name, claim = f"v{ctx.seed}-{i}", models[int(rng.integers(len(models)))]
        t0 = time.perf_counter()
        try:
            emb, s = request(name, pool[j], claim)
        except (ValueError, KeyError):
            failed += 1
            emb, s = None, float("nan")
        lat.append(time.perf_counter() - t0)
        made.append((name, j, claim, emb, s))
        i += 1
    window_s = win.stop()
    captures = graphs.call_counts["captures"] - captures0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del extractor, e.model
    gc.collect()

    # correct: a sample of the window's requests against the reference
    rng = np.random.default_rng([int(ctx.seed), 99])
    picks = list(rng.integers(len(made), size=min(tr["check"]["requests"], len(made))))
    picks[0] = int(np.argmax([len(pool[m[1]]) for m in made]))  # the longest segment
    t_ref = time.perf_counter()
    gaps = {p: {"emb": [], "score": []} for p in ("ref",) + tuple(ctx.controls)}
    with fp32_math(), torch.no_grad():
        for k in picks:
            name, j, claim, emb, s = made[k]
            if emb is None:
                for key in ("emb", "score"):
                    gaps["ref"][key].append(float("inf"))
                continue
            m = models.index(claim)

            def score(vec):
                return ref_backend.llr(be["enroll"][m], ref_backend.project(
                    vec, be["mean"], be["projection"]), be["counts"][m], be["plda_mean"],
                    be["transform"], be["psi"])

            want = embedding(pool[j], name, e.params, cfg, dev, "ref",
                             model=ctx.cell.model).cpu().numpy()
            want_s = score(want)
            for prec in ("ref",) + tuple(ctx.controls):
                if prec == "ref":
                    got, got_s = np.asarray(emb, np.float64), s
                else:
                    got = embedding(pool[j], name, e.params, cfg, dev, prec,
                                    model=ctx.cell.model).double().cpu().numpy()
                    got_s = score(got)
                gaps[prec]["emb"].append(float(np.linalg.norm(got - want) / np.linalg.norm(want)))
                gaps[prec]["score"].append(abs(got_s - want_s))
    ref_time = time.perf_counter() - t_ref
    checks = [Check("embedding_rel_gap", max(gaps["ref"]["emb"]),
                    limit(ctx.cell, "embedding_rel_gap")),
              Check("score_abs_gap", max(gaps["ref"]["score"]), limit(ctx.cell, "score_abs_gap"))]
    ms = np.asarray(lat) * 1e3
    n = len(lat)
    work = {"requests": n, "captures": captures, "reference_s": ref_time,
            "setup_marks": marks.marks, "host": win.host,
            "latency_ms_max": float(ms.max()) if n else None,
            "readings": {p: {k: max(v) for k, v in g.items()} for p, g in gaps.items()}}
    metrics = {"verify_p50_ms": float(np.percentile(ms, 50)),
               "verify_p95_ms": float(np.percentile(ms, 95)), "setup_s": setup_s}
    return Outcome(metrics, n, failed, checks, window_s, setup_s, int(peak), work, spans,
                   win.summary)
