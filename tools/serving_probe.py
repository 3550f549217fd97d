"""Where a captured extraction call's time goes, beside the eager call's.

`EmbeddingExtractor._embed` on one padded batch is the unit the
extraction path repeats: a (B, T, D) host batch in, (B, E) host
embeddings out.  Eager, it copies the batch in, launches the forward's
kernels and copies the embeddings out; captured (`graphs.CallGraphs`), it
computes the graph's key, stages the batch into the graph's static
buffers through pinned memory, replays, clones the outputs and copies
them out.  This probe times, at each bucket and without a profiler:
- the whole call, eager and captured (host clock, each call ending in
  its device-to-host copy), medians of ``--calls`` calls;
- the captured call's parts on the host clock: the key, the staging
  (synchronised), the replay alone (synchronised), the clone and copy out;
- the replay's device time (CUDA events).
TF32 is off (`device.fp32_math`), as `extract_and_score` runs.

    python3 tools/serving_probe.py [--device cuda] [--calls 30] [--out FILE]

One JSON line per bucket to standard output (and to ``--out``), with
the card's `nvidia-smi` name and power limit.  ``--device cpu`` runs the
same calls on the CPU (eager both ways: a rehearsal of the script only).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
BUCKETS = (25, 100, 400, 1600, 10000)


def _ms(fn, calls, sync):
    out = []
    for _ in range(calls):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--calls", type=int, default=30)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--buckets", default=",".join(map(str, BUCKETS)))
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke
    from sepi_tpu_torch import graphs
    from sepi_tpu_torch.bench import card_line
    from sepi_tpu_torch.config import ExtractConfig
    from sepi_tpu_torch.device import fp32_math
    from sepi_tpu_torch.extract import EmbeddingExtractor
    from sepi_tpu_torch.models import V2_XVECTOR

    dev = torch.device(args.device)
    card = card_line(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cfg = dataclasses.replace(V2_XVECTOR, num_speakers=chip_smoke.CV_SPEAKERS)
    model = chip_smoke.random_xvector(cfg, 15, dev)
    ecfg = ExtractConfig(batch_size=args.batch)
    cap = EmbeddingExtractor(model, ecfg, device=dev)
    eag = EmbeddingExtractor(model, ecfg, device=dev, capture=False)
    rng = np.random.default_rng(15)
    lines = []
    with torch.no_grad(), fp32_math():  # as extract_and_score runs it
        for b in map(int, args.buckets.split(",")):
            f = rng.standard_normal((args.batch, b, cfg.feat_dim)).astype(np.float32)
            m = np.ones((args.batch, b), bool)
            for _ in range(3):
                want, got = eag._embed(f, m), cap._embed(f, m)
            rec = {"bucket": b, "batch": args.batch, "device": card,
                   "equal": bool(np.array_equal(want, got)),
                   "eager_ms": _ms(lambda: eag._embed(f, m), args.calls, sync),
                   "captured_ms": _ms(lambda: cap._embed(f, m), args.calls, sync)}
            call_args = [graphs._as_tensor(a) for a in (model, f, m)]
            key = cap.graphs.key(call_args)
            g = cap.graphs.graphs.get(key)
            rec["key_ms"] = _ms(lambda: cap.graphs.key(call_args), args.calls, sync)
            if g is not None:
                rec["stage_ms"] = _ms(lambda: g._load(call_args), args.calls, sync)
                rec["replay_ms"] = _ms(g.graph.replay, args.calls, sync)
                rec["out_ms"] = _ms(lambda: [o.clone().cpu() for o in g.outs], args.calls, sync)
                if dev.type == "cuda":
                    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                    times = []
                    for _ in range(args.calls):
                        ev[0].record()
                        g.graph.replay()
                        ev[1].record()
                        ev[1].synchronize()
                        times.append(ev[0].elapsed_time(ev[1]))
                    rec["replay_device_ms"] = statistics.median(times)
            lines.append(rec)
            print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.writelines(json.dumps(r) + "\n" for r in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
