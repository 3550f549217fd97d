"""Which tensor-scalar op rounds as the optimizer chain's host-float op.

A captured step (`sepi_tpu_torch.train.graphs`) cannot take a Python
float that changes each step, so the chain reads its per-step scalars
(learning rate, bias corrections, shrink factor) from device tensors.
For the captured step to give the eager step's numbers bit for bit, each
op that takes such a scalar must round as the eager op with the host
float does.  This probe runs each of the chain's scalar ops both ways on
the same seeded float32 tensors and scalars and prints, for each
candidate device form, how many elements differ from the host-float op
and by how many ulps at most.

    python3 tools/graph_ops_probe.py [--device cuda] [--out FILE]

One JSON line per (op, candidate) to ``--out`` (default standard output
only); a summary line per op names the candidates that are bit-equal.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
# shapes of a TDNN layer's parameters (conv kernel, bias, output weight)
SHAPES = [(512, 23, 5), (512,), (1500, 512, 1), (5000, 512), (512, 512, 3)]


def _scalars():
    """Representative per-step scalars: bias corrections at early and late
    counts, learning rates, a shrink factor."""
    f32 = np.float32
    out = [f32(1) - f32(d) ** f32(c) for d in (0.9, 0.999) for c in (1, 2, 3, 7, 40, 999, 5000)]
    out += [f32(1e-3), f32(7.3e-4), f32(1e-4), f32(2.34e-5)]
    return [float(x) for x in out]


def _ulps(a, b):
    import torch

    ai = a.view(torch.int32).long()
    bi = b.view(torch.int32).long()
    return int((ai - bi).abs().max())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    dev = torch.device(args.device)
    g = torch.Generator(device="cpu").manual_seed(0)
    tensors = [torch.randn(s, generator=g).to(dev) * 1e-2 for s in SHAPES]
    rows = []

    def record(op, cand, host, dev_out):
        host, dev_out = list(host), list(dev_out)
        diff = sum(int((a != b).sum()) for a, b in zip(host, dev_out))
        ulps = max(_ulps(a, b) for a, b in zip(host, dev_out))
        rows.append({"op": op, "candidate": cand, "elements_differ": diff, "max_ulps": ulps})

    for s in _scalars():
        st = torch.tensor(s, dtype=torch.float32, device=dev)
        inv = torch.tensor(float(np.float32(1) / np.float32(s)), dtype=torch.float32, device=dev)
        host = torch._foreach_div(tensors, s)
        record("_foreach_div(list, float)", "_foreach_div(list, tensor)", host,
               torch._foreach_div(tensors, st))
        record("_foreach_div(list, float)", "_foreach_mul(list, reciprocal tensor)", host,
               torch._foreach_mul(tensors, inv))
        record("_foreach_div(list, float)", "[t / tensor]", host, [t / st for t in tensors])
        record("_foreach_div(list, float)", "[t * reciprocal tensor]", host,
               [t * inv for t in tensors])
        host = [t / s for t in tensors]
        record("t / float", "t / tensor", host, [t / st for t in tensors])
        record("t / float", "t * reciprocal tensor", host, [t * inv for t in tensors])
        host = torch._foreach_mul(tensors, s)
        record("_foreach_mul(list, float)", "_foreach_mul(list, tensor)", host,
               torch._foreach_mul(tensors, st))
        host = [t * s for t in tensors]
        record("t * float", "t * tensor", host, [t * st for t in tensors])
        record("t * -float", "t * -tensor", [t * -s for t in tensors],
               [t * -st for t in tensors])
    summary = {}
    for r in rows:
        key = (r["op"], r["candidate"])
        d, u = summary.get(key, (0, 0))
        summary[key] = (d + r["elements_differ"], max(u, r["max_ulps"]))
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    lines = [{"device": name, "torch": torch.__version__, "op": op, "candidate": cand,
              "elements_differ": d, "max_ulps": u, "scalars": len(_scalars())}
             for (op, cand), (d, u) in summary.items()]
    for line in lines:
        print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
