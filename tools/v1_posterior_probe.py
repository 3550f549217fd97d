"""Why the DNN/i-vector T-matrix EM needs a float64 i-vector posterior.

Runs smoke phase 10b's front half on the card (phase 9's corpus v2,
paired sid/hires features, `pseudo_senone_alignments(hires, 4000)`,
`train_nnet2_am(Nnet2Config(), num_steps=300)`, the nnet2 posteriors,
the UBM moment-matched from them, the initial extractor and its
statistics) and prints:
- the nnet2's training log and how peaked its posteriors are;
- the UBM's smallest covariance eigenvalues and largest whitener norm
  (starved components take the covariance of the component means);
- the components' occupancy quantiles;
- for each of 5 EM iterations: the largest and median ||T_k||, how many
  utterances' L_u = I + sum_k N_uk U_k fail a float32 Cholesky when
  formed in float32, L_u's eigenvalue range in float64, and how far
  float32 rounding moved it.  The iterations themselves run with the
  float64 posterior, as `classical.ivector` does.

Run from the repo root on a machine with the card (~70 s of command):

    python3 tools/v1_posterior_probe.py
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    from sepi_tpu_torch.classical import ivector as iv
    from sepi_tpu_torch.classical.gmm import full_gmm_from_posteriors
    from sepi_tpu_torch.config import IvectorConfig
    from sepi_tpu_torch.device import fp32_math
    from sepi_tpu_torch.models import Nnet2Config
    from sepi_tpu_torch.recipes import (nnet2_posteriors, prepare_paired_features,
                                        pseudo_senone_alignments, train_nnet2_am)

    cs.phase_environment()
    cs.phase_build()
    trn = cs.corpus_v2()["train"]
    t0 = time.perf_counter()
    sid, hires = prepare_paired_features(trn.audio)
    ali = pseudo_senone_alignments(hires, 4000)
    counts = np.bincount(np.concatenate(list(ali.values())), minlength=4000)
    print("label counts: used", (counts > 0).sum(), "min>0", counts[counts > 0].min(),
          "median", np.median(counts), flush=True)
    model, state = train_nnet2_am(hires, ali, Nnet2Config(), num_steps=300,
                                  log=lambda *a: print(a, flush=True))
    post = nnet2_posteriors(model, state, hires)
    print("features+labels+train+post", time.perf_counter() - t0, flush=True)
    pm = np.concatenate([post[u] for u in sorted(sid)])
    print("posterior max per frame: median", np.median(pm.max(1)), "mean", pm.max(1).mean(),
          flush=True)
    q = torch.tensor([0.0, 0.01, 0.5, 1.0], device="cuda")
    with fp32_math():
        frames = np.concatenate([sid[u] for u in sorted(sid)])
        ubm = full_gmm_from_posteriors(frames, pm, device="cuda")
        del pm
        inv_chol, _ = ubm._whitener()
        ev = torch.linalg.eigvalsh(ubm.covars.double())
        print("covars min eig quantiles", [float(x) for x in torch.quantile(ev[:, 0].float(), q)],
              "whitener norm max", float(torch.linalg.matrix_norm(inv_chol, ord=2).max()),
              "weights min", float(ubm.weights.min()), flush=True)
        ext = iv.init_extractor(ubm, 600, 0)
        _, stats = iv.stats_from_features(ext, ubm, sid, IvectorConfig(), 20,
                                          posteriors={u: post[u] for u in sid})
        g = stats.n.sum(0)
        q5 = torch.tensor([0.0, 0.01, 0.1, 0.5, 1.0], device="cuda")
        print("component occupancy quantiles", [float(x) for x in torch.quantile(g, q5)],
              flush=True)
        print("f_white max abs", float(stats.f.abs().max()), "n max", float(stats.n.max()),
              flush=True)
        k, d, m = ext.t.shape
        eye32 = torch.eye(m, device="cuda")
        for it in range(5):
            tn = torch.linalg.matrix_norm(ext.t)
            print(f"iter {it}: T frob max {float(tn.max()):.4g} median {float(tn.median()):.4g}",
                  flush=True)
            u32 = torch.bmm(ext.t.transpose(1, 2), ext.t).reshape(k, m * m)
            l32 = eye32[None] + (stats.n @ u32).reshape(-1, m, m)
            del u32
            bad = int((torch.linalg.cholesky_ex(l32).info > 0).sum())
            t64 = ext.t.double()
            u64 = torch.bmm(t64.transpose(1, 2), t64).reshape(k, m * m)
            l64 = torch.eye(m, device="cuda", dtype=torch.float64)[None] + (
                stats.n.double() @ u64).reshape(-1, m, m)
            del u64
            e64 = torch.linalg.eigvalsh(l64)
            print(f"  float32 cholesky failures {bad} of {stats.n.shape[0]}; float64 L eig min "
                  f"{float(e64[:, 0].min()):.4g} max {float(e64[:, -1].max()):.4g}; "
                  f"float32-vs-64 L max abs diff {float((l32.double() - l64).abs().max()):.4g}; "
                  f"float64 cholesky failures {int((torch.linalg.cholesky_ex(l64).info > 0).sum())}",
                  flush=True)
            del l32, l64, e64
            ext = iv.train_ivector_extractor(ext, stats, IvectorConfig(num_iters=1))
            torch.cuda.empty_cache()
    print("done", time.perf_counter() - t0, flush=True)


if __name__ == "__main__":
    main()
