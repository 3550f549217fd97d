"""Card against CPU against a float64 CPU run: v3/v5 momentum-SGD steps.

`chip_smoke.py` phase 8c holds three interleaved steps (am, xvec, am) of
the full-width v3 and v5 c-vectors on the card against the same steps on
the CPU, by ||p_card - p_cpu|| / ||p_cpu - p_init|| <= 1e-3.  This probe
runs the same comparison at several batch sizes, with and without the
grafted AM, and adds a float64 CPU run as the reference, so it says which
side a difference comes from and how it scales with the batch.  Data as
phase 8's: phase 6's corpus (`make_phonetic_corpus`, 16 speakers x 8
utterances), its s5 labels (`run_s5` with LDA+MLLT and fMLLR), an AM net
(4000 senones) trained on them for 200 steps.  Each line prints the three
distances and the parameters with the largest share of the card-CPU
difference.

Run from the repo root on a machine with the card (~3 min):

    python3 tools/cvector_agreement_probe.py
"""

from __future__ import annotations

import copy
import os
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
# kind, chunks, chunk length (None: a random bucket), frame egs, graft
CASES = (("v3", 16, None, 64, False), ("v5", 16, None, 64, True), ("v5", 16, 200, 64, True),
         ("v5", 64, 200, 256, True), ("v5", 64, 200, 256, False), ("v3", 64, 200, 256, False))


def main() -> int:
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from sepi_tpu_torch.config import AlignConfig, ChunkConfig, OptimizerConfig, TrainConfig
    from sepi_tpu_torch.data import ChunkSampler, FrameSampler, make_phonetic_corpus
    from sepi_tpu_torch.models import cvector as cv
    from sepi_tpu_torch.recipes import (prepare_features_phonetic, run_s5, select_voiced_ali,
                                        train_am_model)

    if not torch.cuda.is_available():
        print("cvector_agreement_probe: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    corpus = make_phonetic_corpus(num_speakers=16, utts_per_speaker=8, words_per_utt=(8, 16),
                                  seed=0)
    pf = prepare_features_phonetic(corpus.audio, device="cuda")
    ds = corpus.dataset
    s5 = run_s5(pf.full, corpus.transcripts, corpus.lexicon,
                AlignConfig(lda_mllt=True, fmllr=True), utt2spk={u.utt_id: u.spk_id for u in ds})
    nosil, ali = pf.nosil, select_voiced_ali(s5.alignments, pf.voiced)
    am_model, _ = train_am_model(nosil, ali, cv.AmConfig(), TrainConfig(), 200, device="cuda")
    am_cpu = copy.deepcopy(am_model).cpu()
    sgd = OptimizerConfig(preconditioner="none")
    n_spk = len(ds.speakers)
    for kind, xb, xl, ab, graft in CASES:
        t0 = time.perf_counter()
        xs = ChunkSampler(nosil, ds, ChunkConfig(), xb, seed=7)
        fs = FrameSampler(nosil, ali, cs.AM_L, ab, seed=7, context=(7, 7))
        seq = [("am", fs.sample_batch()), ("xvec", xs.sample_batch(xl)), ("am", fs.sample_batch())]
        _, pd, _ = cs._cv_run(kind, "cuda", n_spk, sgd, am_model if graft else None, seq)
        p0, pc, _ = cs._cv_run(kind, "cpu", n_spk, sgd, am_cpu if graft else None, seq)
        _, p64, _ = cs._cv_run(kind, "cpu", n_spk, sgd, am_cpu if graft else None, seq,
                               torch.float64)
        sq = {k: float(torch.sum((pd[k] - pc[k]) ** 2)) for k in pc}
        top = sorted(sq, key=sq.get, reverse=True)[:4]
        print(f"{kind} {xb} chunks of {seq[1][1].chunk_len} / {ab} frame egs, graft {graft}: "
              f"card-cpu "
              f"{cs._traj(pd, pc, p0):.3e}, card-float64 {cs._traj(pd, p64, p0):.3e}, "
              f"cpu-float64 {cs._traj(pc, p64, p0):.3e}; largest shares of card-cpu: "
              + ", ".join(f"{k} {100 * sq[k] / max(sum(sq.values()), 1e-300):.1f}%" for k in top)
              + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
