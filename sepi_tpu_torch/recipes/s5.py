"""The s5-analog alignment recipe: transcripts + lexicon -> senone alignments.

Port of `sepi_tpu/recipes/s5.py`.  The reference's `egs/sre/s5/run.sh`
(mono -> tri1..tri6a_4k + fMLLR, lines 108-202) exists to produce one
artifact the phonetic variants consume: `exp/tri6a_4k_ali`, per-frame
tied-senone labels.  The stages:

  1. monophone Viterbi-EM training          (`steps/train_mono.sh`)
  2. likelihood-based state tying            (tree building, tri6a leaves)
  3. [cfg.lda_mllt] LDA over spliced frames + MLLT/STC rounds
     interleaved with re-alignment          (`steps/train_lda_mllt.sh`)
  4. context-dependent re-alignment rounds   (`steps/align_si.sh` passes)
  5. VAD-filtering of the label stream       (`select-voiced-ali.cc`)

With ``cfg.fmllr`` (and ``utt2spk``) a speaker-adaptive pass follows
(`steps/align_fmllr.sh`): per-speaker CMLLR transforms from the refined
alignment, features transformed (in the LDA+MLLT space when that stage is
on), and a final re-alignment round.  Every alignment pass runs the
emission GEMM and the Viterbi kernel on ``device`` (default "cuda").
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from ..align.fmllr import apply_fmllr_corpus, fmllr_transforms
from ..align.lda_mllt import apply_transform, estimate_lda, estimate_mllt, mllt_objf_improvement
from ..align.mono import Lexicon, MonoAligner
from ..align.tied import TiedAligner, refine_tied_aligner, train_tied_aligner
from ..config import AlignConfig
from ..device import DeviceLike, resolve_device


@dataclasses.dataclass
class S5Result:
    """The `exp/tri6a_4k_ali` analog plus the models that produced it."""

    aligner: TiedAligner  # mono front + tied tree
    model: MonoAligner  # refined senone-level GMM bank
    alignments: Dict[str, np.ndarray]  # utt -> senone ids on FULL frames
    phone_alignments: Dict[str, np.ndarray]  # utt -> phone indices
    frames_shifted: List[float]  # per-refine-iteration alignment shift
    num_senones: int
    fmllr: Optional[Dict[str, np.ndarray]] = None  # spk -> (D, D+1) W
    # LDA+MLLT composite transform over spliced frames, rows out
    # ((lda_mllt_dim, (2*splice_context+1)*D)); None when the stage is off
    lda_mllt: Optional[np.ndarray] = None


def run_s5(
    features: Mapping[str, np.ndarray],
    transcripts: Mapping[str, Sequence[str]],
    lexicon: Lexicon,
    cfg: AlignConfig = AlignConfig(),
    log=None,
    utt2spk: Optional[Mapping[str, str]] = None,
    device: DeviceLike = "cuda",
) -> S5Result:
    """Train the aligner and force-align the corpus (with-silence frames).

    ``features`` are the WCMVN with-silence stream
    (`pipeline.prepare_features_phonetic().full`); strip the output with
    `select_voiced_ali` before feeding silence-stripped consumers.
    """
    dev = resolve_device(device)
    if cfg.fmllr and utt2spk is None:
        raise ValueError("cfg.fmllr needs utt2spk (speaker map)")
    if log:
        log(f"[s5] mono EM ({cfg.mono_iters} iters, "
            f"{len(lexicon.phones)} phones x {cfg.states_per_phone} states)")
    tied = train_tied_aligner(
        features,
        transcripts,
        lexicon,
        num_leaves=cfg.num_leaves,
        mono_iters=cfg.mono_iters,
        min_count=cfg.min_count,
        states_per_phone=cfg.states_per_phone,
        seed=cfg.seed,
        log=log,
        device=dev,
    )
    if log:
        log(f"[s5] tied tree: {tied.num_senones} senones "
            f"(budget {cfg.num_leaves}); refining {cfg.refine_iters} rounds")
    lda_mllt_w = None
    align_feats = features
    ali_cur = None
    if cfg.lda_mllt:
        # tri3b rung: LDA on spliced frames labeled by the current tied
        # alignment, then MLLT rounds interleaved with re-alignment in the
        # transformed space; every later stage runs on these features.
        ali_cur = tied.senone_alignments(features, transcripts, device=dev)
        w = estimate_lda(features, ali_cur, tied.num_senones,
                         context=cfg.splice_context, dim=cfg.lda_mllt_dim)
        align_feats = apply_transform(features, w, cfg.splice_context)
        if log:
            log(f"[s5] LDA: spliced ±{cfg.splice_context} -> "
                f"{w.shape[0]} dims (whitened within-class)")
        for it in range(cfg.mllt_iters):
            # EM bootstraps from the current labels: the mono front's GMMs
            # live in raw feature space and cannot align these features
            r = refine_tied_aligner(
                tied, align_feats, transcripts, num_iters=1,
                comps_per_senone=cfg.comps_per_senone, seed=cfg.seed,
                init_alignments=ali_cur, device=dev,
            )
            ali_cur = r.alignments
            m = estimate_mllt(align_feats, ali_cur, tied.num_senones)
            gain = mllt_objf_improvement(align_feats, ali_cur, tied.num_senones, m)
            w = m @ w
            align_feats = {u: (f @ m.T).astype(np.float32)
                           for u, f in align_feats.items()}
            if log:
                log(f"[s5] MLLT round {it + 1}: objf gain/frame {gain:.4f}")
        lda_mllt_w = w
    res = refine_tied_aligner(
        tied,
        align_feats,
        transcripts,
        num_iters=cfg.refine_iters,
        comps_per_senone=cfg.comps_per_senone,
        seed=cfg.seed,
        log=log,
        init_alignments=ali_cur,
        device=dev,
    )
    if log:
        shifts = ", ".join(f"{s:.1%}" for s in res.frames_shifted)
        log(f"[s5] alignment shift per refine round: {shifts}")
    transforms = None
    if cfg.fmllr:
        transforms = fmllr_transforms(
            res.model, align_feats, res.alignments, utt2spk,
            min_beta=cfg.fmllr_min_beta,
        )
        feats_sat = apply_fmllr_corpus(align_feats, transforms, utt2spk)
        if log:
            n_id = sum(
                1 for w in transforms.values()
                if np.allclose(w[:, :-1], np.eye(w.shape[0]))
            )
            log(f"[s5] fMLLR: {len(transforms)} speakers "
                f"({n_id} left identity); SAT re-alignment")
        # SAT features live in the (possibly transformed) refined space;
        # bootstrap from the pre-SAT alignment
        res = refine_tied_aligner(
            tied, feats_sat, transcripts,
            num_iters=max(1, cfg.refine_iters - 1),
            comps_per_senone=cfg.comps_per_senone,
            seed=cfg.seed,
            init_alignments=res.alignments,
            device=dev,
        )
    return S5Result(
        tied, res.model, res.alignments, res.phone_alignments,
        res.frames_shifted, tied.num_senones, transforms, lda_mllt_w,
    )


def select_voiced_ali(
    alignments: Mapping[str, np.ndarray],
    voiced: Mapping[str, np.ndarray],
) -> Dict[str, np.ndarray]:
    """Filter per-frame label streams by VAD masks (the
    `select-voiced-ali.cc:58-91` loop: assert lengths match, keep frames
    where vad==1).  Output rows align with the silence-stripped features
    produced from the same masks."""
    out: Dict[str, np.ndarray] = {}
    for utt, ali in alignments.items():
        if utt not in voiced:
            continue
        v = np.asarray(voiced[utt], bool)
        if len(ali) != len(v):
            raise ValueError(
                f"{utt}: alignment length {len(ali)} != vad length {len(v)}"
            )
        kept = np.asarray(ali)[v]
        if len(kept):
            out[utt] = kept.astype(np.int32)
    return out
