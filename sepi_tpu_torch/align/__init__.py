from .mono import (
    Lexicon,
    MonoAligner,
    align_corpus,
    align_graphs,
    train_mono_aligner,
)
from .fmllr import (
    FmllrStats,
    accumulate_fmllr_stats,
    apply_fmllr,
    apply_fmllr_corpus,
    estimate_fmllr,
    fmllr_transforms,
)
from .tied import RefineResult, TiedAligner, refine_tied_aligner, train_tied_aligner
from .viterbi_cuda import viterbi_batch, viterbi_batch_reference

__all__ = [
    "Lexicon",
    "MonoAligner",
    "align_corpus",
    "align_graphs",
    "train_mono_aligner",
    "TiedAligner",
    "train_tied_aligner",
    "refine_tied_aligner",
    "RefineResult",
    "FmllrStats",
    "accumulate_fmllr_stats",
    "apply_fmllr",
    "apply_fmllr_corpus",
    "estimate_fmllr",
    "fmllr_transforms",
    "viterbi_batch",
    "viterbi_batch_reference",
]
