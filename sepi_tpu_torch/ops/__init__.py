from .cmvn import sliding_cmvn
from .deltas import add_deltas, paste_features, splice_frames, subsample_frames
from .features import FeatureExtractor, dct_matrix, fbank, mel_banks, mfcc
from .framing import frame_signal, num_frames, raw_frames, window_function
from .mfcc_cuda import mfcc_fused, mfcc_fused_reference
from .select import select_voiced_counts, select_voiced_frames
from .vad import energy_vad, gmm_vad, merge_vads, train_vad_gmms, vad_from_frame_likes

__all__ = [
    "FeatureExtractor",
    "add_deltas",
    "dct_matrix",
    "energy_vad",
    "fbank",
    "frame_signal",
    "gmm_vad",
    "mel_banks",
    "merge_vads",
    "mfcc",
    "mfcc_fused",
    "mfcc_fused_reference",
    "num_frames",
    "paste_features",
    "raw_frames",
    "select_voiced_counts",
    "select_voiced_frames",
    "sliding_cmvn",
    "splice_frames",
    "subsample_frames",
    "train_vad_gmms",
    "vad_from_frame_likes",
    "window_function",
]
