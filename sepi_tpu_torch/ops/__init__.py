from .cmvn import sliding_cmvn
from .deltas import add_deltas, paste_features, splice_frames, subsample_frames
from .features import FeatureExtractor
from .mfcc_cuda import mfcc_fused, mfcc_fused_reference
from .select import select_voiced_frames
from .vad import energy_vad, gmm_vad, merge_vads, train_vad_gmms, vad_from_frame_likes

__all__ = [
    "FeatureExtractor",
    "add_deltas",
    "energy_vad",
    "gmm_vad",
    "merge_vads",
    "mfcc_fused",
    "mfcc_fused_reference",
    "paste_features",
    "select_voiced_frames",
    "sliding_cmvn",
    "splice_frames",
    "subsample_frames",
    "train_vad_gmms",
    "vad_from_frame_likes",
]
