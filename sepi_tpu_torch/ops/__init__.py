from .cmvn import sliding_cmvn
from .features import FeatureExtractor
from .mfcc_cuda import mfcc_fused, mfcc_fused_reference
from .select import select_voiced_frames
from .vad import energy_vad

__all__ = [
    "FeatureExtractor",
    "energy_vad",
    "mfcc_fused",
    "mfcc_fused_reference",
    "select_voiced_frames",
    "sliding_cmvn",
]
