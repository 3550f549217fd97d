from .tdnn import (BatchNorm, SegmentHead, StatsPooling, Stream, TdnnLayer, TdnnSpec, TdnnStack,
                   batch_moments, lecun_normal_init)
from .xvector import V2_XVECTOR, XVector, XVectorConfig

__all__ = [
    "BatchNorm",
    "SegmentHead",
    "StatsPooling",
    "Stream",
    "TdnnLayer",
    "TdnnSpec",
    "TdnnStack",
    "V2_XVECTOR",
    "XVector",
    "XVectorConfig",
    "batch_moments",
    "lecun_normal_init",
]
