from .tdnn import SegmentHead, StatsPooling, Stream, TdnnLayer, TdnnSpec, TdnnStack
from .xvector import V2_XVECTOR, XVector, XVectorConfig

__all__ = [
    "SegmentHead",
    "StatsPooling",
    "Stream",
    "TdnnLayer",
    "TdnnSpec",
    "TdnnStack",
    "V2_XVECTOR",
    "XVector",
    "XVectorConfig",
]
