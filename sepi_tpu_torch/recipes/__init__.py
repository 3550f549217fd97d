from .pipeline import (
    PhoneticFeatures,
    backend_eval,
    extract_and_score,
    prepare_features_nosil,
    prepare_features_phonetic,
)
from .s5 import S5Result, run_s5, select_voiced_ali

__all__ = [
    "PhoneticFeatures",
    "S5Result",
    "backend_eval",
    "extract_and_score",
    "prepare_features_nosil",
    "prepare_features_phonetic",
    "run_s5",
    "select_voiced_ali",
]
