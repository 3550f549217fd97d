from .pipeline import (
    PhoneticFeatures,
    auto_heldout,
    backend_eval,
    batch_iterator,
    extract_and_score,
    heldout_split,
    make_task_supersteps,
    prepare_features_nosil,
    prepare_features_phonetic,
    run_checkpointed,
    train_xvector_model,
)
from .phonetic import (
    train_adapted_model,
    train_am_model,
    train_combined_model,
    train_multitask_model,
)
from .s5 import S5Result, run_s5, select_voiced_ali

__all__ = [
    "PhoneticFeatures",
    "S5Result",
    "auto_heldout",
    "backend_eval",
    "batch_iterator",
    "extract_and_score",
    "heldout_split",
    "make_task_supersteps",
    "prepare_features_nosil",
    "prepare_features_phonetic",
    "run_checkpointed",
    "run_s5",
    "select_voiced_ali",
    "train_adapted_model",
    "train_am_model",
    "train_combined_model",
    "train_multitask_model",
    "train_xvector_model",
]
