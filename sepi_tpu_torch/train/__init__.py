from .checkpoint import combine_checkpoints, load_checkpoint, save_checkpoint
from .graft import graft_subtree
from .optim import build_optimizer, dropout_schedule, lr_schedule, subtree_lr_factors
from .trainer import (
    Trainer,
    TrainState,
    am_eval_step,
    am_train_step,
    create_train_state,
    finalize_batch_stats,
    make_am_step,
    make_eval_step,
    make_superstep,
    make_xvec_step,
    xvec_eval_step,
    xvec_train_step,
)

__all__ = [
    "lr_schedule",
    "dropout_schedule",
    "build_optimizer",
    "subtree_lr_factors",
    "TrainState",
    "create_train_state",
    "xvec_train_step",
    "am_train_step",
    "xvec_eval_step",
    "am_eval_step",
    "graft_subtree",
    "make_superstep",
    "Trainer",
    "finalize_batch_stats",
    "save_checkpoint",
    "load_checkpoint",
    "combine_checkpoints",
]
