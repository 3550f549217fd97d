from .kaldi_io import (ArkWriter, iter_int_vector_ark, read_ali_ark, read_ali_dir,
                       read_feats_scp, read_int_vector, read_matrix, read_scp, read_vector)
from .logging import MetricsLogger, profile

__all__ = [
    "ArkWriter",
    "MetricsLogger",
    "iter_int_vector_ark",
    "profile",
    "read_ali_ark",
    "read_ali_dir",
    "read_feats_scp",
    "read_int_vector",
    "read_matrix",
    "read_scp",
    "read_vector",
]
