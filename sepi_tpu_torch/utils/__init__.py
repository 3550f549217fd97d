from .kaldi_io import ArkWriter, read_int_vector, read_matrix, read_scp, read_vector
from .logging import MetricsLogger, profile

__all__ = [
    "ArkWriter",
    "MetricsLogger",
    "profile",
    "read_int_vector",
    "read_matrix",
    "read_scp",
    "read_vector",
]
