"""sepi_tpu_torch: the PyTorch/CUDA port of sepi_tpu.

The extraction-and-scoring path of the v2 x-vector system (MFCC with the
hand-written Hopper kernel -> energy VAD -> sliding CMVN -> voiced-frame
compaction -> x-vector TDNN -> LDA/PLDA scoring -> EER/minDCF), held
against the JAX package by tests that run both on the same inputs.
Imports torch and numpy only; kernels build with nvcc at first use.
"""

from . import backend, config, data, metrics, models, ops, recipes  # noqa: F401
from .device import resolve_device  # noqa: F401
