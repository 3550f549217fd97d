"""sepi_tpu_torch: the PyTorch/CUDA port of sepi_tpu.

Its paths, held against the JAX package by tests that run both on the
same inputs:
- the extraction-and-scoring path of the v2 x-vector system (MFCC with
  the hand-written Hopper kernel -> energy VAD -> sliding CMVN ->
  voiced-frame compaction -> x-vector TDNN -> LDA/PLDA scoring ->
  EER/minDCF);
- the s5 forced aligner (monophone Viterbi-EM -> tied senone tree ->
  LDA+MLLT -> context-dependent re-alignment -> fMLLR SAT), with the
  batched Viterbi as a hand-written Hopper kernel;
- v2 x-vector training (chunk sampler -> cross-entropy steps with the
  Muon/Adam or momentum-SGD chain -> checkpoints and tail combination ->
  batch-norm calibration);
- the phonetic c-vector systems (v3/v4/v5) and the recipe drivers;
- the v1 i-vector systems: GMM-UBM and T-matrix EM (`classical`), the
  DNN/i-vector variant with the p-norm nnet2 senone net, `run_v1`;
- bf16 compute for every TDNN trainer and driver, the on-device backend
  (`backend.device`: PLDA scoring, LDA and PLDA EM in float32), z/t/s-norm,
  score fusion and `extract.streaming_embed`;
- the user-facing surface: the command line (`python -m sepi_tpu_torch`,
  `cli`: v1-v5 on Kaldi data directories, prep-ldc/prep-asr with the
  `data.{corpora,ldc,asr_prep}` walkers, import-kaldi/export-kaldi through
  `utils.{nnet3,nnet2_io,kaldi_models}`) and the acceptance gauntlet
  (`recipes.gauntlet`);
- multi-process data parallelism on torch.distributed (`parallel`: the
  device mesh, data-parallel steps with batch norm reduced over the mesh,
  sharded extraction, GMM statistics and PLDA scoring).
Imports torch and numpy only; kernels build with nvcc at first use.
"""

from . import (align, backend, classical, config, data, metrics, models, ops,  # noqa: F401
               parallel, recipes, train, utils)
from .device import resolve_device  # noqa: F401
