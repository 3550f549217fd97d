"""The configs of the ported paths.

A copy of the dataclasses these paths read from `sepi_tpu/config.py`
(`FrontendConfig` and its five `MFCC_*` presets,
`VadConfig`, `CmvnConfig`, `ChunkConfig`, `OptimizerConfig`,
`TrainConfig`, `ExtractConfig`, `BackendConfig`, `UbmConfig`,
`IvectorConfig`, `AlignConfig`, `MeshConfig`), with the same fields and
defaults, so a config built for either package means the same thing in the
other.
"""

from __future__ import annotations

import dataclasses


def _replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """MFCC extraction options (compute-mfcc-feats compatible)."""

    sample_rate: int = 8000
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    dither: float = 1.0
    preemphasis: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"  # povey | hamming | hanning | rectangular
    round_to_power_of_two: bool = True
    snip_edges: bool = False
    # Mel bank
    num_mel_bins: int = 23
    low_freq: float = 20.0
    high_freq: float = 3700.0  # <=0 means offset from Nyquist
    # MFCC
    num_ceps: int = 23
    use_energy: bool = True  # replace C0 with log raw-frame energy
    energy_floor: float = 0.0
    raw_energy: bool = True  # energy before preemph/window
    cepstral_lifter: float = 22.0
    # fbank
    use_log_fbank: bool = True

    @property
    def frame_length(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000.0)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000.0)

    @property
    def padded_window_size(self) -> int:
        n = self.frame_length
        if not self.round_to_power_of_two:
            return n
        p = 1
        while p < n:
            p *= 2
        return p

    @property
    def nyquist(self) -> float:
        return self.sample_rate / 2.0

    @property
    def high_freq_hz(self) -> float:
        return self.high_freq if self.high_freq > 0 else self.nyquist + self.high_freq

    replace = _replace


# Named presets matching the reference conf/ files.
MFCC_SRE_IVECTOR = FrontendConfig(num_ceps=20)  # v1/conf/mfcc.conf
MFCC_SRE_XVECTOR = FrontendConfig(num_ceps=23)  # v2,v3/conf/mfcc.conf
MFCC_SNIP_EDGES = FrontendConfig(num_ceps=23, snip_edges=True)  # v3 ASR feats
MFCC_HIRES = FrontendConfig(  # v1/conf/mfcc_hires.conf
    use_energy=False,
    num_mel_bins=40,
    num_ceps=40,
    low_freq=40.0,
    high_freq=-200.0,
)
MFCC_ASR = FrontendConfig(  # v1/conf/mfcc_asr.conf
    use_energy=False,
    low_freq=20.0,
    high_freq=0.0,
    num_ceps=13,
)


@dataclasses.dataclass(frozen=True)
class VadConfig:
    """Energy VAD (compute-vad compatible; v2/conf/vad.conf)."""

    energy_threshold: float = 5.5
    energy_mean_scale: float = 0.5
    frames_context: int = 2
    proportion_threshold: float = 0.12

    replace = _replace


@dataclasses.dataclass(frozen=True)
class CmvnConfig:
    """Sliding-window CMVN (apply-cmvn-sliding compatible)."""

    window: int = 300
    center: bool = True
    normalize_variance: bool = False

    replace = _replace


@dataclasses.dataclass(frozen=True)
class ChunkConfig:
    """Training-chunk sampling (replaces the egs allocation pipeline):
    chunk lengths drawn per batch from ``num_buckets`` static lengths (the
    per-archive-constant-length invariant, `get_egs_xvec.sh:9-14`),
    speaker-balanced draws (`allocate_egs_new.py`)."""

    min_chunk_len: int = 200
    max_chunk_len: int = 400
    num_buckets: int = 8
    frames_per_chunk_avg: int = 300

    replace = _replace


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """SGD options matching the nnet3 trainer flags.

    The effective LR decays exponentially from ``initial_lr`` to
    ``final_lr`` over training (`steps/libs/nnet3/train/common.py:644-657`).
    ``shrink_iterations`` spreads the reference's once-per-iteration
    proportional shrink over per-minibatch steps.  ``preconditioner``:
    "muon" (default) = Newton-Schulz orthogonalized momentum on matrix
    parameters and Adam on the rest; "none" = momentum SGD.
    """

    initial_lr: float = 1e-3
    final_lr: float = 1e-4
    momentum: float = 0.5
    max_param_change: float = 2.0
    proportional_shrink: float = 10.0
    shrink_iterations: int = 120
    l2_regularize: float = 0.0
    num_epochs: int = 3
    shrink_guard: float = 0.5  # train_cvector_dnn.py:292-296
    preconditioner: str = "muon"


# the compute dtypes of the TDNN stacks: parameters, batch norm and logits
# stay float32 in both, as in the reference's Flax models
COMPUTE_DTYPES = ("float32", "bfloat16")


def check_compute_dtype(name: str) -> str:
    """``name`` if it is a compute dtype, "float32" or "bfloat16"; anything
    else raises."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {name!r} not in {COMPUTE_DTYPES}")
    return name


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training options.  ``compute_dtype`` is the TDNN stacks' compute
    dtype, "float32" or "bfloat16" (each affine and its ReLU in that
    dtype; parameters, batch norm and logits float32); anything else
    raises.  ``profile`` writes a `torch.profiler` trace per checkpoint
    segment under ``<checkpoint_dir>/../profile/seg<start>-<end>``."""

    optimizer: OptimizerConfig = OptimizerConfig()
    chunks: ChunkConfig = ChunkConfig()
    batch_size: int = 64
    am_batch_size: int = 256
    am_weight: float = 1.0
    xvec_weight: float = 1.0
    repeats_per_spk: int = 0  # 0 = auto-balance
    compute_dtype: str = "float32"
    seed: int = 123
    steps_per_eval: int = 100
    checkpoint_every: int = 100
    keep_checkpoint_every: int = 10  # preserve-model-interval
    # train steps run back to back from one stacked batch (a superstep)
    steps_per_dispatch: int = 1
    # background-thread batch prefetch depth (ark,bg: analog); 0 disables
    prefetch: int = 2
    profile: bool = False

    def __post_init__(self):
        check_compute_dtype(self.compute_dtype)

    replace = _replace


@dataclasses.dataclass(frozen=True)
class ExtractConfig:
    """Chunked embedding extraction (nnet3-xvector-compute compatible):
    min-chunk-size 25, chunk-size 10000, length-weighted averaging of
    per-chunk embeddings."""

    min_chunk_size: int = 25
    chunk_size: int = 10000
    embedding_node: str = "embedding_a"  # tdnn6.affine analog
    batch_size: int = 32

    replace = _replace


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    """LDA/PLDA backend options (v2 run_sre10.sh:221-246)."""

    lda_dim: int = 150
    plda_iters: int = 10
    length_norm: bool = True
    # PLDA adaptation (ivector-adapt-plda, v2/run_sre16.sh:96-103)
    adapt_within_covar_scale: float = 0.75
    adapt_between_covar_scale: float = 0.25
    # score the trial matrix on the device in float32 (`backend.device`)
    device_scoring: bool = False

    replace = _replace


@dataclasses.dataclass(frozen=True)
class UbmConfig:
    """GMM-UBM training (sid/train_diag_ubm.sh + train_full_ubm.sh)."""

    num_gauss: int = 2048
    num_gselect: int = 20  # diag stage (train_diag_ubm.sh num_gselect)
    full_gselect: int = 20
    num_iters_init: int = 4
    num_iters_full: int = 4
    min_post: float = 0.025
    subsample: int = 5  # train on every 5th frame, like train_diag_ubm.sh
    min_gaussian_weight: float = 1e-4
    remove_low_count_gaussians: bool = False

    replace = _replace


@dataclasses.dataclass(frozen=True)
class IvectorConfig:
    """i-vector extractor (sid/train_ivector_extractor.sh)."""

    ivector_dim: int = 600
    num_iters: int = 5
    min_post: float = 0.025
    posterior_scale: float = 1.0

    replace = _replace


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """s5-analog aligner stage (egs/sre/s5/run.sh:108-202 capability).

    Monophone Viterbi-EM (`steps/train_mono.sh`), likelihood-based state
    tying to ``num_leaves`` senones (tri6a's 5000-leaf tree), then
    ``refine_iters`` rounds of context-dependent re-alignment with
    per-senone GMMs (`steps/align_si.sh` semantics).
    """

    num_leaves: int = 4096  # tri6a_4k
    mono_iters: int = 4
    refine_iters: int = 2
    min_count: float = 100.0  # min frames per tied leaf
    states_per_phone: int = 3
    comps_per_senone: int = 2
    seed: int = 0
    # LDA+MLLT feature-space stage (steps/train_lda_mllt.sh, the tri3b
    # rung: est-lda over spliced ±context frames + est-mllt/STC rounds
    # interleaved with tied-tree re-alignment; s5/run.sh:130-140).  The
    # tied tree is reused across the transform (Kaldi rebuilds it).
    lda_mllt: bool = False
    lda_mllt_dim: int = 40
    splice_context: int = 3
    mllt_iters: int = 2
    # Speaker-adaptive pass (steps/align_fmllr.sh): per-speaker fMLLR
    # transforms from the refined alignment, then re-alignment on the
    # transformed features.  Needs utt2spk at the run_s5 call site.
    fmllr: bool = False
    fmllr_min_beta: float = 200.0  # frames below which a spk stays identity

    replace = _replace


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout.  The TDNNs fit one card, so the only sharded
    axis is data; the mesh keeps a model axis, as the reference's does."""

    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel_size: int = 1
