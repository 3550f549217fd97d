"""The configs of the extraction-and-scoring path.

A copy of the dataclasses this path reads from `sepi_tpu/config.py`
(`FrontendConfig`, `VadConfig`, `CmvnConfig`, `ExtractConfig`,
`BackendConfig`), with the same fields and Kaldi-compatible defaults, so
a config built for either package means the same thing in the other.
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
    # on-device scoring is not ported yet; True raises in score_trials
    device_scoring: bool = False

    replace = _replace
