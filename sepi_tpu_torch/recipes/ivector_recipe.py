"""v1 recipe: GMM-UBM / i-vector front end (egs/sre/v1/run_sre10.sh).

Port of `sepi_tpu/recipes/ivector_recipe.py`:

  prepare_features_ivector = 20-dim MFCC -> energy VAD -> deltas (order
      2) -> sliding CMVN -> voiced frames (`add-deltas |
      apply-cmvn-sliding | select-voiced-frames`), (T, 60)
  train_v1_frontend        = train_diag_ubm.sh -> train_full_ubm.sh ->
      train_ivector_extractor.sh (2048 Gaussians, T-matrix 600, 5 EM
      iterations at reference scale)
  extract_v1_ivectors      = extract_ivectors.sh
  (the backend is recipes.pipeline.backend_eval with lda_dim=200)

The DNN-posterior variant (run_sre10_nnet2.sh) passes ``posterior_fn``
(frames -> (N, K)) or per-utterance ``posteriors``; the UBM and the
T-matrix statistics then use those instead of GMM posteriors.  Each
function takes ``device=`` (default "cuda"); the models live there and
the E-steps run there.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np

from ..classical.gmm import FullGmm, full_gmm_from_posteriors, train_diag_ubm, train_full_ubm
from ..classical.ivector import (
    IvectorExtractor,
    extract_ivectors,
    init_extractor,
    stats_from_features,
    train_ivector_extractor,
)
from ..config import CmvnConfig, FrontendConfig, IvectorConfig, MFCC_SRE_IVECTOR, UbmConfig, VadConfig
from ..device import DeviceLike, fp32_math, resolve_device
from ..ops.deltas import add_deltas
from ..ops.features import FeatureExtractor


def iter_features_ivector(
    audio: Mapping[str, np.ndarray],
    frontend: FrontendConfig = MFCC_SRE_IVECTOR,
    vad: VadConfig = VadConfig(),
    cmvn: CmvnConfig = CmvnConfig(),
    delta_order: int = 2,
    batch_size: int = 16,
    device: DeviceLike = "cuda",
):
    """Streaming form of `prepare_features_ivector`: yields (utt_id,
    (T, 60) float32) pairs (for `ArtifactCache.stage_store`)."""
    from .pipeline import _frontend_batches

    fe = FeatureExtractor(frontend, device=device)
    for utt_ids, normed, voiced, _ in _frontend_batches(
        audio, fe, vad, cmvn, None, batch_size,
        transform=lambda f, m: add_deltas(f, m, order=delta_order),
    ):
        for b, utt_id in enumerate(utt_ids):
            v = voiced[b].astype(bool)
            if v.any():
                yield utt_id, normed[b][v]


def prepare_features_ivector(
    audio: Mapping[str, np.ndarray],
    frontend: FrontendConfig = MFCC_SRE_IVECTOR,
    vad: VadConfig = VadConfig(),
    cmvn: CmvnConfig = CmvnConfig(),
    delta_order: int = 2,
    batch_size: int = 16,
    device: DeviceLike = "cuda",
) -> Dict[str, np.ndarray]:
    """MFCC(20) -> VAD -> deltas -> sliding CMVN -> voiced selection, (T, 60),
    batched over length-bucketed utterances (`pipeline._frontend_batches`,
    the deltas through its transform hook)."""
    return dict(iter_features_ivector(audio, frontend, vad, cmvn, delta_order, batch_size,
                                      device))


@fp32_math()
def train_v1_frontend(
    features: Mapping[str, np.ndarray],
    ubm_cfg: UbmConfig = UbmConfig(),
    iv_cfg: IvectorConfig = IvectorConfig(),
    seed: int = 0,
    posterior_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    posteriors: Optional[Mapping[str, np.ndarray]] = None,
    device: DeviceLike = "cuda",
) -> Tuple[FullGmm, IvectorExtractor]:
    """UBM + T-matrix training on the pooled training frames.

    DNN-posterior variant (`init_full_ubm_from_dnn.sh:100-116` +
    `train_ivector_extractor_dnn.sh`): ``posterior_fn`` (frames -> (N, K),
    applied to the pooled frames) or per-utterance ``posteriors`` (utt ->
    (T, K), frame-aligned with ``features``); the UBM is then
    moment-matched from those posteriors and the T-matrix statistics use
    them too."""
    dev = resolve_device(device)
    all_frames = np.concatenate([features[u] for u in sorted(features)])
    if posteriors is not None:
        post_all = np.concatenate([posteriors[u] for u in sorted(features)])
        ubm = full_gmm_from_posteriors(all_frames, post_all, device=dev)
    elif posterior_fn is not None:
        ubm = full_gmm_from_posteriors(all_frames, posterior_fn(all_frames), device=dev)
    else:
        diag = train_diag_ubm(all_frames, ubm_cfg, seed, device=dev)
        ubm = train_full_ubm(all_frames, diag, ubm_cfg)
    ext = init_extractor(ubm, iv_cfg.ivector_dim, seed)
    _, stats = stats_from_features(ext, ubm, features, iv_cfg, ubm_cfg.full_gselect,
                                   posteriors=posteriors)
    ext = train_ivector_extractor(ext, stats, iv_cfg)
    return ubm, ext


@fp32_math()
def extract_v1_ivectors(
    ubm: FullGmm,
    ext: IvectorExtractor,
    features: Mapping[str, np.ndarray],
    iv_cfg: IvectorConfig = IvectorConfig(),
    num_gselect: int = 20,
    posteriors: Optional[Mapping[str, np.ndarray]] = None,
) -> Dict[str, np.ndarray]:
    """utt -> (M,) posterior-mean i-vector, on the extractor's device."""
    utt_ids, stats = stats_from_features(ext, ubm, features, iv_cfg, num_gselect,
                                         posteriors=posteriors)
    ivecs = extract_ivectors(ext, stats, iv_cfg)
    return dict(zip(utt_ids, ivecs))
