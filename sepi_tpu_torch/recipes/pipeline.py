"""Pipeline stages of the extraction-and-scoring path.

Port of the serving half of `sepi_tpu/recipes/pipeline.py`:

  prepare_features_nosil  = make_mfcc + compute_vad + prepare_feats_for_egs
                            (MFCC -> energy VAD -> sliding CMVN -> strip
                            silence; `v2/run_sre10.sh:80-165`)
  extract_and_score       = extract_xvectors_new.sh (chunked forward)
  backend_eval            = mean/LDA/PLDA/scoring/EER
                            (`v2/run_sre10.sh:221-334`)

Signatures follow the reference plus ``device=`` (default "cuda").  The
reference's PRNG ``key`` that salts the dither is a plain int here, and
the training stages and the device mesh wait for later work.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..backend.lda import compute_lda
from ..backend.plda import adapt_plda, score_trials, train_plda
from ..backend.vector import length_normalize, subtract_global_mean
from ..config import BackendConfig, CmvnConfig, ExtractConfig, FrontendConfig, VadConfig
from ..data.manifest import Dataset, Trial
from ..device import DeviceLike
from ..extract import EmbeddingExtractor
from ..metrics.det import EvalResult, evaluate_scores, split_scores_by_trials
from ..ops.cmvn import sliding_cmvn
from ..ops.dither import utt_seeds
from ..ops.features import FeatureExtractor
from ..ops.vad import energy_vad


def _shape_bucket(n: int, grid: int, growth: float = 1.3) -> int:
    """Padded-length bucket for one frontend batch: linear ``grid``
    steps up to ``4*grid`` samples, geometric ~30% steps beyond, so the
    number of distinct batch shapes stays O(log max_len)."""
    n = max(int(n), 1)
    if n <= 4 * grid:
        return -(-n // grid) * grid
    b = 4 * grid
    while b < n:
        b = -(-int(b * growth) // grid) * grid
    return b


def _frontend_batches(
    audio: Mapping[str, np.ndarray],
    fe: FeatureExtractor,
    vad: VadConfig,
    cmvn: CmvnConfig,
    key: Optional[int],
    batch_size: int,
    pad_grid: int = 4000,
    transform=None,
):
    """Run MFCC -> VAD -> [transform] -> CMVN over length-sorted padded
    batches on ``fe.device``.  Yields (utt_ids, feats (B,T,D),
    voiced (B,T), num_frames (B,)) as host arrays.

    With dither on (the Kaldi default), each utterance's noise is a pure
    function of (utt_id, config[, key]) through per-utterance seeds, so
    features do not depend on batch composition.  ``key`` is an int that
    salts the whole corpus.
    """
    dither_on = fe.cfg.dither != 0.0
    salt = int(key) if (key is not None and dither_on) else 0
    if hasattr(audio, "num_samples"):
        ids = sorted(audio, key=lambda u: (audio.num_samples(u), u))
    else:
        ids = sorted(audio, key=lambda u: (len(audio[u]), u))
    for i in range(0, len(ids), batch_size):
        chunk = [(u, np.asarray(audio[u])) for u in ids[i:i + batch_size]]
        pad_len = _shape_bucket(max(len(x) for _, x in chunk), pad_grid)
        samples = np.zeros((len(chunk), pad_len), np.float32)
        lengths = np.zeros((len(chunk),), np.int32)
        for b, (_, x) in enumerate(chunk):
            samples[b, :len(x)] = x
            lengths[b] = len(x)
        seeds = utt_seeds([u for u, _ in chunk], base_seed=salt) if dither_on else None
        feats, mask = fe.mfcc(samples, lengths, utt_seeds=seeds)
        voiced = energy_vad(feats[..., 0], mask, vad)
        if transform is not None:
            feats = transform(feats, mask)
        normed = sliding_cmvn(feats, mask, cmvn)
        yield (
            [u for u, _ in chunk],
            normed.cpu().numpy(),
            voiced.cpu().numpy(),
            mask.sum(-1).cpu().numpy(),
        )


def iter_features_nosil(
    audio: Mapping[str, np.ndarray],
    frontend: FrontendConfig = FrontendConfig(),
    vad: VadConfig = VadConfig(),
    cmvn: CmvnConfig = CmvnConfig(),
    key: Optional[int] = None,
    batch_size: int = 16,
    device: DeviceLike = "cuda",
):
    """Streaming form of `prepare_features_nosil`: yields
    (utt_id, (T_voiced, D) float32) one utterance at a time."""
    fe = FeatureExtractor(frontend, device=device)
    for utt_ids, normed, voiced, _ in _frontend_batches(
        audio, fe, vad, cmvn, key, batch_size
    ):
        for b, utt_id in enumerate(utt_ids):
            v = voiced[b].astype(bool)
            if v.any():
                yield utt_id, normed[b][v]


def prepare_features_nosil(
    audio: Mapping[str, np.ndarray],
    frontend: FrontendConfig = FrontendConfig(),
    vad: VadConfig = VadConfig(),
    cmvn: CmvnConfig = CmvnConfig(),
    key: Optional[int] = None,
    batch_size: int = 16,
    device: DeviceLike = "cuda",
) -> Dict[str, np.ndarray]:
    """MFCC -> VAD -> sliding CMVN -> voiced-frame compaction, batched
    over length-bucketed utterances.  Returns utt_id -> (T_voiced,
    num_ceps) float32: the `_nosil` features every neural recipe uses."""
    return dict(iter_features_nosil(audio, frontend, vad, cmvn, key, batch_size, device))


def extract_and_score(
    model: torch.nn.Module,
    state: Optional[Mapping[str, torch.Tensor]],
    features: Mapping[str, np.ndarray],
    extract_cfg: ExtractConfig = ExtractConfig(),
    min_frames: int = 15,
    model_kwargs: Optional[Dict] = None,
    device: DeviceLike = "cuda",
) -> Dict[str, np.ndarray]:
    """Chunked embedding extraction for all utterances.  ``state`` is a
    state_dict loaded into ``model`` first (e.g. from
    `bridge.xvector_state_dict_from_flax`); None keeps the model's own."""
    if state is not None:
        model.load_state_dict(state)
    extractor = EmbeddingExtractor(model, extract_cfg, min_frames=min_frames,
                                   model_kwargs=model_kwargs, device=device)
    return extractor.extract_utterances(features)


def backend_eval(
    utt_embeddings: Mapping[str, np.ndarray],
    train_dataset: Dataset,
    trials: Sequence[Trial],
    enroll_spk2utt: Mapping[str, Sequence[str]],
    backend_cfg: BackendConfig = BackendConfig(),
    adapt_vectors: Optional[np.ndarray] = None,
) -> Tuple[EvalResult, Dict]:
    """mean -> LDA -> length-norm -> PLDA -> trial scoring -> EER/DCF,
    in float64 on the host as the reference's default.  ``train_dataset``
    supplies the LDA/PLDA training population; ``enroll_spk2utt`` defines
    the enrollment models (speaker -> utts)."""
    train_ids = [u for u in train_dataset.utt_ids if u in utt_embeddings]
    x_train = np.stack([utt_embeddings[u] for u in train_ids])
    labels = [train_dataset[u].spk_id for u in train_ids]

    centered, global_mean = subtract_global_mean(x_train)
    lda_dim = min(backend_cfg.lda_dim, x_train.shape[1] - 1, len(set(labels)) - 1)
    lda = compute_lda(centered, labels, lda_dim)

    def project(vecs: np.ndarray, mean: np.ndarray = global_mean) -> np.ndarray:
        c = np.asarray(vecs, np.float64) - mean
        p = lda(c + lda.mean)  # lda centers internally with its own mean
        return length_normalize(p) if backend_cfg.length_norm else p

    plda = train_plda(project(x_train), labels, backend_cfg.plda_iters)
    # SRE16 mean handling (`v2/run_sre16.sh:96-110`): the adaptation set
    # centers by its own mean, and scoring then uses that in-domain mean
    scoring_mean = global_mean
    if adapt_vectors is not None:
        adapt_mean = np.mean(np.asarray(adapt_vectors, np.float64), axis=0)
        plda = adapt_plda(
            plda,
            project(adapt_vectors, mean=adapt_mean),
            backend_cfg.adapt_within_covar_scale,
            backend_cfg.adapt_between_covar_scale,
        )
        scoring_mean = adapt_mean

    enroll_vecs: Dict[str, np.ndarray] = {}
    num_utts: Dict[str, int] = {}
    for spk, utts in enroll_spk2utt.items():
        vecs = [utt_embeddings[u] for u in utts if u in utt_embeddings]
        if vecs:
            # speaker mean in raw embedding space, then the scoring
            # pipeline (run_sre16.sh:109)
            enroll_vecs[spk] = project(np.mean(vecs, axis=0)[None], mean=scoring_mean)[0]
            num_utts[spk] = len(vecs)
    test_vecs = {
        t.test: project(utt_embeddings[t.test][None], mean=scoring_mean)[0]
        for t in trials
        if t.test in utt_embeddings
    }
    usable = [t for t in trials if t.model in enroll_vecs and t.test in test_vecs]
    scores = score_trials(plda, enroll_vecs, test_vecs, usable, num_utts,
                          device=backend_cfg.device_scoring)
    tgt, non = split_scores_by_trials(
        scores, [(t.model, t.test, t.target) for t in usable]
    )
    return evaluate_scores(tgt, non), {
        "scores": scores, "plda": plda, "lda": lda, "mean": scoring_mean,
    }
