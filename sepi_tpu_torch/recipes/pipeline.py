"""Pipeline stages of the extraction-and-scoring path.

Port of the serving half of `sepi_tpu/recipes/pipeline.py`:

  prepare_features_nosil  = make_mfcc + compute_vad + prepare_feats_for_egs
                            (MFCC -> energy VAD -> sliding CMVN -> strip
                            silence; `v2/run_sre10.sh:80-165`)
  prepare_features_phonetic = the same chain keeping the with-silence
                            stream and the VAD mask (the aligner's input)
  train_xvector_model     = run_xvector_new.sh stages 4-6 (egs + train)
  extract_and_score       = extract_xvectors_new.sh (chunked forward)
  backend_eval            = mean/LDA/PLDA/scoring/EER
                            (`v2/run_sre10.sh:221-334`)

Signatures follow the reference plus ``device=`` (default "cuda").  The
reference's PRNG ``key`` that salts the dither is a plain int here, and
the device mesh waits for later work.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..backend.lda import compute_lda
from ..backend.plda import adapt_plda, score_trials, train_plda
from ..backend.vector import length_normalize, subtract_global_mean
from ..config import (
    BackendConfig,
    CmvnConfig,
    ExtractConfig,
    FrontendConfig,
    TrainConfig,
    VadConfig,
)
from ..data.manifest import Dataset, Trial
from ..data.sampler import ChunkSampler
from ..device import DeviceLike, resolve_device
from ..extract import EmbeddingExtractor
from ..metrics.det import EvalResult, evaluate_scores, split_scores_by_trials
from ..models import XVector, XVectorConfig
from ..ops.cmvn import sliding_cmvn
from ..ops.dither import utt_seeds
from ..ops.features import FeatureExtractor
from ..ops.vad import energy_vad
from ..train import (
    Trainer,
    TrainState,
    build_optimizer,
    combine_checkpoints,
    create_train_state,
    finalize_batch_stats,
    load_checkpoint,
    make_eval_step,
    make_superstep,
    make_xvec_step,
    save_checkpoint,
)
from ..train.checkpoint import latest_checkpoint, parameter_progress
from ..utils.logging import profile


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


@dataclasses.dataclass
class PhoneticFeatures:
    """The artifacts of `sid/nnet3_cvector/cvector/prepare_feats.sh`:
    WCMVN features with silence (aligner input), the per-frame voiced
    mask, and the silence-stripped features (speaker-net input).
    Alignments computed on ``full`` strip to ``nosil`` row for row via the
    same mask (the select-voiced-ali invariant)."""

    full: Dict[str, np.ndarray]  # utt -> (T, D) wcmvn feats incl. silence
    voiced: Dict[str, np.ndarray]  # utt -> (T,) bool VAD decisions
    nosil: Dict[str, np.ndarray]  # utt -> (T_voiced, D)


def prepare_features_phonetic(
    audio: Mapping[str, np.ndarray],
    frontend: FrontendConfig = FrontendConfig(),
    vad: VadConfig = VadConfig(),
    cmvn: CmvnConfig = CmvnConfig(),
    key: Optional[int] = None,
    batch_size: int = 16,
    device: DeviceLike = "cuda",
) -> PhoneticFeatures:
    """MFCC -> VAD -> sliding CMVN, keeping the with-silence stream, the
    stripped stream and the mask that ties them.  ``nosil`` equals
    `prepare_features_nosil` on the same audio."""
    fe = FeatureExtractor(frontend, device=device)
    full: Dict[str, np.ndarray] = {}
    voiced_out: Dict[str, np.ndarray] = {}
    nosil: Dict[str, np.ndarray] = {}
    for utt_ids, normed, voiced, n_frames in _frontend_batches(
        audio, fe, vad, cmvn, key, batch_size
    ):
        for b, utt_id in enumerate(utt_ids):
            n = int(n_frames[b])
            f = normed[b, :n]
            v = voiced[b, :n].astype(bool)
            full[utt_id] = f
            voiced_out[utt_id] = v
            if v.any():
                nosil[utt_id] = f[v]
    return PhoneticFeatures(full, voiced_out, nosil)


def batch_iterator(sampler, train_cfg: TrainConfig):
    """Training batch stream with background prefetch (the `ark,bg:`
    analog), so sampling overlaps device compute.  Close the returned
    iterator (it owns a producer thread) when training finishes."""
    it = iter(sampler)
    if train_cfg.prefetch > 0:
        from ..data.featstore import PrefetchLoader

        it = PrefetchLoader(it, depth=train_cfg.prefetch)
    return it


def _host_params(state) -> Dict[str, torch.Tensor]:
    return {n: p.detach().cpu().clone() for n, p in state.model.named_parameters()}


def run_checkpointed(trainer, it, num_steps: int, train_cfg: TrainConfig,
                     checkpoint_dir: str, log=None, combine_objf=None):
    """--train-stage semantics: resume from the latest checkpoint, run in
    ``checkpoint_every`` segments, save and log per-component parameter
    progress (nnet3-show-progress) at each boundary, and optionally pick
    the best checkpoint-tail combination (nnet3-combine) by
    ``combine_objf(state)``.  With ``train_cfg.profile`` each segment
    writes a `torch.profiler` trace under ``<parent of
    checkpoint_dir>/profile/seg<start>-<end>``."""
    done = latest_checkpoint(checkpoint_dir) or 0
    if done:
        trainer.state = load_checkpoint(trainer.state, checkpoint_dir, done)
        trainer.steps_done = done  # logged steps stay global on resume
    remaining = num_steps - done
    prev_params = _host_params(trainer.state) if log else None
    state = trainer.state
    while remaining > 0:
        run_for = min(train_cfg.checkpoint_every, remaining)
        start = num_steps - remaining
        trace_dir = os.path.join(
            os.path.dirname(checkpoint_dir) or ".", "profile", f"seg{start}-{start + run_for}",
        ) if train_cfg.profile else None
        with profile(trace_dir, enabled=trace_dir is not None):
            state = trainer.run(it, num_steps=run_for)
        remaining -= run_for
        save_checkpoint(state, checkpoint_dir, num_steps - remaining,
                        keep_every=train_cfg.keep_checkpoint_every * train_cfg.checkpoint_every)
        if log:
            cur_params = _host_params(state)
            log(num_steps - remaining, "progress", parameter_progress(prev_params, cur_params))
            prev_params = cur_params
    if combine_objf is not None:
        last_objf = combine_objf(state)
        state, best_objf = combine_checkpoints(state, checkpoint_dir, combine_objf)
        if log:
            log(num_steps, "combine",
                {"objf_last": float(last_objf), "objf_combined": float(best_objf)})
    return state


def make_task_supersteps(tx, tasks, train_cfg: TrainConfig):
    """Per-task superstep functions when steps_per_dispatch > 1, else
    None.  ``tasks`` maps task name -> task_kwargs of the model call."""
    if train_cfg.steps_per_dispatch <= 1:
        return None
    return {t: make_superstep(tx, task_kwargs=kw) for t, kw in tasks.items()}


def auto_heldout(dataset: Dataset, num_heldout_utts: Optional[int]) -> int:
    """Resolve the held-out budget: None = auto (~5%, at least 2, at most
    1000, as get_egs_new.sh holds out 1000 utts of ~100k); an int
    (including 0 = off) passes through."""
    if num_heldout_utts is not None:
        return num_heldout_utts
    return min(1000, max(2, len(dataset) // 20))


def heldout_split(dataset: Dataset, num_heldout_utts: int,
                  min_per_spk: int = 2) -> Tuple[Dataset, Dataset]:
    """Split off held-out diagnostic utterances (get_egs_xvec.sh:104-119):
    only speakers keeping at least ``min_per_spk`` utterances contribute,
    and augmented copies move with their clean source (utt2uniq)."""
    groups: Dict[str, list] = {}
    for u in dataset:
        groups.setdefault(u.uniq_id or u.utt_id, []).append(u)
    heldout: list = []
    remaining_counts = {s: len(us) for s, us in dataset.spk2utt.items()}
    for root in sorted(groups):
        if len(heldout) >= num_heldout_utts:
            break
        members = groups[root]
        spk = members[0].spk_id
        if remaining_counts[spk] > min_per_spk + len(members) - 1:
            heldout.extend(m.utt_id for m in members)
            remaining_counts[spk] -= len(members)
    held_set = set(heldout)
    return (
        dataset.filter(lambda u: u.utt_id not in held_set, f"{dataset.name}_train"),
        dataset.filter(lambda u: u.utt_id in held_set, f"{dataset.name}_valid"),
    )


def training_device(train_cfg: TrainConfig, mesh, device: DeviceLike) -> torch.device:
    """The device of a training entry point, after refusing what is not
    ported: the device mesh and a compute dtype other than float32."""
    if mesh is not None:
        raise NotImplementedError("the device mesh is not ported yet")
    if train_cfg.compute_dtype != "float32":
        raise NotImplementedError(f"compute_dtype {train_cfg.compute_dtype!r}: only float32")
    return resolve_device(device)


def train_xvector_model(
    features: Mapping[str, np.ndarray],
    dataset: Dataset,
    model_cfg: Optional[XVectorConfig] = None,
    train_cfg: TrainConfig = TrainConfig(),
    num_steps: int = 500,
    mesh=None,
    log=None,
    num_heldout_utts: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    device: DeviceLike = "cuda",
):
    """Train a v2 x-vector on nosil features; returns (model, state,
    label_map), the model in eval mode with calibrated batch-norm
    statistics (``state.model`` is the same module).

    ``num_heldout_utts`` (default auto, see `auto_heldout`) holds out
    utterances scored each ``steps_per_eval`` steps (0 disables); with
    ``checkpoint_dir``, checkpoints are written every
    ``checkpoint_every`` steps, a run resumes from the newest, and the
    final model is the best checkpoint-tail combination on the held-out
    objective.  The sampler draws in the reference's order (the valid
    sampler first, a probe batch, calibration batches after training), so
    both packages train on the same batches.
    """
    dev = training_device(train_cfg, mesh, device)
    feat_dim = next(iter(features.values())).shape[1]
    label_map = dataset.speaker_label_map()
    if model_cfg is None:
        model_cfg = XVectorConfig(feat_dim=feat_dim, num_speakers=len(label_map))
    model = XVector(model_cfg)

    train_ds, valid_batches, eval_steps = dataset, None, None
    num_heldout_utts = auto_heldout(dataset, num_heldout_utts)
    if num_heldout_utts > 0:
        train_ds, valid_ds = heldout_split(dataset, num_heldout_utts)
        valid_utts = [u for u in valid_ds.utt_ids if u in features]
        if not valid_utts:
            train_ds = dataset  # nothing could be held out
        else:
            # the global label map: the held-out subset may miss speakers
            valid_sampler = ChunkSampler(
                {u: features[u] for u in valid_utts},
                dataset.subset(valid_utts),
                train_cfg.chunks,
                min(train_cfg.batch_size, max(len(valid_utts), 2)),
                train_cfg.seed + 1,
                label_map=label_map,
            )
            valid_batches = [valid_sampler.sample_batch(l) for l in valid_sampler.buckets[:2]]
            eval_steps = {"xvec": make_eval_step()}

    sampler = ChunkSampler(
        {u: features[u] for u in train_ds.utt_ids if u in features},
        dataset.subset(train_ds.utt_ids),
        train_cfg.chunks,
        train_cfg.batch_size,
        train_cfg.seed,
        block_size=train_cfg.steps_per_dispatch,
        label_map=label_map,
    )
    tx, _ = build_optimizer(train_cfg.optimizer, num_steps)
    # the reference traces its model on this batch; drawn here too so the
    # sampler's RNG stays in step with it
    sampler.sample_batch(sampler.buckets[0])
    state = create_train_state(model, tx, train_cfg.seed, dev)
    trainer = Trainer(
        steps={"xvec": make_xvec_step(tx)}, state=state, log_every=50, logger=log,
        valid_batches=valid_batches, eval_steps=eval_steps,
        eval_every=train_cfg.steps_per_eval,
        supersteps=make_task_supersteps(tx, {"xvec": {}}, train_cfg),
        steps_per_dispatch=train_cfg.steps_per_dispatch,
    )

    it = batch_iterator(sampler, train_cfg)
    try:
        if checkpoint_dir:
            combine_objf = None
            if valid_batches and eval_steps:
                ev = eval_steps["xvec"]

                def combine_objf(s):
                    return float(np.mean([float(ev(s, vb.feats, vb.labels)["objf"])
                                          for vb in valid_batches]))

            state = run_checkpointed(trainer, it, num_steps, train_cfg, checkpoint_dir,
                                     log=log, combine_objf=combine_objf)
        else:
            state = trainer.run(it, num_steps=num_steps)
    finally:
        if hasattr(it, "close"):
            it.close()

    calib = [sampler.sample_batch(l).feats for l in sampler.buckets[:3]]
    state = finalize_batch_stats(state, calib)
    return state.model, state, label_map


def extract_and_score(
    model: torch.nn.Module,
    state,
    features: Mapping[str, np.ndarray],
    extract_cfg: ExtractConfig = ExtractConfig(),
    min_frames: int = 15,
    model_kwargs: Optional[Dict] = None,
    mesh=None,
    device: DeviceLike = "cuda",
) -> Dict[str, np.ndarray]:
    """Chunked embedding extraction for all utterances.  ``state`` is what
    a trainer returned (a `TrainState`, whose ``model`` weights are loaded
    into ``model``), a state_dict (e.g. from
    `bridge.xvector_state_dict_from_flax`), or None to keep the model's
    own weights.  The device mesh is not ported: a mesh raises."""
    if mesh is not None:
        raise NotImplementedError("the device mesh is not ported yet")
    if isinstance(state, TrainState):
        state = state.model.state_dict()
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
