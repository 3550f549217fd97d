"""Declarative experiment drivers — the run_sre10.sh / run_sre16.sh analogs.

Port of `sepi_tpu/recipes/drivers.py`.  One function per reference
variant; each driver is a thin orchestration over the composable stages
with durable artifact caching (the --stage resume property), structured
logging, per-condition reporting and Kaldi-format outputs.  Inputs are
explicit data objects, not corpus paths: LDC-gated corpora are supplied by
the caller as (Dataset, audio, trials [, transcripts/alignments]).

  run_v1  GMM/i-vector + LDA/PLDA        (egs/sre/v1/run_sre10.sh), and
          with ``posterior_provider`` the DNN/i-vector variant
          (run_sre10_nnet2.sh)
  run_v2  x-vector                       (egs/sre/v2/run_sre10.sh)
  run_v3  multitask c-vector             (egs/sre/v3/run_sre10.sh)
  run_v4  phonetic adaptation            (egs/sre/v4/run_sre10.sh)
  run_v5  combined c-vector              (egs/sre/v5/run_sre10.sh)

SRE16-style unsupervised domain adaptation (run_sre16.sh:96-103) is the
``adapt_dataset`` argument of `run_v2`: embeddings of the unlabeled
in-domain set adapt the PLDA covariances before scoring.

Each driver takes the reference's arguments plus ``device=`` (default
"cuda") and passes it to every stage: the features (MFCC kernel), the s5
aligner (Viterbi kernel), the augmentation's FFT, the UBM and T-matrix
EM, the trainers, the extraction and the backend's trial scoring when
``BackendConfig.device_scoring`` is on.  With a ``mesh`` (v2-v5) every
rank runs the driver: training and extraction are data-parallel over the
mesh, the primary alone runs the cached feature and s5 stages and writes
the metrics, checkpoints and Kaldi-format files, and every rank returns
the same result.  `RunResult.seconds` holds
each stage's wall seconds.  Every driver runs inside `device.fp32_math`
(no TF32).  The classical modules load only when `run_v1` runs.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import BackendConfig, ExtractConfig, IvectorConfig, TrainConfig, UbmConfig
from ..data.manifest import Dataset, Trial
from ..device import DeviceLike, fp32_math, resolve_device
from ..metrics.det import EvalResult
from ..metrics.report import evaluate_conditions, format_report
from ..models import AdaptedConfig, AmConfig, CombinedConfig, MultitaskConfig, XVectorConfig
from ..utils.artifacts import ArtifactCache
from ..utils.logging import MetricsLogger
from . import phonetic, pipeline


@dataclasses.dataclass
class RunResult:
    conditions: Dict[str, EvalResult]
    scores: Dict[Tuple[str, str], float]
    report: str
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def pooled(self) -> EvalResult:
        return self.conditions["pooled"]


class _Stages:
    """Wall seconds per stage of one driver call; the card is synchronised
    at each mark, so a stage's device work counts in that stage."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: Dict[str, float] = {}
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self._t
        self._t = now


def _metrics_logger(workdir: str, mesh) -> Optional[MetricsLogger]:
    """The run's metrics stream; with a mesh, the primary's alone."""
    from ..parallel.multihost import is_primary

    return MetricsLogger(f"{workdir}/metrics.jsonl") if mesh is None or is_primary(mesh) else None


@dataclasses.dataclass
class AugmentOptions:
    """v2 stage-2 augmentation (`egs/sre/v2/run_sre10.sh:92-159`):
    reverb/noise/music/babble copies of the training set, a random
    subset of the copies, combined with the clean set.  ``rirs`` and
    ``noises`` supply the RIRS_NOISES / MUSAN sample pools (callers load
    the license-gated corpora; `data.augment.synthetic_rir` and any
    noise arrays work for corpus-free runs)."""

    rirs: Sequence[np.ndarray] = ()
    noises: Mapping[str, Sequence[np.ndarray]] = dataclasses.field(default_factory=dict)
    specs: Sequence = None  # default: data.augment.REFERENCE_AUGMENTS
    subset: Optional[int] = None  # keep this many augmented utts (the 128k analog)
    seed: int = 0


def _apply_augmentation(
    train_dataset: Dataset,
    train_audio: Mapping[str, np.ndarray],
    opts: AugmentOptions,
    device: DeviceLike = "cuda",
) -> Tuple[Dataset, Mapping[str, np.ndarray]]:
    """Stage-2 semantics: augment -> subset -> combine with clean.
    utt2uniq bookkeeping (aug copies carry their clean root) keeps
    heldout splits and PLDA honest downstream.

    Lazy input audio (`AudioStore.lazy_dataset`) stays lazy: augmented
    copies are realized on access from the same draw table
    (`lazy_augment_dataset`) and the clean/aug union is a `ChainAudio`
    view — nothing is materialized, whatever the corpus size."""
    from ..data.audio import ChainAudio
    from ..data.augment import REFERENCE_AUGMENTS, augment_dataset, lazy_augment_dataset

    lazy = hasattr(train_audio, "num_samples")
    make = lazy_augment_dataset if lazy else augment_dataset
    aug_ds, aug_audio = make(
        train_dataset, train_audio,
        rirs=opts.rirs, noises=opts.noises,
        specs=opts.specs or REFERENCE_AUGMENTS, seed=opts.seed, device=device,
    )
    if opts.subset is not None and opts.subset < len(aug_ds):
        rng = np.random.default_rng(opts.seed)
        keep = set(
            np.asarray(aug_ds.utt_ids)[
                rng.permutation(len(aug_ds))[: opts.subset]
            ].tolist()
        )
        aug_ds = aug_ds.filter(lambda u: u.utt_id in keep, f"{aug_ds.name}_sub")
        aug_audio = (aug_audio.subset(keep) if lazy
                     else {u: aug_audio[u] for u in keep})
    combined = train_dataset.combine(aug_ds)
    if lazy:
        return combined, ChainAudio(train_audio, aug_audio)
    return combined, {**train_audio, **aug_audio}


def _audio_fingerprint(audio: Mapping[str, np.ndarray],
                       content_hash: bool = False) -> str:
    """Cache key for feature stages.  Keying on utt ids alone is unsafe:
    augmented copies have deterministic ids (`{utt}-{kind}`) whatever
    the RIR/noise pools and SNR draws produced, and caller audio can
    change under unchanged ids — either would silently reuse stale
    cached features.

    A lazy mapping (`LazyAudio` / `LazyAugmentAudio` / `ChainAudio`)
    supplies a manifest-level digest — utt ids, wav refs, file
    size+mtime, decoder version, augmentation draw tables — costing
    ZERO audio decodes, so a cache hit on a 100k-utt corpus is free.
    Plain dicts (already in RAM) fall back to the content digest;
    ``content_hash=True`` forces it everywhere."""
    if not content_hash and hasattr(audio, "manifest_fingerprint"):
        return audio.manifest_fingerprint()
    from ..data.audio import content_fingerprint

    return content_fingerprint(audio)


def save_embeddings(utt_embeddings: Mapping[str, np.ndarray], workdir: str,
                    name: str = "xvector") -> None:
    """Persist embeddings as a Kaldi ark+scp pair of VECTOR entries —
    the exact table type `extract_xvectors_new.sh:97-108` produces, so
    downstream Kaldi vector tools (ivector-mean, ivector-plda-scoring,
    ivector-normalize-length) consume them directly."""
    from ..utils import ArkWriter

    with ArkWriter(f"{workdir}/{name}.ark", f"{workdir}/{name}.scp") as w:
        for utt in sorted(utt_embeddings):
            w.put_vector(utt, np.asarray(utt_embeddings[utt]))


def _finish(
    utt_embeddings: Mapping[str, np.ndarray],
    train_dataset: Dataset,
    trials: Sequence[Trial],
    enroll_spk2utt: Mapping[str, Sequence[str]],
    backend_cfg: BackendConfig,
    adapt_embeddings: Optional[np.ndarray],
    condition_fn,
    log,
    workdir: Optional[str] = None,
    stages: Optional[_Stages] = None,
    mesh=None,
) -> RunResult:
    from ..parallel.multihost import is_primary

    stages = stages or _Stages(torch.device("cpu"))
    if mesh is not None and not is_primary(mesh):
        workdir = None  # the primary writes the files
    if workdir:
        save_embeddings(utt_embeddings, workdir)
        stages.mark("files")
    result, art = pipeline.backend_eval(
        utt_embeddings, train_dataset, trials, enroll_spk2utt, backend_cfg,
        adapt_vectors=adapt_embeddings, device=stages.device,
    )
    stages.mark("backend")
    if workdir:
        # backend artifacts in the Kaldi wire format — the reference's
        # exp-dir layout (mean.vec / transform.mat / plda,
        # `v2/run_sre10.sh:221-246`), so a run here drops into existing
        # Kaldi scoring infrastructure
        from ..utils import kaldi_models as _km

        bdir = os.path.join(workdir, "backend")
        os.makedirs(bdir, exist_ok=True)
        _km.write_kaldi_vector_file(os.path.join(bdir, "mean.vec"),
                                    art["mean"], double=True)
        _km.write_kaldi_matrix_file(os.path.join(bdir, "transform.mat"),
                                    art["lda"].projection, double=True)
        _km.write_plda(os.path.join(bdir, "plda"), art["plda"])
        stages.mark("files")
    conds = evaluate_conditions(art["scores"], trials, condition_fn)
    stages.mark("backend")
    if workdir:
        # DET curve artifact in probit coordinates (Plot_DET.m analog)
        from ..metrics.det import compute_det, export_det_curve, split_scores_by_trials

        pairs = [
            (t.model, t.test, t.target)
            for t in trials
            if (t.model, t.test) in art["scores"]
        ]
        tgt, non = split_scores_by_trials(art["scores"], pairs)
        if len(tgt) and len(non):
            curve = compute_det(tgt, non)
            export_det_curve(curve, f"{workdir}/det_pooled.txt")
            export_det_curve(curve, f"{workdir}/det_pooled.svg")
        stages.mark("files")
    report = format_report(conds)
    if log:
        for line in report.splitlines():
            print(line, flush=True)
    return RunResult(conds, art["scores"], report, dict(stages.seconds))


@fp32_math()
def run_v1(
    train_dataset: Dataset,
    train_audio: Mapping[str, np.ndarray],
    eval_audio: Mapping[str, np.ndarray],
    trials: Sequence[Trial],
    enroll_spk2utt: Mapping[str, Sequence[str]],
    workdir: str,
    ubm_cfg: UbmConfig = UbmConfig(),
    iv_cfg: IvectorConfig = IvectorConfig(),
    backend_cfg: Optional[BackendConfig] = None,
    adapt_audio: Optional[Mapping[str, np.ndarray]] = None,
    condition_fn=None,
    posterior_provider=None,
    export_kaldi: bool = False,
    device: DeviceLike = "cuda",
) -> RunResult:
    """GMM/i-vector (run_sre10.sh) or, with ``posterior_provider``, the
    DNN/i-vector variant (run_sre10_nnet2.sh): the provider maps a dict
    of 40-dim hires features to senone posterior dicts (e.g.
    `functools.partial(nnet2_recipe.nnet2_posteriors, model, state)`);
    the UBM and T-matrix statistics then come from the paired 20-dim sid
    stream with those posteriors (`init_full_ubm_from_dnn.sh:100-116`).

    The UBM + T-matrix and the i-vectors are cached stages (the
    reference persists final.ubm/final.ie/ivector.scp and resumes past
    them, `v1/run_sre10.sh:89-137`).  ``export_kaldi`` also writes the
    trained front end in the Kaldi wire format (<workdir>/kaldi/
    {final.ubm, final.ie}; ~600 MB at reference scale, hence opt-in).
    Stage seconds: features, posteriors (DNN variant), ubm_tmatrix,
    ivectors, backend, files."""
    from ..classical.gmm import FullGmm
    from ..classical.ivector import IvectorExtractor
    from .ivector_recipe import (
        extract_v1_ivectors,
        iter_features_ivector,
        prepare_features_ivector,
        train_v1_frontend,
    )
    from .nnet2_recipe import prepare_paired_features

    dev = resolve_device(device)
    stages = _Stages(dev)
    cache = ArtifactCache(workdir)
    log = MetricsLogger(f"{workdir}/metrics.jsonl")
    backend_cfg = backend_cfg or BackendConfig(lda_dim=200)  # v1 uses 200

    if posterior_provider is None:
        feats_train = cache.stage_store(
            "ivec_feats_train", [train_dataset.name, _audio_fingerprint(train_audio)],
            lambda: iter_features_ivector(train_audio, device=dev), log=print,
        )
        feats_eval = cache.stage_store(
            "ivec_feats_eval", [_audio_fingerprint(eval_audio)],
            lambda: iter_features_ivector(eval_audio, device=dev), log=print,
        )
        post_train = post_all = None
        stages.mark("features")
    else:
        def _paired(audio):
            sid, hires = prepare_paired_features(audio, device=dev)
            return {"sid": sid, "hires": hires}

        pt = cache.stage(
            "paired_feats_train", [train_dataset.name, _audio_fingerprint(train_audio)],
            lambda: _paired(train_audio), log=print,
        )
        pe = cache.stage(
            "paired_feats_eval", [_audio_fingerprint(eval_audio)],
            lambda: _paired(eval_audio), log=print,
        ) if eval_audio else {"sid": {}, "hires": {}}
        feats_train = {k: np.asarray(v, np.float32) for k, v in pt["sid"].items()}
        feats_eval = {k: np.asarray(v, np.float32) for k, v in pe["sid"].items()}
        hires = {
            **{k: np.asarray(v, np.float32) for k, v in pt["hires"].items()},
            **{k: np.asarray(v, np.float32) for k, v in pe["hires"].items()},
        }
        stages.mark("features")
        post_all = posterior_provider(hires)
        post_train = {u: post_all[u] for u in feats_train}
        stages.mark("posteriors")
    _fkey = [train_dataset.name, _audio_fingerprint(train_audio),
             ubm_cfg, iv_cfg, posterior_provider is not None]

    def _frontend_stage():
        u, e = train_v1_frontend(feats_train, ubm_cfg, iv_cfg, posteriors=post_train,
                                 device=dev)
        return {
            "ubm": {k: getattr(u, k).cpu().numpy() for k in ("weights", "means", "covars")},
            "ext": {k: getattr(e, k).cpu().numpy() for k in ("t", "whitener", "means")},
        }

    art = cache.stage("v1_frontend", _fkey, _frontend_stage, log=print)

    def _on_dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    ubm = FullGmm(*(_on_dev(art["ubm"][k]) for k in ("weights", "means", "covars")))
    ext = IvectorExtractor(*(_on_dev(art["ext"][k]) for k in ("t", "whitener", "means")))
    stages.mark("ubm_tmatrix")
    if export_kaldi:
        from ..utils import kaldi_models as _km

        kdir = os.path.join(workdir, "kaldi")
        os.makedirs(kdir, exist_ok=True)
        _km.write_full_ubm(os.path.join(kdir, "final.ubm"), ubm)
        _km.write_ivector_extractor(os.path.join(kdir, "final.ie"), ext)
        stages.mark("files")
    ivecs = cache.stage(
        "v1_ivectors", _fkey + [_audio_fingerprint(eval_audio)],
        lambda: extract_v1_ivectors(ubm, ext, {**feats_train, **feats_eval}, iv_cfg,
                                    ubm_cfg.full_gselect, posteriors=post_all),
        log=print,
    )
    ivecs = {u: np.asarray(v, np.float32) for u, v in ivecs.items()}
    stages.mark("ivectors")
    adapt_embs = None
    if adapt_audio is not None:
        if posterior_provider is None:
            fa = prepare_features_ivector(adapt_audio, device=dev)
            pa = None
            stages.mark("features")
        else:
            fa, ha = prepare_paired_features(adapt_audio, device=dev)
            stages.mark("features")
            pa = posterior_provider(ha)
            stages.mark("posteriors")
        a = extract_v1_ivectors(ubm, ext, fa, iv_cfg, ubm_cfg.full_gselect, posteriors=pa)
        adapt_embs = np.stack(list(a.values()))
        stages.mark("ivectors")
    return _finish(ivecs, train_dataset, trials, enroll_spk2utt, backend_cfg,
                   adapt_embs, condition_fn, log, workdir, stages)


@fp32_math()
def run_v2(
    train_dataset: Dataset,
    train_audio: Mapping[str, np.ndarray],
    eval_dataset: Dataset,
    eval_audio: Mapping[str, np.ndarray],
    trials: Sequence[Trial],
    enroll_spk2utt: Mapping[str, Sequence[str]],
    workdir: str,
    model_cfg: Optional[XVectorConfig] = None,
    train_cfg: TrainConfig = TrainConfig(),
    extract_cfg: ExtractConfig = ExtractConfig(),
    backend_cfg: BackendConfig = BackendConfig(),
    num_steps: int = 2000,
    adapt_dataset: Optional[Dataset] = None,
    adapt_audio: Optional[Mapping[str, np.ndarray]] = None,
    condition_fn=None,
    mesh=None,
    augments: Optional[AugmentOptions] = None,
    num_heldout_utts: Optional[int] = None,
    checkpoint_dir: Optional[str] = "auto",
    device: DeviceLike = "cuda",
) -> RunResult:
    """``num_heldout_utts`` (default auto — the reference ALWAYS holds
    out valid diagnostics; 0 disables) and ``checkpoint_dir`` (default
    ``<workdir>/ckpt``; None disables) turn on the reference's standing
    training machinery: periodic held-out objf logging
    (nnet3-compute-prob) and the final checkpoint-tail combination on
    the held-out objective (nnet3-combine,
    `frame_level_objf/common.py:763-826`)."""
    dev = pipeline.training_device(train_cfg, mesh, device)
    stages = _Stages(dev)
    cache = ArtifactCache(workdir, mesh)
    log = _metrics_logger(workdir, mesh)
    if checkpoint_dir == "auto":
        checkpoint_dir = f"{workdir}/ckpt"

    if augments is not None:
        # stage 2: reverb/noise/music/babble copies + subset + combine
        # (`run_sre10.sh:92-159`); augmented rows carry utt2uniq roots so
        # heldout splits keep clean/aug groups together
        train_dataset, train_audio = _apply_augmentation(
            train_dataset, train_audio, augments, dev
        )
        stages.mark("augment")
    # feature stages stream into mmap FeatStores (disk-backed, lazy
    # rows): driver RSS stays flat at any corpus size, the property the
    # reference gets from on-disk feats.scp (prepare_feats_for_egs.sh)
    feats_train = cache.stage_store(
        "feats_train", [train_dataset.name, _audio_fingerprint(train_audio)],
        lambda: pipeline.iter_features_nosil(train_audio, device=dev), log=print,
    )
    feats_eval = cache.stage_store(
        "feats_eval", [eval_dataset.name, _audio_fingerprint(eval_audio)],
        lambda: pipeline.iter_features_nosil(eval_audio, device=dev), log=print,
    )
    stages.mark("features")
    model, state, _ = pipeline.train_xvector_model(
        feats_train, train_dataset, model_cfg, train_cfg, num_steps, mesh=mesh,
        log=log, num_heldout_utts=num_heldout_utts, checkpoint_dir=checkpoint_dir,
        device=dev,
    )
    stages.mark("train")
    min_frames = (model_cfg or XVectorConfig()).min_frames
    embs = pipeline.extract_and_score(model, state, {**feats_train, **feats_eval},
                                      extract_cfg, min_frames, mesh=mesh, device=dev)
    stages.mark("extract")
    adapt_embs = None
    if adapt_dataset is not None and adapt_audio is not None:
        feats_adapt = pipeline.prepare_features_nosil(adapt_audio, device=dev)
        stages.mark("features")
        a = pipeline.extract_and_score(model, state, feats_adapt, extract_cfg,
                                       min_frames, mesh=mesh, device=dev)
        adapt_embs = np.stack(list(a.values()))
        stages.mark("extract")
    return _finish(embs, train_dataset, trials, enroll_spk2utt, backend_cfg,
                   adapt_embs, condition_fn, log, workdir, stages, mesh)


def _phonetic_common(train_audio, eval_audio, alignments, workdir,
                     transcripts=None, lexicon=None, align_cfg=None,
                     utt2spk=None, device: DeviceLike = "cuda", stages=None, mesh=None):
    """Shared v3/v4/v5 front half: nosil features + senone alignments.

    Alignment provider precedence (matching the reference's data flow,
    `egs/sre/v3/run_sre10.sh:60-84` consuming `egs/sre/s5` output):
      1. caller-supplied ``alignments`` (the exp/tri6a_4k_ali analog as
         an input artifact — already VAD-stripped to match nosil feats);
      2. ``transcripts`` + ``lexicon``: run the built-in s5 stage
         (recipes.s5.run_s5) on with-silence features, then VAD-strip
         labels and features with the same masks.
    Returns (cache, feats_train, feats_eval, alignments, num_senones).
    """
    from ..config import AlignConfig
    from .s5 import run_s5, select_voiced_ali

    stages = stages or _Stages(torch.device("cpu"))
    cache = ArtifactCache(workdir, mesh)
    feats_eval = cache.stage_store(
        "feats_eval", [_audio_fingerprint(eval_audio)],
        lambda: pipeline.iter_features_nosil(eval_audio, device=device), log=print,
    )
    if alignments is not None:
        feats_train = cache.stage_store(
            "feats_train", [_audio_fingerprint(train_audio)],
            lambda: pipeline.iter_features_nosil(train_audio, device=device), log=print,
        )
        stages.mark("features")
    elif transcripts is not None and lexicon is not None:
        stages.mark("features")
        align_cfg = align_cfg or AlignConfig()

        def _s5_stage():
            pf = pipeline.prepare_features_phonetic(train_audio, device=device)
            s5 = run_s5(pf.full, transcripts, lexicon, align_cfg, log=print,
                        utt2spk=utt2spk, device=device)
            ali = select_voiced_ali(s5.alignments, pf.voiced)
            return {"feats": pf.nosil, "ali": ali}

        art = cache.stage(
            "s5_feats_ali",
            [_audio_fingerprint(train_audio), align_cfg, lexicon,
             {u: list(transcripts[u]) for u in sorted(transcripts)}],
            _s5_stage, log=print,
        )
        feats_train = {k: np.asarray(v, np.float32) for k, v in art["feats"].items()}
        alignments = {k: np.asarray(v, np.int32) for k, v in art["ali"].items()}
        stages.mark("s5")
    else:
        raise ValueError(
            "v3/v4/v5 need senone alignments: pass `alignments` (the "
            "exp/tri6a_4k_ali analog, VAD-stripped) or `transcripts` + "
            "`lexicon` to run the built-in s5 aligner stage."
        )
    num_senones = 1 + max(int(np.max(a)) for a in alignments.values())
    return cache, feats_train, feats_eval, alignments, num_senones


def _phonetic_front(train_dataset, train_audio, eval_audio, alignments, workdir,
                    transcripts, lexicon, align_cfg, augments, dev, stages, mesh):
    if augments is not None:
        # augmented copies join the SPEAKER stream only: they carry no
        # transcripts/alignments, so the AM frame sampler skips them
        # while the chunk sampler trains on clean+augmented (the
        # reference's split: ASR egs from the unaugmented corpus,
        # xvec egs from the augmented one)
        train_dataset, train_audio = _apply_augmentation(
            train_dataset, train_audio, augments, dev
        )
        stages.mark("augment")
    _, feats_train, feats_eval, alignments, num_senones = _phonetic_common(
        train_audio, eval_audio, alignments, workdir, transcripts, lexicon,
        align_cfg, {u.utt_id: u.spk_id for u in train_dataset}, dev, stages, mesh,
    )
    return train_dataset, feats_train, feats_eval, alignments, num_senones


@fp32_math()
def run_v3(
    train_dataset: Dataset,
    train_audio: Mapping[str, np.ndarray],
    eval_audio: Mapping[str, np.ndarray],
    trials: Sequence[Trial],
    enroll_spk2utt: Mapping[str, Sequence[str]],
    workdir: str,
    alignments: Optional[Mapping[str, np.ndarray]] = None,
    model_cfg: Optional[MultitaskConfig] = None,
    train_cfg: TrainConfig = TrainConfig(),
    extract_cfg: ExtractConfig = ExtractConfig(),
    backend_cfg: BackendConfig = BackendConfig(),
    num_steps: int = 2000,
    condition_fn=None,
    mesh=None,
    transcripts=None,
    lexicon=None,
    align_cfg=None,
    augments: Optional[AugmentOptions] = None,
    num_heldout_utts: Optional[int] = None,
    checkpoint_dir: Optional[str] = "auto",
    device: DeviceLike = "cuda",
) -> RunResult:
    dev = pipeline.training_device(train_cfg, mesh, device)
    stages = _Stages(dev)
    if checkpoint_dir == "auto":
        checkpoint_dir = f"{workdir}/ckpt"
    train_dataset, feats_train, feats_eval, alignments, num_senones = _phonetic_front(
        train_dataset, train_audio, eval_audio, alignments, workdir, transcripts, lexicon,
        align_cfg, augments, dev, stages, mesh,
    )
    model_cfg = model_cfg or MultitaskConfig(
        num_speakers=len(train_dataset.speakers), num_senones=num_senones
    )
    if model_cfg.num_senones < num_senones:
        raise ValueError(
            f"model num_senones={model_cfg.num_senones} < alignment "
            f"senone count {num_senones}"
        )
    log = _metrics_logger(workdir, mesh)
    model, state = phonetic.train_multitask_model(
        feats_train, alignments, train_dataset, model_cfg, train_cfg, num_steps,
        mesh=mesh, log=log, checkpoint_dir=checkpoint_dir,
        num_heldout_utts=num_heldout_utts, device=dev,
    )
    stages.mark("train")
    l, r = model_cfg.xvec_context
    embs = pipeline.extract_and_score(
        model, state, {**feats_train, **feats_eval}, extract_cfg, l + r + 1,
        model_kwargs={"task": "xvec"}, mesh=mesh, device=dev,
    )
    stages.mark("extract")
    return _finish(embs, train_dataset, trials, enroll_spk2utt, backend_cfg,
                   None, condition_fn, log, workdir, stages, mesh)


@fp32_math()
def run_v4(
    train_dataset: Dataset,
    train_audio: Mapping[str, np.ndarray],
    eval_audio: Mapping[str, np.ndarray],
    trials: Sequence[Trial],
    enroll_spk2utt: Mapping[str, Sequence[str]],
    workdir: str,
    alignments: Optional[Mapping[str, np.ndarray]] = None,
    am_cfg: Optional[AmConfig] = None,
    model_cfg: Optional[AdaptedConfig] = None,
    train_cfg: TrainConfig = TrainConfig(),
    extract_cfg: ExtractConfig = ExtractConfig(),
    backend_cfg: BackendConfig = BackendConfig(),
    am_steps: int = 1000,
    num_steps: int = 2000,
    am_lr_factor: float = 0.2,
    condition_fn=None,
    mesh=None,
    transcripts=None,
    lexicon=None,
    align_cfg=None,
    augments: Optional[AugmentOptions] = None,
    num_heldout_utts: Optional[int] = None,
    checkpoint_dir: Optional[str] = "auto",
    device: DeviceLike = "cuda",
) -> RunResult:
    dev = pipeline.training_device(train_cfg, mesh, device)
    stages = _Stages(dev)
    if checkpoint_dir == "auto":
        checkpoint_dir = f"{workdir}/ckpt"
    train_dataset, feats_train, feats_eval, alignments, num_senones = _phonetic_front(
        train_dataset, train_audio, eval_audio, alignments, workdir, transcripts, lexicon,
        align_cfg, augments, dev, stages, mesh,
    )
    am_cfg = am_cfg or AmConfig(num_senones=num_senones)
    if am_cfg.num_senones < num_senones:
        raise ValueError(
            f"AM num_senones={am_cfg.num_senones} < alignment senone "
            f"count {num_senones}"
        )
    model_cfg = model_cfg or AdaptedConfig(
        num_speakers=len(train_dataset.speakers), am=am_cfg
    )
    log = _metrics_logger(workdir, mesh)
    # AM pretraining runs without valid diagnostics, matching the
    # reference (train_am.sh removes valid_diagnostic.scp)
    am_model, am_state = phonetic.train_am_model(
        feats_train, alignments, am_cfg, train_cfg, am_steps, mesh=mesh, log=log,
        device=dev,
    )
    stages.mark("am")
    model, state = phonetic.train_adapted_model(
        feats_train, train_dataset, am_model, am_state, model_cfg, train_cfg,
        num_steps, am_lr_factor, mesh=mesh, log=log,
        checkpoint_dir=checkpoint_dir, num_heldout_utts=num_heldout_utts, device=dev,
    )
    stages.mark("train")
    l, r = model_cfg.context
    embs = pipeline.extract_and_score(
        model, state, {**feats_train, **feats_eval}, extract_cfg, l + r + 1,
        mesh=mesh, device=dev,
    )
    stages.mark("extract")
    return _finish(embs, train_dataset, trials, enroll_spk2utt, backend_cfg,
                   None, condition_fn, log, workdir, stages, mesh)


@fp32_math()
def run_v5(
    train_dataset: Dataset,
    train_audio: Mapping[str, np.ndarray],
    eval_audio: Mapping[str, np.ndarray],
    trials: Sequence[Trial],
    enroll_spk2utt: Mapping[str, Sequence[str]],
    workdir: str,
    alignments: Optional[Mapping[str, np.ndarray]] = None,
    am_cfg: Optional[AmConfig] = None,
    model_cfg: Optional[CombinedConfig] = None,
    train_cfg: TrainConfig = TrainConfig(),
    extract_cfg: ExtractConfig = ExtractConfig(),
    backend_cfg: BackendConfig = BackendConfig(),
    am_steps: int = 1000,
    num_steps: int = 2000,
    am_lr_factor: float = 0.1,
    condition_fn=None,
    mesh=None,
    transcripts=None,
    lexicon=None,
    align_cfg=None,
    augments: Optional[AugmentOptions] = None,
    num_heldout_utts: Optional[int] = None,
    checkpoint_dir: Optional[str] = "auto",
    device: DeviceLike = "cuda",
) -> RunResult:
    dev = pipeline.training_device(train_cfg, mesh, device)
    stages = _Stages(dev)
    if checkpoint_dir == "auto":
        checkpoint_dir = f"{workdir}/ckpt"
    train_dataset, feats_train, feats_eval, alignments, num_senones = _phonetic_front(
        train_dataset, train_audio, eval_audio, alignments, workdir, transcripts, lexicon,
        align_cfg, augments, dev, stages, mesh,
    )
    am_cfg = am_cfg or AmConfig(num_senones=num_senones)
    model_cfg = model_cfg or CombinedConfig(
        num_speakers=len(train_dataset.speakers),
        num_senones=am_cfg.num_senones,
        am=am_cfg,
    )
    if min(am_cfg.num_senones, model_cfg.num_senones) < num_senones:
        raise ValueError(
            f"num_senones ({am_cfg.num_senones}/{model_cfg.num_senones}) < "
            f"alignment senone count {num_senones}"
        )
    log = _metrics_logger(workdir, mesh)
    # AM pretraining runs without valid diagnostics, matching the
    # reference (train_am.sh removes valid_diagnostic.scp)
    am_model, am_state = phonetic.train_am_model(
        feats_train, alignments, am_cfg, train_cfg, am_steps, mesh=mesh, log=log,
        device=dev,
    )
    stages.mark("am")
    model, state = phonetic.train_combined_model(
        feats_train, alignments, train_dataset, am_model, am_state, model_cfg,
        train_cfg, num_steps, am_lr_factor, mesh=mesh, log=log,
        checkpoint_dir=checkpoint_dir, num_heldout_utts=num_heldout_utts, device=dev,
    )
    stages.mark("train")
    # embedding-path receptive field from the model's Stream accounting
    # (max of xvec branch and pretrained-AM feed; see CombinedConfig)
    xl, xr = model_cfg.xvec_context
    embs = pipeline.extract_and_score(
        model, state, {**feats_train, **feats_eval}, extract_cfg, xl + xr + 1,
        model_kwargs={"task": "xvec"}, mesh=mesh, device=dev,
    )
    stages.mark("extract")
    return _finish(embs, train_dataset, trials, enroll_spk2utt, backend_cfg,
                   None, condition_fn, log, workdir, stages, mesh)
