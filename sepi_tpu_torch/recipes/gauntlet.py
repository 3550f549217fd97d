"""The non-degenerate parity gauntlet — the framework's acceptance run.

The reference's entire acceptance protocol is EER/minDCF on trials hard
enough to RANK systems (`egs/sre/v2/run_sre10.sh:239-334`),
and its headline claim is an ordering: phonetic-information variants beat
the x-vector baseline (README.md:9-11, the Interspeech 2018 paper).  The
LDC corpora are license-gated, so this module carries a calibrated
synthetic substitute with the three properties that make the real
protocol non-degenerate:

  1. DISJOINT speaker populations: train / eval / adapt corpora share
     one phone inventory (``phone_seed``) but no speakers — the
     evaluation measures generalization, not classification of seen
     speakers (eval-on-train saturates every system at 0.00% EER and
     cannot detect a broken backend or a mis-tapped embedding).
  2. Hardness calibrated to a measurable operating point: weak speaker
     spectral signatures, per-utterance pitch jitter, additive noise,
     per-utterance channel filters, and SHORT utterances (2-3 words) so
     phonetic content variance dominates — the condition (the paper's
     10s-10s analog) under which phonetic awareness actually pays.
  3. A domain shift between train and eval channel FAMILIES
     (``channel_seed``), giving PLDA adaptation (the SRE16 scenario,
     `v2/run_sre16.sh:96-103`) something real to correct.

The reference's calibration (CI scale, JAX on an 8-device CPU mesh,
seeds pinned): v2 16.2% EER / v3 13.9% / v4 12.1% / v5 8.3% — the
paper's ordering with real margins; pinned by tests/test_gauntlet.py and
reproduced on a TPU in docs/BENCHMARKS.md.

A port of `sepi_tpu/recipes/gauntlet.py` (without the JAX compile
cache): every runner takes ``device=`` (default ``"cuda"``, raising
without a GPU unless the caller names the CPU) and passes it to the
port's drivers; the corpora, trials, bootstrap and table are the
reference's, number for number.

Budget parity note: v2/v4 train on speaker chunks only, so ``steps`` is
their speaker-stream budget.  v3/v5 interleave AM frame batches ~1:1
with speaker batches (auto-balanced streams), so they get ``2*steps``
total steps = the SAME speaker-stream exposure plus the AM stream on
top — exactly the reference's accounting, where the multitask trainer
consumes both egs streams over the same 3 epochs
(`train_cvector_dnn.py:254-262`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import (
    AlignConfig,
    BackendConfig,
    ChunkConfig,
    ExtractConfig,
    IvectorConfig,
    TrainConfig,
    UbmConfig,
)
from ..data.manifest import Trial
from ..data.synthetic import (
    PhoneticCorpus,
    make_phonetic_corpus,
    make_phonetic_corpus_v2,
)
from ..device import DeviceLike, resolve_device
from ..models import (
    AdaptedConfig,
    AmConfig,
    CombinedConfig,
    MultitaskConfig,
    XVectorConfig,
)
from ..models.tdnn import TdnnSpec


@dataclasses.dataclass(frozen=True)
class GauntletScale:
    """One calibrated difficulty/size operating point."""

    # corpus.  Trial-count statistics drive the pins' robustness: EER's
    # standard error is ~sqrt(p(1-p)/num_targets), so 144 targets (r2's
    # 24 eval spk × 6 test utts) gave ±3-point swings under ANY feature
    # perturbation (e.g. a different dither stream) and knife-edge
    # orderings; 48 spk × 12 test utts = 576 targets brings it to ~1.5
    # points, and the margins below are calibrated against that.
    num_train_speakers: int = 60
    num_eval_speakers: int = 48
    num_adapt_speakers: int = 12
    utts_per_speaker: int = 9
    eval_utts_per_speaker: int = 15
    words_per_utt: Tuple[int, int] = (2, 3)
    speaker_strength: float = 0.55
    f0_jitter: float = 0.10
    noise_snr_db: Optional[Tuple[float, float]] = (8.0, 20.0)
    channel_strength: float = 0.15
    train_channel_seed: int = 500
    eval_channel_seed: int = 600  # different family = domain shift
    # channel strength for the eval/adapt family (None = channel_strength);
    # raised in the adaptation ablation to make the domain shift strong
    # enough that covariance/mean adaptation has signal to correct
    eval_channel_strength: Optional[float] = None
    # eval/adapt-domain SNR range (None = noise_snr_db).  A NOISE-LEVEL
    # shift is the domain mismatch that actually survives sliding CMVN
    # (a fixed linear channel is an additive log-spectral offset that
    # CMVN mostly removes), so this is what gives PLDA adaptation its
    # signal — matching the SRE16 situation the reference adapts for
    eval_noise_snr_db: Optional[Tuple[float, float]] = None
    phone_seed: int = 11
    seed: int = 100
    enroll_utts: int = 3
    # Corpus generator: 1 = the original stationary-signature generator
    # (kept for the pinned CI calibration), 2 = the phonetically
    # realistic generator (data.synthetic.make_phonetic_corpus_v2) whose
    # speaker identity is non-stationary — VTL warp + per-phone
    # articulation offsets + prosody, with a short/long utterance mix.
    # The v2-only knobs below are ignored at corpus_version=1
    # (and speaker_strength maps to tilt_strength at version 2).
    corpus_version: int = 1
    long_utt_frac: float = 0.25
    phone_offset_std: float = 0.035
    vtl_range: Tuple[float, float] = (0.88, 1.12)
    # budgets (steps = speaker-stream budget; see module docstring).
    # am_steps == steps: the reference pretrains its AM to convergence on
    # the full ASR corpus before grafting (train_am.sh, 3 epochs); an
    # undertrained bottleneck makes v4's advantage vanish into noise
    # (calibration: v4 EER 16.2% at am_steps=steps/2 vs 12.1% at
    # am_steps=steps, with v2 at 16.2%).
    steps: int = 800
    am_steps: int = 800
    # model width
    frame_dim: int = 48
    pool_dim: int = 96
    embed_dim: int = 48
    am_dim: int = 48
    am_bottleneck: int = 24
    batch_size: int = 32
    am_batch_size: int = 128
    # v1 GMM/i-vector size (reference: 2048 Gaussians / 600-dim T,
    # `v1/run_sre10.sh:89-110`; the CI default is a proportionate
    # miniature, and the HW presets scale it up so the v1-vs-neural
    # comparison is not handicapped by a toy supervector model)
    ubm_gauss: int = 64
    ivector_dim: int = 32
    # aligner
    align: AlignConfig = AlignConfig(
        num_leaves=48, mono_iters=4, refine_iters=2, min_count=30.0
    )

    @property
    def mt_steps(self) -> int:
        return 2 * self.steps

    def frame_specs(self) -> Tuple[TdnnSpec, ...]:
        d = self.frame_dim
        return (
            TdnnSpec(d, (-2, -1, 0, 1, 2)),
            TdnnSpec(d, (-2, 0, 2)),
            TdnnSpec(d, (-3, 0, 3)),
            TdnnSpec(d, (0,)),
            TdnnSpec(self.pool_dim, (0,)),
        )

    def am_specs(self) -> Tuple[TdnnSpec, ...]:
        d = self.am_dim
        return (
            TdnnSpec(d, (-2, -1, 0, 1, 2)),
            TdnnSpec(d, (-1, 0, 1)),
            TdnnSpec(d, (-1, 0, 1)),
            TdnnSpec(d, (-3, 0, 3)),
            TdnnSpec(self.am_bottleneck, (-6, -3, 0)),
        )

    def train_cfg(self) -> TrainConfig:
        return TrainConfig(
            batch_size=self.batch_size,
            am_batch_size=self.am_batch_size,
            chunks=ChunkConfig(min_chunk_len=50, max_chunk_len=100, num_buckets=2),
        )

    def extract_cfg(self) -> ExtractConfig:
        return ExtractConfig(chunk_size=300, batch_size=16)


# CI scale: the round-6 calibration point (module docstring numbers).
CI_SCALE = GauntletScale()

# Corpus-v2 CI scale (phonetically realistic generator): speaker
# identity is non-stationary (VTL warp + per-phone offsets), the
# stationary tilt is nearly off, and utterances mix short and long.
# Calibrated so the neural ordering is measurable on the hermetic CPU
# mesh; the hardware analog is HW_SCALE_V2.
CI_SCALE_V2 = dataclasses.replace(
    CI_SCALE,
    corpus_version=2,
    words_per_utt=(3, 7),
    speaker_strength=0.06,  # -> tilt_strength: no stationary giveaway
    f0_jitter=0.12,
    noise_snr_db=(8.0, 20.0),
    channel_strength=0.15,
)

# Adaptation-ablation scale: PLDA adaptation needs (a) a domain shift
# that survives sliding CMVN — a NOISE-LEVEL shift plus a systematic
# channel family, not just a linear filter — and (b) enough PLDA
# training speakers (120 here) that the between-class covariance is
# well estimated.  Calibration (r4, dithered production features):
# plain 25.7% EER / 0.971 minDCF08; in-domain mean re-centering alone
# 23.4% EER; full mean+0.75/0.25 covariance interpolation 25.9% EER /
# 0.947 minDCF08 — see run_adaptation_ablation for why the pins are
# mean->EER and full->minDCF08 at this adapt-set size.
ADAPT_SCALE = dataclasses.replace(
    CI_SCALE,
    num_train_speakers=120,
    num_adapt_speakers=24,
    eval_channel_strength=0.3,
    eval_noise_snr_db=(2.0, 8.0),
)

# Hardware scale: full-size v2 graph (512/1500/512 — run_xvector_new.sh:
# 90-115), reference AM widths scaled to the synthetic senone count,
# larger populations and budgets.  Meant for the real chip via bench/CLI.
#
# Hardness is recalibrated relative to CI_SCALE because full-size models
# saturate the CI corpus: at CI hardness the r4 hardware run measured
# v1 1.24 / v2 3.40 / v3 3.33 / v4 3.65 / v5 4.25 %EER — EERs so low
# that the variant gaps sink under the ±0.8-point standard error and
# the ordering is noise.  With weaker speaker signatures, more pitch
# jitter and a lower SNR floor, full-size v2 lands at 11.2% (se ~1.2 at
# 720 targets) and the phonetic ordering re-emerges (docs/BENCHMARKS.md
# "Accuracy gauntlet").
HW_SCALE = GauntletScale(
    num_train_speakers=150,
    num_eval_speakers=60,
    num_adapt_speakers=16,
    utts_per_speaker=10,
    speaker_strength=0.42,
    f0_jitter=0.14,
    noise_snr_db=(4.0, 14.0),
    channel_strength=0.2,
    steps=2400,
    am_steps=2400,
    frame_dim=512,
    pool_dim=1500,
    embed_dim=512,
    am_dim=256,
    am_bottleneck=128,
    batch_size=64,
    am_batch_size=256,
    ubm_gauss=256,
    ivector_dim=150,
)

# Hardware-scale corpus v2: the phonetically realistic generator under
# the full-size graphs — the acceptance operating point for the
# neural-beats-supervector demonstration (the field's basic SRE10
# result the stationary v1 corpus could not reproduce: i-vectors read
# the stationary tilt directly and demolished every neural system at
# HW_SCALE, docs/BENCHMARKS.md "Other readings").  Identity here is
# non-stationary (VTL warp + per-phone articulation offsets) so the
# supervector's per-Gaussian mean shifts and the TDNN's phone-
# conditional filters see the SAME evidence; utterances mix 2-3-word
# snippets with ~10 s reads.  Run with --eval-speakers 300 for any
# number that goes in a headline table (se halves vs the 60-speaker
# default).
HW_SCALE_V2 = dataclasses.replace(
    HW_SCALE,
    corpus_version=2,
    words_per_utt=(3, 7),
    speaker_strength=0.06,  # -> tilt_strength: no stationary giveaway
    f0_jitter=0.12,
    noise_snr_db=(8.0, 20.0),
    channel_strength=0.15,
    # Supervised embedding transfer is SPEAKER-hungry: with identity
    # non-stationary, v2's eval EER scales 30.8% -> 26.5% -> 22.0%
    # (CI dims) across 60 -> 180 -> 600 train speakers while the
    # unsupervised i-vector sits at ~14% regardless; at 600 speakers and
    # full dims the two tie (12.5% v1 vs 13.6% v2) and v2 leads
    # minDCF08.  1500 speakers is the operating point where the neural
    # systems win outright — the corpus-v1 presets' 150 speakers were
    # tuned for a corpus whose stationary signatures need no transfer.
    num_train_speakers=1500,
    utts_per_speaker=9,
    num_eval_speakers=300,  # headline-table power: se ~halves vs 60
    steps=8000,
    am_steps=8000,
)


@dataclasses.dataclass
class GauntletData:
    train: PhoneticCorpus
    eval: PhoneticCorpus
    adapt: PhoneticCorpus
    trials: List[Trial]
    enroll_spk2utt: Dict[str, List[str]]


def make_gauntlet_data(scale: GauntletScale = CI_SCALE) -> GauntletData:
    """Three disjoint-speaker corpora in one 'language': train (its own
    channel family), eval and adapt (a shifted family).  Trials test
    only non-enrolled eval utterances."""
    common = dict(
        utts_per_speaker=scale.utts_per_speaker,
        words_per_utt=scale.words_per_utt,
        phone_seed=scale.phone_seed,
        f0_jitter=scale.f0_jitter,
        noise_snr_db=scale.noise_snr_db,
        channel_strength=scale.channel_strength,
    )
    if scale.corpus_version == 2:
        maker = make_phonetic_corpus_v2
        common.update(
            tilt_strength=scale.speaker_strength,
            long_utt_frac=scale.long_utt_frac,
            phone_offset_std=scale.phone_offset_std,
            vtl_range=scale.vtl_range,
        )
    else:
        maker = make_phonetic_corpus
        common["speaker_strength"] = scale.speaker_strength
    shifted = dict(common)
    if scale.eval_channel_strength is not None:
        shifted["channel_strength"] = scale.eval_channel_strength
    if scale.eval_noise_snr_db is not None:
        shifted["noise_snr_db"] = scale.eval_noise_snr_db
    train = maker(
        num_speakers=scale.num_train_speakers, seed=scale.seed,
        spk_prefix="trn", channel_seed=scale.train_channel_seed,
        name="gauntlet_train", **common,
    )
    shifted_eval = dict(shifted)
    shifted_eval["utts_per_speaker"] = scale.eval_utts_per_speaker
    evalc = maker(
        num_speakers=scale.num_eval_speakers, seed=scale.seed + 1,
        spk_prefix="evl", channel_seed=scale.eval_channel_seed,
        name="gauntlet_eval", **shifted_eval,
    )
    adapt = maker(
        num_speakers=scale.num_adapt_speakers, seed=scale.seed + 2,
        spk_prefix="adp", channel_seed=scale.eval_channel_seed,
        name="gauntlet_adapt", **shifted,
    )
    enroll = {
        s: list(us[: scale.enroll_utts])
        for s, us in evalc.dataset.spk2utt.items()
    }
    enrolled = {u for us in enroll.values() for u in us}
    trials = [t for t in evalc.trials if t.test not in enrolled]
    return GauntletData(train, evalc, adapt, trials, enroll)


def compute_alignments(data: GauntletData, scale: GauntletScale,
                       workdir: str, log=print,
                       device: DeviceLike = "cuda") -> Dict[str, np.ndarray]:
    """One shared s5 pass for v3/v4/v5 (the reference computes
    exp/tri6a_4k_ali once and feeds every phonetic variant from it)."""
    from ..utils.artifacts import ArtifactCache
    from .pipeline import prepare_features_phonetic
    from .s5 import run_s5, select_voiced_ali

    resolve_device(device)
    cache = ArtifactCache(workdir)

    def _stage():
        pf = prepare_features_phonetic(data.train.audio, device=device)
        s5 = run_s5(
            pf.full, data.train.transcripts, data.train.lexicon, scale.align,
            utt2spk={u.utt_id: u.spk_id for u in data.train.dataset}, log=log,
            device=device,
        )
        return select_voiced_ali(s5.alignments, pf.voiced)

    ali = cache.stage("gauntlet_ali", [dataclasses.asdict(scale)], _stage,
                      log=log)
    return {k: np.asarray(v, np.int32) for k, v in ali.items()}


def run_gauntlet(
    workdir: str,
    scale: GauntletScale = CI_SCALE,
    variants: Sequence[str] = ("v1", "v2", "v3", "v4", "v5"),
    mesh=None,
    log=print,
    train_seed: Optional[int] = None,
    device: DeviceLike = "cuda",
) -> Dict[str, "object"]:
    """Run the requested variants at matched budgets on the calibrated
    disjoint-speaker corpus; returns {variant: RunResult}.

    ``train_seed`` re-seeds model init + the samplers (TrainConfig.seed)
    and isolates each variant's workdir per seed — the knob for
    quantifying TRAINING variance, the component the speaker-level
    bootstrap deliberately excludes (it resamples eval speakers around
    fixed trained systems).  Run several seeds and read the spread."""
    from .drivers import run_v1, run_v2, run_v3, run_v4, run_v5

    resolve_device(device)
    data = make_gauntlet_data(scale)
    results: Dict[str, object] = {}
    need_ali = any(v in variants for v in ("v3", "v4", "v5"))
    ali = (compute_alignments(data, scale, workdir, log=log, device=device)
           if need_ali else None)
    if ali is not None:
        num_senones = 1 + max(int(np.max(a)) for a in ali.values())
        am_cfg = AmConfig(feat_dim=23, num_senones=num_senones,
                          specs=scale.am_specs())
    tc, ec = scale.train_cfg(), scale.extract_cfg()
    sfx = ""
    if train_seed is not None:
        tc = dataclasses.replace(tc, seed=train_seed)
        sfx = f"_seed{train_seed}"
    n_spk = scale.num_train_speakers
    common = (data.train.dataset, data.train.audio)

    def _tick(name, fn):
        t0 = time.time()
        results[name] = fn()
        r = results[name].pooled
        log(f"[gauntlet:{name}] EER {r.eer * 100:.2f}%  "
            f"minDCF08 {r.min_dcf08:.3f}  ({time.time() - t0:.0f}s)")

    if "v1" in variants:
        g = scale.ubm_gauss
        _tick("v1", lambda: run_v1(
            *common, data.eval.audio, data.trials, data.enroll_spk2utt,
            workdir=f"{workdir}/v1{sfx}",
            ubm_cfg=UbmConfig(num_gauss=g, num_gselect=min(16, g // 4),
                              full_gselect=min(16, g // 4),
                              num_iters_init=4, num_iters_full=2, subsample=4),
            iv_cfg=IvectorConfig(ivector_dim=scale.ivector_dim, num_iters=3),
            device=device,
        ))
    if "v2" in variants:
        _tick("v2", lambda: run_v2(
            *common, data.eval.dataset, data.eval.audio, data.trials,
            data.enroll_spk2utt, workdir=f"{workdir}/v2{sfx}",
            model_cfg=XVectorConfig(feat_dim=23, num_speakers=n_spk,
                                    frame_specs=scale.frame_specs(),
                                    embed_dim=scale.embed_dim),
            train_cfg=tc, extract_cfg=ec, num_steps=scale.steps, mesh=mesh,
            device=device,
        ))
    if "v3" in variants:
        _tick("v3", lambda: run_v3(
            *common, data.eval.audio, data.trials, data.enroll_spk2utt,
            workdir=f"{workdir}/v3{sfx}", alignments=ali,
            model_cfg=MultitaskConfig(num_speakers=n_spk,
                                      num_senones=num_senones,
                                      embed_dim=scale.embed_dim,
                                      hidden_dim=scale.frame_dim,
                                      pool_dim=scale.pool_dim),
            train_cfg=tc, extract_cfg=ec, num_steps=scale.mt_steps, mesh=mesh,
            device=device,
        ))
    if "v4" in variants:
        _tick("v4", lambda: run_v4(
            *common, data.eval.audio, data.trials, data.enroll_spk2utt,
            workdir=f"{workdir}/v4{sfx}", alignments=ali, am_cfg=am_cfg,
            model_cfg=AdaptedConfig(num_speakers=n_spk, am=am_cfg,
                                    embed_dim=scale.embed_dim,
                                    hidden_dim=scale.frame_dim,
                                    pool_dim=scale.pool_dim),
            train_cfg=tc, extract_cfg=ec, am_steps=scale.am_steps,
            num_steps=scale.steps, mesh=mesh,
            device=device,
        ))
    if "v5" in variants:
        _tick("v5", lambda: run_v5(
            *common, data.eval.audio, data.trials, data.enroll_spk2utt,
            workdir=f"{workdir}/v5{sfx}", alignments=ali, am_cfg=am_cfg,
            model_cfg=CombinedConfig(num_speakers=n_spk,
                                     num_senones=num_senones, am=am_cfg,
                                     embed_dim=scale.embed_dim,
                                     hidden_dim=scale.frame_dim,
                                     pool_dim=scale.pool_dim),
            train_cfg=tc, extract_cfg=ec, am_steps=scale.am_steps,
            num_steps=scale.mt_steps, mesh=mesh,
            device=device,
        ))
    return results


def run_adaptation_ablation(
    workdir: str, scale: GauntletScale = ADAPT_SCALE, mesh=None, log=print,
    device: DeviceLike = "cuda",
) -> Dict[str, "object"]:
    """PLDA domain adaptation on the noise+channel-shifted eval
    (`v2/run_sre16.sh:96-110`): score the SAME v2 system plain, with
    in-domain mean re-centering only, and with the full reference
    adaptation (mean + 0.75/0.25 covariance interpolation).  Runs share
    one workdir, so checkpoints resume and only extraction/backend
    re-run.  Returns {"plain", "mean", "full"} RunResults.

    Why the decomposition (measured r4, stable across corpus-hardness
    perturbations): the in-domain MEAN correction is the dominant,
    robust EER effect on this corpus (25.7% -> 23.4% at ADAPT_SCALE),
    while the covariance interpolation consistently improves minDCF08
    (0.971 -> 0.947) but is knife-edge at the EER operating point —
    the adapt set is only ~216 vectors, so the excess-covariance
    eigenstructure carries between-speaker sampling noise from 24
    speakers, and the 0.75-within redistribution discounts real speaker
    directions.  SRE16's major set is an order of magnitude larger; on
    this synthetic scale the acceptance pins are mean->EER and
    full->minDCF08, each with real margins."""
    from .drivers import run_v2

    resolve_device(device)
    data = make_gauntlet_data(scale)
    kw = dict(
        model_cfg=XVectorConfig(feat_dim=23,
                                num_speakers=scale.num_train_speakers,
                                frame_specs=scale.frame_specs(),
                                embed_dim=scale.embed_dim),
        train_cfg=scale.train_cfg(), extract_cfg=scale.extract_cfg(),
        num_steps=scale.steps, mesh=mesh, device=device,
    )
    args = (data.train.dataset, data.train.audio, data.eval.dataset,
            data.eval.audio, data.trials, data.enroll_spk2utt)
    adapt = dict(adapt_dataset=data.adapt.dataset,
                 adapt_audio=data.adapt.audio)
    mean_only = BackendConfig(adapt_within_covar_scale=0.0,
                              adapt_between_covar_scale=0.0)
    out = {
        "plain": run_v2(*args, workdir=f"{workdir}/v2_adapt", **kw),
        "mean": run_v2(*args, workdir=f"{workdir}/v2_adapt",
                       backend_cfg=mean_only, **adapt, **kw),
        "full": run_v2(*args, workdir=f"{workdir}/v2_adapt", **adapt, **kw),
    }
    for name, r in out.items():
        log(f"[gauntlet:adapt] {name:<5} EER {r.pooled.eer * 100:.2f}%  "
            f"minDCF08 {r.pooled.min_dcf08:.3f}")
    return out


def run_adaptation_scale_ablation(
    workdir: str,
    scale: GauntletScale = ADAPT_SCALE,
    adapt_speakers: Sequence[int] = (24, 240, 1100),
    mesh=None,
    log=print,
    device: DeviceLike = "cuda",
) -> Dict[int, Dict[str, "object"]]:
    """PLDA-adaptation sweep over ADAPT-SET SIZE (r4 VERDICT #3).

    The reference's SRE16 recipe interpolates the PLDA covariances
    toward the unlabeled in-domain set (`v2/run_sre16.sh:96-103`,
    ivector-adapt-plda 0.75/0.25); r4 measured that step HURTING EER
    with ~216 adapt vectors and could not distinguish "small-sample
    artifact" from "implementation divergence".  The divergence has
    since been found and fixed (adapt_plda now mirrors
    PldaUnsupervisedAdaptor::UpdatePlda exactly — backend/plda.py), so
    this sweep answers the remaining question: at what adapt-set size
    does the covariance interpolation beat mean-only re-centering?
    SRE16's major set is ~2k utterances; the sweep brackets it.

    The v2 system is trained ONCE (train/eval corpora are identical
    across cells — only the adapt corpus grows), each cell re-runs
    extraction + backend on its adapt set.  Returns
    ``{num_adapt_vectors: {"plain"|"mean"|"full": RunResult}}`` where
    "plain" (no adaptation, shared across cells) appears under every
    key for table convenience.
    """
    from .drivers import run_v2

    resolve_device(device)
    kw = dict(
        model_cfg=XVectorConfig(feat_dim=23,
                                num_speakers=scale.num_train_speakers,
                                frame_specs=scale.frame_specs(),
                                embed_dim=scale.embed_dim),
        train_cfg=scale.train_cfg(), extract_cfg=scale.extract_cfg(),
        num_steps=scale.steps, mesh=mesh, device=device,
    )
    mean_only = BackendConfig(adapt_within_covar_scale=0.0,
                              adapt_between_covar_scale=0.0)
    out: Dict[int, Dict[str, object]] = {}
    plain = None
    for n_spk in adapt_speakers:
        s = dataclasses.replace(scale, num_adapt_speakers=n_spk)
        data = make_gauntlet_data(s)
        n_vec = len(data.adapt.dataset)
        args = (data.train.dataset, data.train.audio, data.eval.dataset,
                data.eval.audio, data.trials, data.enroll_spk2utt)
        adapt = dict(adapt_dataset=data.adapt.dataset,
                     adapt_audio=data.adapt.audio)
        if plain is None:
            plain = run_v2(*args, workdir=f"{workdir}/v2_adapt", **kw)
        cell = {
            "plain": plain,
            "mean": run_v2(*args, workdir=f"{workdir}/v2_adapt",
                           backend_cfg=mean_only, **adapt, **kw),
            "full": run_v2(*args, workdir=f"{workdir}/v2_adapt",
                           **adapt, **kw),
        }
        out[n_vec] = cell
        for name in ("plain", "mean", "full"):
            r = cell[name].pooled
            log(f"[gauntlet:adapt-scale] n={n_vec:<6} {name:<5} "
                f"EER {r.eer * 100:.2f}%  minDCF08 {r.min_dcf08:.3f}")
    return out


def run_v4_effect_study(
    workdir: str,
    scale: GauntletScale = CI_SCALE_V2,
    lr_factors: Sequence[float] = (0.1, 0.2, 0.5),
    am_budget_fracs: Sequence[float] = (0.5, 1.0),
    n_boot: int = 2000,
    mesh=None,
    log=print,
    device: DeviceLike = "cuda",
) -> Dict[Tuple[float, float], BootstrapComparison]:
    """v4 phonetic-adaptation effect-size study (r4 VERDICT #4).

    The paper's claim covers adaptation (`v4/run_sre10.sh`,
    README.md:9-11) but r4's single-cell measurement was a statistical
    tie vs v2.  This sweeps the two mechanism knobs — the AM-branch
    learning-rate factor (the reference uses 0.2 on SRE10 and 0.1
    inside v5, `train_xvector_with_am.sh:63-65`) and the AM pretraining
    budget (an undertrained bottleneck carries no phonetic information
    to adapt TO) — and paired-bootstraps every cell against one shared
    v2 baseline on identical speaker replicates.  Returns
    ``{(am_lr_factor, am_budget_frac): BootstrapComparison}`` (positive
    delta = v4 cell beats v2).
    """
    from .drivers import run_v2, run_v4

    resolve_device(device)
    data = make_gauntlet_data(scale)
    ali = compute_alignments(data, scale, workdir, log=log, device=device)
    num_senones = 1 + max(int(np.max(a)) for a in ali.values())
    am_cfg = AmConfig(feat_dim=23, num_senones=num_senones,
                      specs=scale.am_specs())
    tc, ec = scale.train_cfg(), scale.extract_cfg()
    n_spk = scale.num_train_speakers
    common = (data.train.dataset, data.train.audio)
    utt2spk = {u.utt_id: u.spk_id for u in data.eval.dataset}

    v2 = run_v2(
        *common, data.eval.dataset, data.eval.audio, data.trials,
        data.enroll_spk2utt, workdir=f"{workdir}/v2",
        model_cfg=XVectorConfig(feat_dim=23, num_speakers=n_spk,
                                frame_specs=scale.frame_specs(),
                                embed_dim=scale.embed_dim),
        train_cfg=tc, extract_cfg=ec, num_steps=scale.steps, mesh=mesh, device=device,
    )
    log(f"[gauntlet:v4-study] v2 baseline EER {v2.pooled.eer * 100:.2f}%")
    out: Dict[Tuple[float, float], BootstrapComparison] = {}
    for lf in lr_factors:
        for bf in am_budget_fracs:
            cell = f"v4_lf{lf}_ab{bf}"
            r = run_v4(
                *common, data.eval.audio, data.trials, data.enroll_spk2utt,
                workdir=f"{workdir}/{cell}", alignments=ali, am_cfg=am_cfg,
                model_cfg=AdaptedConfig(num_speakers=n_spk, am=am_cfg,
                                        embed_dim=scale.embed_dim,
                                        hidden_dim=scale.frame_dim,
                                        pool_dim=scale.pool_dim),
                train_cfg=tc, extract_cfg=ec,
                am_steps=max(1, int(scale.am_steps * bf)),
                num_steps=scale.steps, am_lr_factor=lf, mesh=mesh,
                device=device,
            )
            comps = paired_speaker_bootstrap(
                {"v2": v2, cell: r}, data.trials, utt2spk,
                pairs=[("v2", cell)], n_boot=n_boot,
            )
            out[(lf, bf)] = comps[0]
            log(f"[gauntlet:v4-study] lr_factor={lf} am_budget={bf}: "
                f"{comps[0].line()}")
    return out


def run_augmentation_ablation(
    workdir: str, scale: GauntletScale = CI_SCALE, mesh=None, log=print,
    device: DeviceLike = "cuda",
) -> Tuple[float, float]:
    """Augmentation must help when train is clean and eval is noisy
    (`v2/run_sre10.sh:92-159`): train v2 on a noise-free corpus, evaluate
    on the noisy shifted-channel eval; then retrain with MUSAN-style
    reverb/noise/babble copies mixed in.  Returns (eer_plain, eer_aug)."""
    from ..data.augment import AugmentSpec, synthetic_rir
    from .drivers import AugmentOptions, run_v2

    resolve_device(device)
    clean_scale = dataclasses.replace(scale, noise_snr_db=None)
    data = make_gauntlet_data(clean_scale)
    noisy_eval = make_gauntlet_data(
        dataclasses.replace(scale, noise_snr_db=(3.0, 12.0))
    )
    rng = np.random.default_rng(scale.seed + 77)
    noise_pool = [(rng.normal(size=(16000,)) * 800).astype(np.float32)
                  for _ in range(6)]
    babble_pool = [(rng.normal(size=(12000,)) * 1500).astype(np.float32)
                   for _ in range(8)]
    opts = AugmentOptions(
        rirs=[synthetic_rir(seed=3)],
        noises={"noise": noise_pool, "music": noise_pool,
                "babble": babble_pool},
        specs=(AugmentSpec("reverb"),
               AugmentSpec("noise", (0.0, 5.0, 10.0, 15.0)),
               AugmentSpec("babble", (13.0, 15.0, 17.0, 20.0))),
        subset=len(data.train.dataset),
        seed=scale.seed,
    )
    kw = dict(
        model_cfg=XVectorConfig(feat_dim=23,
                                num_speakers=scale.num_train_speakers,
                                frame_specs=scale.frame_specs(),
                                embed_dim=scale.embed_dim),
        train_cfg=scale.train_cfg(), extract_cfg=scale.extract_cfg(),
        num_steps=scale.steps, mesh=mesh, device=device,
    )
    plain = run_v2(data.train.dataset, data.train.audio,
                   noisy_eval.eval.dataset, noisy_eval.eval.audio,
                   noisy_eval.trials, noisy_eval.enroll_spk2utt,
                   workdir=f"{workdir}/v2_plain", **kw)
    log(f"[gauntlet:aug] clean-train EER {plain.pooled.eer * 100:.2f}%")
    aug = run_v2(data.train.dataset, data.train.audio,
                 noisy_eval.eval.dataset, noisy_eval.eval.audio,
                 noisy_eval.trials, noisy_eval.enroll_spk2utt,
                 workdir=f"{workdir}/v2_aug", augments=opts, **kw)
    log(f"[gauntlet:aug] augmented EER {aug.pooled.eer * 100:.2f}%")
    return plain.pooled.eer, aug.pooled.eer


def _weighted_rates(scores: np.ndarray, targets: np.ndarray,
                    order: np.ndarray, weights: np.ndarray):
    """(FRR, FAR) sweeps of a trial-weighted score set (weights =
    bootstrap multiplicities).  ``order`` is argsort(scores) precomputed
    by the caller so replicates share the sort."""
    ys = targets[order]
    ws = weights[order]
    cum_tgt = np.cumsum(ws * ys)
    cum_non = np.cumsum(ws * ~ys)
    tot_t, tot_n = cum_tgt[-1], cum_non[-1]
    if tot_t <= 0 or tot_n <= 0:
        return None, None
    frr = cum_tgt / tot_t  # targets at or below each threshold
    far = 1.0 - cum_non / tot_n  # nontargets above it
    return frr, far


def _eer_from_rates(frr: np.ndarray, far: np.ndarray) -> float:
    """EER by linear interpolation at the frr/far crossing.

    With few target trials per bootstrap replicate the raw sweeps are
    step functions quantized in 1/#targets increments; taking the single
    crossing index coarsens the bootstrap CI by that step size, so
    interpolate between the bracketing sweep points instead (matching
    metrics.det's convex-interpolated EER).
    """
    d = frr - far  # nondecreasing: frr rises, far falls along the sweep
    k = min(int(np.searchsorted(d, 0.0)), len(frr) - 1)
    if k == 0 or d[k] == d[k - 1]:
        return float(0.5 * (frr[k] + far[k]))
    t = float(-d[k - 1] / (d[k] - d[k - 1]))
    frr_i = frr[k - 1] + t * (frr[k] - frr[k - 1])
    far_i = far[k - 1] + t * (far[k] - far[k - 1])
    return float(0.5 * (frr_i + far_i))


def _dcf08_from_rates(frr: np.ndarray, far: np.ndarray) -> float:
    """NIST-normalized minDCF08 (C_miss=10, C_fa=1, P_tgt=0.01 —
    metrics.det.SRE08_DCF)."""
    c_miss, c_fa, p_t = 10.0, 1.0, 0.01
    dcf = c_miss * frr * p_t + c_fa * far * (1.0 - p_t)
    return float(np.min(dcf) / min(c_miss * p_t, c_fa * (1.0 - p_t)))


def _weighted_eer(scores: np.ndarray, targets: np.ndarray,
                  order: np.ndarray, weights: np.ndarray) -> float:
    frr, far = _weighted_rates(scores, targets, order, weights)
    return float("nan") if frr is None else _eer_from_rates(frr, far)


def _weighted_min_dcf08(scores: np.ndarray, targets: np.ndarray,
                        order: np.ndarray, weights: np.ndarray) -> float:
    frr, far = _weighted_rates(scores, targets, order, weights)
    return float("nan") if frr is None else _dcf08_from_rates(frr, far)


@dataclasses.dataclass
class BootstrapComparison:
    """Paired-bootstrap summary for 'is system B better than A?'."""

    system_a: str
    system_b: str
    eer_a: float
    eer_b: float
    delta_mean: float  # mean over replicates of EER_a - EER_b (>0: B wins)
    ci_low: float  # 2.5th percentile of the delta
    ci_high: float  # 97.5th percentile
    p_b_better: float  # fraction of replicates with delta > 0
    # same summary for minDCF08 (the adaptation pins' metric)
    dcf_delta_mean: float = float("nan")
    dcf_ci_low: float = float("nan")
    dcf_ci_high: float = float("nan")
    p_b_better_dcf: float = float("nan")

    def line(self) -> str:
        return (f"{self.system_b} vs {self.system_a}: "
                f"dEER {self.delta_mean * 100:+.2f} pts "
                f"[{self.ci_low * 100:+.2f}, {self.ci_high * 100:+.2f}] "
                f"P({self.system_b} better) = {self.p_b_better:.3f}; "
                f"dminDCF08 {self.dcf_delta_mean:+.3f} "
                f"[{self.dcf_ci_low:+.3f}, {self.dcf_ci_high:+.3f}] "
                f"P = {self.p_b_better_dcf:.3f}")


def paired_speaker_bootstrap(
    results: Dict[str, object],
    trials: Sequence,
    utt2spk: Dict[str, str],
    pairs: Sequence[Tuple[str, str]] = (("v2", "v3"), ("v2", "v4"),
                                        ("v2", "v5")),
    n_boot: int = 1000,
    seed: int = 0,
) -> List[BootstrapComparison]:
    """Speaker-level paired bootstrap of EER differences.

    Two systems scored on the SAME trial list have strongly correlated
    EERs, so the paired DIFFERENCE has a far smaller standard error
    than either EER alone — this is what lets a ~1-point ordering be
    pinned at a scale where each EER's own se is ~1 point.  (The
    reference's acceptance protocol compares systems on one fixed
    trials key for the same reason, `v2/run_sre10.sh:239-334`; NIST's
    SRE analyses bootstrap over speakers, the dominant variance unit.)

    Each replicate resamples the eval speakers with replacement and
    reweights every trial by enroll-speaker multiplicity x test-speaker
    multiplicity; all systems are re-scored on IDENTICAL replicates and
    the per-replicate EER deltas summarize into (mean, 95% CI,
    P(B better)).
    """
    # only trials scored by EVERY system are comparable (backend_eval
    # drops trials whose test utt has no embedding / model no enrolls)
    scored = [t for t in trials
              if all((t.model, t.test) in r.scores for r in results.values())]
    if len(scored) < len(trials):
        print(f"[bootstrap] {len(trials) - len(scored)} of {len(trials)} "
              "trials unscored by some system; comparing the scored "
              "intersection", flush=True)
    trials = scored
    if not trials:
        return []
    spks = sorted({t.model for t in trials}
                  | {utt2spk[t.test] for t in trials})
    spk_idx = {s: i for i, s in enumerate(spks)}
    enr = np.array([spk_idx[t.model] for t in trials])
    tst = np.array([spk_idx[utt2spk[t.test]] for t in trials])
    targets = np.array([t.target for t in trials], bool)

    sys_scores = {}
    for name, res in results.items():
        s = np.array([res.scores[(t.model, t.test)] for t in trials])
        sys_scores[name] = (s, np.argsort(s, kind="stable"))

    rng = np.random.default_rng(seed)
    deltas = {pair: [] for pair in pairs}
    dcf_deltas = {pair: [] for pair in pairs}
    point = {name: _weighted_eer(s, targets, o, np.ones(len(trials)))
             for name, (s, o) in sys_scores.items()}
    for _ in range(n_boot):
        counts = np.bincount(rng.integers(0, len(spks), len(spks)),
                             minlength=len(spks)).astype(np.float64)
        w = counts[enr] * counts[tst]
        if not (np.any(w * targets) and np.any(w * ~targets)):
            continue
        eers, dcfs = {}, {}
        for name, (s, o) in sys_scores.items():
            frr, far = _weighted_rates(s, targets, o, w)
            if frr is None:
                break
            eers[name] = _eer_from_rates(frr, far)
            dcfs[name] = _dcf08_from_rates(frr, far)
        for a, b in pairs:
            if a in eers and b in eers:
                deltas[(a, b)].append(eers[a] - eers[b])
                dcf_deltas[(a, b)].append(dcfs[a] - dcfs[b])
    out = []
    for (a, b), d in deltas.items():
        if not d or a not in point or b not in point:
            continue
        d = np.asarray(d)
        dd = np.asarray(dcf_deltas[(a, b)])
        out.append(BootstrapComparison(
            a, b, point[a], point[b], float(d.mean()),
            float(np.percentile(d, 2.5)), float(np.percentile(d, 97.5)),
            float(np.mean(d > 0)),
            float(dd.mean()), float(np.percentile(dd, 2.5)),
            float(np.percentile(dd, 97.5)), float(np.mean(dd > 0)),
        ))
    return out


def format_table(results: Dict[str, object]) -> str:
    lines = [f"{'system':<8}{'EER%':>8}{'minDCF08':>10}{'DCF10x1e3':>10}"
             f"{'#tgt':>7}{'#non':>7}"]
    for name in sorted(results):
        r = results[name].pooled
        lines.append(
            f"{name:<8}{r.eer * 100:>8.2f}{r.min_dcf08:>10.3f}"
            f"{r.min_dcf10 * 1e3:>10.1f}{r.num_target:>7}{r.num_nontarget:>7}"
        )
    return "\n".join(lines)
