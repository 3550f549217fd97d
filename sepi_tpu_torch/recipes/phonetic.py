"""Phonetic recipe stages: AM pretraining, v3 multitask, v4 adaptation,
v5 combined c-vector.

Port of `sepi_tpu/recipes/phonetic.py`, stage for stage with the Kaldi scripts:

  train_am_model         = local/nnet3_cvector/cvector/train_am.sh
  train_multitask_model  = train_cvector.sh -> train_cvector_dnn.py
  train_adapted_model    = train_xvector_with_am.sh (graft + lr x0.2)
  train_combined_model   = train_cvector_with_am.sh (graft + multitask)
  pseudo_senone_alignments = an explicit test and smoke helper, never a
                           driver default: GMM-clustered frame labels

Alignments obey the select-voiced-ali invariant: label streams are
frame-aligned with the (silence-stripped) feature streams, as
`recipes.s5.select_voiced_ali` leaves them.  Each trainer takes
``device=`` (default "cuda") and returns (model, state) with the model in
eval mode and calibrated batch-norm statistics.  The samplers draw in the
reference's order (held-out batches, a probe batch, calibration batches,
then training), so both packages train on the same batches.  With a
``mesh`` every rank draws the same global batches and trains on its
shard of each (`pipeline.train_xvector_model`).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np

from ..config import TrainConfig
from ..data.manifest import Dataset
from ..data.sampler import ChunkSampler, FrameSampler, MultitaskInterleaver
from ..device import DeviceLike, fp32_math, resolve_device
from ..models import (
    AdaptedConfig,
    AdaptedXVector,
    AmConfig,
    AmNet,
    CombinedConfig,
    CombinedCVector,
    MultitaskConfig,
    MultitaskCVector,
)
from ..train import Trainer, build_optimizer, create_train_state, finalize_batch_stats
from ..train.graft import graft_subtree
from ..train.trainer import make_am_step, make_eval_step, make_xvec_step
from .pipeline import (
    auto_heldout,
    batch_iterator,
    heldout_split,
    make_task_supersteps,
    run_checkpointed,
    training_device,
)

BOTH_TASKS = {"am": {"task": "am"}, "xvec": {"task": "xvec"}}


def pseudo_senone_alignments(features: Mapping[str, np.ndarray], num_senones: int = 32,
                             seed: int = 0, device: DeviceLike = "cuda") -> Dict[str, np.ndarray]:
    """Frame labels from a diag GMM over all frames (argmax of the
    component log-likelihoods): a consistent, learnable phone-like
    labelling for tests and smoke runs without transcripts.  Not phonetic
    and never a driver default; the real providers are caller-supplied
    alignments or `recipes.s5.run_s5`."""
    import torch

    from ..classical.gmm import _mstep_diag, accumulate_stats, init_diag_from_frames
    from ..config import UbmConfig

    dev = resolve_device(device)
    all_frames = np.concatenate(list(features.values()))
    cfg = UbmConfig(num_gauss=num_senones, num_gselect=num_senones)
    gmm = init_diag_from_frames(all_frames[::5], num_senones, seed, dev)
    var_floor = float(np.var(all_frames, axis=0).mean()) * 1e-4 + 1e-6
    x = torch.as_tensor(np.asarray(all_frames[::5], np.float32), device=dev)
    for _ in range(4):
        stats = accumulate_stats(gmm, x, num_gselect=num_senones)
        gmm = _mstep_diag(stats, cfg, var_floor)
    out = {}
    with torch.no_grad():
        for utt, f in features.items():
            ll = gmm.log_likes(torch.as_tensor(np.asarray(f, np.float32), device=dev))
            out[utt] = torch.argmax(ll, dim=1).cpu().numpy().astype(np.int32)
    return out


def _train(state, steps: Dict, batch_iter, num_steps: int, calib_feats, train_cfg: TrainConfig,
           model_kwargs=None, log=None, valid_batches=None, eval_steps=None,
           checkpoint_dir=None, supersteps=None, mesh=None):
    """The shared loop.  With ``checkpoint_dir``, checkpoints every
    ``checkpoint_every`` steps, a run resumes from the newest, and the final
    model is the best checkpoint-tail combination on the held-out
    objectives *summed* across tasks (`combine_cvector_models`,
    `frame_level_objf/common.py:970-1055`).  Logs every 50 steps and
    evaluates every 100, whatever ``train_cfg.steps_per_eval`` says.  The
    calibration batches were drawn before, and the prefetch thread starts
    here."""
    trainer = Trainer(
        steps=steps, state=state, log_every=50, logger=log,
        valid_batches=valid_batches, eval_steps=eval_steps, eval_every=100,
        supersteps=supersteps, steps_per_dispatch=train_cfg.steps_per_dispatch, mesh=mesh,
    )
    it = batch_iterator(batch_iter, train_cfg, mesh)
    try:
        if checkpoint_dir:
            combine_objf = None
            if valid_batches and eval_steps:
                def combine_objf(s):
                    return sum(float(eval_steps[vb.task](s, vb.feats, vb.labels)["objf"])
                               for vb in valid_batches if vb.task in eval_steps)

            state = run_checkpointed(trainer, it, num_steps, train_cfg, checkpoint_dir,
                                     log=log, combine_objf=combine_objf, mesh=mesh)
        else:
            state = trainer.run(it, num_steps=num_steps)
    finally:
        if hasattr(it, "close"):
            it.close()
    return finalize_batch_stats(state, calib_feats, model_kwargs=model_kwargs, mesh=mesh)


@fp32_math()
def train_am_model(
    features: Mapping[str, np.ndarray],
    alignments: Mapping[str, np.ndarray],
    am_cfg: AmConfig,
    train_cfg: TrainConfig = TrainConfig(),
    num_steps: int = 300,
    frames_per_eg: int = 8,
    mesh=None,
    log=None,
    device: DeviceLike = "cuda",
):
    """v4/v5 stage 0: pretrain the bottleneck ASR TDNN on frame egs (no
    held-out batches and no checkpoints, as `train_am.sh`)."""
    dev = training_device(train_cfg, mesh, device)
    sampler = FrameSampler(features, alignments, chunk_len=frames_per_eg,
                           batch_size=train_cfg.am_batch_size, seed=train_cfg.seed,
                           context=am_cfg.context)
    tx, _ = build_optimizer(train_cfg.optimizer, num_steps)
    sampler.sample_batch()  # the reference's probe batch: keeps the RNG in step
    state = create_train_state(AmNet(am_cfg, dtype=train_cfg.compute_dtype), tx,
                               train_cfg.seed, dev, mesh=mesh)
    calib = [sampler.sample_batch().feats for _ in range(3)]
    state = _train(state, {"am": make_am_step(tx, mesh=mesh)}, iter(sampler), num_steps, calib,
                   train_cfg, log=log,
                   supersteps=make_task_supersteps(tx, {"am": {}}, train_cfg, mesh), mesh=mesh)
    return state.model, state


def _heldout_valid(features, alignments, dataset: Dataset, cfg: TrainConfig,
                   num_heldout_utts: Optional[int], am_context=None, frames_per_eg: int = 8):
    """Held-out diagnostics for the phonetic trainers: the dataset split
    by `heldout_split` (utt2uniq-aware, `get_egs_xvec.sh:104-119`), the
    held-out utterances removed from the training features and
    alignments, and from them one x-vector batch at the first bucket
    (global label map) and, with ``am_context`` and held-out alignments,
    one AM frame batch (batch min(am_batch_size, 64), seed + 1).

    Returns (train_ds, train_features, train_alignments, valid_batches);
    valid_batches is None when nothing could be held out."""
    alignments = alignments or {}
    n = auto_heldout(dataset, num_heldout_utts)
    if n <= 0:
        return dataset, dict(features), dict(alignments), None
    train_ds, valid_ds = heldout_split(dataset, n)
    valid_utts = [u for u in valid_ds.utt_ids if u in features]
    if not valid_utts:
        return dataset, dict(features), dict(alignments), None
    label_map = dataset.speaker_label_map()
    train_feats = {u: features[u] for u in train_ds.utt_ids if u in features}
    train_ali = {u: alignments[u] for u in train_ds.utt_ids if u in alignments}
    vs = ChunkSampler({u: features[u] for u in valid_utts}, dataset.subset(valid_utts),
                      cfg.chunks, min(cfg.batch_size, max(len(valid_utts), 2)), cfg.seed + 1,
                      label_map=label_map)
    valid_batches = [vs.sample_batch(vs.buckets[0])]
    ali_utts = [u for u in valid_utts if u in alignments]
    if am_context is not None and ali_utts:
        fs = FrameSampler({u: features[u] for u in ali_utts}, {u: alignments[u] for u in ali_utts},
                          chunk_len=frames_per_eg, batch_size=min(cfg.am_batch_size, 64),
                          seed=cfg.seed + 1, context=am_context)
        valid_batches.append(fs.sample_batch())
    return train_ds, train_feats, train_ali, valid_batches


def _multitask_iter(features, alignments, dataset: Dataset, cfg: TrainConfig, am_context,
                    num_steps: int, frames_per_eg: int = 8, label_map=None):
    """The two samplers and their interleaver.  The stream budget follows
    `get_egs_xvec.sh:126-143`: the AM stream holds frames / frames_per_eg
    examples (frames of utterances with alignments only: augmented copies
    feed the speaker stream alone), the x-vector stream repeats_per_spk x
    speakers (0 = as many batches as the AM stream); both scale to the
    step budget and run out together."""
    am_sampler = FrameSampler(features, alignments, chunk_len=frames_per_eg,
                              batch_size=cfg.am_batch_size, seed=cfg.seed, context=am_context)
    xvec_sampler = ChunkSampler(features, dataset, cfg.chunks, cfg.batch_size, cfg.seed,
                                block_size=cfg.steps_per_dispatch, label_map=label_map)
    total_frames = sum(f.shape[0] for u, f in features.items() if u in alignments)
    am_egs = max(total_frames // frames_per_eg, 1)
    am_batches_epoch = max(-(-am_egs // cfg.am_batch_size), 1)
    if cfg.repeats_per_spk > 0:
        xvec_egs = cfg.repeats_per_spk * max(xvec_sampler.num_speakers, 1)
        xvec_batches_epoch = max(-(-xvec_egs // cfg.batch_size), 1)
    else:
        xvec_batches_epoch = am_batches_epoch
    frac_am = am_batches_epoch / (am_batches_epoch + xvec_batches_epoch)
    num_am = min(max(int(round(num_steps * frac_am)), 1), num_steps - 1)
    interleaver = MultitaskInterleaver(
        am_sampler, xvec_sampler, num_am_batches=num_am + 1,
        num_xvec_batches=num_steps - num_am + 1, am_weight=cfg.am_weight,
        xvec_weight=cfg.xvec_weight, seed=cfg.seed, block_size=cfg.steps_per_dispatch,
    )
    return am_sampler, xvec_sampler, interleaver


def _two_task_run(model, features, alignments, dataset: Dataset, train_cfg: TrainConfig,
                  num_steps: int, am_context, dev, log, checkpoint_dir, num_heldout_utts,
                  lr_factors=None, graft_from=None, mesh=None):
    """v3 and v5: interleaved am/xvec steps on one model, the per-task
    held-out batches, calibration with both branches on."""
    label_map = dataset.speaker_label_map()
    train_ds, features, alignments, valid_batches = _heldout_valid(
        features, alignments, dataset, train_cfg, num_heldout_utts, am_context)
    _, xvec_sampler, interleaver = _multitask_iter(
        features, alignments, train_ds, train_cfg, am_context, num_steps, label_map=label_map)
    tx, _ = build_optimizer(train_cfg.optimizer, num_steps, lr_factors=lr_factors)
    xvec_sampler.sample_batch(xvec_sampler.buckets[0])  # the reference's probe batch
    state = create_train_state(model, tx, train_cfg.seed, dev, mesh=mesh)
    if graft_from is not None:
        graft_subtree(state.model, graft_from, "am")
    steps = {"am": make_am_step(tx, BOTH_TASKS["am"], mesh),
             "xvec": make_xvec_step(tx, BOTH_TASKS["xvec"], mesh)}
    calib = [xvec_sampler.sample_batch(b).feats for b in xvec_sampler.buckets[:3]]
    eval_steps = ({t: make_eval_step(kw, mesh) for t, kw in BOTH_TASKS.items()}
                  if valid_batches else None)
    state = _train(state, steps, iter(interleaver), num_steps, calib, train_cfg,
                   model_kwargs={"task": "both"}, log=log, valid_batches=valid_batches,
                   eval_steps=eval_steps, checkpoint_dir=checkpoint_dir,
                   supersteps=make_task_supersteps(tx, BOTH_TASKS, train_cfg, mesh), mesh=mesh)
    return state.model, state


@fp32_math()
def train_multitask_model(
    features: Mapping[str, np.ndarray],
    alignments: Mapping[str, np.ndarray],
    dataset: Dataset,
    model_cfg: MultitaskConfig,
    train_cfg: TrainConfig = TrainConfig(),
    num_steps: int = 300,
    mesh=None,
    log=None,
    checkpoint_dir: Optional[str] = None,
    num_heldout_utts: Optional[int] = None,
    device: DeviceLike = "cuda",
):
    """v3: two-head training on interleaved single-task minibatches."""
    dev = training_device(train_cfg, mesh, device)
    return _two_task_run(MultitaskCVector(model_cfg, dtype=train_cfg.compute_dtype),
                         features, alignments, dataset, train_cfg,
                         num_steps, model_cfg.am_context, dev, log, checkpoint_dir,
                         num_heldout_utts, mesh=mesh)


@fp32_math()
def train_adapted_model(
    features: Mapping[str, np.ndarray],
    dataset: Dataset,
    am_model,
    am_state,
    model_cfg: AdaptedConfig,
    train_cfg: TrainConfig = TrainConfig(),
    num_steps: int = 300,
    am_lr_factor: float = 0.2,
    mesh=None,
    log=None,
    checkpoint_dir: Optional[str] = None,
    num_heldout_utts: Optional[int] = None,
    device: DeviceLike = "cuda",
):
    """v4: graft the pretrained AM (``am_model``, the module of
    ``am_state`` as `train_am_model` returns them), scale its learning rate
    by ``am_lr_factor``, train on speaker chunks with held-out
    diagnostics and (with ``checkpoint_dir``) checkpoint-tail combination.
    The pretrained model is copied, never changed."""
    dev = training_device(train_cfg, mesh, device)
    label_map = dataset.speaker_label_map()
    train_ds, features, _, valid_batches = _heldout_valid(
        features, None, dataset, train_cfg, num_heldout_utts)
    sampler = ChunkSampler(features, train_ds, train_cfg.chunks, train_cfg.batch_size,
                           train_cfg.seed, block_size=train_cfg.steps_per_dispatch,
                           label_map=label_map)
    tx, _ = build_optimizer(train_cfg.optimizer, num_steps, lr_factors={"am": am_lr_factor})
    sampler.sample_batch(sampler.buckets[0])  # the reference's probe batch
    state = create_train_state(AdaptedXVector(model_cfg, dtype=train_cfg.compute_dtype), tx,
                               train_cfg.seed, dev, mesh=mesh)
    graft_subtree(state.model, am_model, "am")
    eval_steps = {"xvec": make_eval_step(mesh=mesh)} if valid_batches else None
    calib = [sampler.sample_batch(b).feats for b in sampler.buckets[:3]]
    state = _train(state, {"xvec": make_xvec_step(tx, mesh=mesh)}, iter(sampler), num_steps,
                   calib, train_cfg, log=log, valid_batches=valid_batches, eval_steps=eval_steps,
                   checkpoint_dir=checkpoint_dir,
                   supersteps=make_task_supersteps(tx, {"xvec": {}}, train_cfg, mesh), mesh=mesh)
    return state.model, state


@fp32_math()
def train_combined_model(
    features: Mapping[str, np.ndarray],
    alignments: Mapping[str, np.ndarray],
    dataset: Dataset,
    am_model,
    am_state,
    model_cfg: CombinedConfig,
    train_cfg: TrainConfig = TrainConfig(),
    num_steps: int = 300,
    am_lr_factor: float = 0.1,
    mesh=None,
    log=None,
    checkpoint_dir: Optional[str] = None,
    num_heldout_utts: Optional[int] = None,
    device: DeviceLike = "cuda",
):
    """v5: the pretrained-AM graft (as `train_adapted_model`) and two-head
    training (as `train_multitask_model`); the am-task frame egs take the
    multitask AM head's context."""
    dev = training_device(train_cfg, mesh, device)
    return _two_task_run(CombinedCVector(model_cfg, dtype=train_cfg.compute_dtype),
                         features, alignments, dataset, train_cfg,
                         num_steps, model_cfg.am_context, dev, log, checkpoint_dir,
                         num_heldout_utts, lr_factors={"am": am_lr_factor}, graft_from=am_model,
                         mesh=mesh)
