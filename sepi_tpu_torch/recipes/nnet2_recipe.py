"""The DNN/i-vector (nnet2) path — run_sre10_nnet2.sh.

Port of `sepi_tpu/recipes/nnet2_recipe.py`.  The reference trains a
p-norm multisplice TDNN on 40-dim hires MFCC and uses its senone softmax
as the frame-to-component posteriors of a full-covariance UBM and
i-vector extractor computed on *paired* 20-dim sid features
(`sid/init_full_ubm_from_dnn.sh:100-116`).

  prepare_paired_features  sid (20 + deltas) and hires (40) features from
                           one framing, both stripped by the sid-energy
                           VAD so they stay frame-aligned
  train_nnet2_am           frame-level senone CE on hires features with
                           the multisplice context (FrameSampler, the AM
                           step, supersteps, the Trainer)
  nnet2_posteriors         per-utterance senone softmax, edge-replicated
                           so T frames in give T rows out

Each takes ``device=`` (default "cuda").  The reference's PRNG ``key``
that salts the dither is a plain int here.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import (
    CmvnConfig,
    FrontendConfig,
    MFCC_HIRES,
    MFCC_SRE_IVECTOR,
    OptimizerConfig,
    TrainConfig,
    VadConfig,
)
from ..data.sampler import FrameSampler
from ..device import DeviceLike, fp32_math, resolve_device
from ..models.nnet2 import Nnet2Config, Nnet2Multisplice
from ..ops.cmvn import sliding_cmvn
from ..ops.deltas import add_deltas
from ..ops.dither import utt_seeds
from ..ops.features import FeatureExtractor
from ..ops.vad import energy_vad
from ..train import Trainer, TrainState, build_optimizer, create_train_state
from ..train.trainer import make_am_step
from .pipeline import batch_iterator, make_task_supersteps, padded_audio_batches, training_device

# train_multisplice_accel2.sh defaults as wired by run_nnet2_multisplice.sh:
# initial/final effective lr 0.0015 -> 0.00015, no momentum/shrinkage.
NNET2_OPTIMIZER = OptimizerConfig(
    initial_lr=0.0015, final_lr=0.00015, momentum=0.0, proportional_shrink=0.0
)


def prepare_paired_features(
    audio: Mapping[str, np.ndarray],
    sid_frontend: FrontendConfig = MFCC_SRE_IVECTOR,
    hires_frontend: FrontendConfig = MFCC_HIRES,
    vad: VadConfig = VadConfig(),
    cmvn: CmvnConfig = CmvnConfig(),
    delta_order: int = 2,
    key: Optional[int] = None,
    batch_size: int = 16,
    device: DeviceLike = "cuda",
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(sid_feats, hires_feats): same framing, one VAD, two streams.

    The VAD decision comes from the sid stream's C0 energy (the hires
    config drops energy), as the reference computes one vad.scp and
    selects voiced frames of both pipelines with it.  Dither draws
    independently per stream through per-utterance seeds (sid: base
    ``key``, hires: ``key ^ 0x5EED``), so each utterance's noise is a pure
    function of (utt_id, stream, key) and the length-sorted batches of
    ``batch_size`` utterances give the features the reference computes
    one utterance at a time.  Dicts keep ``audio``'s order."""
    if (sid_frontend.frame_shift != hires_frontend.frame_shift
            or sid_frontend.frame_length != hires_frontend.frame_length
            or sid_frontend.snip_edges != hires_frontend.snip_edges):
        raise ValueError("paired streams need identical framing")
    dithered = sid_frontend.dither != 0.0 or hires_frontend.dither != 0.0
    salt = int(key) if (key is not None and dithered) else 0
    fe_sid = FeatureExtractor(sid_frontend, device=device)
    fe_hires = FeatureExtractor(hires_frontend, device=device)
    sid_out: Dict[str, np.ndarray] = {}
    hires_out: Dict[str, np.ndarray] = {}
    for names, samples, lengths in padded_audio_batches(audio, batch_size):
        s_s = utt_seeds(names, base_seed=salt) if dithered else None
        s_h = utt_seeds(names, base_seed=salt ^ 0x5EED) if dithered else None
        f_sid, mask = fe_sid.mfcc(samples, lengths, utt_seeds=s_s)
        f_hires, mask_h = fe_hires.mfcc(samples, lengths, utt_seeds=s_h)
        voiced = energy_vad(f_sid[..., 0], mask, vad).cpu().numpy()
        sid_n = sliding_cmvn(add_deltas(f_sid, mask, order=delta_order), mask, cmvn).cpu().numpy()
        hires_n = sliding_cmvn(f_hires, mask_h, cmvn).cpu().numpy()
        for b, u in enumerate(names):
            v = voiced[b]
            if v.any():
                sid_out[u] = sid_n[b][v]
                hires_out[u] = hires_n[b][v]
    order = [u for u in audio if u in sid_out]
    return {u: sid_out[u] for u in order}, {u: hires_out[u] for u in order}


@fp32_math()
def train_nnet2_am(
    features: Mapping[str, np.ndarray],
    alignments: Mapping[str, np.ndarray],
    cfg: Optional[Nnet2Config] = None,
    train_cfg: Optional[TrainConfig] = None,
    num_steps: int = 300,
    frames_per_eg: int = 8,
    mesh=None,
    log=None,
    device: DeviceLike = "cuda",
):
    """Train the p-norm multisplice senone net on hires frame egs
    (`sid/nnet2/train_multisplice_accel2.sh`: frame egs and the reference
    LR schedule).  Returns (model, state), the model in eval mode; the
    sampler draws the reference's probe batch first, as it does.  With a
    ``mesh`` each rank trains on its shard of every batch."""
    if cfg is None:
        num_senones = 1 + max(int(np.max(a)) for a in alignments.values())
        feat_dim = next(iter(features.values())).shape[1]
        cfg = Nnet2Config(feat_dim=feat_dim, num_senones=num_senones)
    train_cfg = train_cfg or TrainConfig(optimizer=NNET2_OPTIMIZER)
    if train_cfg.compute_dtype != "float32":
        # the p-norm net has no compute dtype (the reference trains it in
        # float32 whatever the config says): a bf16 request is refused
        # rather than quietly run in float32
        raise ValueError(f"compute_dtype {train_cfg.compute_dtype!r}: the nnet2 model "
                         "computes in float32 only")
    dev = training_device(train_cfg, mesh, device)
    sampler = FrameSampler(features, alignments, chunk_len=frames_per_eg,
                           batch_size=train_cfg.am_batch_size, seed=train_cfg.seed,
                           context=cfg.context)
    tx, _ = build_optimizer(train_cfg.optimizer, num_steps)
    sampler.sample_batch()  # the reference's probe batch: keeps the RNG in step
    state = create_train_state(Nnet2Multisplice(cfg), tx, train_cfg.seed, dev, mesh=mesh)
    trainer = Trainer(
        steps={"am": make_am_step(tx, mesh=mesh)}, state=state, log_every=50, logger=log,
        supersteps=make_task_supersteps(tx, {"am": {}}, train_cfg, mesh),
        steps_per_dispatch=train_cfg.steps_per_dispatch, mesh=mesh,
    )
    it = batch_iterator(sampler, train_cfg, mesh)
    try:
        state = trainer.run(it, num_steps=num_steps)
    finally:
        if hasattr(it, "close"):
            it.close()
    state.model.eval()
    return state.model, state


@fp32_math()
def nnet2_posteriors(
    model: Nnet2Multisplice,
    state,
    features: Mapping[str, np.ndarray],
    batch_frames: int = 16384,
    device: DeviceLike = "cuda",
) -> Dict[str, np.ndarray]:
    """utt -> (T, K) senone softmax, frame-aligned with the input.

    Edge frames are covered by replicating the first and last frame
    (`nnet-am-compute`'s convention).  Length-sorted groups of about
    ``batch_frames`` frames, padded to a 64-frame grid with copies of
    each utterance's last frame.  ``state``: a `TrainState`, a
    state_dict, or None to keep the model's own weights."""
    dev = resolve_device(device)
    if isinstance(state, TrainState):
        state = state.model.state_dict()
    if state is not None:
        model.load_state_dict(state)
    model = model.to(dev).eval()
    l, r = model.cfg.context
    out: Dict[str, np.ndarray] = {}
    items = sorted(features.items(), key=lambda kv: (kv[1].shape[0], kv[0]))
    typical = items[len(items) // 2][1].shape[0] + l + r if items else 1
    group_size = max(1, batch_frames // max(typical, 1))
    with torch.no_grad():
        for i in range(0, len(items), group_size):
            group = items[i:i + group_size]
            t_pad = -(-max(f.shape[0] + l + r for _, f in group) // 64) * 64
            dim = group[0][1].shape[1]
            x = np.zeros((len(group), t_pad, dim), np.float32)
            for j, (_, f) in enumerate(group):
                padded = np.pad(f, ((l, r), (0, 0)), mode="edge")
                x[j, :padded.shape[0]] = padded
                x[j, padded.shape[0]:] = padded[-1]  # edge-replicate the tail
            logits = model(torch.as_tensor(x, device=dev))["logits"]
            post = torch.softmax(logits, dim=-1).cpu().numpy()
            for j, (utt, f) in enumerate(group):
                out[utt] = post[j, :f.shape[0]].astype(np.float32)
    return out
