"""Embedding extraction: the inference path.

Port of `sepi_tpu/extract.py` (`extract_xvectors_new.sh` +
`nnet3-xvector-compute`): utterances split into <= chunk_size pieces,
chunks padded up to a small ladder of bucket lengths and run as dense
masked batches, per-chunk embeddings averaged weighted by chunk length,
and `ivector-mean` speaker averaging.  `streaming_embed` is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .config import ExtractConfig
from .device import DeviceLike, resolve_device


def chunk_spans(num_frames: int, cfg: ExtractConfig, min_frames: int) -> List[Tuple[int, int]]:
    """(offset, length) chunks per nnet3-xvector-compute semantics."""
    lo = max(cfg.min_chunk_size, min_frames)
    if num_frames < lo:
        return []
    size = min(cfg.chunk_size, num_frames)
    spans = []
    off = 0
    while off < num_frames:
        length = min(size, num_frames - off)
        if length < lo:
            break  # trailing remnant shorter than min chunk: dropped
        spans.append((off, length))
        off += length
    return spans


def bucket_ladder(cfg: ExtractConfig, min_frames: int) -> List[int]:
    """Static chunk-length buckets: geometric from min to chunk_size."""
    lo = max(cfg.min_chunk_size, min_frames)
    out = [lo]
    while out[-1] < cfg.chunk_size:
        out.append(min(out[-1] * 2, cfg.chunk_size))
    return out


class EmbeddingExtractor:
    """Batched bucketed extractor for a model whose
    ``forward(feats, frame_mask, **model_kwargs)`` returns a dict holding
    ``cfg.embedding_node``.  The model is moved to ``device`` and run in
    eval mode without gradients."""

    def __init__(self, model: torch.nn.Module, cfg: ExtractConfig = ExtractConfig(),
                 min_frames: int = 15, model_kwargs: Optional[Dict] = None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.min_frames = min_frames
        self.model_kwargs = dict(model_kwargs or {})

    def extract_utterances(self, features: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """utt_id -> (T, D) features  =>  utt_id -> embedding."""
        ladder = bucket_ladder(self.cfg, self.min_frames)
        plan: Dict[int, List[Tuple[str, int, int]]] = {b: [] for b in ladder}
        skipped = []
        for utt, f in features.items():
            spans = chunk_spans(f.shape[0], self.cfg, self.min_frames)
            if not spans:
                skipped.append(utt)
                continue
            for off, length in spans:
                b = next(b for b in ladder if b >= length)
                plan[b].append((utt, off, length))
        if skipped:
            raise ValueError(
                f"{len(skipped)} utterances shorter than min chunk "
                f"({max(self.cfg.min_chunk_size, self.min_frames)} frames), "
                f"e.g. {skipped[:3]}"
            )

        feat_dim = next(iter(features.values())).shape[1]
        sums: Dict[str, np.ndarray] = {}
        weights: Dict[str, float] = {}
        bs = self.cfg.batch_size
        node = self.cfg.embedding_node
        for b, items in plan.items():
            for i0 in range(0, len(items), bs):
                group = items[i0:i0 + bs]
                feats = np.zeros((bs, b, feat_dim), np.float32)
                mask = np.zeros((bs, b), bool)
                for j, (utt, off, length) in enumerate(group):
                    feats[j, :length] = features[utt][off:off + length]
                    mask[j, :length] = True
                with torch.no_grad():
                    out = self.model(torch.from_numpy(feats).to(self.device),
                                     frame_mask=torch.from_numpy(mask).to(self.device),
                                     **self.model_kwargs)
                emb = out[node].cpu().numpy()
                for j, (utt, off, length) in enumerate(group):
                    if utt in sums:
                        sums[utt] = sums[utt] + length * emb[j]
                        weights[utt] += length
                    else:
                        sums[utt] = length * emb[j]
                        weights[utt] = float(length)
        return {u: sums[u] / weights[u] for u in sums}


def speaker_mean(
    utt_embeddings: Mapping[str, np.ndarray], spk2utt: Mapping[str, List[str]]
) -> Tuple[Dict[str, np.ndarray], Dict[str, int]]:
    """ivector-mean per speaker (+ num_utts, used by PLDA multi-enroll)."""
    out, counts = {}, {}
    for spk, utts in spk2utt.items():
        vecs = [utt_embeddings[u] for u in utts if u in utt_embeddings]
        if not vecs:
            continue
        out[spk] = np.mean(vecs, axis=0)
        counts[spk] = len(vecs)
    return out, counts
