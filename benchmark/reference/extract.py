"""Plain reference of an utterance's embedding, from its raw samples.

`prepare_features_nosil` then `extract_and_score` for one utterance:
the voiced features (`frontend.nosil_features`), cut into chunks by
nnet3-xvector-compute's rule (chunks of min(chunk_size, T) frames, a
trailing remnant below the minimum dropped; `extract_xvectors.sh`), each
chunk's embedding (the model kind's ``embed``, `benchmark/models/`) on
its real frames alone, averaged weighted by chunk length.
"""

from __future__ import annotations

from typing import List, Mapping

import numpy as np
import torch

from .frontend import nosil_features, utt_seed


def chunks(num_frames: int, ext: Mapping) -> List[tuple]:
    lo = max(ext["min_chunk_size"], ext["min_frames"])
    if num_frames < lo:
        return []
    size = min(ext["chunk_size"], num_frames)
    out, off = [], 0
    while off < num_frames:
        length = min(size, num_frames - off)
        if length < lo:
            break
        out.append((off, length))
        off += length
    return out


def embedding(samples: np.ndarray, utt_id: str, params, cfg: Mapping, device,
              prec: str = "ref", salt: int = 0, *, model) -> torch.Tensor:
    """The float64 (or the control's) embedding of one utterance;
    ``model`` is the configuration's model kind (`harness.core.model_kind`),
    whose ``embed`` takes one chunk."""
    x = torch.from_numpy(np.ascontiguousarray(samples, np.float32)).to(device)
    feats, _ = nosil_features(x, utt_seed(utt_id, salt), cfg, prec)
    spans = chunks(feats.shape[0], cfg["extract"])
    if not spans:
        raise ValueError(f"{utt_id}: {feats.shape[0]} voiced frames, below the minimum chunk")
    total = sum(length for _, length in spans)
    acc = 0.0
    for off, length in spans:
        acc = acc + length * model.embed(feats[off:off + length], params, cfg, prec).to(torch.float64)
    return acc / total
