"""Embedding extraction: the inference path.

Port of `sepi_tpu/extract.py` (`extract_xvectors_new.sh` +
`nnet3-xvector-compute`): utterances split into <= chunk_size pieces,
chunks padded up to a small ladder of bucket lengths and run as dense
masked batches (each of a bucket's batches as many rows as the power of
two at or above the chunks the bucket holds, up to ``batch_size``),
per-chunk embeddings averaged weighted by chunk length, and
`ivector-mean` speaker averaging; `streaming_embed` pools an
utterance of any length exactly.  A bfloat16 model's embeddings come back
as float32: the values are bf16-rounded and the sums float32, as the
reference's numpy upcast gives them.

On a CUDA device without a mesh each bucket's forward is one replay of a
CUDA graph (`graphs.CallGraphs`), the counterpart of the reference's
jitted forward per bucket; ``capture=False`` runs it eagerly.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from . import graphs
from .config import ExtractConfig
from .device import DeviceLike, fp32_math, host_buffer, pack_rows, readback, resolve_device
from .utils.logging import count, span


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
    eval mode without gradients.

    With a ``mesh`` (`parallel.make_mesh`; the reference's GSPMD
    extraction, the analog of `extract_xvectors_new.sh`'s nj=32 fan-out)
    every rank plans the same batches, forwards its rows of each over the
    mesh's data axis and gathers the embeddings, so every rank returns the
    whole dict.  ``cfg.batch_size`` must be divisible by the data-axis
    size, and the device is the rank's on the mesh (``device`` unused).

    ``capture`` (the counterpart of `jax.disable_jit`): None replays a
    CUDA graph of each bucket's forward on a CUDA device without a mesh
    (one capture per bucket, model storage and math flags; `graphs`) and
    runs eagerly on the CPU and with a mesh; False always runs eagerly;
    True raises on the CPU and with a mesh."""

    def __init__(self, model: torch.nn.Module, cfg: ExtractConfig = ExtractConfig(),
                 min_frames: int = 15, model_kwargs: Optional[Dict] = None,
                 device: DeviceLike = "cuda", mesh=None, capture: Optional[bool] = None):
        if capture and mesh is not None:
            raise ValueError("capture=True with a mesh: a mesh extraction runs eagerly "
                             "(capture=None or False)")
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
        else:
            from .parallel.mesh import data_size, mesh_device

            self.device = mesh_device(mesh)
            if cfg.batch_size % data_size(mesh):
                raise ValueError(f"batch_size {cfg.batch_size} not divisible by data axis "
                                 f"{data_size(mesh)}")
        if capture and not graphs.BACKEND.capturable(self.device):
            raise ValueError(f"capture=True needs a CUDA device: extraction on {self.device} "
                             f"runs eagerly (capture=None or False)")
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.min_frames = min_frames
        self.model_kwargs = dict(model_kwargs or {})
        self.graphs = graphs.CallGraphs(
            self._forward, capture=False if mesh is not None else capture,
            static=(cfg.embedding_node, tuple(sorted(self.model_kwargs.items()))))

    def _forward(self, model: torch.nn.Module, feats: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
        """One padded batch's float32 embeddings (a bucket's graph)."""
        return model(feats, frame_mask=mask, **self.model_kwargs)[self.cfg.embedding_node].float()

    def _embed(self, feats: torch.Tensor, mask: torch.Tensor) -> np.ndarray:
        """The embeddings of one padded batch; with a mesh, this rank's
        rows forwarded and every rank's gathered."""
        if self.mesh is None:
            out = self.graphs(self.model, feats, mask)
        else:
            from .parallel.mesh import all_gather_rows, data_group
            from .parallel.multihost import local_batch_slice

            sl = local_batch_slice(feats.shape[0], self.mesh)
            out = self.graphs(self.model, feats[sl], mask[sl])
            with torch.no_grad():
                out = all_gather_rows(out, data_group(self.mesh))
        with span("extract.readback"):
            return readback([out])[0]

    def _rows(self, n: int) -> int:
        """The rows of every batch of a bucket holding ``n`` chunks: the
        power of two at or above ``n``, capped at ``cfg.batch_size``; with a
        mesh always ``cfg.batch_size`` (the data axis divides it).  Every
        model the extractor runs is row-independent in eval mode, so the
        rung changes how many all-zero rows a batch carries and, through
        the kernels a shape selects, only the rounding; each bucket keeps
        one shape a call, so a call captures no more graphs."""
        bs = self.cfg.batch_size
        if self.mesh is not None:
            return bs
        return min(bs, 1 << max(n - 1, 0).bit_length())

    def extract_utterances(self, features: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """utt_id -> (T, D) features  =>  utt_id -> embedding.  Counts each
        batch's real chunk rows and frames against its slots (`_rows` x
        bucket length): ``extract.rows``, ``extract.row_slots``,
        ``extract.frames``, ``extract.frame_slots``, and the batches packed
        at fewer than ``cfg.batch_size`` rows, ``extract.rung_batches``
        (`utils.logging.count`)."""
        with span("extract"):
            with span("extract.plan"):
                plan = self._plan(features)
            feat_dim = next(iter(features.values())).shape[1]
            sums: Dict[str, np.ndarray] = {}
            weights: Dict[str, float] = {}
            for b, items in plan.items():
                rows = self._rows(len(items))
                for i0 in range(0, len(items), rows):
                    group = items[i0:i0 + rows]
                    with span("extract.pack"):
                        feats = host_buffer((rows, b, feat_dim), torch.float32, self.device)
                        mask = host_buffer((rows, b), torch.bool, self.device)
                        pack_rows(feats, [features[utt][off:off + length]
                                          for utt, off, length in group], mask=mask)
                    count("extract.rows", len(group))
                    count("extract.row_slots", rows)
                    count("extract.frames", sum(length for _, _, length in group))
                    count("extract.frame_slots", rows * b)
                    if rows < self.cfg.batch_size:
                        count("extract.rung_batches", 1)
                    emb = self._embed(feats, mask)
                    for j, (utt, off, length) in enumerate(group):
                        if utt in sums:
                            sums[utt] = sums[utt] + length * emb[j]
                            weights[utt] += length
                        else:
                            sums[utt] = length * emb[j]
                            weights[utt] = float(length)
            return {u: sums[u] / weights[u] for u in sums}

    def _plan(self, features: Mapping[str, np.ndarray]) -> Dict[int, List[Tuple[str, int, int]]]:
        """bucket length -> the (utt, offset, length) chunks it holds."""
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
        return plan


@fp32_math()
def streaming_embed(model: torch.nn.Module, feats: np.ndarray, chunk: int = 10000,
                    var_floor: float = 1e-10, device: DeviceLike = "cuda") -> np.ndarray:
    """Exact single-pass embedding of an utterance of any length.

    The reference recipe caps stats pooling at 10 000 frames and averages
    per-chunk embeddings (`extract_xvectors_new.sh:86-93`).  Here trunk
    chunks overlap by the receptive field, so every trunk frame is
    computed exactly once, and feed a running count, sum and float64 sum
    of squares; the segment head runs once on the whole utterance's
    statistics.  ``model`` exposes ``trunk``/``head`` (`models.XVector`)
    and runs in eval mode on ``device``; ``feats`` is (T, D).  Returns
    the float32 ``embedding_a``.  A model without such a trunk (one whose
    frame layers read the whole chunk, as ECAPA-TDNN's SE and attention
    do) raises a `ValueError` naming it."""
    if not (hasattr(model, "trunk") and hasattr(model, "head")
            and hasattr(getattr(model, "cfg", None), "context")):
        raise ValueError(f"streaming_embed: {type(model).__name__} has no streamable trunk "
                         f"(model.trunk, model.head, model.cfg.context): its frame layers "
                         f"must have a finite context whose outputs tile over chunks")
    dev = resolve_device(device)
    model = model.to(dev).eval()
    left, right = model.cfg.context
    ctx = left + right
    t = feats.shape[0]
    if t <= ctx:
        raise ValueError(f"utterance too short: {t} <= receptive field {ctx}")
    x = torch.as_tensor(np.asarray(feats, np.float32), device=dev)
    count, s1, s2 = 0, 0.0, 0.0
    # chunk starts step by (chunk - ctx) so the trunk's outputs tile exactly
    step = max(chunk - ctx, 1)
    with torch.no_grad():
        for off in range(0, t - ctx, step):
            piece = x[off:off + chunk]
            if piece.shape[0] <= ctx:
                break
            out = model.trunk(piece[None]).x[0]  # (piece - ctx, C), float32
            count += out.shape[0]
            s1 = s1 + out.sum(0)
            s2 = s2 + (out.double() ** 2).sum(0)
        mean = s1 / count
        var = torch.clamp(s2 / count - mean.double() ** 2, min=var_floor)
        pooled = torch.cat([mean, torch.sqrt(var).float()])
        return model.head(pooled[None])["embedding_a"][0].float().cpu().numpy()


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
