"""Monophone GMM-HMM forced aligner: the s5-equivalent alignment provider.

Port of `sepi_tpu/align/mono.py`.  A monophone 3-state GMM-HMM trained by
Viterbi EM with forced alignment against known transcripts (no decoding
graph, no language model).

Alignment graph per utterance (linear):
  [sil] w1_phones [opt sil] w2_phones [opt sil] ... wN_phones [sil]
each phone = ``states_per_phone`` left-to-right states with self-loops;
optional inter-word silences are skippable via skip arcs, so every
state's predecessors are {s, s-1, s-skip} and the batched banded Viterbi
(`align/viterbi_cuda.py`) aligns a whole bucket of utterances at once.

pdf-ids are (phone_index * states_per_phone + state).  Emissions are
per-pdf diagonal GMMs evaluated as one (N, num_pdf * comps) GEMM plus a
grouped logsumexp, in fp32 on the model's device (`_emissions_batch`, the
one emission function; `MonoAligner.log_emissions` and `align_utterance`
derive from it).  The M-step (`_estimate_from_alignment`) and the
backtrace are host numpy, with the reference's random draws in the same
order.  Entry points take ``device=`` (default "cuda"): the tensors'
device picks the Viterbi kernel or its plain version.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .viterbi_cuda import viterbi_batch

SIL = "sil"
_NEG = -1e30


@dataclasses.dataclass
class Lexicon:
    """word -> phone sequence; phone inventory fixed at construction."""

    pron: Dict[str, Tuple[str, ...]]
    phones: Tuple[str, ...]  # includes SIL at index 0

    @classmethod
    def from_dict(cls, pron: Mapping[str, Sequence[str]]) -> "Lexicon":
        phones = sorted({p for ps in pron.values() for p in ps} - {SIL})
        return cls({w: tuple(ps) for w, ps in pron.items()}, (SIL, *phones))

    def phone_index(self, phone: str) -> int:
        return self.phones.index(phone)

    def words_to_phones(self, words: Sequence[str]) -> List[str]:
        out: List[str] = []
        for w in words:
            if w not in self.pron:
                raise KeyError(f"OOV word {w!r}")
            out.extend(self.pron[w])
        return out


@dataclasses.dataclass
class UttGraph:
    """Linear alignment graph: per-state pdf ids + predecessor table."""

    pdf: np.ndarray  # (S,) int32
    preds: np.ndarray  # (S, 3) int32, -1 = absent; col 0 is always self
    final_states: np.ndarray  # states allowed to end the utterance
    num_states: int


def build_graph(
    lex: Lexicon,
    words: Sequence[str],
    states_per_phone: int = 3,
    optional_silence: bool = True,
) -> UttGraph:
    """[sil] w1 [sil?] w2 ... wN [sil] with skippable inter-word sil."""
    blocks: List[Tuple[int, bool]] = [(0, False)]  # (phone_idx, optional?)
    word_phones = [
        [lex.phone_index(p) for p in lex.pron[w]] if w in lex.pron else None
        for w in words
    ]
    for i, ph in enumerate(word_phones):
        if ph is None:
            raise KeyError(f"OOV word {words[i]!r}")
        for p in ph:
            blocks.append((p, False))
        if optional_silence and i < len(word_phones) - 1:
            blocks.append((0, True))
    blocks.append((0, False))

    pdf: List[int] = []
    preds: List[List[int]] = []
    prev_exits: List[int] = []  # states that can transition into next block
    for phone, optional in blocks:
        for j in range(states_per_phone):
            s = len(pdf)
            pdf.append(phone * states_per_phone + j)
            p = [s]  # self loop
            if j > 0:
                p.append(s - 1)
            else:
                p.extend(prev_exits)
            preds.append((p + [-1, -1, -1])[:3])
        exit_state = len(pdf) - 1
        if optional:
            # next block may come from this sil OR skip it entirely
            prev_exits = [exit_state] + prev_exits[:1]
        else:
            prev_exits = [exit_state]
    # first block has no external predecessor: strip the dangling entries
    preds[0] = [0, -1, -1]
    return UttGraph(
        pdf=np.asarray(pdf, np.int32),
        preds=np.asarray(preds, np.int32),
        final_states=np.asarray([len(pdf) - 1], np.int32),
        num_states=len(pdf),
    )


@dataclasses.dataclass
class MonoAligner:
    """Per-pdf diagonal-GMM emissions + per-state transition log-probs.

    The GMM arrays are fp32 tensors on the model's device; ``loop_logp``
    stays a host numpy array, since only the host-side transition tables
    read it."""

    means: torch.Tensor  # (P, C, D)
    vars: torch.Tensor  # (P, C, D)
    mix_w: torch.Tensor  # (P, C) log mixture weights
    loop_logp: np.ndarray  # (P,) self-loop log-prob, host float32
    phones: Tuple[str, ...] = ()
    states_per_phone: int = 3

    @property
    def num_pdf(self) -> int:
        return self.means.shape[0]

    @property
    def num_senones(self) -> int:
        return self.num_pdf

    @property
    def device(self) -> torch.device:
        return self.means.device

    def to(self, device: DeviceLike) -> "MonoAligner":
        dev = torch.device(device)
        if dev == self.device:
            return self
        return dataclasses.replace(self, means=self.means.to(dev), vars=self.vars.to(dev),
                                   mix_w=self.mix_w.to(dev))

    def log_emissions(self, x) -> torch.Tensor:
        """(T, D) -> (T, P) on the model's device."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        return _emissions_batch(self.means, self.vars, self.mix_w, x[None])[0]


def _backtrace(
    bps: np.ndarray, preds: np.ndarray, final_state: int, t_len: int
) -> np.ndarray:
    s = final_state
    path = np.zeros(t_len, np.int32)
    path[-1] = s
    for t in range(t_len - 2, -1, -1):
        s = preds[s, bps[t, s]]
        path[t] = s
    return path


class _GraphCache:
    def __init__(self, lex: Lexicon, states_per_phone: int):
        self.lex = lex
        self.spp = states_per_phone
        self._cache: Dict[Tuple[str, ...], UttGraph] = {}

    def get(self, words: Sequence[str]) -> UttGraph:
        key = tuple(words)
        if key not in self._cache:
            self._cache[key] = build_graph(self.lex, words, self.spp)
        return self._cache[key]


def _round_up(n: int, step: int = 32) -> int:
    return -(-n // step) * step


def _bucket_len(n: int, base: int = 256, ratio: float = 1.25) -> int:
    """Geometric padded-length ladder for the batched alignment path:
    64-frame steps up to ``base``, then ~25% steps, so few distinct
    (T, S) shapes cover a corpus and length-sorted groups waste little."""
    if n <= base:
        return _round_up(n, 64)
    b = float(base)
    while b < n:
        b *= ratio
    return _round_up(int(b), 64)


def _emissions_batch(means: torch.Tensor, vars_: torch.Tensor, mix_w: torch.Tensor,
                     feats: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (B, T, P) log diag-GMM emissions, fp32 on feats' device."""
    p, c, d = means.shape
    m = means.reshape(p * c, d)
    v = vars_.reshape(p * c, d)
    inv_v = 1.0 / v
    log2pi = torch.log(torch.tensor(2.0 * math.pi, dtype=torch.float32, device=m.device))
    const = mix_w.reshape(p * c) - 0.5 * (
        torch.log(v).sum(1) + d * log2pi + (m * m * inv_v).sum(1)
    )
    lin = torch.matmul(feats, (m * inv_v).T)
    quad = torch.matmul(feats * feats, (0.5 * inv_v).T)
    ll = const[None, None] + lin - quad  # (B, T, P*C)
    b, t = feats.shape[:2]
    return torch.logsumexp(ll.reshape(b, t, p, c), dim=3)


def align_utterance(
    aligner: MonoAligner,
    graph: UttGraph,
    feats: np.ndarray,
    return_states: bool = False,
    device: DeviceLike = "cuda",
):
    """Force-align one utterance -> per-frame pdf ids (T,): `align_graphs`
    on one graph.

    With ``return_states`` also returns the per-frame graph-state path,
    from which block/phone identity is recoverable even when the graph's
    pdf table holds tied senones (`align.tied.context_graph`)."""
    ali, states = align_graphs(aligner, {"utt": graph}, {"utt": feats}, batch_size=1,
                               return_states=True, device=device)
    if return_states:
        return ali["utt"], states["utt"]
    return ali["utt"]


def _flat_start_alignment(graph: UttGraph, t_len: int) -> np.ndarray:
    """Uniform segmentation: frames spread across all states (bootstraps EM)."""
    s = graph.num_states
    idx = np.minimum((np.arange(t_len) * s) // max(t_len, 1), s - 1)
    return graph.pdf[idx]


def _estimate_from_alignment(
    features: Mapping[str, np.ndarray],
    alignments: Mapping[str, np.ndarray],
    num_pdf: int,
    comps: int,
    phones: Tuple[str, ...],
    states_per_phone: int,
    rng: np.random.Generator,
    device: DeviceLike = "cuda",
) -> MonoAligner:
    """M-step over aligned frames (host numpy; the model lands on ``device``).

    Frame grouping is one corpus-wide stable argsort by pdf id (plus
    bincounts for the transition stats): O(N log N), never
    O(num_pdf x N).  k-means seeds are drawn pdf by pdf with ``rng``, in
    the reference's order."""
    d = next(iter(features.values())).shape[1]
    means = np.zeros((num_pdf, comps, d), np.float32)
    vars_ = np.ones((num_pdf, comps, d), np.float32)
    mix_w = np.full((num_pdf, comps), np.log(1.0 / comps), np.float32)
    loops = np.full(num_pdf, 0.0)
    counts = np.zeros(num_pdf)
    self_counts = np.zeros(num_pdf)
    adv_counts = np.zeros(num_pdf)
    utt_ids = [u for u in alignments if u in features]
    all_f = np.concatenate([features[u] for u in utt_ids])
    all_a = np.concatenate([alignments[u] for u in utt_ids]).astype(np.int64)
    order = np.argsort(all_a, kind="stable")
    sorted_f = all_f[order]
    bounds = np.searchsorted(all_a[order], np.arange(num_pdf + 1))
    for u in utt_ids:
        ali = np.asarray(alignments[u], np.int64)
        same = ali[1:] == ali[:-1]
        self_counts += np.bincount(ali[:-1][same], minlength=num_pdf)
        adv_counts += np.bincount(ali[:-1][~same], minlength=num_pdf)
    global_mean = np.mean(all_f, axis=0)
    global_var = np.var(all_f, axis=0) + 1e-3
    for p in range(num_pdf):
        x = sorted_f[bounds[p] : bounds[p + 1]]
        if len(x):
            counts[p] = len(x)
            if comps == 1 or len(x) < comps * 4:
                means[p, :] = x.mean(axis=0)
                v = x.var(axis=0) + 1e-3 if len(x) > 3 else global_var
                vars_[p, :] = np.maximum(v, 1e-3)
            else:
                # k-means-lite: random frame seeds + one assignment pass
                seeds = x[rng.choice(len(x), comps, replace=False)]
                d2 = ((x[:, None, :] - seeds[None]) ** 2).sum(-1)
                a = d2.argmin(1)
                for ci in range(comps):
                    xc = x[a == ci]
                    if len(xc) > 3:
                        means[p, ci] = xc.mean(axis=0)
                        vars_[p, ci] = np.maximum(xc.var(axis=0), 1e-3)
                        # floored at log(1e-3): no mixture row is all -inf
                        mix_w[p, ci] = np.log(max(len(xc) / len(x), 1e-3))
                    else:
                        means[p, ci] = x.mean(axis=0)
                        vars_[p, ci] = np.maximum(x.var(axis=0), 1e-3)
                mix_w[p] -= np.log(np.exp(mix_w[p]).sum())
        else:
            means[p, :] = global_mean
            vars_[p, :] = global_var
        tot = self_counts[p] + adv_counts[p]
        loop_p = self_counts[p] / tot if tot else 0.5
        loops[p] = np.log(np.clip(loop_p, 0.05, 0.95))
    dev = torch.device(device)
    return MonoAligner(
        torch.as_tensor(means, device=dev),
        torch.as_tensor(vars_, device=dev),
        torch.as_tensor(mix_w, device=dev),
        loops.astype(np.float32),
        phones,
        states_per_phone,
    )


def train_mono_aligner(
    features: Mapping[str, np.ndarray],
    transcripts: Mapping[str, Sequence[str]],
    lexicon: Lexicon,
    num_iters: int = 4,
    states_per_phone: int = 3,
    comps_per_state: int = 2,
    seed: int = 0,
    batched: bool = True,
    log=None,
    device: DeviceLike = "cuda",
) -> MonoAligner:
    """Flat-start + Viterbi-EM monophone training (train_mono.sh analog);
    each EM re-alignment goes through the bucketed batched Viterbi, with
    ``batched`` either way (`align_corpus`)."""
    import time as _time

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    cache = _GraphCache(lexicon, states_per_phone)
    num_pdf = len(lexicon.phones) * states_per_phone
    alignments = {
        u: _flat_start_alignment(cache.get(transcripts[u]), features[u].shape[0])
        for u in features
        if u in transcripts
    }
    aligner = _estimate_from_alignment(
        features, alignments, num_pdf, 1, lexicon.phones, states_per_phone, rng, dev
    )
    aligned = {u: features[u] for u in alignments}
    for it in range(num_iters):
        t0 = _time.time()
        comps = 1 if it < num_iters // 2 else comps_per_state
        alignments = align_corpus(aligner, aligned, transcripts, lexicon, batched=batched,
                                  device=dev)
        aligner = _estimate_from_alignment(
            features, alignments, num_pdf, comps, lexicon.phones, states_per_phone, rng, dev
        )
        if log:
            log(f"[mono] EM iter {it + 1}/{num_iters} "
                f"({comps} comp/state, {_time.time() - t0:.0f}s)")
    return aligner


def align_corpus(
    aligner: MonoAligner,
    features: Mapping[str, np.ndarray],
    transcripts: Mapping[str, Sequence[str]],
    lexicon: Lexicon,
    batched: bool = False,
    batch_size: int = 32,
    device: DeviceLike = "cuda",
) -> Dict[str, np.ndarray]:
    """Forced alignment for every utterance -> {utt: (T,) pdf ids}, in
    length-sorted batches of ``batch_size`` through the Viterbi kernel
    (`align_graphs`).  ``batched`` is the reference's choice between its
    per-utterance scan and its batched Viterbi, which it holds equal
    (`tests/test_align.py:190`); here both values take the kernel, and the
    alignments do not depend on it."""
    cache = _GraphCache(lexicon, aligner.states_per_phone)
    graphs = {u: cache.get(transcripts[u]) for u in features if u in transcripts}
    return align_graphs(aligner, graphs, features, batch_size, device=device)


def _utt_tables(aligner: MonoAligner, graph: UttGraph, s_pad: int):
    """(pdf, preds, trans (3, S)) padded tables for the batched path."""
    pdf = np.zeros(s_pad, np.int32)
    pdf[: graph.num_states] = graph.pdf
    preds = np.full((s_pad, 3), -1, np.int32)
    preds[: graph.num_states] = graph.preds
    loop = aligner.loop_logp
    trans = np.full((3, s_pad), _NEG, np.float32)
    for s in range(graph.num_states):
        for j, p in enumerate(graph.preds[s]):
            if p < 0:
                continue
            if p == s:
                trans[0, s] = loop[graph.pdf[s]]
            else:
                lp = loop[graph.pdf[p]]
                trans[j, s] = float(np.log1p(-np.exp(min(lp, -1e-4))))
    return pdf, preds, trans


def _check_banded(graph: UttGraph, skip: int) -> None:
    """The shift recursion's invariant: preds columns are {s, s-1, s-skip}."""
    ss = np.arange(graph.num_states)
    if not (np.all((graph.preds[:, 1] == -1) | (graph.preds[:, 1] == ss - 1))
            and np.all((graph.preds[:, 2] == -1) | (graph.preds[:, 2] == ss - skip))):
        raise ValueError("graph is not banded: predecessors outside {s, s-1, s-skip}")


def align_graphs(
    aligner: MonoAligner,
    graphs: Mapping[str, UttGraph],
    features: Mapping[str, np.ndarray],
    batch_size: int = 32,
    return_states: bool = False,
    device: DeviceLike = "cuda",
):
    """Batched forced alignment over arbitrary per-utterance graphs.

    Monophone graphs and tied-senone context graphs
    (`align.tied.context_graph`) share this path; only the pdf tables
    differ.  Utterances are sorted by length and grouped by ``batch_size``;
    each group is padded to a ``_bucket_len`` frame count and a 128-multiple
    state count.  Per group: one emission GEMM, a per-state gather along the
    pdf axis and the batched Viterbi, all on ``device``; only the int8
    backpointers and the final scores come back for the host backtrace."""
    dev = resolve_device(device)
    model = aligner.to(dev)
    skip = aligner.states_per_phone + 1
    items = [(u, graphs[u], features[u].shape[0]) for u in features if u in graphs]
    items.sort(key=lambda x: (x[2], x[1].num_states))
    out: Dict[str, np.ndarray] = {}
    states_out: Dict[str, np.ndarray] = {}
    for i0 in range(0, len(items), batch_size):
        group = items[i0 : i0 + batch_size]
        t_pad = _bucket_len(max(x[2] for x in group))
        s_pad = _round_up(max(x[1].num_states for x in group), 128)
        b = len(group)
        d = features[group[0][0]].shape[1]
        feats_p = np.zeros((b, t_pad, d), np.float32)
        tlen = np.zeros(b, np.int32)
        pdf_idx = np.zeros((b, s_pad), np.int64)
        trans = np.zeros((b, 3, s_pad), np.float32)
        tables = []
        for j, (u, g, t_len) in enumerate(group):
            _check_banded(g, skip)
            feats_p[j, :t_len] = features[u]
            pdf, preds, tr = _utt_tables(aligner, g, s_pad)
            tlen[j] = t_len
            pdf_idx[j] = pdf  # padded states read pdf 0, as the reference
            trans[j] = tr
            tables.append((pdf, preds, g))
        e_all = _emissions_batch(model.means, model.vars, model.mix_w,
                                 torch.as_tensor(feats_p, device=dev))  # (b, t_pad, P)
        tlen_t = torch.as_tensor(tlen, device=dev)
        idx = torch.as_tensor(pdf_idx, device=dev)[:, None, :].expand(b, t_pad, s_pad)
        emit = torch.gather(e_all, 2, idx)
        live = torch.arange(t_pad, device=dev)[None, :, None] < tlen_t[:, None, None]
        emit = torch.where(live, emit, torch.full((), _NEG, device=dev)).contiguous()
        bps, delta = viterbi_batch(emit, tlen_t, torch.as_tensor(trans, device=dev), skip)
        bps = bps.cpu().numpy()
        delta = delta.cpu().numpy()
        for j, (u, g, t_len) in enumerate(group):
            pdf, preds, graph = tables[j]
            final = int(graph.final_states[0])
            if delta[j, final] < _NEG / 2:
                raise ValueError(
                    f"unalignable utterance {u}: {t_len} frames for "
                    f"{graph.num_states} states"
                )
            states = _backtrace(bps[j], preds, final, t_len)
            out[u] = pdf[states]
            if return_states:
                states_out[u] = states
    if return_states:
        return out, states_out
    return out
