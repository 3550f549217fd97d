"""Tree-clustered context-dependent senones (the tri6a_4k equivalent).

Port of `sepi_tpu/align/tied.py`.  The monophone aligner (align.mono)
caps senone granularity at 3 x #phones; this module lifts it to a leaf
budget with likelihood-based state tying:

1. monophone align the corpus (align.mono),
2. for every aligned frame derive its (left, center, state, right)
   context from the realized phone sequence,
3. greedily split (center, state) populations by set-membership
   questions on the left/right context, choosing at each step the
   global split with the largest single-Gaussian log-likelihood gain,
   until ``num_leaves`` is reached,
4. leaves are the senone ids; re-estimate per-senone GMM emissions and
   re-align with context-dependent graphs (same banded Viterbi; only the
   pdf table of each utterance graph changes).

Tree building and the context statistics are host numpy, as in the
reference; alignment passes run on ``device`` (default "cuda").
Simplifications vs Kaldi's tree: questions are data-derived phone
bisections per node; silence stays context-independent; cross-word
context looks through optional silence.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device
from .mono import (
    Lexicon,
    MonoAligner,
    UttGraph,
    _estimate_from_alignment,
    _GraphCache,
    align_graphs,
    build_graph,
    train_mono_aligner,
)


@dataclasses.dataclass
class _Node:
    """Decision-tree node for one (center_phone, hmm_state)."""

    leaf_id: int = -1
    side: str = ""  # 'l' or 'r'
    phone_set: frozenset = frozenset()
    yes: Optional["_Node"] = None
    no: Optional["_Node"] = None

    def lookup(self, l: int, r: int) -> int:
        node = self
        while node.leaf_id < 0:
            ctx = l if node.side == "l" else r
            node = node.yes if ctx in node.phone_set else node.no
        return node.leaf_id


@dataclasses.dataclass
class TiedTree:
    """(center_phone, state) -> context decision tree; sil untied."""

    roots: Dict[Tuple[int, int], _Node]
    num_leaves: int
    states_per_phone: int
    num_phones: int

    def senone(self, l: int, c: int, state: int, r: int) -> int:
        return self.roots[(c, state)].lookup(l, r)

    def dense_table(self) -> np.ndarray:
        """(num_phones, spp, num_phones, num_phones) senone lookup table,
        built once: per-frame tree walks become one fancy-index."""
        if not hasattr(self, "_table"):
            p, s = self.num_phones, self.states_per_phone
            tbl = np.zeros((p, s, p, p), np.int32)
            for c in range(p):
                for st in range(s):
                    for l in range(p):
                        for r in range(p):
                            tbl[c, st, l, r] = self.senone(l, c, st, r)
            self._table = tbl
        return self._table


class _Gauss:
    """Diagonal single-Gaussian sufficient stats for LL-gain scoring."""

    __slots__ = ("n", "s1", "s2")

    def __init__(self, d):
        self.n = 0.0
        self.s1 = np.zeros(d)
        self.s2 = np.zeros(d)

    def add(self, other):
        self.n += other.n
        self.s1 += other.s1
        self.s2 += other.s2

    def ll(self) -> float:
        if self.n < 2:
            return 0.0
        mean = self.s1 / self.n
        var = np.maximum(self.s2 / self.n - mean**2, 1e-4)
        d = len(mean)
        return float(-0.5 * self.n * (np.sum(np.log(var)) + d * (1 + np.log(2 * np.pi))))


def _best_split(stats: Dict[Tuple[int, int], _Gauss], d: int):
    """Best (side, phone_set) bisection of a node's context population:
    per side, order the context phones by their mean along the parent's
    top-variance dimension and scan the ordered bisections."""
    parent = _Gauss(d)
    for g in stats.values():
        parent.add(g)
    base = parent.ll()
    best = None
    for side_idx, side in ((0, "l"), (1, "r")):
        by_phone: Dict[int, _Gauss] = {}
        for (l, r), g in stats.items():
            p = (l, r)[side_idx]
            if p not in by_phone:
                by_phone[p] = _Gauss(d)
            by_phone[p].add(g)
        if len(by_phone) < 2:
            continue
        mean = parent.s1 / max(parent.n, 1)
        var = np.maximum(parent.s2 / max(parent.n, 1) - mean**2, 1e-8)
        dim = int(np.argmax(var))
        order = sorted(by_phone, key=lambda p: by_phone[p].s1[dim] / max(by_phone[p].n, 1))
        left = _Gauss(d)
        acc = []
        for p in order[:-1]:
            left.add(by_phone[p])
            acc.append(p)
            right = _Gauss(d)
            right.n = parent.n - left.n
            right.s1 = parent.s1 - left.s1
            right.s2 = parent.s2 - left.s2
            gain = left.ll() + right.ll() - base
            if best is None or gain > best[0]:
                best = (gain, side, frozenset(acc))
    return best  # (gain, side, phone_set) or None


def build_tied_tree(
    context_stats: Mapping[Tuple[int, int], Dict[Tuple[int, int], _Gauss]],
    num_leaves: int,
    states_per_phone: int,
    num_phones: int,
    min_count: float = 100.0,
) -> TiedTree:
    """Global greedy splitting with a priority queue over candidate gains."""
    roots: Dict[Tuple[int, int], _Node] = {}
    next_leaf = 0
    heap: List = []
    counter = 0

    def make_leaf(stats):
        nonlocal next_leaf, counter
        node = _Node(leaf_id=next_leaf)
        next_leaf += 1
        d = len(next(iter(stats.values())).s1) if stats else 1
        total = sum(g.n for g in stats.values())
        if stats and total >= 2 * min_count:
            split = _best_split(stats, d)
            if split and split[0] > 0:
                heapq.heappush(heap, (-split[0], counter, node, split, stats))
                counter += 1
        return node

    for key, stats in sorted(context_stats.items()):
        roots[key] = make_leaf(stats)

    while heap and next_leaf < num_leaves:
        neg_gain, _, node, (gain, side, phone_set), stats = heapq.heappop(heap)
        if node.leaf_id < 0:
            continue  # already split
        yes_stats = {
            ctx: g for ctx, g in stats.items()
            if (ctx[0] if side == "l" else ctx[1]) in phone_set
        }
        no_stats = {ctx: g for ctx, g in stats.items() if ctx not in yes_stats}
        if sum(g.n for g in yes_stats.values()) < min_count or (
            sum(g.n for g in no_stats.values()) < min_count
        ):
            continue
        # convert this leaf into an internal node; reuse its id for 'no'
        node.side = side
        node.phone_set = phone_set
        old_id = node.leaf_id
        node.leaf_id = -1
        node.no = _Node(leaf_id=old_id)
        node.yes = make_leaf(yes_stats)
        # re-queue the 'no' child
        d = len(next(iter(no_stats.values())).s1) if no_stats else 1
        if no_stats and sum(g.n for g in no_stats.values()) >= 2 * min_count:
            split = _best_split(no_stats, d)
            if split and split[0] > 0:
                heapq.heappush(heap, (-split[0], counter, node.no, split, no_stats))
                counter += 1
    return TiedTree(roots, next_leaf, states_per_phone, num_phones)


def _block_contexts(graph: UttGraph, spp: int) -> np.ndarray:
    """(num_blocks, 2) left/right phone context per block, looking
    through optional silence (sil at utterance edges)."""
    phones = graph.pdf.reshape(-1, spp)[:, 0] // spp
    nb = len(phones)
    ctx = np.zeros((nb, 2), np.int32)
    for i in range(nb):
        l = 0
        for j in range(i - 1, -1, -1):
            if phones[j] != 0:
                l = phones[j]
                break
        r = 0
        for j in range(i + 1, nb):
            if phones[j] != 0:
                r = phones[j]
                break
        ctx[i] = (l, r)
    return ctx


@dataclasses.dataclass
class TiedAligner:
    """Context-dependent aligner: mono acoustic front + tied senone map."""

    mono: MonoAligner
    tree: TiedTree
    lexicon: Lexicon

    @property
    def num_senones(self) -> int:
        return self.tree.num_leaves

    def senone_alignments(
        self,
        features: Mapping[str, np.ndarray],
        transcripts: Mapping[str, Sequence[str]],
        batched: bool = False,
        device: DeviceLike = "cuda",
    ) -> Dict[str, np.ndarray]:
        """Forced alignment -> per-frame tied-senone ids, vectorized per
        utterance: the graph state path gives block indices, and the dense
        tree table turns context lookups into one fancy-index.  Both
        values of ``batched`` align through the Viterbi kernel
        (`mono.align_corpus`); the result does not depend on it."""
        spp = self.mono.states_per_phone
        cache = _GraphCache(self.lexicon, spp)
        graphs = {u: cache.get(transcripts[u]) for u in features if u in transcripts}
        mono_ali, states = align_graphs(
            self.mono, graphs, features, return_states=True, device=device
        )
        table = self.tree.dense_table()
        out: Dict[str, np.ndarray] = {}
        for u, pdf_path in mono_ali.items():
            graph = graphs[u]
            ctx = _block_contexts(graph, spp)
            blocks = states[u] // spp
            phone = pdf_path // spp
            state = pdf_path % spp
            l = np.where(phone == 0, 0, ctx[blocks, 0])
            r = np.where(phone == 0, 0, ctx[blocks, 1])
            out[u] = table[phone, state, l, r].astype(np.int32)
        return out


def context_graph(
    lexicon: Lexicon, words: Sequence[str], tree: TiedTree, spp: int
) -> UttGraph:
    """Alignment graph whose pdf table is tied-senone ids: the monophone
    topology with per-state pdfs from a tree lookup on the canonical
    through-silence context."""
    g = build_graph(lexicon, words, spp)
    ctx = _block_contexts(g, spp)
    pdf = np.zeros_like(g.pdf)
    for s in range(g.num_states):
        phone, state = int(g.pdf[s] // spp), int(g.pdf[s] % spp)
        blk = s // spp
        if phone == 0:
            pdf[s] = tree.senone(0, 0, state, 0)
        else:
            l, r = ctx[blk]
            pdf[s] = tree.senone(int(l), phone, state, int(r))
    return UttGraph(pdf=pdf, preds=g.preds, final_states=g.final_states,
                    num_states=g.num_states)


@dataclasses.dataclass
class RefineResult:
    """Output of the context-dependent re-alignment pass.

    ``alignments`` are per-frame tied-senone ids; ``phone_alignments``
    the per-frame phone indices recovered from the graph state path;
    ``frames_shifted`` the per-iteration fraction of frames whose senone
    changed vs the previous pass."""

    model: MonoAligner  # senone-level acoustic model (pdf bank)
    alignments: Dict[str, np.ndarray]
    phone_alignments: Dict[str, np.ndarray]
    frames_shifted: List[float]


def refine_tied_aligner(
    tied: TiedAligner,
    features: Mapping[str, np.ndarray],
    transcripts: Mapping[str, Sequence[str]],
    num_iters: int = 2,
    comps_per_senone: int = 2,
    seed: int = 0,
    batched: bool = True,
    init_alignments: Optional[Mapping[str, np.ndarray]] = None,
    log=None,
    device: DeviceLike = "cuda",
) -> RefineResult:
    """Viterbi-EM refinement at senone granularity (the tri-pass analog,
    `egs/sre/s5/run.sh:108-202`, `steps/align_si.sh`): re-estimate
    per-senone GMM emissions from the tied alignment and re-align with
    tied-pdf context graphs, ``num_iters`` rounds.

    ``init_alignments`` bootstraps EM from given senone labels instead of
    re-aligning with the (raw-feature-space) mono front: required when
    ``features`` live in a transformed space (LDA+MLLT).  ``batched``
    changes nothing (`mono.align_corpus`)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    spp = tied.mono.states_per_phone
    ali = (dict(init_alignments) if init_alignments is not None
           else tied.senone_alignments(features, transcripts, batched=batched, device=dev))
    graphs = {
        u: context_graph(tied.lexicon, transcripts[u], tied.tree, spp)
        for u in features
        if u in transcripts
    }
    # per-state phone table (topology shared with the mono graph)
    mono_cache = _GraphCache(tied.lexicon, spp)
    state_phone = {
        u: mono_cache.get(transcripts[u]).pdf // spp for u in graphs
    }
    model = None
    states: Dict[str, np.ndarray] = {}
    shifts: List[float] = []
    for it in range(num_iters):
        model = _estimate_from_alignment(
            features, ali, tied.num_senones, comps_per_senone, (), spp, rng, dev
        )
        new_ali, states = align_graphs(
            model, graphs, features, return_states=True, device=dev
        )
        changed = sum(int(np.sum(new_ali[u] != ali[u])) for u in new_ali)
        total = sum(len(a) for a in new_ali.values())
        shifts.append(changed / max(total, 1))
        ali = new_ali
        if log:
            log(f"[tied] refine iter {it + 1}/{num_iters}: "
                f"{shifts[-1] * 100:.1f}% frames shifted")
    phones = {u: state_phone[u][states[u]] for u in states}
    return RefineResult(model, ali, phones, shifts)


def train_tied_aligner(
    features: Mapping[str, np.ndarray],
    transcripts: Mapping[str, Sequence[str]],
    lexicon: Lexicon,
    num_leaves: int = 2048,
    mono_iters: int = 4,
    min_count: float = 100.0,
    states_per_phone: int = 3,
    seed: int = 0,
    batched: bool = True,
    log=None,
    device: DeviceLike = "cuda",
) -> TiedAligner:
    """Mono training + context-stat collection + tree building.
    ``batched`` changes nothing (`mono.align_corpus`)."""
    dev = resolve_device(device)
    mono = train_mono_aligner(
        features, transcripts, lexicon, mono_iters, states_per_phone, seed=seed,
        batched=batched, log=log, device=dev,
    )
    if log:
        log("[tied] collecting context stats")
    spp = states_per_phone
    cache = _GraphCache(lexicon, spp)
    graphs = {u: cache.get(transcripts[u]) for u in features if u in transcripts}
    ali, states = align_graphs(mono, graphs, features, return_states=True, device=dev)
    d = next(iter(features.values())).shape[1]
    num_phones = len(lexicon.phones)

    # Context-conditioned single-Gaussian stats, accumulated into dense
    # flat-keyed arrays with np.add.at.  Key =
    # ((phone*spp + state)*P + l)*P + r.
    k_flat = num_phones * spp * num_phones * num_phones
    counts = np.zeros(k_flat)
    s1 = np.zeros((k_flat, d))
    s2 = np.zeros((k_flat, d))
    for u, pdf_path in ali.items():
        ctx = _block_contexts(graphs[u], spp)
        blocks = states[u] // spp
        phone = pdf_path // spp
        state = pdf_path % spp
        l = np.where(phone == 0, 0, ctx[blocks, 0])
        r = np.where(phone == 0, 0, ctx[blocks, 1])
        key = ((phone.astype(np.int64) * spp + state) * num_phones + l) * num_phones + r
        f = features[u].astype(np.float64)
        np.add.at(counts, key, 1.0)
        np.add.at(s1, key, f)
        np.add.at(s2, key, f * f)

    stats: Dict[Tuple[int, int], Dict[Tuple[int, int], _Gauss]] = {}
    for c in range(num_phones):
        for s in range(spp):
            stats[(c, s)] = {}
    for k in np.nonzero(counts)[0]:
        r = int(k % num_phones)
        l = int((k // num_phones) % num_phones)
        state = int((k // (num_phones * num_phones)) % spp)
        phone = int(k // (num_phones * num_phones * spp))
        g = _Gauss(d)
        g.n = float(counts[k])
        g.s1 = s1[k]
        g.s2 = s2[k]
        stats[(phone, state)][(l, r)] = g
    tree = build_tied_tree(stats, num_leaves, spp, num_phones, min_count)
    return TiedAligner(mono, tree, lexicon)
