"""ASR data preparation — Fisher/SWBD transcript walkers, the
CMUdict-based lexicon builder, and the Mixer 6 corpus walker.

Typed equivalents of the reference's s5-stage input producers
(`egs/sre/s5/run.sh:21-60`):

  walk_fisher      = local/fisher_data_prep.sh   (transcripts + segments)
  walk_swbd1       = local/swbd1_data_prep.sh    (+ swbd1_map_words.pl)
  map_swbd_word    = local/swbd1_map_words.pl    (word-form normalization)
  read_cmudict     = the cmudict.0.7a ingestion of
                     local/fisher_swbd_prepare_dict.sh:38-48
  build_lexicon    = local/fisher_swbd_prepare_dict.sh (vocab-limited
                     lexicon + compound expansion + noise-word prons)
  walk_mx6_mic / walk_mx6_calls / walk_mx6
                   = local/make_mx6_mic.pl / make_mx6_calls.pl / make_mx6.sh

Outputs are typed: `(Dataset, transcripts)` pairs feed `recipes.s5.run_s5`
directly (the `--text` producer), and `build_lexicon` returns an
`align.mono.Lexicon` (the `--lexicon` producer), so the whole v3/v4/v5
phonetic chain can start from raw LDC layouts with in-repo code.

Deviation (documented in docs/PARITY.md): the reference keeps multiple
CMUdict pronunciation variants per word; `align.mono.Lexicon` stores one
pronunciation per word, so `build_lexicon` keeps the FIRST variant (the
unnumbered cmudict entry).  For forced alignment this changes at most
which allophone sequence a word aligns to, not the senone inventory.

A copy of `sepi_tpu/data/asr_prep.py`; the lexicon it builds is the
port's `sepi_tpu_torch.align.Lexicon`.
"""

from __future__ import annotations

import csv
import os
import re
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .manifest import Dataset, Utterance

# ---------------------------------------------------------------------------
# Fisher (LDC2004T19/LDC2005T19 transcripts + LDC2004S13/LDC2005S13 audio)
# ---------------------------------------------------------------------------

# Stage-2 noise-token normalization of fisher_data_prep.sh:136-144.
_FISHER_TOKEN_MAP = {
    "[laugh]": "[laughter]",
    "[sigh]": "[noise]",
    "[cough]": "[noise]",
    "[mn]": "[noise]",
    "[breath]": "[noise]",
    "[lipsmack]": "[noise]",
}

_FISHER_ROW = re.compile(r"^([0-9.]+)\s+([0-9.]+) ([AB]):\s*(\S.*?)\s*$")


def normalize_fisher_words(words: Sequence[str]) -> Optional[List[str]]:
    """fisher_data_prep.sh stage-2 text cleanup on one utterance: rows
    containing '((' (uncertain-transcription spans) are dropped entirely,
    noise tokens are canonicalized, and empty results are dropped."""
    if any("((" in w for w in words):
        return None
    out = [_FISHER_TOKEN_MAP.get(w, w) for w in words]
    return out or None


def parse_fisher_transcript(path: str) -> Tuple[str, List[Tuple[float, float, str, List[str]]]]:
    """One `fe_03_NNNNN.txt` transcript -> (call_id, rows).

    Rows are `(start_sec, end_sec, side, words)` from lines shaped
    `7.38 8.78 A: an- so the topic is` (fisher_data_prep.sh:100-131);
    the header comment `# fe_03_NNNNN.sph` must match the filename.
    """
    call_id = os.path.basename(path)
    call_id = call_id[: -len(".txt")] if call_id.endswith(".txt") else call_id
    rows: List[Tuple[float, float, str, List[str]]] = []
    with open(path, errors="replace") as f:
        first = f.readline()
        m = re.search(r"#\s*(\S+)\.sph", first)
        if m and m.group(1) != call_id:
            raise ValueError(f"call-id mismatch: file {call_id} header {m.group(1)}")
        for line in f:
            m = _FISHER_ROW.match(line)
            if not m:
                continue
            rows.append((float(m.group(1)), float(m.group(2)), m.group(3),
                         m.group(4).split()))
    return call_id, rows


def _walk_files(dirs: Iterable[str], suffix: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for d in dirs:
        for root, _, files in os.walk(d, followlinks=True):
            for f in sorted(files):
                if f.lower().endswith(suffix):
                    out[f[: -len(suffix)]] = os.path.join(root, f)
    return out


def walk_fisher(
    corpus_dirs: Sequence[str],
) -> Tuple[Dataset, Dict[str, List[str]]]:
    """fisher_data_prep.sh: walk Fisher English distributions and return
    `(dataset, transcripts)`.

    ``corpus_dirs`` are the LDC roots (any split across distributions —
    the script symlinks `fe_03_data_sph` / `fe_03_tran` subdirs from each,
    fisher_data_prep.sh:50-62; a single merged directory also works).

    Utterances are `{call}-{side}-{start*100:06d}-{end*100:06d}` with
    speaker `{call}-{side}` (one conversation side = one speaker), the
    segment interval on the call recording, and channel 1/2 for side A/B
    (the sph2pipe -c mapping, fisher_data_prep.sh:166-170).  Genders come
    from the `fe_03_p*_filelist.tbl` docs when present
    (fisher_data_prep.sh:172-180).
    """
    tran_dirs = [os.path.join(d, "fe_03_tran") for d in corpus_dirs
                 if os.path.isdir(os.path.join(d, "fe_03_tran"))]
    sph_dirs = [os.path.join(d, "fe_03_data_sph") for d in corpus_dirs
                if os.path.isdir(os.path.join(d, "fe_03_data_sph"))]
    if not tran_dirs:
        raise FileNotFoundError(f"no fe_03_tran under any of {corpus_dirs}")
    transcripts_files = _walk_files(
        [os.path.join(t, "trans") for t in tran_dirs if os.path.isdir(os.path.join(t, "trans"))]
        or tran_dirs, ".txt")
    sph = _walk_files(sph_dirs, ".sph") if sph_dirs else {}

    gender: Dict[str, str] = {}
    for t in tran_dirs:
        doc = os.path.join(t, "doc")
        if not os.path.isdir(doc):
            continue
        for fn in sorted(os.listdir(doc)):
            if not re.match(r"fe_03_p\d+_filelist\.tbl$", fn):
                continue
            with open(os.path.join(doc, fn)) as f:
                for line in f:
                    m = re.match(r"^\S+\s+(\S+)\.sph\s+([fm])([fm])", line)
                    if m:
                        gender[f"{m.group(1)}-A"] = m.group(2)
                        gender[f"{m.group(1)}-B"] = m.group(3)

    utts: List[Utterance] = []
    transcripts: Dict[str, List[str]] = {}
    for call_id in sorted(transcripts_files):
        _, rows = parse_fisher_transcript(transcripts_files[call_id])
        path = sph.get(call_id)
        for start, end, side, words in rows:
            norm = normalize_fisher_words(words)
            if norm is None or end <= start:
                continue
            spk = f"{call_id}-{side}"
            utt_id = f"{call_id}-{side}-{int(round(start * 100)):06d}-{int(round(end * 100)):06d}"
            meta = [("channel", "1" if side == "A" else "2"), ("codec", "sph")]
            if spk in gender:
                meta.append(("gender", gender[spk]))
            utts.append(Utterance(
                utt_id, spk, wav=path or f"missing:{call_id}",
                recording=f"{call_id}-{side}", start=start, end=end,
                meta=tuple(meta),
            ))
            transcripts[utt_id] = norm
    return Dataset(utts, "fisher"), transcripts


# ---------------------------------------------------------------------------
# Switchboard-1 release 2 (LDC97S62)
# ---------------------------------------------------------------------------

_SWBD_SUBS: List[Tuple[re.Pattern, str]] = [
    # swbd1_map_words.pl word-form normalization (case-insensitive), in
    # the perl script's order; examples in the comments are its own.
    (re.compile(r"^(|\-)\[LAUGHTER-(.+)\](|\-)$", re.I), r"\1\2\3"),  # [LAUGHTER-STORY] -> STORY
    (re.compile(r"^\[(.+)/.+\](|\-)$"), r"\1\2"),                      # [IT'N/ISN'T] -> IT'N
    (re.compile(r"^(|\-)\[[^][]+\](.+)$"), r"-\2"),                    # -[AN]Y -> -Y
    (re.compile(r"^(.+)\[[^][]+\](|\-)$"), r"\1-"),                    # AB[SOLUTE]- -> AB-
    (re.compile(r"([^][]+)\[.+\]$"), r"\1"),                           # EX[SPECIALLY] -> EX-
    (re.compile(r"^\{(.+)\}$"), r"\1"),                                # {YUPPIEDOM} -> YUPPIEDOM
    # AMMU[N]IT- -> AMMU-IT-: the perl rule's $3 is undefined (treated
    # as empty), so the match collapses to "<last-captured-char>-"
    (re.compile(r"[A-Z]\[([^][])+\][A-Z]", re.I),
     lambda m: (m.group(1) or "") + "-"),
    (re.compile(r"_\d$"), ""),                                          # THEM_1 -> THEM
]


def map_swbd_word(word: str) -> str:
    """swbd1_map_words.pl on one token: strip partial-word / laughter /
    alternate-pronunciation markup down to the intended word form."""
    a = word
    for pat, repl in _SWBD_SUBS:
        a = pat.sub(repl, a)
    return a


_SWBD_DROP = re.compile(r"^<[BE]_ASIDE>$", re.I)


def normalize_swbd_words(words: Sequence[str]) -> Optional[List[str]]:
    """swbd1_data_prep.sh:70-84: drop [SILENCE] and the aside markers,
    map word forms, drop utterances left empty."""
    out: List[str] = []
    for w in words:
        if w.upper() == "[SILENCE]" or _SWBD_DROP.match(w):
            continue
        out.append(map_swbd_word(w))
    return out or None


def walk_swbd1(db_base: str) -> Tuple[Dataset, Dict[str, List[str]]]:
    """swbd1_data_prep.sh: Switchboard-1 transcripts + audio.

    Transcript rows in `swb_ms98_transcriptions/*/*/*-trans.text` are
    `sw2001A-ms98-a-0001 start end words...`; utterances become
    `sw0{conv}-{side}_{start*100:06.0f}-{end*100:06.0f}` with speaker =
    conversation side `sw0{conv}-{side}` (swbd1_data_prep.sh:54-60,124-128)
    and the segment interval on the recording.  Text is lowercased
    (Edinburgh variant, :50-53) and word-mapped.
    """
    sph = _walk_files([db_base], ".sph")
    tr_root = None
    for root, dirs, _ in os.walk(db_base, followlinks=True):
        if os.path.basename(root) == "swb_ms98_transcriptions":
            tr_root = root
            break
    if tr_root is None:
        raise FileNotFoundError(f"no swb_ms98_transcriptions under {db_base}")

    utts: List[Utterance] = []
    transcripts: Dict[str, List[str]] = {}
    trans_files = []
    for root, _, files in os.walk(tr_root):
        trans_files.extend(os.path.join(root, f) for f in files
                           if f.endswith("-trans.text"))
    for tf in sorted(trans_files):
        with open(tf, errors="replace") as f:
            for line in f:
                toks = line.split()
                if len(toks) < 4:
                    continue
                tag, start, end = toks[0], float(toks[1]), float(toks[2])
                # sw2001A-ms98-a-0001 -> name sw02001, side A
                m = re.match(r"^sw(\d+)([AB])", tag)
                if not m or end <= start:
                    continue
                name, side = f"sw0{m.group(1)}", m.group(2)
                words = normalize_swbd_words([w.lower() for w in toks[3:]])
                if words is None:
                    continue
                reco = f"{name}-{side}"
                utt_id = f"{reco}_{int(100 * start + 0.5):06d}-{int(100 * end + 0.5):06d}"
                path = sph.get(name)
                utts.append(Utterance(
                    utt_id, reco, wav=path or f"missing:{name}",
                    recording=reco, start=start, end=end,
                    meta=(("channel", "1" if side == "A" else "2"),
                          ("codec", "sph")),
                ))
                transcripts[utt_id] = words
    return Dataset(utts, "train_swbd"), transcripts


# ---------------------------------------------------------------------------
# CMUdict lexicon (fisher_swbd_prepare_dict.sh)
# ---------------------------------------------------------------------------

def read_cmudict(path: str) -> Dict[str, List[str]]:
    """cmudict.0.7a -> {word: first pronunciation}, lowercased, stress
    digits stripped (fisher_swbd_prepare_dict.sh:45-48 discards stress).
    `word(2)`-style alternates beyond the first are dropped (module
    docstring deviation)."""
    pron: Dict[str, List[str]] = {}
    with open(path, errors="replace") as f:
        for line in f:
            if line.startswith(";;;") or not line.strip():
                continue
            toks = line.split()
            w = toks[0].lower()
            if re.search(r"\(\d+\)$", w):
                continue  # alternate pronunciation
            phones = [re.sub(r"\d", "", p).lower() for p in toks[1:]]
            if w and phones:
                pron[w] = phones
    return pron


#: silence-class words and their dedicated phones
#: (fisher_swbd_prepare_dict.sh:35-36,50-53 + the `mm m` / `<unk> oov`
#: extras of :94-96)
NOISE_PRONS: Dict[str, List[str]] = {
    "[laughter]": ["laughter"],
    "[noise]": ["noise"],
    "<unk>": ["oov"],
}


def build_lexicon(
    transcripts: Mapping[str, Sequence[str]],
    cmudict: Mapping[str, Sequence[str]],
    extra_prons: Optional[Mapping[str, Sequence[str]]] = None,
):
    """Vocabulary-limited lexicon over the words seen in ``transcripts``
    (fisher_swbd_prepare_dict.sh:60-82): CMUdict entries for in-vocab
    words, underscore-compound expansion (`c._n._n.` -> concatenated
    letter prons) for compounds whose parts are all in CMUdict, the
    noise-word prons, and `mm -> m`.  Returns
    `(align.mono.Lexicon, oov_counts)` where ``oov_counts`` maps each
    unresolvable word to its corpus count (the oov_counts.txt analog).
    """
    from ..align.mono import Lexicon

    counts: Dict[str, int] = {}
    for words in transcripts.values():
        for w in words:
            counts[w] = counts.get(w, 0) + 1

    pron: Dict[str, List[str]] = {}
    oov: Dict[str, int] = {}
    base: Dict[str, Sequence[str]] = dict(cmudict)
    base.setdefault("mm", ["m"])
    for k, v in NOISE_PRONS.items():
        base.setdefault(k, v)
    for k, v in (extra_prons or {}).items():
        base[k] = list(v)
    for w, c in counts.items():
        if w in base:
            pron[w] = list(base[w])
            continue
        parts = w.split("_")
        if len(parts) > 1 and all(p in base for p in parts):
            pron[w] = [ph for p in parts for ph in base[p]]
            continue
        oov[w] = c
    pron.setdefault("<unk>", list(NOISE_PRONS["<unk>"]))
    return Lexicon.from_dict(pron), oov


def apply_oov(
    transcripts: Mapping[str, Sequence[str]], lexicon
) -> Dict[str, List[str]]:
    """Map words absent from ``lexicon`` to `<unk>` so alignment never
    hits a KeyError (the prepare_lang OOV handling)."""
    return {
        u: [w if w in lexicon.pron else "<unk>" for w in ws]
        for u, ws in transcripts.items()
    }


# ---------------------------------------------------------------------------
# Mixer 6 (LDC2013S03)
# ---------------------------------------------------------------------------

#: lapel-interviewer / often-silent channels make_mx6.sh:17-21 excludes
MX6_BAD_CHANNELS = ("01", "03", "14")


def _mx6_genders(db_base: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    path = os.path.join(db_base, "mx6_speech", "docs", "mx6_subjs.csv")
    with open(path) as f:
        for row in csv.reader(f):
            if len(row) >= 2 and row[1].strip().lower() in ("f", "m"):
                out[row[0].strip()] = row[1].strip().lower()
    return out


def walk_mx6_mic(db_base: str, channel: str) -> Dataset:
    """make_mx6_mic.pl: interview speech from one room microphone.

    Rows of `docs/mx6_ivcomponents.csv` name the session
    (`YYYYMMDD_HHMMSS_LDC_SUBJID`), and cols 7-8 give the interview
    speech interval; audio is `data/pcm_flac/CH{ch}/{session}_CH{ch}.flac`
    (14-channel room recording, lapel/silent channels excluded).
    Utterances are `{spk}_MX6_{date}_{time}_{ch}` with the trim interval
    as a segment (the reference's `sox ... trim t1 =t2` + 8k resample is
    left to the audio loader).
    """
    if channel in MX6_BAD_CHANNELS:
        raise ValueError(f"channel {channel} is excluded (lapel/silent)")
    flac_dir = os.path.join(db_base, "mx6_speech", "data", "pcm_flac", f"CH{channel}")
    if not os.path.isdir(flac_dir):
        raise FileNotFoundError(flac_dir)
    gender = _mx6_genders(db_base)
    utts: List[Utterance] = []
    meta_path = os.path.join(db_base, "mx6_speech", "docs", "mx6_ivcomponents.csv")
    with open(meta_path) as f:
        for row in csv.reader(f):
            if len(row) < 9:
                continue
            session = row[0].strip()
            flac = os.path.join(flac_dir, f"{session}_CH{channel}.flac")
            if not os.path.isfile(flac):
                continue
            try:
                t1, t2 = float(row[7]), float(row[8])
            except ValueError:
                continue
            toks = session.split("_")
            if len(toks) < 4:
                continue
            spk = toks[3]
            utt_id = f"{spk}_MX6_{toks[0]}_{toks[1]}_{channel}"
            meta = [("codec", "flac")]
            if spk in gender:
                meta.append(("gender", gender[spk]))
            utts.append(Utterance(
                utt_id, spk, wav=flac, recording=utt_id, start=t1, end=t2,
                meta=tuple(meta),
            ))
    return Dataset(utts, f"mx6_mic_{channel}")


def walk_mx6_calls(db_base: str) -> Dataset:
    """make_mx6_calls.pl: the telephone portion.  `docs/mx6_calls.csv`
    rows give call id (col 0) and the two subject ids (cols 4 and 12);
    audio is 2-channel u-law SPHERE under `data/ulaw_sphere/` keyed by
    the call id embedded in the filename."""
    sph_root = os.path.join(db_base, "mx6_speech", "data", "ulaw_sphere")
    if not os.path.isdir(sph_root):
        raise FileNotFoundError(sph_root)
    call2sph: Dict[str, str] = {}
    for stem, path in _walk_files([sph_root], ".sph").items():
        toks = stem.split("_")
        if len(toks) >= 3:
            call2sph[toks[2]] = path
    gender = _mx6_genders(db_base)
    utts: List[Utterance] = []
    with open(os.path.join(db_base, "mx6_speech", "docs", "mx6_calls.csv")) as f:
        for row in csv.reader(f):
            if len(row) < 13:
                continue
            call_id = row[0].strip()
            if call_id not in call2sph:
                continue
            for sid, ch, side in ((row[4].strip(), "1", "A"),
                                  (row[12].strip(), "2", "B")):
                meta = [("channel", ch), ("codec", "sph")]
                if sid in gender:
                    meta.append(("gender", gender[sid]))
                utts.append(Utterance(
                    f"{sid}_MX6_{call_id}_{side}", sid,
                    wav=call2sph[call_id], meta=tuple(meta),
                ))
    return Dataset(utts, "mx6_calls")


def walk_mx6(
    db_base: str,
    mic_channels: Sequence[str] = ("02", "04", "05", "06", "07", "08",
                                   "09", "10", "11", "12", "13"),
    mic_subset: int = 2000,
    seed: int = 0,
) -> Dataset:
    """make_mx6.sh: mic 02 in full, a ``mic_subset``-utterance random
    subset of mics 04-13 for channel diversity without duplication, plus
    the telephone calls, combined."""
    mic02 = walk_mx6_mic(db_base, mic_channels[0])
    rest_sets = [walk_mx6_mic(db_base, ch) for ch in mic_channels[1:]]
    rest = rest_sets[0]
    for d in rest_sets[1:]:
        rest = rest.combine(d)
    if mic_subset < len(rest):
        rng = np.random.default_rng(seed)
        keep = set(np.asarray(rest.utt_ids)[
            rng.permutation(len(rest))[:mic_subset]].tolist())
        rest = rest.filter(lambda u: u.utt_id in keep, "mx6_mic_04_to_13_2k")
    out = mic02.combine(rest).combine(walk_mx6_calls(db_base))
    return Dataset(list(out), "mx6")
