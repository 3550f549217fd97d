"""LDC corpus walkers — typed equivalents of the reference's data-prep
scripts (`local/make_sre.pl`, `make_sre08.pl`, `make_sre10.pl`,
`make_sre16_eval.pl`,
`make_sre16_unlabeled.pl`, `make_swbd_cellular{1,2}.pl`,
`make_swbd2_phase{1,2,3}.pl`, `make_musan.py` — SURVEY.md §2.3 "data
prep (corpora)").  Each walker reads the documented LDC distribution
layout and returns typed `Dataset`s (and `Trial` lists where the
distribution ships keys), instead of emitting shell data-dirs.

Audio references: LDC speech ships as 2-channel NIST SPHERE (.sph); the
reference pipes through `sph2pipe -f wav -p -c N`.  Here each utterance
keeps ``wav`` = the .sph path with ``meta`` ``("channel", "1"|"2")`` and
``("codec", "sph")``; `AudioStore.load_dataset` decodes these natively
(native/sphere.cc: PCM/mu-law/A-law + embedded-shorten — the sph2pipe
equivalent), honoring the channel meta.  MUSAN is plain wav and loads
directly.  Gender rides in ``meta`` ("gender", "m"|"f") replacing
spk2gender files.

A copy of `sepi_tpu/data/ldc.py` on the port's own `Dataset`.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

from .manifest import Dataset, Trial, Utterance


def _find_by_stem(db_base: str, suffix: str = ".sph") -> Dict[str, str]:
    """Recursive file walk -> {basename-without-extension: path} (the
    `find -name '*.sph'` + stem-split every walker starts with)."""
    out: Dict[str, str] = {}
    for root, _, files in os.walk(db_base, followlinks=True):
        for f in files:
            if f.endswith(suffix):
                out[f.split(".")[0]] = os.path.join(root, f)
    return out


def _sph_utt(utt_id, spk, path, channel, gender=None, extra=()):
    meta = [("channel", str(channel)), ("codec", "sph")]
    if gender:
        meta.append(("gender", gender))
    meta.extend(extra)
    return Utterance(utt_id, spk, wav=path, meta=tuple(meta))


def walk_sre(
    db_base: str,
    sre_year: str,
    sre_ref_path: str,
    name: Optional[str] = None,
) -> Dataset:
    """make_sre.pl: SRE 2004-2008 via the combined `sre_ref` key file.

    ``sre_ref`` rows: `<speaker> <gender> sre20YY <utt_id> <A|B>`;
    utterances become `{spk}-sre{YY}-{utt}-{a|b}` with channel A->1,
    B->2.  ``sre_year`` is the two-digit year ('04', '05', ...).
    """
    utt2sph = _find_by_stem(db_base)
    utts: List[Utterance] = []
    with open(sre_ref_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 5:
                continue
            speaker, gender, other_year, utt_id, channel = parts[:5]
            if other_year != f"sre20{sre_year}" or utt_id not in utt2sph:
                continue
            ch = "1" if channel == "A" else "2"
            utts.append(_sph_utt(
                f"{speaker}-sre{sre_year}-{utt_id}-{channel.lower()}",
                speaker, utt2sph[utt_id], ch, gender,
            ))
    return Dataset(utts, name or f"sre20{sre_year}")


def walk_sre08(
    db_base_test: str,
    db_base_train: str,
    keys_rel: str = "data/keys/NIST_SRE08_KEYS.v0.1",
    condition: str = "short2-short3",
) -> Dataset:
    """make_sre08.pl: SRE08 test (LDC2011S08) + enroll (LDC2011S05) into
    ONE dataset, driven by the NIST key files under the test release.

    Layout: `.sph` audio under `{test,train}/data/**`; model key
    `{keys_rel}/model-keys/NIST_SRE08_{short2}.model.key` rows
    `model,gender,seg:ch,sid` (one enrollment segment per model, gender
    per NIST speaker id); trial key
    `{keys_rel}/trial-keys/NIST_SRE08_{condition}.trial.key` rows
    `model,seg,ch,target,...` — every *target* trial whose model maps to
    a speaker contributes `{sid}_SRE08_{seg}_{A|B}` (like make_sre10.pl,
    this builds PLDA *training* data, not an eval set).
    """
    seg2sph = _find_by_stem(os.path.join(db_base_test, "data"))
    seg2sph.update(_find_by_stem(os.path.join(db_base_train, "data")))
    model_cond = condition.split("-")[0]
    model_key = os.path.join(
        db_base_test, keys_rel, "model-keys",
        f"NIST_SRE08_{model_cond}.model.key")
    trial_key = os.path.join(
        db_base_test, keys_rel, "trial-keys",
        f"NIST_SRE08_{condition}.trial.key")

    utts: Dict[str, Utterance] = {}
    model2sid: Dict[str, str] = {}
    sid2gender: Dict[str, str] = {}

    def add(sid: str, seg: str, ch: str) -> None:
        if ch not in ("a", "b"):
            raise ValueError(f"malformed SRE08 key channel: {ch!r}")
        if seg not in seg2sph:
            return
        utt = f"{sid}_SRE08_{seg}_{ch.upper()}"
        utts[utt] = _sph_utt(utt, sid, seg2sph[seg],
                             "1" if ch == "a" else "2", sid2gender.get(sid))

    with open(model_key) as f:
        for line in f:
            toks = line.strip().split(",")
            if len(toks) < 4:
                continue
            model, gender, seg_ch, sid = toks[:4]
            seg, _, ch = seg_ch.partition(":")
            model2sid[model] = sid
            sid2gender[sid] = gender
            add(sid, seg, ch)
    with open(trial_key) as f:
        for line in f:
            toks = line.strip().split(",")
            if len(toks) < 4:
                continue
            model, seg, ch, target = toks[:4]
            if target == "target" and model in model2sid:
                add(model2sid[model], seg, ch)
    return Dataset(list(utts.values()), "sre08")


def walk_sre10(db_base: str, condition: str = "coreext") -> Dataset:
    """make_sre10.pl: SRE10 *training* data from the target trials.

    Layout: `data/**.sph`, `train/{condition}.trn`
    (`model gender path/seg:CH`), `keys/{condition}.modelkey.csv`
    (`model,speaker-id` with NOT_SCORED rows dropped), and
    `keys/{condition}-{condition}.trialkey.csv`
    (`model,seg,ch,target,...`): every *target* trial whose model maps to
    a speaker contributes `{sid}_SRE10_{seg}_{A|B}`.
    """
    seg2sph = _find_by_stem(os.path.join(db_base, "data"))
    model2sid: Dict[str, str] = {}
    with open(os.path.join(db_base, "keys", f"{condition}.modelkey.csv")) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) >= 2 and parts[1] != "NOT_SCORED":
                model2sid[parts[0]] = parts[1]
    utts: Dict[str, Utterance] = {}
    key = os.path.join(db_base, "keys", f"{condition}-{condition}.trialkey.csv")
    with open(key) as f:
        for line in f:
            toks = line.strip().split(",")
            if len(toks) < 4:
                continue
            model, seg, ch, target = toks[:4]
            if target != "target" or model not in model2sid or seg not in seg2sph:
                continue
            sid = model2sid[model]
            if ch not in ("a", "b"):
                raise ValueError(f"malformed trial row: {line!r}")
            utt = f"{sid}_SRE10_{seg}_{ch.upper()}"
            utts[utt] = _sph_utt(utt, sid, seg2sph[seg], "1" if ch == "a" else "2")
    return Dataset(list(utts.values()), "sre10")


def walk_sre16_eval(
    db_base: str,
) -> Tuple[Dataset, Dataset, Dict[str, List[Trial]]]:
    """make_sre16_eval.pl: (enroll, test, trials by condition).

    Layout: `docs/sre16_eval_enrollment.tsv` (spk seg ...),
    `data/enrollment/**.sph`, `data/test/**.sph`,
    `docs/sre16_eval_trial_key.tsv` (spk seg _ target ...),
    `docs/sre16_eval_segment_key.tsv` (seg call),
    `metadata/calls.tsv` (call language).  Trials split into pooled /
    tgl / yue by the call language (`v2/run_sre16.sh:113-117`).
    """
    enroll_sph = _find_by_stem(os.path.join(db_base, "data", "enrollment"))
    test_sph = _find_by_stem(os.path.join(db_base, "data", "test"))

    enroll_utts: List[Utterance] = []
    with open(os.path.join(db_base, "docs", "sre16_eval_enrollment.tsv")) as f:
        for line in f:
            toks = line.split()
            if len(toks) < 2 or toks[1] == "segment":
                continue
            spk, seg = toks[0], toks[1]
            if seg in enroll_sph:
                enroll_utts.append(
                    _sph_utt(f"{spk}-{seg}", spk, enroll_sph[seg], "1")
                )

    def read_map(path):
        out = {}
        with open(path) as f:
            for line in f:
                toks = line.split()
                if len(toks) >= 2:
                    out[toks[0]] = toks[1]
        return out

    utt2call = read_map(os.path.join(db_base, "docs", "sre16_eval_segment_key.tsv"))
    call2lang = read_map(os.path.join(db_base, "metadata", "calls.tsv"))

    test_utts = [
        _sph_utt(seg, seg, path, "1",
                 extra=(("lang", call2lang.get(utt2call.get(seg, ""), "")),))
        for seg, path in sorted(test_sph.items())
    ]

    trials: Dict[str, List[Trial]] = {"pooled": [], "tgl": [], "yue": []}
    unknown_lang: set = set()
    with open(os.path.join(db_base, "docs", "sre16_eval_trial_key.tsv")) as f:
        for line in f:
            toks = line.split()
            if len(toks) < 4 or toks[1] == "segment":
                continue
            spk, seg, target = toks[0], toks[1], toks[3]
            t = Trial(spk, seg, target == "target")
            trials["pooled"].append(t)
            lang = call2lang.get(utt2call.get(seg, ""), "")
            if lang in ("tgl", "yue"):
                trials[lang].append(t)
            else:
                # missing/unknown language metadata: the trial still
                # counts toward pooled (one absent calls.tsv row must not
                # abort the whole walk); it just joins no language split
                unknown_lang.add(seg)
    if unknown_lang:
        print(f"walk_sre16_eval: {len(unknown_lang)} test segments with "
              "missing/unknown language metadata (pooled-only)")
    return (
        Dataset(enroll_utts, "sre16_eval_enroll"),
        Dataset(test_utts, "sre16_eval_test"),
        trials,
    )


def walk_sre16_unlabeled(db_base: str) -> Tuple[Dataset, Dataset]:
    """make_sre16_unlabeled.pl: (major, minor) unlabeled in-domain sets
    under `data/unlabeled/{major,minor}/**.sph` — the PLDA-adaptation
    input of `v2/run_sre16.sh:96-103`."""
    out = []
    for subset in ("major", "minor"):
        sph = _find_by_stem(os.path.join(db_base, "data", "unlabeled", subset))
        out.append(Dataset(
            [_sph_utt(seg, seg, path, "1") for seg, path in sorted(sph.items())],
            f"sre16_{subset}",
        ))
    return out[0], out[1]


def walk_swbd_cellular(
    db_base: str,
    stats_rel: str = "doc/swb_callstats.tbl",
    bad_audio: Sequence[str] = ("40019", "45024", "40022"),
    name: str = "swbd_cellular1",
) -> Dataset:
    """make_swbd_cellular{1,2}.pl: the call-stats table drives both
    sides of every call.  Rows: `id,spkA,spkB,genderA,genderB,...`;
    audio `sw_{id}.sph`; utterances `sw_{spk}-swbdc_sw_{id}_{1,2}`."""
    sph = _find_by_stem(db_base)
    utts: Dict[str, Utterance] = {}
    with open(os.path.join(db_base, stats_rel)) as f:
        for line in f:
            a = line.strip().split(",")
            if len(a) < 5 or a[0] in bad_audio:
                continue
            wav = f"sw_{a[0]}"
            if wav not in sph:
                continue
            for side, (spk, g) in enumerate(
                ((a[1], a[3]), (a[2], a[4])), start=1
            ):
                gender = {"M": "m", "F": "f"}.get(g.strip().upper())
                if gender is None:
                    raise ValueError(f"unknown gender in row {line!r}")
                utt = f"sw_{spk}-swbdc_{wav}_{side}"
                utts[utt] = _sph_utt(utt, f"sw_{spk}", sph[wav], str(side), gender)
    return Dataset(list(utts.values()), name)


def walk_swbd2_phase(
    db_base: str,
    callstat_rel: str = "DISC1/doc/callstat.tbl",
    callinfo_rel: str = "DISC1/doc/callinfo.tbl",
    name: str = "swbd2",
) -> Dataset:
    """make_swbd2_phase{1,2,3}.pl: callstat rows pair with every second
    callinfo row (two channels per call in callinfo); speakers at
    callstat cols 2-3, genders cols 4-5, conversation id from callinfo
    col 0."""
    sph = _find_by_stem(db_base)
    utts: Dict[str, Utterance] = {}
    with open(os.path.join(db_base, callinfo_rel)) as ci:
        info_lines = ci.read().splitlines()
    with open(os.path.join(db_base, callstat_rel)) as cs:
        for i, line in enumerate(cs):
            a = line.strip().split(",")
            # callinfo has two rows per call; the second carries the id
            ci_row = info_lines[2 * i + 1] if 2 * i + 1 < len(info_lines) else ""
            wav = ci_row.split(",")[0].strip() if ci_row else ""
            if len(a) < 6 or not wav or wav not in sph:
                continue
            for side, (spk, g) in enumerate(
                ((a[2], a[4]), (a[3], a[5])), start=1
            ):
                gender = {"M": "m", "F": "f"}.get(g.strip().upper())
                if gender is None:
                    raise ValueError(f"unknown gender in row {line!r}")
                utt = f"sw_{spk}_{wav}_{side}"
                utts[utt] = _sph_utt(utt, f"sw_{spk}", sph[wav], str(side), gender)
    return Dataset(list(utts.values()), name)


def walk_musan(
    root_dir: str, use_vocals: bool = False
) -> Dict[str, Dataset]:
    """make_musan.{sh,py}: the MUSAN corpus into {music, speech, noise}
    datasets.  Music tracks with vocals are dropped unless
    ``use_vocals`` (the ANNOTATIONS `vocals == Y` flag); every file is
    its own 'speaker' except speech, where it is too (the reference uses
    utt ids as speakers throughout).  MUSAN is plain wav: utterances
    load directly."""
    out: Dict[str, Dataset] = {}
    for kind in ("music", "speech", "noise"):
        kdir = os.path.join(root_dir, kind)
        utt2wav: Dict[str, str] = {}
        vocals: Dict[str, bool] = {}
        for root, _, files in os.walk(kdir):
            for f in files:
                path = os.path.join(root, f)
                if f.endswith(".wav"):
                    utt2wav[f[: -len(".wav")]] = path
                elif f == "ANNOTATIONS" and kind == "music":
                    with open(path) as fh:
                        for line in fh:
                            toks = line.split()
                            if len(toks) >= 3:
                                vocals[toks[0]] = toks[2] == "Y"
        utts = []
        for utt, path in sorted(utt2wav.items()):
            if kind == "music":
                if utt not in vocals:
                    continue  # unannotated music file (reference skips it)
                if vocals[utt] and not use_vocals:
                    continue
            utts.append(Utterance(utt, utt, wav=path))
        out[kind] = Dataset(utts, f"musan_{kind}")
    return out
