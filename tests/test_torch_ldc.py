"""`sepi_tpu_torch.data.ldc` against `sepi_tpu.data.ldc` on fixture trees
reproducing the documented LDC layouts (the trees of tests/test_ldc.py,
copied): each walker gives field-for-field equal datasets and trials."""

import dataclasses
import os

import pytest
import torch

from sepi_tpu.data import ldc as ref
from sepi_tpu_torch.data import ldc as port

torch.set_num_threads(2)


def _touch(path, content=""):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(content)


def rows(ds):
    return ds.name, [dataclasses.asdict(u) for u in ds]


# ------------------------------------------------------------------ trees


def build_sre(root):
    db = root / "LDC2006S44"
    for seg in ["xaaa", "xbbb", "xccc"]:
        _touch(str(db / "data" / f"{seg}.sph"), "fake")
    sre_ref = root / "sre_ref"
    _touch(str(sre_ref), "\n".join([
        "1001 f sre2004 xaaa A",
        "1001 f sre2004 xaaa B",
        "1002 m sre2004 xbbb B",
        "1003 m sre2005 xccc A",   # wrong year: dropped
        "1004 m sre2004 zzzz A",   # missing sph: dropped
        "short row",
    ]))
    return (str(db), "04", str(sre_ref)), {}


def build_sre08(root):
    test_db = root / "LDC2011S08"
    train_db = root / "LDC2011S05"
    for seg in ["tseg1", "tseg2"]:
        _touch(str(test_db / "data" / f"{seg}.sph"))
    _touch(str(train_db / "data" / "eseg1.sph"))
    keys = test_db / "data" / "keys" / "NIST_SRE08_KEYS.v0.1"
    _touch(str(keys / "model-keys" / "NIST_SRE08_short2.model.key"), "\n".join([
        "m1,f,eseg1:a,9001",
        "m2,m,missing:b,9002",      # enroll sph absent: enroll utt dropped
    ]))
    _touch(str(keys / "trial-keys" / "NIST_SRE08_short2-short3.trial.key"),
           "\n".join([
               "m1,tseg1,a,target,x",
               "m1,tseg2,b,nontarget,x",  # nontarget: dropped
               "m2,tseg2,b,target,x",     # model's enroll missing, sid known
               "m9,tseg1,b,target,x",     # unknown model: dropped
           ]))
    return (str(test_db), str(train_db)), {}


def build_sre10(root):
    db = root / "sre10"
    for seg in ["seg1", "seg2"]:
        _touch(str(db / "data" / f"{seg}.sph"))
    _touch(str(db / "train" / "coreext.trn"), "")
    _touch(str(db / "keys" / "coreext.modelkey.csv"),
           "m1,5555\nm2,NOT_SCORED\nm3,6666\n")
    _touch(str(db / "keys" / "coreext-coreext.trialkey.csv"), "\n".join([
        "m1,seg1,a,target,x",
        "m1,seg2,b,nontarget,x",   # nontarget: dropped
        "m2,seg2,a,target,x",      # NOT_SCORED model: dropped
        "m3,seg2,b,target,x",
    ]))
    return (str(db),), {}


def build_sre16_eval(root):
    db = root / "R149"
    _touch(str(db / "data" / "enrollment" / "enr1.sph"))
    _touch(str(db / "data" / "test" / "tst1.sph"))
    _touch(str(db / "data" / "test" / "tst2.sph"))
    _touch(str(db / "data" / "test" / "tst3.sph"))
    _touch(str(db / "docs" / "sre16_eval_enrollment.tsv"),
           "modelid segment\nspkA enr1\n")
    _touch(str(db / "docs" / "sre16_eval_segment_key.tsv"),
           "segment callid\ntst1 c1\ntst2 c2\n")
    _touch(str(db / "metadata" / "calls.tsv"), "c1 tgl\nc2 yue\nsegment x\n")
    _touch(str(db / "docs" / "sre16_eval_trial_key.tsv"), "\n".join([
        "modelid segment side targettype",
        "spkA tst1 a target",
        "spkA tst2 a nontarget",
        "spkA tst3 a nontarget",   # no language metadata: pooled only
    ]))
    return (str(db),), {}


def build_sre16_unlabeled(root):
    db = root / "R150"
    _touch(str(db / "data" / "unlabeled" / "major" / "a.sph"))
    _touch(str(db / "data" / "unlabeled" / "major" / "b.sph"))
    _touch(str(db / "data" / "unlabeled" / "minor" / "c.sph"))
    return (str(db),), {}


def build_swbd_cellular(root):
    db = root / "LDC2001S13"
    _touch(str(db / "doc" / "swb_callstats.tbl"), "\n".join([
        "40000,1111,2222,M,F",
        "40019,3333,4444,M,M",  # bad-audio skip list
        "40001,1111,5555,M,F",  # reuses speaker 1111
    ]))
    for w in ["40000", "40019", "40001"]:
        _touch(str(db / f"sw_{w}.sph"))
    return (str(db),), {}


def build_swbd2(root):
    db = root / "LDC99S79"
    _touch(str(db / "DISC1" / "doc" / "callstat.tbl"),
           "x,x,1111,2222,M,F\nx,x,3333,4444,F,M\n")
    # two callinfo rows per call; the SECOND carries the conversation id
    _touch(str(db / "DISC1" / "doc" / "callinfo.tbl"), "\n".join([
        "ignored_a,1", "20001,2", "ignored_b,1", "20002,2", ""
    ]))
    _touch(str(db / "DISC1" / "20001.sph"))
    _touch(str(db / "DISC2" / "20002.sph"))
    return (str(db),), {}


def build_musan(root):
    m = root / "musan"
    _touch(str(m / "music" / "fma" / "music-fma-0001.wav"))
    _touch(str(m / "music" / "fma" / "music-fma-0002.wav"))
    _touch(str(m / "music" / "fma" / "music-fma-0003.wav"))  # unannotated
    _touch(str(m / "music" / "fma" / "ANNOTATIONS"),
           "music-fma-0001 rock Y artist1\nmusic-fma-0002 jazz N artist2\n")
    _touch(str(m / "speech" / "us-gov" / "speech-us-gov-0001.wav"))
    _touch(str(m / "noise" / "free-sound" / "noise-free-sound-0001.wav"))
    return (str(m),), {}


WALKERS = {
    "walk_sre": build_sre,
    "walk_sre08": build_sre08,
    "walk_sre10": build_sre10,
    "walk_sre16_eval": build_sre16_eval,
    "walk_sre16_unlabeled": build_sre16_unlabeled,
    "walk_swbd_cellular": build_swbd_cellular,
    "walk_swbd2_phase": build_swbd2,
    "walk_musan": build_musan,
}


def normalize(out):
    """A walker's return value with every Dataset and Trial made plain."""
    if hasattr(out, "spk2utt"):
        return rows(out)
    if isinstance(out, dict):
        return {k: normalize(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return [normalize(v) for v in out]
    if dataclasses.is_dataclass(out):
        return dataclasses.asdict(out)
    return out


@pytest.mark.parametrize("walker", sorted(WALKERS))
def test_walker_matches_reference(tmp_path, walker):
    args, kw = WALKERS[walker](tmp_path)
    got = getattr(port, walker)(*args, **kw)
    assert normalize(got) == normalize(getattr(ref, walker)(*args, **kw))
    assert normalize(got) not in ([], {}, None)


def test_walker_outputs_carry_the_layout(tmp_path):
    """Spot checks of what the walkers read (tests/test_ldc.py's)."""
    args, _ = build_sre(tmp_path)
    u = port.walk_sre(*args)["1001-sre04-xaaa-b"]
    assert u.spk_id == "1001" and u.get_meta("channel") == "2"
    assert u.get_meta("gender") == "f" and u.wav.endswith("xaaa.sph")
    args, _ = build_sre16_eval(tmp_path)
    enroll, test, trials = port.walk_sre16_eval(*args)
    assert enroll.utt_ids == ["spkA-enr1"] and test["tst1"].get_meta("lang") == "tgl"
    assert len(trials["pooled"]) == 3 and [t.test for t in trials["yue"]] == ["tst2"]
    args, _ = build_musan(tmp_path)
    assert port.walk_musan(*args)["music"].utt_ids == ["music-fma-0002"]
    assert port.walk_musan(*args, use_vocals=True)["music"].utt_ids == [
        "music-fma-0001", "music-fma-0002"]


@pytest.mark.parametrize("walker,table", [
    ("walk_swbd_cellular", ("doc/swb_callstats.tbl", "40000,1,2,M,X\n", "sw_40000.sph")),
    ("walk_swbd2_phase", ("DISC1/doc/callstat.tbl", "x,x,1,2,M,Q\n", "20001.sph")),
])
def test_bad_gender_raises_like_reference(tmp_path, walker, table):
    rel, content, sph = table
    db = tmp_path / "bad"
    _touch(str(db / rel), content)
    _touch(str(db / "DISC1" / "doc" / "callinfo.tbl"), "a,1\n20001,2\n")
    _touch(str(db / sph))
    with pytest.raises(ValueError, match="gender"):
        getattr(ref, walker)(str(db))
    with pytest.raises(ValueError, match="gender"):
        getattr(port, walker)(str(db))


def test_malformed_key_channel_raises_like_reference(tmp_path):
    args, _ = build_sre10(tmp_path)
    key = os.path.join(args[0], "keys", "coreext-coreext.trialkey.csv")
    with open(key, "a") as f:
        f.write("\nm1,seg2,c,target,x\n")
    with pytest.raises(ValueError, match="malformed"):
        ref.walk_sre10(*args)
    with pytest.raises(ValueError, match="malformed"):
        port.walk_sre10(*args)
