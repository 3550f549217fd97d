"""`sepi_tpu_torch.data.asr_prep` against `sepi_tpu.data.asr_prep` on
miniature Fisher / Switchboard-1 / Mixer 6 trees and a CMUdict (the trees
of tests/test_asr_prep.py, copied): equal datasets, transcripts and
lexicons."""

import dataclasses

import pytest
import torch

from sepi_tpu.data import asr_prep as ref
from sepi_tpu_torch.align import Lexicon
from sepi_tpu_torch.data import asr_prep as port

torch.set_num_threads(2)

FISHER_TRAN = """# fe_03_00004.sph
# Transcribed at the LDC

7.38 8.78 A: an- so the topic is
9.10 10.00 B: yeah [laugh] okay
11.00 12.00 A: (( unclear words ))
13.00 14.50 B: i [cough] think so
15.00 15.20 A:
"""

SWBD_TRANS = """sw2001A-ms98-a-0001 0.98 11.56 okay so [SILENCE] um
sw2001A-ms98-a-0002 12.00 13.00 [SILENCE]
sw2001B-ms98-a-0001 2.50 4.00 <B_ASIDE> yeah right
sw2001B-ms98-a-0002 5.00 6.25 [LAUGHTER-STORY] AB[SOLUTE]- them_1
"""

CMUDICT = """;;; # CMUdict comment
OKAY  OW2 K EY1
SO  S OW1
UM  AH1 M
C.  S IY1
C.(2)  S IY0
N.  EH1 N
THE  DH AH0
TOPIC  T AA1 P IH0 K
IS  IH1 Z
YEAH  Y AE1
I  AY1
THINK  TH IH1 NG K
"""


def build_fisher(root):
    root = root / "fisher"
    trans = root / "fe_03_tran" / "trans" / "000"
    trans.mkdir(parents=True)
    (trans / "fe_03_00004.txt").write_text(FISHER_TRAN)
    doc = root / "fe_03_tran" / "doc"
    doc.mkdir()
    (doc / "fe_03_p1_filelist.tbl").write_text("fe_03_p1_sph1 fe_03_00004.sph fm 9.9\n")
    sph = root / "fe_03_data_sph" / "000"
    sph.mkdir(parents=True)
    (sph / "fe_03_00004.sph").write_bytes(b"NIST_1A\n")
    return str(root)


def build_swbd(root):
    root = root / "swbd"
    tr = root / "docs" / "swb_ms98_transcriptions" / "20" / "2001"
    tr.mkdir(parents=True)
    (tr / "sw2001A-ms98-a-trans.text").write_text(SWBD_TRANS)
    aud = root / "data"
    aud.mkdir()
    (aud / "sw02001.sph").write_bytes(b"NIST_1A\n")
    return str(root)


def build_mx6(root):
    root = root / "LDC2013S03"
    docs = root / "mx6_speech" / "docs"
    docs.mkdir(parents=True)
    (docs / "mx6_subjs.csv").write_text(
        "subj_id,sex,other\n120345,F,x\n120346,M,x\n120347,M,x\n")
    (docs / "mx6_ivcomponents.csv").write_text(
        "20100113_134557_LDC_120345,a,b,c,d,e,f,240.0,1140.5\n"
        "20100114_091122_LDC_120346,a,b,c,d,e,f,300.0,900.0\n")
    (docs / "mx6_calls.csv").write_text(
        "4093,20100201_101500,x,x,120345,a,b,c,d,e,f,g,120347,h\n"
        "9999,20100202_101500,x,x,120345,a,b,c,d,e,f,g,120346,h\n")
    for ch in ("02", "04"):
        d = root / "mx6_speech" / "data" / "pcm_flac" / f"CH{ch}"
        d.mkdir(parents=True)
        (d / f"20100113_134557_LDC_120345_CH{ch}.flac").write_bytes(b"fLaC")
        if ch == "04":
            (d / f"20100114_091122_LDC_120346_CH{ch}.flac").write_bytes(b"fLaC")
    sphd = root / "mx6_speech" / "data" / "ulaw_sphere"
    sphd.mkdir(parents=True)
    (sphd / "20100201_101500_4093.sph").write_bytes(b"NIST_1A\n")
    return str(root)


def rows(ds):
    return ds.name, [dataclasses.asdict(u) for u in ds]


def test_walk_fisher_matches(tmp_path):
    root = build_fisher(tmp_path)
    ds, text = port.walk_fisher([root])
    ds_r, text_r = ref.walk_fisher([root])
    assert rows(ds) == rows(ds_r) and text == text_r
    assert len(ds) == 3 and ds["fe_03_00004-B-000910-001000"].get_meta("gender") == "m"
    assert text["fe_03_00004-B-001300-001450"] == ["i", "[noise]", "think", "so"]


def test_walk_fisher_needs_transcripts(tmp_path):
    with pytest.raises(FileNotFoundError):
        ref.walk_fisher([str(tmp_path)])
    with pytest.raises(FileNotFoundError, match="fe_03_tran"):
        port.walk_fisher([str(tmp_path)])


def test_walk_swbd1_matches(tmp_path):
    root = build_swbd(tmp_path)
    ds, text = port.walk_swbd1(root)
    ds_r, text_r = ref.walk_swbd1(root)
    assert rows(ds) == rows(ds_r) and text == text_r
    assert text["sw02001-B_000250-000400"] == ["yeah", "right"]
    assert len(ds) == 3


@pytest.mark.parametrize("word", [
    "[LAUGHTER-STORY]", "[IT'N/ISN'T]", "-[AN]Y", "[AN]Y", "AB[SOLUTE]-", "AB[SOLUTE]",
    "{YUPPIEDOM}", "THEM_1", "them_1", "okay", "[laughter-story]", "AMMU[N]IT-", "-[TH]AT-",
])
def test_map_swbd_word_matches(word):
    assert port.map_swbd_word(word) == ref.map_swbd_word(word)


@pytest.mark.parametrize("words", [
    ["((", "huh", "))"], [], ["[sigh]"], ["[laugh]", "so", "[mn]"], ["plain", "words"],
])
def test_normalize_fisher_words_matches(words):
    assert port.normalize_fisher_words(words) == ref.normalize_fisher_words(words)


def test_cmudict_and_lexicon_match(tmp_path):
    p = tmp_path / "cmudict.0.7a"
    p.write_text(CMUDICT)
    cmu = port.read_cmudict(str(p))
    assert cmu == ref.read_cmudict(str(p))
    text = {
        "u1": ["okay", "so", "[laughter]", "c._n._n.", "zzyzx"],
        "u2": ["um", "mm", "so", "zzyzx", "qq_okay"],
    }
    extra = {"qq": ["k", "y", "uw"]}
    lex, oov = port.build_lexicon(text, cmu, extra_prons=extra)
    lex_r, oov_r = ref.build_lexicon(text, ref.read_cmudict(str(p)), extra_prons=extra)
    assert isinstance(lex, Lexicon)
    assert (lex.pron, lex.phones, oov) == (lex_r.pron, lex_r.phones, oov_r)
    assert oov == {"zzyzx": 2} and lex.pron["qq_okay"] == ("k", "y", "uw", "ow", "k", "ey")
    assert port.apply_oov(text, lex) == ref.apply_oov(text, lex_r)


def test_walk_mx6_matches(tmp_path):
    root = build_mx6(tmp_path)
    assert rows(port.walk_mx6_mic(root, "02")) == rows(ref.walk_mx6_mic(root, "02"))
    assert rows(port.walk_mx6_calls(root)) == rows(ref.walk_mx6_calls(root))
    for subset in (1, 2000):
        got = port.walk_mx6(root, mic_channels=("02", "04"), mic_subset=subset)
        assert rows(got) == rows(ref.walk_mx6(root, mic_channels=("02", "04"),
                                              mic_subset=subset))
    assert len([u for u in got.utt_ids if u.endswith("_04")]) == 2


def test_mx6_rejections_match(tmp_path):
    root = build_mx6(tmp_path)
    for fn, args, err in ((ref.walk_mx6_mic, (root, "01"), ValueError),
                          (ref.walk_mx6_mic, (root, "05"), FileNotFoundError),
                          (ref.walk_mx6_calls, (str(tmp_path),), FileNotFoundError)):
        with pytest.raises(err):
            fn(*args)
        with pytest.raises(err):
            getattr(port, fn.__name__)(*args)
