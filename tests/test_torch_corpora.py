"""`sepi_tpu_torch.data.corpora` against `sepi_tpu.data.corpora`: the same
tables, trees and Kaldi data dirs give field-for-field equal datasets, and
`write_kaldi_dir` writes byte-equal directories."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from sepi_tpu.data import corpora as ref
from sepi_tpu.data.manifest import Dataset as RefDataset
from sepi_tpu.data.manifest import Utterance as RefUtterance
from sepi_tpu_torch.data import corpora as port
from sepi_tpu_torch.data import write_wav
from sepi_tpu_torch.data.manifest import Dataset, Utterance

torch.set_num_threads(2)


def rows(ds):
    return ds.name, [dataclasses.asdict(u) for u in ds]


def assert_same(ds_port, ds_ref):
    assert rows(ds_port) == rows(ds_ref)


def dir_bytes(path):
    return {f: open(os.path.join(path, f), "rb").read() for f in sorted(os.listdir(path))}


def both(utts, name="corpus"):
    """The same utterances as a port and as a reference dataset."""
    return (Dataset([Utterance(**u) for u in utts], name),
            RefDataset([RefUtterance(**u) for u in utts], name))


def test_dataset_from_table_matches():
    table = [("u1", "s1", "/x/u1.wav"), ("u2", "s2", "/x/u2.wav")]
    meta = {"u1": {"gender": "f", "lang": "en"}}
    assert_same(port.dataset_from_table(table, "t", meta),
                ref.dataset_from_table(table, "t", meta))


def test_dataset_from_table_probes_audio(tmp_path):
    rng = np.random.default_rng(0)
    p = str(tmp_path / "a.wav")
    write_wav(p, rng.normal(size=321) * 100, 8000)
    table = [("u", "s", p)]
    got = port.dataset_from_table(table, probe_audio=True)
    assert_same(got, ref.dataset_from_table(table, probe_audio=True))
    assert got["u"].num_samples == 321 and got["u"].sample_rate == 8000


def test_wav_tree_walk_matches(tmp_path):
    rng = np.random.default_rng(1)
    for spk in ("alice", "bob"):
        d = tmp_path / spk / "sess"
        d.mkdir(parents=True)
        for i in range(2):
            write_wav(str(d / f"{i}.wav"), rng.normal(size=100) * 100, 8000)
    (tmp_path / "alice" / "notes.txt").write_text("skip me")
    assert_same(port.dataset_from_wav_tree(str(tmp_path)),
                ref.dataset_from_wav_tree(str(tmp_path)))

    def spk(rel):
        return rel.split(os.sep)[0]

    got = port.dataset_from_wav_tree(str(tmp_path), "tree", spk_from_path=spk)
    assert_same(got, ref.dataset_from_wav_tree(str(tmp_path), "tree", spk_from_path=spk))
    assert set(got.speakers) == {"alice", "bob"} and len(got) == 4


@pytest.mark.parametrize("cmd", [
    "sph2pipe -f wav -p -c 2 x.sph |",
    "/usr/local/bin/sph2pipe -f wav -p x.sph |",
    "sph2pipe -t 1:3 -c 1 /d/y.SPH |",
    "sph2pipe -f wav |",
    "sph2pipe -f wav x.flac |",
    "flac -c -d x.flac |",
    "|",
])
def test_parse_sph2pipe_matches(cmd):
    assert port._parse_sph2pipe(cmd) == ref._parse_sph2pipe(cmd)


SPH_UTTS = [
    dict(utt_id="a-1", spk_id="a", wav="/d/r1.sph", recording="r1", start=0.5, end=1.25,
         meta=(("channel", "2"), ("codec", "sph"))),
    dict(utt_id="a-2", spk_id="a", wav="/d/r1.sph", recording="r1", start=1.5, end=2.0,
         meta=(("channel", "2"), ("codec", "sph"))),
    dict(utt_id="b-1", spk_id="b", wav="/d/b1.wav", num_frames=500, uniq_id="b-0"),
    dict(utt_id="b-2", spk_id="b", wav="/d/b2.wav"),
    dict(utt_id="c-1", spk_id="c", wav=None),
]


def test_write_kaldi_dir_is_byte_equal(tmp_path):
    ds_port, ds_ref = both(SPH_UTTS, "mix")
    port.write_kaldi_dir(ds_port, str(tmp_path / "port"))
    ref.write_kaldi_dir(ds_ref, str(tmp_path / "ref"))
    got = dir_bytes(str(tmp_path / "port"))
    assert got == dir_bytes(str(tmp_path / "ref"))
    assert set(got) == {"wav.scp", "segments", "utt2spk", "spk2utt", "utt2num_frames",
                        "utt2uniq"}
    assert b"r1 sph2pipe -f wav -p -c 2 /d/r1.sph |" in got["wav.scp"]


def test_kaldi_dir_roundtrip_matches(tmp_path):
    ds_port, _ = both(SPH_UTTS[:4], "k")
    out = str(tmp_path / "data")
    port.write_kaldi_dir(ds_port, out)
    with open(os.path.join(out, "utt2dur"), "w") as f:
        f.write("b-1 3.5\n")
    back = port.dataset_from_kaldi_dir(out)
    assert_same(back, ref.dataset_from_kaldi_dir(out))
    assert back["a-1"].recording == "r1" and back["a-1"].get_meta("channel") == "2"
    assert back["b-1"].num_frames == 500 and back["b-1"].uniq_id == "b-0"
    assert abs(back["a-1"].duration - 0.75) < 1e-9 and back["b-1"].duration == 3.5
    assert port.dataset_from_kaldi_dir(out, "named").name == "named"


def test_kaldi_dir_rejections_match(tmp_path):
    d = tmp_path / "k"
    d.mkdir()
    with pytest.raises(FileNotFoundError):
        ref.dataset_from_kaldi_dir(str(d))
    with pytest.raises(FileNotFoundError, match="wav.scp"):
        port.dataset_from_kaldi_dir(str(d))
    (d / "wav.scp").write_text("u1 flac -c -d x.flac |\n")
    (d / "utt2spk").write_text("u1 s1\n")
    with pytest.raises(ValueError):
        ref.dataset_from_kaldi_dir(str(d))
    with pytest.raises(ValueError, match="pipeline"):
        port.dataset_from_kaldi_dir(str(d))


def test_segments_and_missing_recordings_match(tmp_path):
    d = tmp_path / "data"
    d.mkdir()
    (d / "wav.scp").write_text("recA /w/recA.wav\nrecB sph2pipe -f wav -p -c 1 /w/recB.sph |\n")
    (d / "segments").write_text("s1-a recA 0.50 1.50\ns1-b recB 1.70 2.90\nbad recX 0 1\n"
                                "short recA 1\n")
    (d / "utt2spk").write_text("s1-a s1\ns1-b s1\nbad s2\nshort s2\nlone s3\n")
    got = port.dataset_from_kaldi_dir(str(d))
    assert_same(got, ref.dataset_from_kaldi_dir(str(d)))
    assert got.utt_ids == ["s1-a", "s1-b"]
