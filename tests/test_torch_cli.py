"""`sepi_tpu_torch.cli` against `sepi_tpu.cli`.

Held on the CPU:
- every subcommand's parser has the reference's options and defaults,
  plus ``--device`` where the subcommand computes;
- v1-v5 on one Kaldi data dir (WAVs, a `segments` row, SPHERE pipes) hand
  each driver the reference's arguments, the port's plus ``device``;
- prep-ldc and prep-asr write byte-equal files;
- import-kaldi/export-kaldi: classical files import to the reference's
  arrays and export to its bytes; an nnet3 model and a trainer checkpoint
  round-trip to the same bytes; the nnet2 fixture imports; `.mdl` files
  route like the reference's;
- without a GPU every computing subcommand raises unless given
  ``--device cpu``, and the file commands run.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import sepi_tpu.cli as ref_cli
import sepi_tpu_torch.cli as cli
from sepi_tpu.recipes import drivers as ref_drivers
from sepi_tpu_torch.data import Dataset, make_phonetic_corpus, save_trials, write_kaldi_dir, write_wav
from sepi_tpu_torch.recipes import drivers
from sepi_tpu_torch.utils import nnet3
from test_torch_asr_prep import CMUDICT, build_fisher, build_mx6, build_swbd
from test_torch_ldc import WALKERS

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures", "kaldi_wire")


@pytest.fixture(autouse=True)
def _no_jax_cache(monkeypatch):
    monkeypatch.setenv("SEPI_TPU_NO_COMPILE_CACHE", "1")


def write_sph(path, payload: bytes, *, rate=8000, channels=1, samples=0):
    """A NIST SPHERE file of 16-bit PCM (tests/test_sphere.py's builder)."""
    fields = [f"sample_rate -i {rate}", f"channel_count -i {channels}",
              f"sample_count -i {samples}", "sample_n_bytes -i 2",
              "sample_byte_format -s2 01", "sample_coding -s3 pcm", "end_head"]
    head = ("NIST_1A\n   1024\n" + "\n".join(fields) + "\n").encode().ljust(1024, b" ")
    with open(path, "wb") as f:
        f.write(head + payload)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A Kaldi data dir of WAVs (one utterance cut by `segments`, two sides
    of a SPHERE call), its trials, transcripts and lexicon."""
    root = tmp_path_factory.mktemp("cli")
    corpus = make_phonetic_corpus(num_speakers=3, utts_per_speaker=3, seed=41,
                                  words_per_utt=(2, 3))
    wavs = root / "wavs"
    wavs.mkdir()
    utts = []
    for i, u in enumerate(corpus.dataset):
        p = str(wavs / f"{u.utt_id}.wav")
        x = corpus.audio[u.utt_id]
        if i == 0:  # one recording cut by a segments row
            write_wav(p, np.concatenate([np.zeros(4000, np.float32), x]), 8000)
            n = len(x) / 8000.0
            utts.append(u.replace(wav=p, recording="rec0", start=0.5, end=0.5 + n))
        else:
            write_wav(p, x, 8000)
            utts.append(u.replace(wav=p))
    ddir = str(root / "data")
    write_kaldi_dir(Dataset(utts, "cli"), ddir)
    sph = str(root / "call.sph")
    a = (np.arange(3000) % 101 - 50).astype("<i2") * 100
    inter = np.empty(6000, "<i2")
    inter[0::2], inter[1::2] = a, -a
    write_sph(sph, inter.tobytes(), channels=2, samples=3000)
    with open(os.path.join(ddir, "wav.scp"), "a") as f:
        f.write(f"call-a sph2pipe -f wav -p -c 1 {sph} |\ncall-b sph2pipe -f wav -p -c 2 {sph} |\n")
    with open(os.path.join(ddir, "utt2spk"), "a") as f:
        f.write("call-a spkA\ncall-b spkB\n")
    trials = str(root / "trials")
    save_trials(corpus.trials, trials)
    text = str(root / "text")
    with open(text, "w") as f:
        for u, ws in sorted(corpus.transcripts.items()):
            f.write(f"{u} {' '.join(ws)}\n")
    lexicon = str(root / "lexicon.txt")
    with open(lexicon, "w") as f:
        for w, ps in sorted(corpus.lexicon.pron.items()):
            f.write(f"{w} {' '.join(ps)}\n")
    musan = root / "musan"
    rng = np.random.default_rng(5)
    for sub in ("noise", "music", "speech"):
        (musan / sub).mkdir(parents=True)
        write_wav(str(musan / sub / f"{sub}0.wav"), rng.normal(size=4000) * 900, 8000)
    rirs = root / "rirs"
    rirs.mkdir()
    write_wav(str(rirs / "rir0.wav"), rng.normal(size=200) * 2000, 8000)
    return types.SimpleNamespace(root=root, ddir=ddir, trials=trials, text=text,
                                 lexicon=lexicon, musan=str(musan), rirs=str(rirs))


# ------------------------------------------------------------------ parsers


class _Parsed(Exception):
    pass


def _parser_of(main, argv, monkeypatch):
    """The parser a subcommand builds, caught at its parse_args."""
    seen = {}

    def catch(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed):
        main(argv)
    monkeypatch.undo()
    return seen["parser"]


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.required, a.choices, a.type,
                     type(a).__name__, a.nargs)
            for a in parser._actions if a.dest != "help"}


COMPUTING = ("", "gauntlet", "import-kaldi")


@pytest.mark.parametrize("sub", ["", "prep-asr", "prep-ldc", "import-kaldi", "export-kaldi",
                                 "gauntlet"])
def test_parsers_match_reference(monkeypatch, sub):
    argv = [sub] if sub else ["v2"]
    got = _options(_parser_of(cli.main, argv, monkeypatch))
    want = _options(_parser_of(ref_cli.main, argv, monkeypatch))
    if sub in COMPUTING:
        assert got.pop("device") == (("--device",), "cuda", False, None, None,
                                     "_StoreAction", None)
    assert got == want


def test_table_loaders_match(tmp_path):
    t = tmp_path / "text"
    t.write_text("utt1 hello world\nutt2 foo\nlonely\n")
    assert cli.load_transcripts(str(t)) == ref_cli.load_transcripts(str(t))
    lx = tmp_path / "lexicon.txt"
    lx.write_text("hello h eh l ow\nworld w er l d\nhello h ax l ow\nbad\n")
    got, want = cli.load_lexicon(str(lx)), ref_cli.load_lexicon(str(lx))
    assert (got.pron, got.phones) == (want.pron, want.phones)
    assert got.pron["hello"] == ("h", "eh", "l", "ow") and got.phones[0] == "sil"


def test_load_corpus_matches(world):
    ds, audio = cli._load_corpus(world.ddir, 8000)
    ds_r, audio_r = ref_cli._load_corpus(world.ddir, 8000)
    assert [dataclasses.asdict(u) for u in ds] == [dataclasses.asdict(u) for u in ds_r]
    assert set(audio) == set(audio_r)
    for u in audio:
        np.testing.assert_array_equal(audio[u], audio_r[u])
    np.testing.assert_array_equal(audio["call-b"], -audio["call-a"])
    first = next(u for u in ds if u.recording == "rec0")
    assert len(audio[first.utt_id]) == round((first.end - first.start) * 8000)
    with pytest.raises(ValueError, match="sample rate"):
        cli._load_corpus(world.ddir, 16000)


# ----------------------------------------------------------------- dispatch


def _norm(x):
    """Arguments in a form both packages' objects compare by value."""
    if hasattr(x, "spk2utt") and hasattr(x, "utt_ids"):
        return ("Dataset", x.name, [dataclasses.asdict(u) for u in x])
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: _norm(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, dict) or hasattr(x, "keys"):
        return {k: _norm(x[k]) for k in x.keys()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


def _record(monkeypatch, module, calls):
    for name in ("run_v1", "run_v2", "run_v3", "run_v4", "run_v5"):
        def fake(*args, _name=name, **kw):
            calls.append((_name, args, kw))
            return types.SimpleNamespace(report=f"{_name} report")
        monkeypatch.setattr(module, name, fake)


VARIANT_ARGS = {
    "v1": ["--export-kaldi"],
    "v2": ["--num-steps", "7", "--min-chunk", "50", "--max-chunk", "90",
           "--chunk-buckets", "2", "--batch-size", "5", "--steps-per-dispatch", "3",
           "--prefetch", "0", "--preconditioner", "none"],
    "v3": ["--num-leaves", "33", "--fmllr", "--num-steps", "11"],
    "v4": ["--am-steps", "5", "--num-steps", "9"],
    "v5": ["--am-steps", "4", "--num-steps", "8", "--batch-size", "6"],
}


@pytest.mark.parametrize("variant", sorted(VARIANT_ARGS))
def test_dispatch_matches_reference(world, monkeypatch, capsys, variant):
    argv = [variant, "--train-data", world.ddir, "--enroll-data", world.ddir,
            "--eval-data", world.ddir, "--trials", world.trials,
            "--workdir", str(world.root / "wd"), "--adapt-data", world.ddir]
    argv += VARIANT_ARGS[variant]
    if variant != "v1":
        argv += ["--musan-dir", world.musan, "--rirs-dir", world.rirs, "--aug-subset", "4"]
    if variant in ("v3", "v4", "v5"):
        argv += ["--text", world.text, "--lexicon", world.lexicon]
    got, want = [], []
    _record(monkeypatch, drivers, got)
    _record(monkeypatch, ref_drivers, want)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == f"run_{variant} report"
    assert ref_cli.main(argv) == 0
    (name, args, kw), = got
    (ref_name, ref_args, ref_kw), = want
    assert name == ref_name == f"run_{variant}"
    assert kw.pop("device") == "cpu"
    assert _norm(args) == _norm(ref_args)
    assert _norm(kw) == _norm(ref_kw)
    assert set(kw) >= ({"export_kaldi", "adapt_audio"} if variant == "v1" else {"augments"})


def test_phonetic_variant_needs_text_and_lexicon(world):
    with pytest.raises(SystemExit, match="text"):
        cli.main(["v3", "--train-data", world.ddir, "--enroll-data", world.ddir,
                  "--trials", world.trials, "--workdir", str(world.root / "x"),
                  "--device", "cpu"])


def test_v1_refuses_augmentation(world, monkeypatch):
    _record(monkeypatch, drivers, [])
    with pytest.raises(SystemExit, match="augmentation"):
        cli.main(["v1", "--train-data", world.ddir, "--enroll-data", world.ddir,
                  "--trials", world.trials, "--workdir", str(world.root / "x"),
                  "--musan-dir", world.musan, "--device", "cpu"])


# ------------------------------------------------------------- data prep


def build_mx6_all_mics(root):
    """The Mixer 6 tree with a session on every room microphone walk_mx6
    reads by default (02, 04-13)."""
    db = build_mx6(root)
    for ch in ("05", "06", "07", "08", "09", "10", "11", "12", "13"):
        d = os.path.join(db, "mx6_speech", "data", "pcm_flac", f"CH{ch}")
        os.makedirs(d)
        with open(os.path.join(d, f"20100114_091122_LDC_120346_CH{ch}.flac"), "wb") as f:
            f.write(b"fLaC")
    return db


def _tree_bytes(path):
    out = {}
    for dirpath, _, files in os.walk(path):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, path)] = open(p, "rb").read()
    return out


PREP_LDC = {
    "sre": ("walk_sre", lambda a: ["--db", a[0], "--year", a[1], "--sre-ref", a[2]]),
    "sre08": ("walk_sre08", lambda a: ["--db", a[0], "--db2", a[1]]),
    "sre10": ("walk_sre10", lambda a: ["--db", a[0]]),
    "sre16-eval": ("walk_sre16_eval", lambda a: ["--db", a[0]]),
    "sre16-unlabeled": ("walk_sre16_unlabeled", lambda a: ["--db", a[0]]),
    "swbd-cellular": ("walk_swbd_cellular", lambda a: ["--db", a[0]]),
    "swbd2": ("walk_swbd2_phase", lambda a: ["--db", a[0]]),
    "musan": ("walk_musan", lambda a: ["--db", a[0], "--use-vocals"]),
}


@pytest.mark.parametrize("corpus", sorted(PREP_LDC) + ["mx6"])
def test_prep_ldc_writes_reference_bytes(tmp_path, corpus, capsys):
    if corpus == "mx6":
        args = ["--db", build_mx6_all_mics(tmp_path)]
    else:
        walker, to_argv = PREP_LDC[corpus]
        args = to_argv(WALKERS[walker](tmp_path)[0])
    for main, out in ((cli.main, "port"), (ref_cli.main, "ref")):
        assert main(["prep-ldc", "--corpus", corpus, *args, "--out", str(tmp_path / out)]) == 0
    printed = capsys.readouterr().out
    got = _tree_bytes(str(tmp_path / "port"))
    assert got and got == _tree_bytes(str(tmp_path / "ref"))
    assert printed.count("wrote") == 2 * len(got)


def test_prep_asr_writes_reference_bytes(tmp_path):
    fisher, swbd = build_fisher(tmp_path), build_swbd(tmp_path)
    mx6 = build_mx6_all_mics(tmp_path)
    cmu = tmp_path / "cmudict.0.7a"
    cmu.write_text(CMUDICT)
    common = ["--fisher-dir", fisher, "--swbd-dir", swbd, "--mx6-dir", mx6, "--cmudict", str(cmu)]
    assert cli.main(["prep-asr", *common, "--out-dir", str(tmp_path / "port")]) == 0
    assert ref_cli.main(["prep-asr", *common, "--out-dir", str(tmp_path / "ref")]) == 0
    got = _tree_bytes(str(tmp_path / "port"))
    assert got == _tree_bytes(str(tmp_path / "ref"))
    assert {"train_asr/text", "lexicon.txt", "oov_counts.txt", "mx6/wav.scp"} <= set(got)
    text = cli.load_transcripts(str(tmp_path / "port" / "train_asr" / "text"))
    assert text["fe_03_00004-A-000738-000878"][0] == "<unk>"
    with pytest.raises(SystemExit, match="cmudict"):
        cli.main(["prep-asr", "--fisher-dir", fisher, "--out-dir", str(tmp_path / "x")])


# --------------------------------------------------------------- interop


CLASSICAL = ("final.dubm", "final.ubm", "final.ie", "plda", "mean.vec", "transform.mat")


@pytest.mark.parametrize("name", CLASSICAL)
def test_classical_interop_matches_reference(tmp_path, name, recwarn):
    src = os.path.join(FIX, name)
    assert cli.main(["import-kaldi", "--raw", src, "--out", str(tmp_path / "p")]) == 0
    assert ref_cli.main(["import-kaldi", "--raw", src, "--out", str(tmp_path / "r")]) == 0
    got, want = np.load(tmp_path / "p" / "model.npz"), np.load(tmp_path / "r" / "model.npz")
    assert set(got.files) == set(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    for f in ("meta.json",):
        assert (tmp_path / "p" / f).read_text() == (tmp_path / "r" / f).read_text()
    npz = str(tmp_path / "p" / "model.npz")
    assert cli.main(["export-kaldi", "--model", npz, "--out", str(tmp_path / "back_p")]) == 0
    assert ref_cli.main(["export-kaldi", "--model", npz, "--out", str(tmp_path / "back_r")]) == 0
    assert (tmp_path / "back_p").read_bytes() == (tmp_path / "back_r").read_bytes()
    if name == "final.ie":
        assert ((tmp_path / "back_p.meta.json").read_text()
                == (tmp_path / "back_r.meta.json").read_text())
    if name in ("plda", "mean.vec", "transform.mat"):  # stored in float64 in model.npz
        assert (tmp_path / "back_p").read_bytes() == open(src, "rb").read()


def _tiny_v2_raw(path):
    """A port x-vector at narrow widths, seeded, exported to Kaldi bytes."""
    from sepi_tpu_torch.models import XVector, XVectorConfig
    from sepi_tpu_torch.models.tdnn import TdnnSpec, lecun_normal_init

    cfg = XVectorConfig(feat_dim=8, num_speakers=5, embed_dim=12, frame_specs=(
        TdnnSpec(16, (-2, -1, 0, 1, 2)), TdnnSpec(16, (-2, 0, 2)), TdnnSpec(16, (-3, 0, 3)),
        TdnnSpec(16, (0,)), TdnnSpec(24, (0,))))
    model = XVector(cfg)
    lecun_normal_init(model, 3)
    g = torch.Generator().manual_seed(4)
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(torch.randn(buf.shape, generator=g))
        elif name.endswith("running_var"):
            buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
    nnet3.export_kaldi_raw(model, "v2", path)
    return model


def test_nnet3_round_trip_through_the_cli(tmp_path, capsys):
    raw = str(tmp_path / "final.raw")
    model = _tiny_v2_raw(raw)
    out = tmp_path / "imp"
    assert cli.main(["import-kaldi", "--raw", raw, "--out", str(out), "--device", "cpu"]) == 0
    assert "imported v2 model" in capsys.readouterr().out
    meta = json.loads((out / "meta.json").read_text())
    assert meta["arch"] == "v2"
    assert meta["config"] == json.loads(json.dumps(dataclasses.asdict(model.cfg)))
    state = torch.load(out / "model.pt", weights_only=True)
    assert set(state) == set(model.state_dict())
    back = str(tmp_path / "back.raw")
    assert cli.main(["export-kaldi", "--model", str(out / "model.pt"), "--arch", "v2",
                     "--out", back]) == 0
    assert open(back, "rb").read() == open(raw, "rb").read()
    # the reference reads the port's export and writes the same bytes back
    from sepi_tpu.utils.nnet3 import export_kaldi_raw, import_kaldi_raw

    _, variables, arch = import_kaldi_raw(back)
    export_kaldi_raw(variables, arch, str(tmp_path / "ref.raw"))
    assert (tmp_path / "ref.raw").read_bytes() == open(raw, "rb").read()
    with pytest.raises(SystemExit, match="arch"):
        cli.main(["export-kaldi", "--model", str(out / "model.pt"), "--out", back])


def test_trainer_checkpoint_exports(tmp_path):
    from sepi_tpu_torch.train.checkpoint import save_checkpoint
    from sepi_tpu_torch.train.trainer import TrainState

    raw = str(tmp_path / "final.raw")
    model = _tiny_v2_raw(raw)
    path = save_checkpoint(TrainState(model, {"mu": {"w": torch.zeros(2)}}, 12),
                           str(tmp_path / "ck"), 12)
    out = str(tmp_path / "ck.raw")
    assert cli.main(["export-kaldi", "--model", path, "--arch", "v2", "--out", out]) == 0
    assert open(out, "rb").read() == open(raw, "rb").read()
    torch.save({"not": "a model"}, tmp_path / "bad.pt")
    with pytest.raises(SystemExit, match="not a sepi_tpu_torch model"):
        cli.main(["export-kaldi", "--model", str(tmp_path / "bad.pt"), "--arch", "v2",
                  "--out", out])


def test_nnet2_fixture_imports_like_the_reference(tmp_path):
    src = os.path.join(FIX, "final_nnet2.mdl")
    assert cli.main(["import-kaldi", "--raw", src, "--out", str(tmp_path / "p"),
                     "--device", "cpu"]) == 0
    assert ref_cli.main(["import-kaldi", "--raw", src, "--out", str(tmp_path / "r")]) == 0
    assert (tmp_path / "p" / "meta.json").read_text() == (tmp_path / "r" / "meta.json").read_text()
    np.testing.assert_array_equal(np.load(tmp_path / "p" / "priors.npy"),
                                  np.load(tmp_path / "r" / "priors.npy"))
    state = torch.load(tmp_path / "p" / "model.pt", weights_only=True)
    assert {"output.weight", "layer0.affine.weight"} <= set(state)


def test_mdl_files_route_like_the_reference(tmp_path):
    import struct

    raw = str(tmp_path / "v2.raw")
    _tiny_v2_raw(raw)
    tm = (b"<TransitionModel> <X> \x04" + struct.pack("<i", 1) + b"\xff </TransitionModel> ")
    mdl = tmp_path / "final.mdl"
    mdl.write_bytes(b"\x00B" + tm + open(raw, "rb").read()[2:])
    assert cli.main(["import-kaldi", "--raw", str(mdl), "--out", str(tmp_path / "n3"),
                     "--device", "cpu"]) == 0
    assert json.loads((tmp_path / "n3" / "meta.json").read_text())["arch"] == "v2"
    nnet2 = open(os.path.join(FIX, "final_nnet2.mdl"), "rb").read()
    assert nnet2[2:].startswith(b"<TransitionModel>")
    assert cli.main(["import-kaldi", "--raw", os.path.join(FIX, "final_nnet2.mdl"),
                     "--out", str(tmp_path / "n2"), "--device", "cpu"]) == 0
    assert json.loads((tmp_path / "n2" / "meta.json").read_text())["arch"] == "nnet2"


def test_python_m_entry_point(tmp_path):
    """`python -m sepi_tpu_torch` runs cli.main in a fresh process."""
    raw = str(tmp_path / "final.raw")
    _tiny_v2_raw(raw)
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    env.pop("PYTHONSTARTUP", None)
    out = subprocess.run(
        [sys.executable, "-m", "sepi_tpu_torch", "import-kaldi", "--raw", raw,
         "--out", str(tmp_path / "imp"), "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "imported v2 model" in out.stdout and (tmp_path / "imp" / "model.pt").exists()


# ------------------------------------------------------------ no GPU


def test_computing_subcommands_need_a_gpu_unless_told(world, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = str(tmp_path / "final.raw")
    _tiny_v2_raw(raw)
    wd = tmp_path / "wd"
    for argv in (["v2", "--train-data", world.ddir, "--enroll-data", world.ddir,
                  "--trials", world.trials, "--workdir", str(wd)],
                 ["gauntlet", "--workdir", str(wd)],
                 ["import-kaldi", "--raw", raw, "--out", str(wd)],
                 ["import-kaldi", "--raw", os.path.join(FIX, "final_nnet2.mdl"),
                  "--out", str(wd)]):
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(argv)
    assert not wd.exists()
    # the file commands run without one
    assert cli.main(["import-kaldi", "--raw", os.path.join(FIX, "plda"),
                     "--out", str(tmp_path / "plda")]) == 0
    assert cli.main(["export-kaldi", "--model", str(tmp_path / "plda" / "model.npz"),
                     "--out", str(tmp_path / "plda.out")]) == 0
    args, _ = WALKERS["walk_sre10"](tmp_path)
    assert cli.main(["prep-ldc", "--corpus", "sre10", "--db", args[0],
                     "--out", str(tmp_path / "sre10")]) == 0


@pytest.mark.slow
def test_cli_v2_end_to_end_on_the_cpu(world, capsys):
    """The default (full-width) x-vector through the whole v2 recipe."""
    wd = str(world.root / "exp_v2")
    rc = cli.main(["v2", "--train-data", world.ddir, "--enroll-data", world.ddir,
                   "--trials", world.trials, "--workdir", wd, "--num-steps", "20",
                   "--min-chunk", "50", "--max-chunk", "100", "--chunk-buckets", "2",
                   "--batch-size", "8", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "pooled" in out and "EER" in out
    for f in ("xvector.scp", "det_pooled.svg", "metrics.jsonl"):
        assert os.path.exists(os.path.join(wd, f))
