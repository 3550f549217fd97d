"""Command-line recipe runner — the run_sre10.sh-shaped entry point.

A port of `sepi_tpu/cli.py`: the same subcommands and options, plus
``--device`` (default ``cuda``) wherever a subcommand computes.

  python -m sepi_tpu_torch v2 --train-data data/swbd_sre --enroll-data data/enroll \\
      --eval-data data/test --trials data/trials --workdir exp/v2 \\
      [--num-steps N] [--adapt-data DIR] [--device cuda]
  python -m sepi_tpu_torch v3 ... --text data/train/text --lexicon lexicon.txt \\
      [--num-leaves 4096] [--fmllr]
  python -m sepi_tpu_torch prep-ldc | prep-asr | import-kaldi | export-kaldi | gauntlet ...

Data dirs are standard Kaldi layout (wav.scp/utt2spk[/segments]);
wav.scp must point at real wav files or sph2pipe pipes (decoded natively
with their channel).  `--text` is the Kaldi transcript table
(`utt w1 w2 ...`), `--lexicon` the pronunciation lexicon
(`word p1 p2 ...`); together they enable the built-in s5 alignment stage
for v3/v4/v5.  Results (report, DET curves, embeddings, metrics.jsonl)
land in --workdir.

Without a GPU every subcommand that computes (v1-v5, gauntlet, and
import-kaldi of an nnet3 or nnet2 model) raises unless it is given
``--device cpu``; prep-ldc, prep-asr, export-kaldi and import-kaldi of a
classical file only read and write files.  Where the reference writes Flax
``variables.msgpack`` files, the port writes ``model.pt`` (a torch
``state_dict``) beside the same ``meta.json``; classical ``model.npz``
files keep the reference's layout, so both packages read each other's.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List

import numpy as np

DEVICE_HELP = ("torch device for the computing stages (default cuda; pass "
               "'cpu' to run on the CPU)")


def load_transcripts(path: str) -> Dict[str, List[str]]:
    """Kaldi `text` table: utt_id followed by the word sequence."""
    out: Dict[str, List[str]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out[parts[0]] = parts[1:]
    return out


def load_lexicon(path: str):
    """Kaldi lexicon.txt: `word phone phone ...` -> align.Lexicon."""
    from .align import Lexicon

    pron = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                pron.setdefault(parts[0], parts[1:])
    return Lexicon.from_dict(pron)


def _load_corpus(data_dir: str, expected_rate: int):
    """Kaldi data dir -> (Dataset, {utt: samples}); applies segments."""
    from .data import dataset_from_kaldi_dir, extract_segments
    from .data.audio import read_audio

    ds = dataset_from_kaldi_dir(data_dir)
    recs: Dict[str, np.ndarray] = {}
    rate = expected_rate
    for u in ds:
        key = u.recording or u.utt_id
        if key not in recs:
            # read_audio dispatches WAV vs NIST SPHERE (the wav.scp
            # sph2pipe pipes dataset_from_kaldi_dir resolves natively);
            # the channel meta carries 2-channel telephone sides.
            x, r = read_audio(u.wav, channel=int(u.get_meta("channel", "1")))
            if r != expected_rate:
                raise ValueError(
                    f"{u.wav}: sample rate {r} != configured {expected_rate}"
                )
            recs[key] = x
    audio = extract_segments(recs, ds, rate)
    return ds, audio


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sepi_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("variant", choices=["v1", "v2", "v3", "v4", "v5"])
    p.add_argument("--train-data", required=True, help="Kaldi data dir (training)")
    p.add_argument("--enroll-data", required=True,
                   help="Kaldi data dir defining enrollment models (spk2utt)")
    p.add_argument("--eval-data", default=None, help="Kaldi data dir (test)")
    p.add_argument("--trials", required=True, help="NIST trial list")
    p.add_argument("--workdir", required=True)
    p.add_argument("--num-steps", type=int, default=2000)
    p.add_argument("--am-steps", type=int, default=1000, help="v4/v5 AM pretrain steps")
    p.add_argument("--min-chunk", type=int, default=200,
                   help="min training chunk length in frames (--min-frames-per-chunk)")
    p.add_argument("--max-chunk", type=int, default=400,
                   help="max training chunk length in frames (--max-frames-per-chunk)")
    p.add_argument("--chunk-buckets", type=int, default=8,
                   help="distinct static chunk lengths (shape buckets)")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--steps-per-dispatch", type=int, default=8,
                   help="train steps per dispatch unit (superstep; 1 = "
                        "dispatch every step)")
    p.add_argument("--prefetch", type=int, default=2,
                   help="background batch-prefetch depth (0 disables)")
    p.add_argument("--preconditioner", choices=["none", "muon"], default="muon",
                   help="'muon' (default) = orthogonalized-momentum "
                        "preconditioning (the NG-SGD substitute); 'none' = "
                        "reference momentum-SGD-without-NG semantics")
    p.add_argument("--sample-rate", type=int, default=8000)
    p.add_argument("--adapt-data", default=None,
                   help="unlabeled in-domain dir for PLDA adaptation (SRE16)")
    p.add_argument("--musan-dir", default=None,
                   help="MUSAN root (noise/ music/ speech/ wav subtrees) "
                        "for v2 stage-2 augmentation")
    p.add_argument("--rirs-dir", default=None,
                   help="directory tree of RIR wavs (RIRS_NOISES analog)")
    p.add_argument("--aug-subset", type=int, default=128000,
                   help="augmented utterances kept before combining with "
                        "clean (run_sre10.sh subsets 128k)")
    p.add_argument("--aug-pool-max", type=int, default=1000,
                   help="max files loaded per noise/RIR pool (pools are "
                        "held in RAM; 0 = load everything)")
    p.add_argument("--text", default=None, help="Kaldi transcripts (v3/v4/v5)")
    p.add_argument("--lexicon", default=None, help="pronunciation lexicon (v3/v4/v5)")
    p.add_argument("--num-leaves", type=int, default=4096)
    p.add_argument("--fmllr", action="store_true",
                   help="speaker-adaptive re-alignment pass in the s5 stage")
    p.add_argument("--export-kaldi", action="store_true",
                   help="(v1) also write the trained frontend in Kaldi "
                        "format: <workdir>/kaldi/{final.ubm, final.ie}.  "
                        "Backend artifacts (mean.vec/transform.mat/plda) "
                        "are written by every variant unconditionally.")
    p.add_argument("--device", default="cuda", help=DEVICE_HELP)
    return p


def prep_asr_main(argv) -> int:
    """`python -m sepi_tpu_torch prep-asr`: walk raw LDC ASR layouts into
    the Kaldi-style artifacts the v3/v4/v5 flags consume (--train-data
    dir + --text + --lexicon) — the fisher_data_prep.sh /
    swbd1_data_prep.sh / fisher_swbd_prepare_dict.sh / make_mx6.sh
    surface."""
    p = argparse.ArgumentParser(prog="sepi_tpu_torch prep-asr",
                                description=prep_asr_main.__doc__)
    p.add_argument("--fisher-dir", action="append", default=[],
                   help="Fisher LDC root(s) (fe_03_tran / fe_03_data_sph); "
                        "repeatable")
    p.add_argument("--swbd-dir", default=None, help="Switchboard-1 LDC root")
    p.add_argument("--mx6-dir", default=None, help="Mixer 6 (LDC2013S03) root")
    p.add_argument("--cmudict", default=None,
                   help="cmudict.0.7a path (lexicon source; required with "
                        "--fisher-dir/--swbd-dir)")
    p.add_argument("--out-dir", required=True)
    args = p.parse_args(argv)
    from .data.asr_prep import (
        apply_oov, build_lexicon, read_cmudict,
        walk_fisher, walk_mx6, walk_swbd1,
    )
    from .data.corpora import write_kaldi_dir

    transcripts: Dict[str, List[str]] = {}
    datasets = []
    if args.fisher_dir:
        ds, text = walk_fisher(args.fisher_dir)
        datasets.append(ds)
        transcripts.update(text)
    if args.swbd_dir:
        ds, text = walk_swbd1(args.swbd_dir)
        datasets.append(ds)
        transcripts.update(text)
    if args.mx6_dir:
        write_kaldi_dir(walk_mx6(args.mx6_dir),
                        os.path.join(args.out_dir, "mx6"))
        print(f"wrote {args.out_dir}/mx6", flush=True)
    if datasets:
        combined = datasets[0]
        for d in datasets[1:]:
            combined = combined.combine(d)
        train_dir = os.path.join(args.out_dir, "train_asr")
        write_kaldi_dir(combined, train_dir)
        if not args.cmudict:
            raise SystemExit("--cmudict is required to build the lexicon")
        lex, oov = build_lexicon(transcripts, read_cmudict(args.cmudict))
        transcripts = apply_oov(transcripts, lex)
        with open(os.path.join(train_dir, "text"), "w") as f:
            for u in sorted(transcripts):
                f.write(f"{u} {' '.join(transcripts[u])}\n")
        with open(os.path.join(args.out_dir, "lexicon.txt"), "w") as f:
            for w in sorted(lex.pron):
                f.write(f"{w} {' '.join(lex.pron[w])}\n")
        with open(os.path.join(args.out_dir, "oov_counts.txt"), "w") as f:
            for w, c in sorted(oov.items(), key=lambda kv: -kv[1]):
                f.write(f"{c} {w}\n")
        print(f"wrote {train_dir} (+text), {args.out_dir}/lexicon.txt "
              f"({len(lex.pron)} words, {len(oov)} OOV types)", flush=True)
    return 0


def prep_ldc_main(argv) -> int:
    """`python -m sepi_tpu_torch prep-ldc`: walk a raw LDC distribution
    into typed manifests — the CLI surface of the reference's
    `local/make_*.pl` data-prep call sites (`v1/run_sre10.sh:48-76`).
    Writes JSONL manifests (`Dataset.save`) plus NIST trial lists where the
    corpus ships keys; audio stays referenced in place (native SPHERE
    decode resolves channels at load time)."""
    p = argparse.ArgumentParser(prog="sepi_tpu_torch prep-ldc",
                                description=prep_ldc_main.__doc__)
    p.add_argument("--corpus", required=True,
                   choices=["sre", "sre08", "sre10", "sre16-eval",
                            "sre16-unlabeled", "swbd-cellular", "swbd2",
                            "mx6", "musan"])
    p.add_argument("--db", required=True, help="corpus distribution root")
    p.add_argument("--db2", default=None,
                   help="second root (sre08: the enroll/train release)")
    p.add_argument("--out", required=True, help="output manifest directory")
    p.add_argument("--year", default=None, help="sre: two-digit year (04..08)")
    p.add_argument("--sre-ref", default=None, help="sre: combined key file")
    p.add_argument("--condition", default="coreext", help="sre10 condition")
    p.add_argument("--use-vocals", action="store_true",
                   help="musan: keep music tracks with vocals")
    args = p.parse_args(argv)
    from .data import ldc
    from .data.asr_prep import walk_mx6
    from .data.manifest import save_trials

    os.makedirs(args.out, exist_ok=True)
    written = []

    def put(ds, stem=None):
        path = os.path.join(args.out, f"{stem or ds.name}.jsonl")
        ds.save(path)
        written.append(f"{path} ({len(ds)} utts, {len(ds.speakers)} spks)")

    c = args.corpus
    if c == "sre":
        if not (args.year and args.sre_ref):
            p.error("--corpus sre needs --year and --sre-ref")
        put(ldc.walk_sre(args.db, args.year, args.sre_ref))
    elif c == "sre08":
        if not args.db2:
            p.error("--corpus sre08 needs --db (test, LDC2011S08) and "
                    "--db2 (train, LDC2011S05)")
        put(ldc.walk_sre08(args.db, args.db2))
    elif c == "sre10":
        put(ldc.walk_sre10(args.db, args.condition))
    elif c == "sre16-eval":
        enroll, test, trials = ldc.walk_sre16_eval(args.db)
        put(enroll)
        put(test)
        for cond, ts in trials.items():
            tp = os.path.join(args.out, f"trials_{cond}")
            save_trials(ts, tp)
            written.append(f"{tp} ({len(ts)} trials)")
    elif c == "sre16-unlabeled":
        major, minor = ldc.walk_sre16_unlabeled(args.db)
        put(major)
        put(minor)
    elif c == "swbd-cellular":
        put(ldc.walk_swbd_cellular(args.db))
    elif c == "swbd2":
        put(ldc.walk_swbd2_phase(args.db))
    elif c == "mx6":
        put(walk_mx6(args.db))
    elif c == "musan":
        for kind, ds in ldc.walk_musan(args.db, args.use_vocals).items():
            put(ds)
    for line in written:
        print(f"wrote {line}", flush=True)
    return 0


NNET3_ARCHS = ["am", "v2", "v3", "v4", "v5"]


def _save_model(out_dir: str, state_dict, meta: dict) -> str:
    """<out>/model.pt (the state_dict on the host) + <out>/meta.json."""
    import json

    import torch

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "model.pt")
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return path


def load_state_dict_file(path: str):
    """A `model.pt` (from import-kaldi) or a trainer ``ckpt_*.pt`` -> the
    model's state_dict on the host."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model" in obj and "step" in obj:
        obj = obj["model"]  # train.checkpoint.save_checkpoint's payload
    if not (isinstance(obj, dict) and obj
            and all(isinstance(v, torch.Tensor) for v in obj.values())):
        raise SystemExit(
            f"{path}: not a sepi_tpu_torch model file (a state_dict or a "
            "trainer checkpoint)")
    return obj


def interop_main(cmd: str, argv) -> int:
    """`python -m sepi_tpu_torch import-kaldi|export-kaldi`: trained-
    artifact interop.  import-kaldi sniffs the object kind and loads a
    Kaldi-trained v1-v5 nnet3 `final.raw` (utils/nnet3.py) into a port
    model's state_dict (<out>/model.pt + meta.json), an nnet2 `final.mdl`
    the same way, or a classical artifact — `final.dubm`/`final.ubm`/
    `final.ie`/`plda` (utils/kaldi_models.py) — into a model.npz;
    export-kaldi writes either back to the Kaldi wire format (a model.pt
    or trainer ckpt_*.pt needs --arch; a model.npz carries its kind)."""
    import dataclasses as _dc

    p = argparse.ArgumentParser(prog=f"sepi_tpu_torch {cmd}",
                                description=interop_main.__doc__)
    if cmd == "import-kaldi":
        p.add_argument("--raw", required=True,
                       help="Kaldi nnet3 raw model or classical artifact "
                            "(final.dubm/final.ubm/final.ie/plda)")
        p.add_argument("--arch", default=None, choices=NNET3_ARCHS,
                       help="override auto-detection (nnet3 models only)")
        p.add_argument("--out", required=True, help="output directory")
        p.add_argument("--device", default="cuda", help=DEVICE_HELP)
        args = p.parse_args(argv)

        from .utils.kaldi_models import sniff_kaldi_object
        from .utils.nnet3 import Nnet3ParseError, import_kaldi_raw

        kind = sniff_kaldi_object(args.raw)
        if kind in ("diag_ubm", "full_ubm", "ivector_extractor", "plda",
                    "vector", "matrix"):
            return _import_classical(args.raw, kind, args.out)
        if kind == "nnet2":
            return _import_nnet2(args.raw, args.out, args.device)
        if kind == "transition_model":
            # an .mdl leads with <TransitionModel> whether nnet2 or nnet3;
            # b'<Nnet3> ' can occur by chance inside an nnet2 model's
            # weights, so TRY the nnet3 parser (garbage surfaces as
            # Nnet3ParseError) and fall back to the nnet2 importer.
            try:
                model, state_dict, arch = import_kaldi_raw(args.raw, args.arch,
                                                           device=args.device)
            except Nnet3ParseError:
                return _import_nnet2(args.raw, args.out, args.device)
        else:
            model, state_dict, arch = import_kaldi_raw(args.raw, args.arch,
                                                       device=args.device)
        path = _save_model(args.out, state_dict, {
            "arch": arch, "source": os.path.abspath(args.raw),
            "config": _dc.asdict(model.cfg)})
        n_params = sum(int(t.numel()) for t in model.parameters())
        print(f"imported {arch} model ({n_params} params) -> {path}", flush=True)
        return 0

    p.add_argument("--model", required=True,
                   help="model.pt (from import-kaldi) or a trainer "
                        "ckpt_*.pt, or a classical model.npz (from "
                        "import-kaldi)")
    p.add_argument("--arch", default=None, choices=NNET3_ARCHS,
                   help="required for nnet3 .pt models; ignored for "
                        "classical .npz")
    p.add_argument("--out", required=True, help="output raw path")
    args = p.parse_args(argv)
    if args.model.endswith(".npz"):
        return _export_classical(args.model, args.out)
    if args.arch is None:
        raise SystemExit("--arch is required when exporting an nnet3 "
                         ".pt model")
    from .utils.nnet3 import export_kaldi_raw

    export_kaldi_raw(load_state_dict_file(args.model), args.arch, args.out)
    print(f"wrote Kaldi nnet3 raw model {args.out}", flush=True)
    return 0


def _import_nnet2(path: str, out_dir: str, device) -> int:
    """Load a nnet2 final.mdl (the v1 DNN/i-vector acoustic model) into
    <out>/model.pt + meta.json for nnet2_recipe.nnet2_posteriors."""
    import dataclasses as _dc

    from .utils.nnet2_io import import_kaldi_nnet2

    model, state_dict, cfg, priors = import_kaldi_nnet2(path, device=device)
    vpath = _save_model(out_dir, state_dict, {
        "arch": "nnet2", "source": os.path.abspath(path),
        "config": _dc.asdict(cfg)})
    if priors is not None:
        np.save(os.path.join(out_dir, "priors.npy"), priors)
    n_params = sum(int(t.numel()) for t in model.parameters())
    print(f"imported nnet2 p-norm multisplice model ({n_params} params) "
          f"-> {vpath}", flush=True)
    return 0


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _import_classical(path: str, kind: str, out_dir: str) -> int:
    """Load a classical Kaldi artifact into <out>/model.npz + meta.json
    (the reference's layout); read on the host."""
    import json

    from .utils import kaldi_models as km

    os.makedirs(out_dir, exist_ok=True)
    if kind == "diag_ubm":
        g = km.read_diag_ubm(path, device="cpu")
        arrays = {"weights": _host(g.weights), "means": _host(g.means),
                  "vars": _host(g.vars)}
        desc = f"DiagGmm K={g.num_comp} D={g.dim}"
    elif kind == "full_ubm":
        g = km.read_full_ubm(path, device="cpu")
        arrays = {"weights": _host(g.weights), "means": _host(g.means),
                  "covars": _host(g.covars)}
        desc = f"FullGmm K={g.num_comp} D={g.dim}"
    elif kind == "ivector_extractor":
        ext, meta = km.read_ivector_extractor(path, device="cpu")
        arrays = {"t": _host(ext.t), "whitener": _host(ext.whitener),
                  "means": _host(ext.means),
                  "prior_offset": np.float64(meta.prior_offset),
                  "w": meta.w, "w_vec": meta.w_vec}
        desc = (f"IvectorExtractor K={ext.t.shape[0]} D={ext.t.shape[1]} "
                f"M={ext.ivector_dim}")
    elif kind == "plda":
        pl = km.read_plda(path)
        arrays = {"mean": pl.mean, "transform": pl.transform, "psi": pl.psi}
        desc = f"Plda D={pl.dim}"
    elif kind == "vector":
        x = km.read_kaldi_vector_file(path)
        arrays = {"data": x}
        desc = f"vector dim={x.shape[0]}"
    else:  # matrix (mean.vec / transform.mat style bare objects)
        x = km.read_kaldi_matrix_file(path)
        arrays = {"data": x}
        desc = f"matrix {x.shape[0]}x{x.shape[1]}"
    npz = os.path.join(out_dir, "model.npz")
    np.savez(npz, kind=kind, **arrays)
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({"kind": kind, "source": os.path.abspath(path)}, f, indent=2)
    print(f"imported {desc} -> {npz}", flush=True)
    return 0


def _export_classical(npz_path: str, out: str) -> int:
    """Write a classical model.npz back to the Kaldi wire format."""
    import json

    import torch

    from .backend.plda import Plda
    from .classical.gmm import DiagGmm, FullGmm
    from .classical.ivector import IvectorExtractor
    from .utils import kaldi_models as km

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    z = np.load(npz_path)
    kind = str(z["kind"])
    if kind == "diag_ubm":
        km.write_diag_ubm(out, DiagGmm(f32(z["weights"]), f32(z["means"]),
                                       f32(z["vars"])))
    elif kind == "full_ubm":
        km.write_full_ubm(out, FullGmm(f32(z["weights"]), f32(z["means"]),
                                       f32(z["covars"])))
    elif kind == "ivector_extractor":
        ext = IvectorExtractor(f32(z["t"]), f32(z["whitener"]), f32(z["means"]))
        meta = km.IvectorExtractorMeta(float(z["prior_offset"]), z["w"],
                                       z["w_vec"])
        out_meta = km.write_ivector_extractor(
            out, ext, meta, prior_offset=float(z["prior_offset"]))
        with open(out + ".meta.json", "w") as f:
            json.dump({"kind": kind,
                       "mean_column_added": bool(out_meta.mean_column_added),
                       "prior_offset": float(out_meta.prior_offset)},
                      f, indent=2)
        if out_meta.mean_column_added:
            m_dim = int(np.asarray(z["t"]).shape[2])
            print(f"WARNING: approximate export — ivector dim grew "
                  f"{m_dim} -> {m_dim + 1} (mean-carrying column; Kaldi "
                  "pins the extra coordinate only approximately at the "
                  "prior offset, so Kaldi-extracted i-vectors match "
                  "native ones approximately, not exactly)", flush=True)
    elif kind == "plda":
        km.write_plda(out, Plda(z["mean"], z["transform"], z["psi"]))
    elif kind == "vector":
        km.write_kaldi_vector_file(out, z["data"], double=True)
    elif kind == "matrix":
        km.write_kaldi_matrix_file(out, z["data"], double=True)
    else:
        raise SystemExit(f"{npz_path}: unknown classical kind {kind!r}")
    print(f"wrote Kaldi {kind} {out}", flush=True)
    return 0


def gauntlet_main(argv) -> int:
    """`python -m sepi_tpu_torch gauntlet`: the non-degenerate parity run —
    v1-v5 at matched budgets on the calibrated disjoint-speaker synthetic
    corpus, plus the PLDA-adaptation and augmentation ablations.  The
    corpus-free analog of the reference's SRE10/SRE16 acceptance protocol
    (`v2/run_sre10.sh:239-334`); see recipes/gauntlet.py."""
    p = argparse.ArgumentParser(prog="sepi_tpu_torch gauntlet",
                                description=gauntlet_main.__doc__)
    p.add_argument("--workdir", required=True)
    p.add_argument("--scale", choices=["ci", "hw", "ci2", "hw2"],
                   default="ci",
                   help="'ci' = CPU-sized calibration point; 'hw' = "
                        "full-size v2 graph + larger populations (run on "
                        "the card); the '2' variants use the "
                        "phonetically realistic corpus-v2 generator "
                        "(non-stationary speaker identity)")
    p.add_argument("--variants", default="v1,v2,v3,v4,v5")
    p.add_argument("--ablations", action="store_true",
                   help="also run the adaptation + augmentation ablations")
    p.add_argument("--adapt-sweep", action="store_true",
                   help="run the PLDA-adaptation ADAPT-SET-SIZE sweep "
                        "(mean-only vs full 0.75/0.25 covariance "
                        "interpolation at ~216 / ~2k / ~10k vectors) "
                        "instead of the variant gauntlet")
    p.add_argument("--v4-study", action="store_true",
                   help="run the v4 effect-size study (am_lr_factor x "
                        "AM-budget sweep, each cell paired-bootstrapped "
                        "against one shared v2 baseline) instead of the "
                        "variant gauntlet")
    p.add_argument("--bootstrap", type=int, default=0, metavar="N",
                   help="paired speaker-level bootstrap with N replicates: "
                        "pins the v2-vs-phonetic ordering with a 95%% CI "
                        "(the paired delta has far smaller se than either "
                        "EER alone)")
    p.add_argument("--eval-speakers", type=int, default=0,
                   help="override the scale's eval population — the "
                        "statistical-power knob: training is unchanged "
                        "(checkpoints resume), only extraction/backend "
                        "re-run on the larger trial set")
    p.add_argument("--train-seed", type=int, default=None,
                   help="re-seed model init + samplers and isolate "
                        "workdirs per seed — run several to quantify "
                        "TRAINING variance (the component the speaker "
                        "bootstrap excludes)")
    p.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = p.parse_args(argv)
    from .recipes.gauntlet import (
        CI_SCALE, CI_SCALE_V2, HW_SCALE, HW_SCALE_V2, format_table,
        make_gauntlet_data, paired_speaker_bootstrap,
        run_adaptation_ablation, run_adaptation_scale_ablation,
        run_augmentation_ablation, run_gauntlet, run_v4_effect_study,
    )

    dev = args.device
    scale = {"ci": CI_SCALE, "hw": HW_SCALE,
             "ci2": CI_SCALE_V2, "hw2": HW_SCALE_V2}[args.scale]
    if args.eval_speakers:
        import dataclasses as _dc

        scale = _dc.replace(scale, num_eval_speakers=args.eval_speakers)
    if args.adapt_sweep:
        # the sweep has its own calibrated operating point (ADAPT_SCALE);
        # --scale is ignored here
        run_adaptation_scale_ablation(args.workdir, device=dev)
        return 0
    if args.v4_study:
        run_v4_effect_study(args.workdir, scale,
                            n_boot=args.bootstrap or 2000, device=dev)
        return 0
    results = run_gauntlet(args.workdir, scale,
                           variants=tuple(args.variants.split(",")),
                           train_seed=args.train_seed, device=dev)
    print(format_table(results), flush=True)
    if args.bootstrap:
        pairs = [("v2", v) for v in ("v3", "v4", "v5") if v in results]
        if "v1" in results and "v2" in results:
            # the neural-beats-supervector acceptance pair (corpus v2)
            pairs.insert(0, ("v1", "v2"))
        if "v2" not in results or not pairs:
            print("bootstrap: needs v2 (the baseline) plus at least one "
                  "of v3/v4/v5 in --variants; skipping", flush=True)
        else:
            data = make_gauntlet_data(scale)
            utt2spk = {u.utt_id: u.spk_id for u in data.eval.dataset}
            for c in paired_speaker_bootstrap(results, data.trials, utt2spk,
                                              pairs, n_boot=args.bootstrap):
                print(f"bootstrap: {c.line()}", flush=True)
    if args.ablations:
        r = run_adaptation_ablation(args.workdir, scale, device=dev)
        print(f"adaptation: plain EER {r['plain'].pooled.eer*100:.2f}% -> "
              f"mean-recentered {r['mean'].pooled.eer*100:.2f}%; "
              f"minDCF08 {r['plain'].pooled.min_dcf08:.3f} -> "
              f"full-adapted {r['full'].pooled.min_dcf08:.3f}")
        pl, au = run_augmentation_ablation(args.workdir, scale, device=dev)
        print(f"augmentation: clean-train {pl*100:.2f}% -> augmented "
              f"{au*100:.2f}%")
    return 0


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "prep-asr":
        return prep_asr_main(argv[1:])
    if argv and argv[0] == "prep-ldc":
        return prep_ldc_main(argv[1:])
    if argv and argv[0] == "gauntlet":
        return gauntlet_main(argv[1:])
    if argv and argv[0] in ("import-kaldi", "export-kaldi"):
        return interop_main(argv[0], argv[1:])
    args = build_parser().parse_args(argv)
    from .config import AlignConfig, ChunkConfig, OptimizerConfig, TrainConfig
    from .data.manifest import load_trials
    from .device import resolve_device
    from .recipes import drivers

    resolve_device(args.device)  # before any corpus is read
    train_cfg = TrainConfig(
        optimizer=OptimizerConfig(preconditioner=args.preconditioner),
        chunks=ChunkConfig(
            min_chunk_len=args.min_chunk, max_chunk_len=args.max_chunk,
            num_buckets=args.chunk_buckets,
            frames_per_chunk_avg=(args.min_chunk + args.max_chunk) // 2,
        ),
        batch_size=args.batch_size,
        steps_per_dispatch=args.steps_per_dispatch,
        prefetch=args.prefetch,
    )

    train_ds, train_audio = _load_corpus(args.train_data, args.sample_rate)
    enroll_ds, enroll_audio = _load_corpus(args.enroll_data, args.sample_rate)
    if args.eval_data:
        eval_ds, eval_audio = _load_corpus(args.eval_data, args.sample_rate)
    else:
        eval_ds, eval_audio = enroll_ds, {}
    trials = load_trials(args.trials)
    enroll = enroll_ds.spk2utt
    # the extractor needs every trial-side utterance's audio available
    eval_audio = {**enroll_audio, **eval_audio}

    aug_kw = {}
    if args.musan_dir or args.rirs_dir:
        from .data.audio import read_audio
        from .recipes.drivers import AugmentOptions

        def pool(root):
            out = []
            for dirpath, dirs, files in os.walk(root):
                dirs.sort()  # filesystem-order walks break seed determinism
                for f in sorted(files):
                    if f.lower().endswith((".wav", ".sph")):
                        x, r = read_audio(os.path.join(dirpath, f))
                        if r != args.sample_rate:
                            raise ValueError(
                                f"{dirpath}/{f}: rate {r} != {args.sample_rate}"
                            )
                        out.append(x)
                        if args.aug_pool_max and len(out) >= args.aug_pool_max:
                            return out
            return out

        noises = {}
        if args.musan_dir:
            for kind, sub in (("noise", "noise"), ("music", "music"),
                              ("babble", "speech")):
                d = os.path.join(args.musan_dir, sub)
                if os.path.isdir(d):
                    noises[kind] = pool(d)
        rirs = pool(args.rirs_dir) if args.rirs_dir else ()
        aug_kw = {"augments": AugmentOptions(
            rirs=rirs, noises=noises, subset=args.aug_subset)}

    adapt_kw = {}
    if args.adapt_data:
        adapt_ds, adapt_audio = _load_corpus(args.adapt_data, args.sample_rate)
        adapt_kw = (
            {"adapt_audio": adapt_audio} if args.variant == "v1"
            else {"adapt_dataset": adapt_ds, "adapt_audio": adapt_audio}
        )

    phonetic_kw = {}
    if args.variant in ("v3", "v4", "v5"):
        if not (args.text and args.lexicon):
            raise SystemExit(
                f"{args.variant} needs --text and --lexicon (the s5 aligner "
                "inputs) or precomputed alignments via the Python API"
            )
        phonetic_kw = dict(
            transcripts=load_transcripts(args.text),
            lexicon=load_lexicon(args.lexicon),
            align_cfg=AlignConfig(num_leaves=args.num_leaves, fmllr=args.fmllr),
        )

    dev = {"device": args.device}
    if args.variant == "v1":
        if aug_kw:
            raise SystemExit(
                "v1 does not take --musan-dir/--rirs-dir: the reference "
                "i-vector recipe trains on unaugmented data "
                "(egs/sre/v1/run_sre10.sh has no augmentation stage)"
            )
        res = drivers.run_v1(train_ds, train_audio, eval_audio, trials, enroll,
                             args.workdir, export_kaldi=args.export_kaldi,
                             **adapt_kw, **dev)
    elif args.variant == "v2":
        res = drivers.run_v2(train_ds, train_audio, eval_ds, eval_audio, trials,
                             enroll, args.workdir, train_cfg=train_cfg,
                             num_steps=args.num_steps, **adapt_kw, **aug_kw, **dev)
    elif args.variant == "v3":
        res = drivers.run_v3(train_ds, train_audio, eval_audio, trials, enroll,
                             args.workdir, train_cfg=train_cfg,
                             num_steps=args.num_steps, **phonetic_kw, **aug_kw,
                             **dev)
    elif args.variant == "v4":
        res = drivers.run_v4(train_ds, train_audio, eval_audio, trials, enroll,
                             args.workdir, train_cfg=train_cfg,
                             am_steps=args.am_steps,
                             num_steps=args.num_steps, **phonetic_kw, **aug_kw,
                             **dev)
    else:
        res = drivers.run_v5(train_ds, train_audio, eval_audio, trials, enroll,
                             args.workdir, train_cfg=train_cfg,
                             am_steps=args.am_steps,
                             num_steps=args.num_steps, **phonetic_kw, **aug_kw,
                             **dev)
    print(res.report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
