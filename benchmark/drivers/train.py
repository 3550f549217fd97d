"""Training a speaker network through the port's Trainer, for any model
kind with a ``train`` section.

Training is assembled by the model kind's ``train_setup``
(`benchmark/models/<model>.py`) as its recipe assembles it: the combined
c-vector's interleaved am and xvec supersteps as
`recipes/phonetic._two_task_run` does (`phonetic._heldout_valid`,
`phonetic._multitask_iter`, the ``am`` learning-rate factor, the am
subtree grafted from a seeded `AmNet`), the x-vector's one ``xvec`` task
as `recipes/pipeline.train_xvector_model` does.  The driver then builds
`make_task_supersteps`, `batch_iterator` (prefetch thread) and a `Trainer`
that logs every 50 steps and evaluates the held-out batches every 100,
under `fp32_math` as the recipes run.  The benchmark adds only what it
measures with: a `Recorder` around each superstep the Trainer calls, the
window's deadline (`until`) and seeded weights made on the device.  The
data lives in host memory, made from the seed: speakers x utterances x
frames of 23-dim features (a speaker offset plus noise) and, for a model
with senones, random senone alignments.  No checkpoints.

Set-up takes the Trainer through its first supersteps on the feed until
every task has run one (the checked units), then runs the superstep of
every chunk bucket not yet met on batches of a sampler of its own, so
the window meets no shape for the first time.  The window is one
`Trainer.run` over the feed that stops at the first block boundary after
the window's seconds; it ends when that run returns and the card is idle.
End to end: the window's milliseconds over the steps the Trainer
completed in it.

``correct``: checked units are followed by the plain reference
(`reference.train`, with the model kind's ``forward_train``) from the
program's state before each, on the same batch: forward, loss, backward
and the optimizer chain (`compare`).  A superstep shows its state only between
units, so the reference follows the program unit by unit from its own
state.  The checked units are set-up's (the first ``check.units`` units
of the feed, each task among them, from the seeded state) and, once the
window has closed, the window's: the Trainer goes on from the window's
final state over the same feed until every task has run a unit, then
the superstep the Trainer calls runs once on every chunk bucket not among
them, so every superstep shape the window ran is compared at the state
the window left.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from harness import audio
from harness import weights as W
from harness.core import Check, Marks, Outcome, RunContext, Spans, limit
from harness.flops import train_forward_flops
from harness.profiling import Window
from harness.training import TrainInputs
from reference import train as ref_train

# the reference's arithmetic for the configuration's stated training precision
REF_PRECISION = {"bfloat16": "bf16", "float32": "ref"}


def make_data(tr: Dict, cfg: Dict, seed: int, dev: torch.device):
    """{utt: (frames, D) float32}, {utt: (frames,) int32 senones} (none
    for a model without senones), Utterance rows."""
    from sepi_tpu_torch.data.manifest import Utterance

    g = audio.generator(seed, dev)
    spk, per, t, d = tr["speakers"], tr["utts_per_speaker"], tr["frames_per_utt"], cfg["feat_dim"]
    offsets = torch.randn((spk, 1, 1, d), generator=g, device=dev)
    feats = (torch.randn((spk, per, t, d), generator=g, device=dev) + offsets).reshape(-1, t, d)
    names = [f"spk{s:05d}-u{k}" for s in range(spk) for k in range(per)]
    utts = [Utterance(utt_id=n, spk_id=n.split("-")[0], num_frames=t) for n in names]
    alignments = {}
    if cfg.get("num_senones"):
        ali = torch.randint(0, cfg["num_senones"], (spk * per, t), generator=g, device=dev,
                            dtype=torch.int32)
        alignments = dict(zip(names, ali.cpu().numpy()))
    return dict(zip(names, feats.cpu().numpy())), alignments, utts


class Recorder:
    """A training call as the Trainer makes it (a superstep, or with K = 1
    a step), counting every unit's work.  While ``keep`` records, it also
    keeps each unit's task, batch and metrics and the state before it, and
    for the first unit of each task the state after it, on the host.  A
    step's batch and metrics are kept as a unit of one step."""

    def __init__(self, task: str, call, keep: List, single: bool = False):
        self.task, self.call, self.keep, self.single = task, call, keep, single
        self.units: List[tuple] = []  # (task, K, batch, frames)
        self.shapes = set()

    def __call__(self, state, feats, labels, weights):
        keep = self.keep is not None and self.keep.recording
        if keep:
            batch = (feats, labels, torch.as_tensor(weights, dtype=torch.float32))
            if self.single:
                batch = tuple(x.reshape(1, *x.shape) for x in batch)
            rec = {"task": self.task, "before": snapshot(state),
                   "batch": tuple(host(x) for x in batch)}
        out = self.call(state, feats, labels, weights)
        shape = (1,) + tuple(feats.shape) if self.single else tuple(feats.shape)
        self.units.append((self.task,) + shape[:3])
        self.shapes.add(shape)
        if keep:
            rec["metrics"] = {m: host(v).reshape(-1) for m, v in out.items()}
            if all(r["task"] != self.task for r in self.keep):
                rec["after"] = snapshot(state)
            self.keep.append(rec)
        return out

    def bucket(self, state, sampler, frames: int, k: int, dev) -> None:
        """One unit of ``k`` batches of ``sampler``'s bucket ``frames``."""
        bs = [sampler.sample_batch(frames) for _ in range(k)]
        feats, labels = (torch.from_numpy(np.stack([getattr(x, a) for x in bs])).to(dev)
                         for a in ("feats", "labels"))
        weights = torch.ones(k, device=dev)
        if self.single:
            feats, labels, weights = feats[0], labels[0], weights[0]
        self(state, feats, labels, weights)


class Kept(list):
    """The checked units, in the order they ran."""

    recording = True


def host(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", copy=True)


def snapshot(state) -> Dict:
    return {"params": {n: host(p) for n, p in state.model.named_parameters()},
            "mu": {n: host(t) for n, t in state.opt_state["mu"].items()},
            "nu": {n: host(t) for n, t in state.opt_state.get("nu", {}).items()},
            "count": int(state.opt_state["count"])}


def until(it, deadline, block: int):
    """The feed, stopped at the first block boundary past the deadline."""
    n = 0
    for item in it:
        yield item
        n += 1
        if n % block == 0 and deadline():
            return


def checked_units(trainer, it, recorders, keep, state, sampler, frames, K, dev, units=0):
    """Units through ``trainer`` on the feed ``it`` until each task has run
    one (and at least ``units`` ran), recorded into ``keep``; then, with
    ``sampler``, a unit of every bucket in ``frames`` not yet run (all of
    them recorded while ``keep`` records)."""
    for r in recorders.values():
        r.keep = keep
    while len(keep) < units or {r["task"] for r in keep} != set(recorders):
        trainer.run(it, num_steps=K)
    xvec = recorders["xvec"]
    for b in frames:
        if not any(s[2] == b for s in xvec.shapes):
            xvec.bucket(state, sampler, b, K, dev)


def run(ctx: RunContext) -> Outcome:
    from sepi_tpu_torch.config import ChunkConfig, OptimizerConfig, TrainConfig
    from sepi_tpu_torch.data.manifest import Dataset
    from sepi_tpu_torch.data.sampler import ChunkSampler
    from sepi_tpu_torch.device import fp32_math
    from sepi_tpu_torch.recipes.pipeline import batch_iterator, make_task_supersteps
    from sepi_tpu_torch.train import Trainer

    cfg, tr, dev, kind = ctx.cell.config, ctx.cell.traffic, ctx.device, ctx.cell.model
    tc = cfg["train"]
    marks = Marks(ctx)
    spans = Spans(record=ctx.trace)
    K = tc["steps_per_dispatch"]
    seed = ctx.sub_seed(6) % (1 << 31)
    train_cfg = TrainConfig(
        optimizer=OptimizerConfig(**tc["optimizer"]), chunks=ChunkConfig(**tc["chunks"]),
        batch_size=tc["batch_size"],
        **({"am_batch_size": tc["am_batch_size"]} if "am_batch_size" in tc else {}),
        compute_dtype="bfloat16" if tc["precision"] == "bfloat16" else "float32", seed=seed,
        steps_per_dispatch=K, prefetch=tc["prefetch"])
    if tr["speakers"] != cfg["num_speakers"]:
        raise ValueError(f"{tr['speakers']} speakers in the mix, {cfg['num_speakers']} outputs")
    features, alignments, utts = make_data(tr, cfg, ctx.sub_seed(7), dev)
    dataset = Dataset(utts, "train")
    marks("data")
    num_steps = tr["num_steps"]

    with fp32_math():
        # the recipe's assembly, in its order of draws; the weights from the seed
        asm = kind.train_setup(TrainInputs(
            kind, cfg, train_cfg, features, alignments, dataset, num_steps, dev,
            lambda shapes, tag: W.make(shapes, ctx.sub_seed(tag), dev, kind)))
        state = asm.state
        keep = Kept()
        supersteps = make_task_supersteps(asm.tx, asm.tasks, train_cfg)
        recorders = {t: Recorder(t, (supersteps or asm.steps)[t], keep,
                                 single=supersteps is None) for t in asm.tasks}
        trainer = Trainer(steps=recorders if supersteps is None else asm.steps, state=state,
                          log_every=tc["log_every"], valid_batches=asm.valid_batches,
                          eval_steps=asm.eval_steps, eval_every=tc["eval_every"],
                          supersteps=None if supersteps is None else recorders,
                          steps_per_dispatch=K)
        it = batch_iterator(asm.feed, train_cfg)
        try:
            marks("model")
            # set-up: the checked units from the feed, then every bucket's superstep
            warm = ChunkSampler(asm.train_feats, asm.train_ds, train_cfg.chunks,
                                train_cfg.batch_size, seed + 2, label_map=asm.label_map)
            checked_units(trainer, it, recorders, keep, state, warm, (), K, dev,
                          tr["check"]["units"])
            keep.recording = False
            marks("checked units")
            checked_units(trainer, it, recorders, keep, state, warm, warm.buckets, K, dev)
            for vb in asm.valid_batches or ():
                asm.eval_steps[vb.task](state, vb.feats, vb.labels)
            marks("warm-up")
            for r in recorders.values():
                r.units.clear()
            done0 = trainer.steps_done

            win = Window(dev, ctx.trace)
            setup_s = win.start() - ctx.process_start
            with spans.span("trainer_run"):
                trainer.run(until(it, lambda: win.elapsed() >= ctx.seconds, K))
            window_s = win.stop()
            steps_done = trainer.steps_done - done0
            units = [u for r in recorders.values() for u in r.units]
            peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

            # the window's units: from its final state, every task and bucket
            post = Kept()
            for r in recorders.values():
                r.shapes.clear()
            checked_units(trainer, it, recorders, post, state, warm, warm.buckets, K, dev)
        finally:
            if hasattr(it, "close"):
                it.close()
    flops = sum(3.0 * k * train_forward_flops(cfg, t, b, f, kind) for t, k, b, f in units)
    ref_init, lr_factors = asm.ref_init, asm.lr_factors
    del trainer, state, recorders, it, supersteps, asm
    gc.collect()

    t_ref = time.perf_counter()
    ref_prec = REF_PRECISION[tc["precision"]]
    readings = compare(keep, post, ref_init, cfg, tc, num_steps, dev, ref_prec,
                       tuple(ctx.controls), kind, lr_factors)
    ref_s = time.perf_counter() - t_ref
    got = readings[ref_prec]
    checks = [Check(n, got[n], limit(ctx.cell, n)) for n in ctx.cell.limits["limits"]]
    work = {"steps": steps_done, "units": len(units), "train_flops": flops,
            "am_units": sum(1 for u in units if u[0] == "am"), "reference_s": ref_s,
            "checked_units": {"set-up": len(keep), "window": len(post)},
            "setup_marks": marks.marks, "host": win.host, "readings": readings}
    return Outcome({"train_step_ms": 1e3 * window_s / max(steps_done, 1), "setup_s": setup_s},
                   steps_done, 0, checks, window_s, setup_s, int(peak), work, spans, win.summary)


def trajectory(rec: Dict, chain, cfg: Dict, dev, variant: str, kind) -> Dict:
    """The reference over one checked unit from the program's state before
    it, on the same batch: each step's objf and gradient norm, the first
    step's gradients, and for a unit the program kept the state after, the
    parameters and first moments after every step of the unit.
    ``variant`` is a precision of `reference.precision`, or
    "<precision>-half": a planted fault, the step on half of each batch."""
    prec, _, fault = variant.partition("-")
    before = rec["before"]
    params = {n: p.to(dev) for n, p in before["params"].items()}
    state = {"count": before["count"],
             "mu": {n: t.to(dev, torch.float64) for n, t in before["mu"].items()},
             "nu": {n: before["nu"].get(n, torch.zeros_like(t)).to(dev, torch.float64)
                    for n, t in before["mu"].items()}}
    feats, labels, weights = (x.to(dev) for x in rec["batch"])
    if fault == "half":
        feats, labels = feats[:, : feats.shape[1] // 2], labels[:, : labels.shape[1] // 2]
    out = {"objf": [], "grad_norm": [], "grads": None}
    for k in range(feats.shape[0] if "after" in rec else 1):
        r = ref_train.step(params, state, chain, feats[k], labels[k], float(weights[k]),
                           rec["task"], cfg, prec, kind.forward_train)
        out["grads"] = out["grads"] or r["grads"]
        out["objf"].append(r["objf"])
        out["grad_norm"].append(r["grad_norm"])
    if "after" in rec:
        out.update(params=params, mu=state["mu"])
    return out


def program_side(rec: Dict, dev) -> Dict:
    """What the program produced over a checked unit, in `trajectory`'s terms."""
    m = rec["metrics"]
    out = {"objf": [float(v) for v in m["objf"]], "grad_norm": [float(v) for v in m["grad_norm"]]}
    if "after" in rec:
        out.update(params={n: t.to(dev) for n, t in rec["after"]["params"].items()},
                   mu={n: t.to(dev) for n, t in rec["after"]["mu"].items()})
    return out


def family(name: str) -> str:
    """A leaf's kind: its module and parameter, e.g. "batchnorm.weight"."""
    return ".".join(name.split(".")[-2:])


def compare(keep: List, post: List, ref_init: Dict, cfg: Dict, tc: Dict, num_steps: int, dev,
            ref_prec: str, controls: tuple, kind, lr_factors: Dict) -> Dict[str, Dict]:
    """The numbers compared, for the program and for each control put in
    its place, each against the reference (``ref_prec``) from the same
    state on the same batch.  Over set-up's units (``keep``): the first
    step's loss and global gradient norm of every unit (their root mean
    square, ``*_first_rel_gap``), and over the K steps of the first unit
    of each task the per-leaf first moment and change (their median leaf).
    Over the window's units (``post``): the first step's loss and gradient
    norm (``window_*_rel_gap``) and the median leaves of the first unit of
    each task (``window_*_median_leaf_gap``).  Each unit's later steps,
    worst leaf and median leaf of each family go to ``detail``."""
    chain = ref_train.Chain(tc["optimizer"], num_steps, lr_factors)
    out = {v: {"start_gap": 0.0} for v in (ref_prec,) + controls}
    for v in out:
        out[v]["detail"] = []
    for group, recs in (("first", keep), ("window", post)):
        pre = "" if group == "first" else "window_"
        gaps = {v: {"loss": [], "grad_norm": [], "moment": [], "change": []} for v in out}
        for rec in recs:
            ref = trajectory(rec, chain, cfg, dev, ref_prec, kind)
            moving = start = None
            if "after" in rec:
                norms = {n: float(g.double().norm()) for n, g in ref["grads"].items()}
                med = float(np.median([x for x in norms.values() if x > 0]))
                moving = [n for n, x in norms.items() if x >= 1e-3 * med]
                start = {n: p.to(dev).double() for n, p in rec["before"]["params"].items()}
            for v in out:
                got = program_side(rec, dev) if v == ref_prec else \
                    trajectory(rec, chain, cfg, dev, v, kind)
                n_steps = len(ref["objf"])
                loss = [abs(got["objf"][k] - ref["objf"][k]) / abs(ref["objf"][k])
                        for k in range(n_steps)]
                gnorm = [abs(got["grad_norm"][k] - ref["grad_norm"][k]) / ref["grad_norm"][k]
                         for k in range(n_steps)]
                gaps[v]["loss"].append(loss[0])
                gaps[v]["grad_norm"].append(gnorm[0])
                unit = {"group": group, "task": rec["task"], "count": rec["before"]["count"],
                        "frames": int(rec["batch"][0].shape[2]), "loss": loss,
                        "grad_norm": gnorm, "ref_objf": ref["objf"][0],
                        "ref_grad_norm": ref["grad_norm"][0]}
                if moving is not None:
                    if group == "first" and rec["before"]["count"] == 0:
                        out[v]["start_gap"] = max(
                            float((rec["before"]["params"][n] - ref_init[n].cpu()).abs().max())
                            for n in ref_init)
                    mom = ref_train.leaf_gaps(got["mu"], ref["mu"], moving)
                    chg = ref_train.leaf_gaps(
                        {n: got["params"][n].double() - start[n] for n in moving},
                        {n: ref["params"][n].double() - start[n] for n in moving}, moving)
                    gaps[v]["moment"].append(float(np.median(list(mom.values()))))
                    gaps[v]["change"].append(float(np.median(list(chg.values()))))
                    fams = sorted({family(n) for n in moving})
                    unit.update({
                        "left_out": len(ref["grads"]) - len(moving),
                        "moment_worst": max(mom.items(), key=lambda kv: kv[1]),
                        "change_worst": max(chg.items(), key=lambda kv: kv[1]),
                        "moment_by_family": {f: float(np.median(
                            [x for n, x in mom.items() if family(n) == f])) for f in fams},
                        "change_by_family": {f: float(np.median(
                            [x for n, x in chg.items() if family(n) == f])) for f in fams}})
                out[v]["detail"].append(unit)
        for v, g in gaps.items():
            if not g["loss"]:
                continue
            mid = "_first" if group == "first" else ""
            for key in ("loss", "grad_norm"):
                out[v][f"{pre}{key}{mid}_rel_gap"] = float(np.sqrt(np.mean(np.square(g[key]))))
                out[v][f"{pre}{key}{mid}_max"] = max(g[key])
            for key in ("moment", "change"):
                out[v][f"{pre}{key}_median_leaf_gap"] = max(g[key], default=0.0)
    return out
