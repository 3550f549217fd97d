"""What decides ``correct`` fails what it must.

The control (the reference put in the program's place in the next lower
precision: TF32 for the float32 extraction, fp8 for the bf16 training)
reads above each cell's limit while the program reads below it; and a
run whose timed path is broken underneath comes out not correct, once
for each fault the cell can have.  (The exchange between chips is not a
fault of these one-card cells.)  Readings here are at the tests' small
sizes on the CPU; the limits' readings on the card are in PERF.md."""

import numpy as np
import pytest

import tiny

SERVING = ["xvector_v2.extract", "cvector_v5.extract", "xvector_v2.verify"]


@pytest.mark.parametrize("cell", SERVING)
def test_the_tf32_control_fails_where_the_program_passes(cell):
    out = tiny.execute(cell, controls=("tf32",))
    limits = tiny.OVERRIDES[cell].get("limits", {}).get("limits") or \
        __import__("harness.core", fromlist=["x"]).load_json(
            f"{tiny.BENCH}/limits/{cell}.json")["limits"]
    got, ctl = out.work["readings"]["ref"], out.work["readings"]["tf32"]
    if isinstance(got, float):
        got, ctl = {"embedding_rel_gap": got}, {"embedding_rel_gap": ctl}
    else:
        got = {"embedding_rel_gap": got["emb"], "score_abs_gap": got["score"]}
        ctl = {"embedding_rel_gap": ctl["emb"], "score_abs_gap": ctl["score"]}
    assert out.correct and all(got[k] <= limits[k] for k in got)
    assert any(ctl[k] > limits[k] for k in ctl)


def test_the_fp8_control_fails_where_the_program_passes():
    out = tiny.execute("cvector_v5.train", controls=("fp8",))
    limits = {c.name: c.limit for c in out.checks}
    ctl = out.work["readings"]["fp8"]
    assert out.correct and any(ctl[k] > v for k, v in limits.items())


def _altered(monkeypatch):
    from sepi_tpu_torch.extract import EmbeddingExtractor

    orig = EmbeddingExtractor._embed

    def embed(self, feats, mask):
        return orig(self, feats, mask) * np.float32(1.001)

    monkeypatch.setattr(EmbeddingExtractor, "_embed", embed)


def _half_batch(monkeypatch):
    from sepi_tpu_torch.extract import EmbeddingExtractor

    orig = EmbeddingExtractor._embed

    def embed(self, feats, mask):
        out = orig(self, feats, mask)
        rows = np.flatnonzero(np.asarray(mask).any(1))  # the rows that carry chunks
        if len(rows) > 1:
            out[rows[len(rows) // 2:]] = out[rows[: len(rows) // 2]].mean(0)
        return out

    monkeypatch.setattr(EmbeddingExtractor, "_embed", embed)


def _train_fault(kind):
    def plant(monkeypatch):
        from sepi_tpu_torch.train import trainer

        if kind == "unchanged":
            monkeypatch.setattr(trainer, "apply_updates", lambda params, updates: None)
            return
        orig = trainer._ce_step

        def ce_step(tx, kw, group):
            inner = orig(tx, kw, group)

            def step(state, feats, labels, weight=1.0, scalars=None):
                if kind == "half":
                    h = feats.shape[0] // 2
                    return inner(state, feats[:h], labels[:h], weight, scalars)
                m = inner(state, feats, labels, weight, scalars)
                return dict(m, objf=m["objf"] * 1.01)

            return step

        monkeypatch.setattr(trainer, "_ce_step", ce_step)

    return plant


def _late_bucket(monkeypatch):
    """The loss altered in the longest chunk bucket's steps alone, and only
    once set-up has ended: set-up's checked units cannot see it, the
    window's (every bucket, from the window's final state) must."""
    from harness import core
    from sepi_tpu_torch.train import trainer

    late, mark, orig = [], core.Marks.__call__, trainer._ce_step
    longest = tiny.OVERRIDES["cvector_v5.train"]["config"]["train"]["chunks"]["max_chunk_len"]

    def marked(self, name):
        mark(self, name)
        late.append(name == "warm-up" or bool(late and late[-1]))

    def ce_step(tx, kw, group):
        inner = orig(tx, kw, group)

        def step(state, feats, labels, weight=1.0, scalars=None):
            m = inner(state, feats, labels, weight, scalars)
            if late and late[-1] and feats.shape[1] == longest:
                return dict(m, objf=m["objf"] * 1.05)
            return m

        return step

    monkeypatch.setattr(core.Marks, "__call__", marked)
    monkeypatch.setattr(trainer, "_ce_step", ce_step)


# a verification request is a batch of one utterance: no half to leave out
FAULTS = [(c, f.__name__, f) for c in SERVING for f in (_altered, _half_batch)
          if (c, f) != ("xvector_v2.verify", _half_batch)] + [
    ("cvector_v5.train", k, _train_fault(k)) for k in ("unchanged", "half", "altered")] + [
    ("cvector_v5.train", "late_bucket", _late_bucket)]


@pytest.mark.parametrize("cell,name,plant", FAULTS, ids=[f"{c}-{n}" for c, n, _ in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, name, plant, monkeypatch):
    plant(monkeypatch)
    rc, res = tiny.run(cell)
    assert rc == 0 and res["correct"] is False, res["checks"]
