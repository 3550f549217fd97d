"""The MFA-Conformer cell, `mfa_conformer.extract`: its CPU dry run at a
small size, the kind's names against the program's, its flop count at the
published widths by hand, the attention score kernel's roofline reader
against a direct count, and a cell found by name whose kind loads neither
JAX nor the program."""

import json

import pytest

import tiny
from harness import audio, core
from harness.profiling import TraceSummary
from reference.extract import chunks
from reference.frontend import num_frames
from test_harness_imports import JAX, PROGRAM, _modules_after

CELL = "mfa_conformer.extract"
SMALL = {"feat_dim": 40, "d_model": 32, "num_blocks": 2, "num_heads": 2, "ff_dim": 64,
         "conv_kernel": 5, "mfa_channels": 64, "attention_bottleneck": 16, "embed_dim": 24,
         "num_speakers": 10,
         "frontend": {"num_mel_bins": 40, "num_ceps": 40}, "extract": {"chunk_size": 200}}
OVERRIDES = {"config": SMALL, "traffic": tiny.SERVE}
PUBLISHED = core.load_json(core.BENCH_DIR / "configs" / "mfa_conformer.json")
BENCH = json.load(open(f"{tiny.REPO}/BENCHMARK.json"))
READER = core.BENCH_DIR / "metrics" / "relpos_softmax_roofline.extract.py"


def test_a_run_reports_the_cells_metrics():
    rc, res = tiny.run(CELL, overrides=OVERRIDES)
    assert rc == 0 and res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"extract_audio_s_per_s", "setup_s"}
    assert res["checks"]["embedding_rel_gap"]["value"] < 1e-5  # float32 against float64


def test_a_traced_run_reports_what_the_cpu_can_read():
    """No device trace and no peaks table on the CPU: of the cell's
    per-layer metrics only the frontend's share reads."""
    rc, res = tiny.run(CELL, trace=1, overrides=OVERRIDES)
    assert rc == 0 and res["correct"]
    assert set(res["metrics"]) == {"frontend_pct.extract"}
    names = {m["name"] for m in core.cell_metrics(BENCH, CELL, True)}
    assert names == {"frontend_pct.extract", "mfcc_roofline.extract", "mfu.extract",
                     "device_idle_pct.extract", "conv_pct.extract",
                     "relpos_softmax_roofline.extract"}


def test_the_tf32_control_fails_the_limit():
    import run as bench_run

    args = bench_run.parse(["--workload", CELL, "--seed", str(tiny.SEED), "--seconds", "0.3"])
    out = bench_run.execute(args, device="cpu", overrides=OVERRIDES, controls=("tf32",))[3]
    lim = core.limit(core.find_cell(BENCH, CELL), "embedding_rel_gap")
    assert out.correct and out.work["readings"]["ref"] < lim < out.work["readings"]["tf32"]


def test_the_kinds_names_are_the_programs():
    """Every tensor the configuration names is the program's, with its
    shape, but for the batch norms' offsets and step counts; 20,213,888
    parameters without the AAM weight, about the 20.2 M counted by layer."""
    import torch

    kind = core.model_kind(PUBLISHED)
    with torch.device("meta"):
        model = kind.build(PUBLISHED, torch.device("meta"))
    state = {n: tuple(t.shape) for n, t in model.state_dict().items()
             if not n.endswith(kind.PROGRAM_ONLY)}
    names = kind.param_names(PUBLISHED)
    assert state == names
    total = sum(torch.Size(s).numel() for n, s in names.items()
                if not n.endswith(("running_mean", "running_var")) and n != "aam.weight")
    assert total == 20_213_888 and abs(total - 20.2e6) < 0.01 * 20.2e6
    ones = {n for n in names if kind.starts_at_one(n)}
    assert {n.rsplit(".", 1)[-1] for n in ones} == {"weight", "running_var"}
    assert "blocks.0.norm_ff1.weight" in ones and "pool_bn.weight" in ones
    assert "blocks.0.norm_ff1.bias" not in ones and "blocks.0.mhsa.pos_bias_u" not in ones


@pytest.mark.parametrize("frames", [3000, 10000])
def test_embed_flops_at_the_published_widths_by_hand(frames):
    """82.7 MFLOP a subsampled frame outside the attention, and 9,216 T'^2
    a chunk for the three attention products over six blocks."""
    kind = core.model_kind(PUBLISHED)
    sub = 256 * 256 * 9 * 37 + 9472 * 256  # second convolution, the affine
    block = 2 * 256 * 2048 * 2 + 4 * 256 * 256 + 3 * 256 * 256 + 256 * 15
    pool = 4608 * 128 + 128 * 1536
    frame = 2 * (sub + 6 * block + pool)
    assert frame == 80_786_432
    assert kind.frame_flops(PUBLISHED) == frame
    t1, t2 = (frames - 3) // 2 + 1, (frames - 1) // 2 - 2
    front = 2 * (frames * 80 * 80 + t1 * 39 * 9 * 256)
    positions = 2 * 6 * (2 * t2 - 1) * 256 * 256
    products = 9216 * t2 * t2
    head = 2 * 3072 * 192
    want = t2 * frame + front + positions + products + head
    assert kind.embed_flops(PUBLISHED, frames) == want
    per_frame_outside = (t2 * frame + front + positions + head) / t2
    assert 82.5e6 < per_frame_outside < 82.9e6


def test_the_score_kernels_bytes_against_a_direct_count():
    """The reader's bytes on a tiny mix (three durations, one over the
    200-frame chunk cap) against each chunk's 12 T' bytes a row counted
    by hand, over the window's shards; the kernel's traced time found by
    name, the parent's trace (no such kernel) read as nothing."""
    cell = core.find_cell(BENCH, CELL, overrides={
        "config": SMALL, "traffic": {"pool_utts": 3, "duration_s": {"min": 0.6, "max": 3.1}}})
    secs = audio.durations(cell.traffic["duration_s"], 3)
    lens = [length for s in secs
            for _, length in chunks(num_frames(int(round(s * 16000)), cell.config["frontend"]),
                                    cell.config["extract"])]
    assert len(lens) > len(secs)  # the longest is cut into chunks
    per_shard = sum(12 * 2 * 2 * ((n - 1) // 2 - 2) ** 2 for n in lens)
    reader = core.load_module(READER)
    peaks = {"hbm_bytes_per_s": 1e9}
    kernels = {"_relpos_softmax_kernel": 0.25, "_relpos_softmax_kernel_1": 0.25, "gemm": 3.0}
    out = core.Outcome({}, 0, 0, [], 1.0, 1.0, 0, work={"shards": 5},
                       trace=TraceSummary(4.0, 5.0, kernels, [], 3))
    assert reader.read(out, cell, peaks) == pytest.approx(100.0 * 5 * per_shard / 1e9 / 0.5)
    parent = core.Outcome({}, 0, 0, [], 1.0, 1.0, 0, work={"shards": 5},
                          trace=TraceSummary(4.0, 5.0, {"gemm": 3.0}, [], 1))
    assert reader.read(parent, cell, peaks) is None
    assert reader.read(core.Outcome({}, 0, 0, [], 1.0, 1.0, 0), cell, peaks) is None


def test_the_cell_is_found_by_name():
    """Its configuration, mix, limits, kind and new metric are files found
    by name beside the other cells'; its per-layer metrics are the
    extraction cells' and the kernel's roofline."""
    c = core.find_cell(BENCH, CELL)
    assert (c.entry["config"], c.entry["traffic"], c.chips) == ("mfa_conformer",
                                                                "extract_long_16k", 1)
    assert c.config["model"] == "mfa_conformer" and c.config["reduced"] == []
    assert c.traffic["driver"] == "extract" and c.limits["limits"]["embedding_rel_gap"] == 5e-5
    assert c.model.__name__.endswith("mfa_conformer")
    for m in core.cell_metrics(BENCH, CELL, True):
        assert hasattr(core.load_module(core.BENCH_DIR / "metrics" / f"{m['name']}.py"), "read")
    entry = [m for m in BENCH["per_layer"] if m["name"] == "relpos_softmax_roofline.extract"][0]
    assert entry["workloads"] == [CELL] and entry["moves"] == "extract_audio_s_per_s"


def test_the_kinds_reference_loads_neither_jax_nor_the_program():
    loaded = _modules_after(
        f"import json, torch\nfrom harness import core\n"
        f"c = json.loads({json.dumps(json.dumps(core.merge(PUBLISHED, SMALL)))})\n"
        "k = core.model_kind(c)\n"
        "p = {n: torch.full(s, 0.1) for n, s in k.param_names(c).items()}\n"
        "k.embed(torch.ones(60, 40), p, c, 'ref'), k.embed(torch.ones(60, 40), p, c, 'tf32')\n"
        "k.embed_flops(c, 60), k.relpos_bytes(c, 60)")
    assert not loaded & (JAX | {PROGRAM})
