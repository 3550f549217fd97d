"""The ECAPA-TDNN cell, `ecapa_c1024.extract`: its CPU dry run at a small
size, its flop count at the published widths by hand, its conv_pct reader
on a synthetic trace, and a kind file whose reference, names and counts
load neither JAX nor the program."""

import json

import pytest

import tiny
from harness import core
from harness.profiling import TraceSummary
from test_harness_imports import JAX, PROGRAM, _modules_after

CELL = "ecapa_c1024.extract"
SMALL = {"feat_dim": 40, "channels": 64, "se_bottleneck": 16, "attention_bottleneck": 16,
         "mfa_channels": 96, "embed_dim": 32, "num_speakers": 10,
         "frontend": {"num_mel_bins": 40, "num_ceps": 40}, "extract": {"chunk_size": 200}}
OVERRIDES = {"config": SMALL, "traffic": tiny.SERVE}
PUBLISHED = core.load_json(core.BENCH_DIR / "configs" / "ecapa_c1024.json")
BENCH = json.load(open(f"{tiny.REPO}/BENCHMARK.json"))


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
                     "device_idle_pct.extract", "conv_pct.extract"}


def test_the_tf32_control_fails_the_limit():
    import run as bench_run

    args = bench_run.parse(["--workload", CELL, "--seed", str(tiny.SEED), "--seconds", "0.3"])
    out = bench_run.execute(args, device="cpu", overrides=OVERRIDES, controls=("tf32",))[3]
    lim = core.limit(core.find_cell(BENCH, CELL), "embedding_rel_gap")
    assert out.correct and out.work["readings"]["ref"] < lim < out.work["readings"]["tf32"]


def test_embed_flops_at_the_published_widths_by_hand():
    kind = core.model_kind(PUBLISHED)
    stem = 2 * 80 * 5 * 1024
    block = 2 * (1024 * 1024 * 2 + 7 * 128 * 128 * 3)
    mfa = 2 * 3072 * 1536
    attention = 2 * (4608 * 128 + 128 * 1536)
    frame = stem + 3 * block + mfa + attention
    assert (stem, block, mfa, attention) == (819_200, 4_882_432, 9_437_184, 1_572_864)
    assert frame == 26_476_544  # 26.48 MFLOP a frame
    once = 3 * 2 * (1024 * 128 + 128 * 1024) + 2 * 3072 * 192  # SE bottlenecks, the head
    assert kind.frame_flops(PUBLISHED) == frame
    assert kind.embed_flops(PUBLISHED, 3000) == 3000 * frame + once


def test_conv_pct_reads_convolution_and_gemm_kernels():
    reader = core.load_module(core.BENCH_DIR / "metrics" / "conv_pct.extract.py")
    kernels = {
        "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize256x64x8": 6.0,
        "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x16_warpgroupsize1x1x1": 1.0,
        "void gemv2T_kernel_val<int, int, float, float, float, float, 128, 16, 4, 4>": 0.5,
        "void cudnn::bn_fw_inf_1C11_kernel_NCHW<float, float, true, 1>": 1.5,
        "mfcc_kernel(Args)": 0.5,
        "void at::native::vectorized_elementwise_kernel<4, MulFunctor<float>>": 0.5}
    out = core.Outcome({}, 0, 0, [], 1.0, 1.0, 0,
                       trace=TraceSummary(10.0, 12.0, kernels, [], len(kernels)))
    assert reader.read(out, None, None) == pytest.approx(75.0)
    assert reader.read(core.Outcome({}, 0, 0, [], 1.0, 1.0, 0), None, None) is None


def test_the_ecapa_kinds_reference_loads_neither_jax_nor_the_program():
    loaded = _modules_after(
        f"import json, torch\nfrom harness import core\n"
        f"c = json.loads({json.dumps(json.dumps(core.merge(PUBLISHED, SMALL)))})\n"
        "k = core.model_kind(c)\n"
        "p = {n: torch.full(s, 0.1) for n, s in k.param_names(c).items()}\n"
        "k.embed(torch.ones(60, 40), p, c, 'ref'), k.embed(torch.ones(60, 40), p, c, 'tf32')\n"
        "k.embed_flops(c, 60)")
    assert not loaded & (JAX | {PROGRAM})
