"""MFA-Conformer (`models.conformer`) and its attention score route
(`ops.relpos_softmax`) against the benchmark's plain float64 reference
(`benchmark/reference/conformer.py`, the repository's one copy), on the
CPU at a small size: d 32, 2 blocks of 2 heads, FF 64, depthwise kernel
5, MFA 64, attention bottleneck 16, embedding 24, 40 bins, on seeded
random weights with u, v, offsets and batch-norm statistics away from 0
and 1.  The published widths are only built, to count their parameters.

Tolerances: the port computes in float32 and the reference in float64,
so an embedding's gap is float32 rounding carried through the subsampler
and two blocks: 1-3e-7 of its norm here.  1e-5 leaves that room, and the
reference computed with TF32 products (the control a float32
configuration must fail) reads 2-5e-4, above 10 x 1e-5.  Score rows are
probabilities: the CPU route against explicit indexing, and blocked
attention against one block, differ only by float32 rounding of the same
sums (1e-6).  The input map recovers log-mel energies of magnitude up to
~25 from float32 cepstra: within 1e-4.
"""

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
BENCH = REPO / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from reference import conformer as ref  # noqa: E402
from reference.extract import embedding as ref_embedding  # noqa: E402
from sepi_tpu_torch.config import CmvnConfig, ExtractConfig, FrontendConfig, VadConfig  # noqa: E402
from sepi_tpu_torch.extract import EmbeddingExtractor  # noqa: E402
from sepi_tpu_torch.models import MfaConformer, MfaConformerConfig  # noqa: E402
from sepi_tpu_torch.models import conformer  # noqa: E402
from sepi_tpu_torch.models.conformer import (input_map, query_rows,  # noqa: E402
                                             relative_positions, subsampled_frames)
from sepi_tpu_torch.ops.features import FeatureExtractor  # noqa: E402
from sepi_tpu_torch.ops.relpos_softmax import (FLOOR, relpos_softmax,  # noqa: E402
                                               relpos_softmax_reference)
from sepi_tpu_torch.recipes.pipeline import prepare_features_nosil  # noqa: E402

torch.set_num_threads(2)

PUBLISHED = json.loads((BENCH / "configs" / "mfa_conformer.json").read_text())
SMALL = dict(PUBLISHED, feat_dim=40, d_model=32, num_blocks=2, num_heads=2, ff_dim=64,
             conv_kernel=5, mfa_channels=64, attention_bottleneck=16, embed_dim=24,
             num_speakers=10, frontend=dict(PUBLISHED["frontend"], num_mel_bins=40, num_ceps=40))
MODEL_KEYS = [f.name for f in dataclasses.fields(MfaConformerConfig)]  # the lifter: default 22
TOL = 1e-5  # float32 through the network (see the module docstring)
LENGTHS = (37, 64, 150, 301)


def model_config(cfg):
    return MfaConformerConfig(**{k: cfg[k] for k in MODEL_KEYS if k in cfg})


def rel(a, b):
    a, b = torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64)
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def weights():
    g = torch.Generator().manual_seed(25)
    p = {}
    for name, shape in ref.param_names(SMALL).items():
        if name.endswith("weight") and len(shape) >= 2:
            p[name] = torch.randn(shape, generator=g) / float(np.prod(shape[1:])) ** 0.5
        elif name.endswith("running_var"):
            p[name] = 0.5 + 1.5 * torch.rand(shape, generator=g)
        elif ref.starts_at_one(name):
            p[name] = 0.5 + torch.rand(shape, generator=g)
        else:
            p[name] = 0.3 * torch.randn(shape, generator=g)
    return p


def _load(m, weights):
    missing, unexpected = m.load_state_dict(weights, strict=False)
    assert not unexpected and all(n.endswith(ref.PROGRAM_ONLY) for n in missing)
    return m.eval()


@pytest.fixture(scope="module")
def model(weights):
    return _load(MfaConformer(model_config(SMALL)), weights)


@pytest.fixture(scope="module")
def feats():
    return torch.randn(max(LENGTHS), 40, generator=torch.Generator().manual_seed(26))


def test_one_utterance_matches_the_float64_reference(model, weights, feats):
    with torch.no_grad():
        got = model(feats[None])["embedding"][0]
    want = ref.embed(feats, weights, SMALL, "ref")
    assert got.dtype == torch.float32 and got.shape == (24,)
    assert rel(got, want) < TOL
    assert rel(ref.embed(feats, weights, SMALL, "tf32"), want) > 10 * TOL


@pytest.mark.parametrize("filler", ["zeros", "noise", "nonfinite"])
def test_a_padded_batch_equals_each_row_alone(model, weights, feats, filler):
    """Rows of 37, 64, 150 and 301 frames in one 301-frame batch, and a row
    with no valid frame: each real row equals its utterance run alone and
    the reference; what the padding holds changes nothing, bit for bit;
    the empty row stays finite."""
    t = max(LENGTHS)
    lens = LENGTHS + (0,)
    mask = torch.arange(t)[None, :] < torch.tensor(lens)[:, None]

    def batch(fill):
        x = fill.clone()
        for i, n in enumerate(lens):
            x[i, :n] = feats[:n]
        return x

    shape = (len(lens), t, 40)
    fill = {"zeros": torch.zeros(shape),
            "noise": 1e4 * torch.randn(shape, generator=torch.Generator().manual_seed(3)),
            "nonfinite": torch.full(shape, float("nan"))}[filler]
    if filler == "nonfinite":
        fill[:, ::2] = float("inf")
    with torch.no_grad():
        base = model(batch(torch.zeros(shape)), mask)["embedding"]
        got = model(batch(fill), mask)["embedding"]
        assert torch.equal(got, base) and bool(torch.isfinite(got).all())
        for i, n in enumerate(LENGTHS):
            alone = model(feats[None, :n])["embedding"][0]
            assert rel(got[i], alone) < TOL
            assert rel(got[i], ref.embed(feats[:n], weights, SMALL, "ref")) < TOL


@pytest.mark.parametrize("t,want", [(7, 1), (8, 1), (9, 2)])
def test_the_subsamplers_length_rule(model, weights, feats, t, want):
    """T' = (T - 1) // 2 - 2: the subsampler's output frames at T = 7, 8
    and 9, and each such row in a 9-frame batch equal to itself alone and
    to the reference; below 7 frames the model refuses."""
    assert subsampled_frames(t) == want
    with torch.no_grad():
        assert model.subsample(feats[None, :t]).shape == (1, want, 32)
        x = torch.zeros(1, 9, 40)
        x[0, :t] = feats[:t]
        mask = torch.arange(9)[None, :] < t
        got = model(x, mask)["embedding"][0]
        assert rel(got, model(feats[None, :t])["embedding"][0]) < TOL
    assert rel(got, ref.embed(feats[:t], weights, SMALL, "ref")) < TOL
    with pytest.raises(ValueError, match="below the subsampler's 7"):
        model(feats[None, :6])


@pytest.mark.parametrize("bins", [40, 80])
def test_the_input_map_gives_the_log_mel_energies(bins):
    """Cepstra of as many bins (C0 the DCT's, `use_energy` off) times the
    model's input map equal the log-mel filterbank of the same samples;
    every lifter coefficient below 80 is at least 0.565 in magnitude at
    Q = 22, so the map is well conditioned."""
    cfg = FrontendConfig(**dict(PUBLISHED["frontend"], num_mel_bins=bins, num_ceps=bins,
                                use_energy=False, dither=0.0))
    fe = FeatureExtractor(cfg, device="cpu")
    rng = np.random.default_rng(bins)
    x = torch.tensor((1000 * rng.standard_normal(16000) * np.sin(np.arange(16000) / 700.0)
                      ).astype(np.float32))
    ceps, _ = fe.mfcc(x)
    logmel, _ = fe.fbank(x)
    m = input_map(bins, cfg.cepstral_lifter)
    assert float((ceps @ m - logmel).abs().max()) < 1e-4
    k = np.arange(80)
    assert np.abs(1 + 11 * np.sin(np.pi * k / 22)).min() > 0.565


def test_the_score_route_against_explicit_indexing():
    """`relpos_softmax_reference` on a block of rows i0 .. i0 + Q - 1 (the
    band of positions T - i1 .. 2T - 2 - i0) equals, row by row, the
    softmax of (ac[i, j] + bd[i, T - 1 - i + j]) / 8 over the keys below
    the row's length, and ESPnet's rel_shift (pad, view, slice) of the
    whole (T, 2T - 1) matrix gives the same shifted scores."""
    g = torch.Generator().manual_seed(5)
    b, h, t, i0, q = 2, 3, 11, 4, 5
    full_ac = torch.randn(b, h, t, t, generator=g)
    full_bd = torch.randn(b, h, t, 2 * t - 1, generator=g)
    lengths = torch.tensor([t, 6], dtype=torch.int32)
    i1 = i0 + q
    got = relpos_softmax_reference(full_ac[:, :, i0:i1], full_bd[:, :, i0:i1, t - i1:2 * t - 1 - i0],
                                   lengths, 0.125)
    want = torch.empty_like(got)
    for bb in range(b):
        for hh in range(h):
            for i in range(i0, i1):
                s = torch.tensor([(full_ac[bb, hh, i, j] + full_bd[bb, hh, i, t - 1 - i + j]) / 8
                                  if j < lengths[bb] else FLOOR for j in range(t)])
                want[bb, hh, i - i0] = torch.softmax(s, 0)
    assert float((got - want).abs().max()) < 1e-6
    # ESPnet's rel_shift
    pad = torch.cat([torch.zeros(b, h, t, 1), full_bd], dim=-1).view(b, h, 2 * t, t)
    shifted = pad[:, :, 1:].reshape(b, h, t, 2 * t - 1)[..., :t]
    i = torch.arange(t)
    gathered = full_bd.gather(-1, ((t - 1 - i)[:, None] + i[None, :]).expand(b, h, t, t))
    assert torch.equal(shifted, gathered)


def test_the_score_route_refuses_what_the_kernel_does_not_take():
    ac, bd = torch.zeros(1, 1, 3, 5), torch.zeros(1, 1, 3, 7)
    lengths = torch.tensor([5], dtype=torch.int32)
    assert torch.allclose(relpos_softmax(ac, bd, lengths, 1.0), torch.full((1, 1, 3, 5), 0.2))
    with pytest.raises(ValueError, match="want"):
        relpos_softmax(ac, bd[..., :6], lengths, 1.0)
    with pytest.raises(ValueError, match="int32"):
        relpos_softmax(ac, bd, lengths.long(), 1.0)
    with pytest.raises(ValueError, match="float32"):
        relpos_softmax(ac.double(), bd, lengths, 1.0)


@pytest.mark.parametrize("budget", [20_000, 200_000, 1 << 24])
def test_query_blocked_attention_equals_one_block(model, feats, budget, monkeypatch):
    """A budget of a few query rows, of dozens, and of all of them: the
    blocked attention's embeddings equal one block's within float32
    rounding, and each block's ac and bd fit the budget."""
    t = max(LENGTHS)
    ts = subsampled_frames(t)
    mask = torch.arange(t)[None, :] < torch.tensor(LENGTHS)[:, None]
    x = torch.zeros(len(LENGTHS), t, 40)
    for i, n in enumerate(LENGTHS):
        x[i, :n] = feats[:n]
    rows = query_rows(len(LENGTHS), 2, ts, budget)
    assert rows == ts or 4 * len(LENGTHS) * 2 * rows * (rows + 2 * ts - 1) <= budget
    assert (rows < ts) == (budget < 1 << 24)
    with torch.no_grad():
        a = model(x, mask)["embedding"]
        monkeypatch.setattr(conformer, "ATTENTION_BLOCK_BYTES", budget)
        b = model(x, mask)["embedding"]
    assert float((a - b).abs().max() / a.abs().max()) < 1e-6


def test_query_rows_at_the_largest_bucket():
    """32 rows of 4,997 subsampled frames under 2 GiB: 384 query rows, 14
    blocks, each block's scores under the budget."""
    rows = query_rows(32, 4, 4997, 1 << 31)
    assert rows == 384 and math.ceil(4997 / rows) == 14
    assert 4 * 32 * 4 * rows * (rows + 2 * 4997 - 1) <= 1 << 31
    assert query_rows(1, 4, 10, 1 << 31) == 10


def test_relative_positions_match_the_reference():
    pe = relative_positions(6, 32, torch.device("cpu"))
    want = ref.positions(6, 32, "cpu")
    assert pe.shape == (11, 32) and float((pe.double() - want).abs().max()) < 1e-7
    assert torch.equal(pe[5], torch.tensor([0.0, 1.0] * 16))  # row T - 1: position 0


def test_extraction_through_the_frontend_matches_the_reference_pipeline(model, weights):
    """`prepare_features_nosil` at the configuration's 16 kHz frontend (no
    VAD, sliding mean removal) and `EmbeddingExtractor` (eager, the bucket
    ladder, chunks of 200 frames) against the reference's MFCC, CMN and
    embedding."""
    rng = np.random.default_rng(27)
    lengths = (16000, 23456, 41000)  # 1.0-2.6 s: three buckets of the ladder, chunked
    audio = {f"utt{i}": (1000 * rng.standard_normal(n) * np.sin(np.arange(n) / 900.0)
                         ).astype(np.float32) for i, n in enumerate(lengths)}
    fcfg = FrontendConfig(**SMALL["frontend"])
    ecfg = ExtractConfig(min_chunk_size=SMALL["extract"]["min_chunk_size"], chunk_size=200,
                         embedding_node="embedding", batch_size=2)
    feats = prepare_features_nosil(audio, fcfg, VadConfig(**SMALL["vad"]),
                                   CmvnConfig(**SMALL["cmvn"]), None, 2, device="cpu")
    got = EmbeddingExtractor(model, ecfg, min_frames=SMALL["extract"]["min_frames"],
                             device="cpu", capture=False).extract_utterances(feats)
    cfg = dict(SMALL, extract=dict(SMALL["extract"], chunk_size=200))
    for u, x in audio.items():
        want = ref_embedding(x, u, weights, cfg, "cpu", "ref", model=ref)
        assert rel(got[u], want) < TOL


def test_the_published_widths():
    """20,213,888 parameters without the AAM weight: the subsampler
    3,017,728, each block 2,635,264, the MFA norm, pooling and head
    1,384,576; the names and shapes are the configuration's, which the
    reference reads."""
    with torch.device("meta"):
        m = MfaConformer(model_config(PUBLISHED))
    count = {k: sum(p.numel() for n, p in m.named_parameters() if n.startswith(k))
             for k in ("subsample.", "blocks.0.", "")}
    head = count[""] - count["subsample."] - 6 * count["blocks.0."] - m.aam.weight.numel()
    assert (count["subsample."], count["blocks.0."], head) == (3_017_728, 2_635_264, 1_384_576)
    assert count[""] - m.aam.weight.numel() == 20_213_888
    assert tuple(m.aam.weight.shape) == (5994, 192)
    state = {k: tuple(v.shape) for k, v in m.state_dict().items()
             if not k.endswith(ref.PROGRAM_ONLY)}
    assert state == ref.param_names(PUBLISHED)


def test_the_stages_are_spans_when_tracing_is_on(model, feats):
    """One forward with spans on: the subsampler and the pooling once, each
    block, its attention and its convolution module once a block, nested
    in the block; off, nothing is recorded."""
    from sepi_tpu_torch.utils import logging as L

    L.reset()
    with torch.no_grad():
        model(feats[None])
        assert L.spans() == []
        with L.tracing(True):
            model(feats[None])
    names = [s.name for s in L.spans()]
    L.reset()
    assert {n: names.count(n) for n in set(names)} == {
        "conformer.subsample": 1, "conformer.block": 2, "conformer.mhsa": 2,
        "conformer.conv": 2, "conformer.pool": 1}
    assert names[:4] == ["conformer.subsample", "conformer.mhsa", "conformer.conv",
                         "conformer.block"]
