"""ECAPA-TDNN (`models.ecapa`) against the benchmark's plain float64
reference (`benchmark/reference/ecapa.py`, the repository's one copy), on
the CPU at a small size: C 64 (scale 8, groups of 8), SE and attention
bottlenecks 16, MFA 96, embedding 32, 40 mel bins, on seeded random
weights with batch-norm statistics away from 0 and 1.  The published
widths are only built, to count their parameters.

Tolerances: the port computes in float32 and the reference in float64,
so a gap is float32 rounding carried through 26 layers: 1.3-1.7e-7 of
the embedding's norm here.  1e-5 leaves that room, and the reference
computed with TF32 products (the control a float32 configuration must
fail) reads 3e-4, 30x above it.  With the frontend in front (its
float32 MFCC against the reference's float64 one) the gap reads 2-4e-7.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
BENCH = REPO / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from reference import ecapa as ref  # noqa: E402
from reference.extract import embedding as ref_embedding  # noqa: E402
from sepi_tpu_torch.config import CmvnConfig, ExtractConfig, FrontendConfig, VadConfig  # noqa: E402
from sepi_tpu_torch.extract import EmbeddingExtractor, streaming_embed  # noqa: E402
from sepi_tpu_torch.models import EcapaConfig, EcapaTdnn, lecun_normal_init  # noqa: E402
from sepi_tpu_torch.recipes.pipeline import prepare_features_nosil  # noqa: E402

torch.set_num_threads(2)

PUBLISHED = json.loads((BENCH / "configs" / "ecapa_c1024.json").read_text())
SMALL = dict(PUBLISHED, feat_dim=40, channels=64, se_bottleneck=16, attention_bottleneck=16,
             mfa_channels=96, embed_dim=32, num_speakers=10,
             frontend=dict(PUBLISHED["frontend"], num_mel_bins=40, num_ceps=40))
MODEL_KEYS = [f.name for f in dataclasses.fields(EcapaConfig)]
TOL = 1e-5  # float32 through the network (see the module docstring)
LENGTHS = (37, 64, 150, 301)


def model_config(cfg):
    kw = {k: cfg[k] for k in MODEL_KEYS}
    return EcapaConfig(**dict(kw, dilations=tuple(kw["dilations"])))


def rel(a, b):
    a, b = torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64)
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def weights():
    """Seeded tensors by the reference's names: weights at 1/sqrt(fan_in),
    biases and running means around 0, variances and scales away from 1."""
    g = torch.Generator().manual_seed(20)
    p = {}
    for name, shape in ref.param_names(SMALL).items():
        if name.endswith("weight") and len(shape) >= 2:
            p[name] = torch.randn(shape, generator=g) / float(np.prod(shape[1:])) ** 0.5
        elif name.endswith("running_var"):
            p[name] = 0.5 + 1.5 * torch.rand(shape, generator=g)
        elif name.endswith("bn.weight"):
            p[name] = 0.5 + torch.rand(shape, generator=g)
        else:
            p[name] = 0.3 * torch.randn(shape, generator=g)
    return p


@pytest.fixture(scope="module")
def model(weights):
    m = EcapaTdnn(model_config(SMALL))
    missing, unexpected = m.load_state_dict(weights, strict=False)
    assert not unexpected and all(n.endswith(ref.PROGRAM_ONLY) for n in missing)
    return m.eval()


@pytest.fixture(scope="module")
def feats():
    return torch.randn(max(LENGTHS), 40, generator=torch.Generator().manual_seed(21))


def test_one_utterance_matches_the_float64_reference(model, weights, feats):
    with torch.no_grad():
        got = model(feats[None])["embedding"][0]
    want = ref.embed(feats, weights, SMALL, "ref")
    assert got.dtype == torch.float32 and got.shape == (32,)
    assert rel(got, want) < TOL
    assert rel(ref.embed(feats, weights, SMALL, "tf32"), want) > 10 * TOL


@pytest.mark.parametrize("filler", ["zeros", "noise", "nonfinite"])
def test_a_padded_batch_equals_each_row_alone(model, weights, feats, filler):
    """Rows of 37, 64, 150 and 301 frames in one 301-frame batch: each row
    equals its utterance run alone (zero "same" padding at its real ends)
    and the reference; what the padding holds changes nothing, bit for bit."""
    t = max(LENGTHS)
    mask = torch.arange(t)[None, :] < torch.tensor(LENGTHS)[:, None]

    def batch(fill):
        x = fill.clone()
        for i, n in enumerate(LENGTHS):
            x[i, :n] = feats[:n]
        return x

    zeros = batch(torch.zeros(len(LENGTHS), t, 40))
    fill = {"zeros": torch.zeros(len(LENGTHS), t, 40),
            "noise": 1e4 * torch.randn(len(LENGTHS), t, 40,
                                       generator=torch.Generator().manual_seed(3)),
            "nonfinite": torch.full((len(LENGTHS), t, 40), float("nan"))}[filler]
    if filler == "nonfinite":
        fill[:, ::2] = float("inf")
    with torch.no_grad():
        base = model(zeros, mask)["embedding"]
        got = model(batch(fill), mask)["embedding"]
        assert torch.equal(got, base)
        for i, n in enumerate(LENGTHS):
            alone = model(feats[None, :n])["embedding"][0]
            assert rel(got[i], alone) < TOL
            assert rel(got[i], ref.embed(feats[:n], weights, SMALL, "ref")) < TOL


def test_extraction_through_the_frontend_matches_the_reference_pipeline(model, weights):
    """`prepare_features_nosil` at the configuration's 16 kHz frontend (no
    VAD, utterance-level mean subtraction) and `EmbeddingExtractor` (eager,
    the bucket ladder) against the reference's MFCC, CMN and embedding."""
    rng = np.random.default_rng(22)
    lengths = (16000, 23456, 41000)  # 1.0-2.6 s: three buckets of the ladder
    audio = {f"utt{i}": (1000 * rng.standard_normal(n) * np.sin(np.arange(n) / 900.0)
                         ).astype(np.float32) for i, n in enumerate(lengths)}
    fcfg = FrontendConfig(**SMALL["frontend"])
    ecfg = ExtractConfig(min_chunk_size=SMALL["extract"]["min_chunk_size"],
                         chunk_size=SMALL["extract"]["chunk_size"],
                         embedding_node="embedding", batch_size=2)
    feats = prepare_features_nosil(audio, fcfg, VadConfig(**SMALL["vad"]),
                                   CmvnConfig(**SMALL["cmvn"]), None, 2, device="cpu")
    assert {u: f.shape[0] for u, f in feats.items()} == {
        u: (n + 80) // 160 for u, n in zip(audio, lengths)}  # every frame voiced
    got = EmbeddingExtractor(model, ecfg, min_frames=SMALL["extract"]["min_frames"],
                             device="cpu", capture=False).extract_utterances(feats)
    for u, x in audio.items():
        want = ref_embedding(x, u, weights, SMALL, "cpu", "ref", model=ref)
        assert rel(got[u], want) < TOL


def test_the_published_widths():
    """14,644,480 parameters without the AAM weight (the batch norms learn
    a scale and no offset), within 1% of the paper's 14.7 M; the names and
    shapes are the configuration's, which the reference reads."""
    with torch.device("meta"):
        m = EcapaTdnn(model_config(PUBLISHED))
    n = sum(p.numel() for name, p in m.named_parameters() if not name.startswith("aam."))
    assert n == 14_644_480 and abs(n - 14.7e6) < 0.01 * 14.7e6
    assert tuple(m.aam.weight.shape) == (5994, 192)
    want = ref.param_names(PUBLISHED)
    state = {k: tuple(v.shape) for k, v in m.state_dict().items()
             if not k.endswith(ref.PROGRAM_ONLY)}
    assert state == want


def test_lecun_normal_init_covers_every_layer():
    """Flax's initialisation (`models.lecun_normal_init`) reaches every
    layer, the bias-free AAM weight included."""
    m = EcapaTdnn(model_config(SMALL))
    lecun_normal_init(m, 0)
    for name, t in m.state_dict().items():
        if name.endswith("weight") and t.dim() >= 2:
            fan_in = t[0].numel()
            assert abs(float(t.std()) * fan_in ** 0.5 - 1.0) < 0.2, name
        elif name.endswith(("bn.weight", "running_var")):
            assert torch.all(t == 1.0), name
        else:
            assert torch.all(t == 0), name


def test_streaming_embed_refuses_ecapa(model):
    with pytest.raises(ValueError, match="EcapaTdnn"):
        streaming_embed(model, np.zeros((500, 40), np.float32), device="cpu")
