"""What the existing cells read is the same as before the model kinds
moved into `benchmark/models/`: golden values (`golden.json`) recorded
from the code before the move, held bit-equal.  Per configuration, at
full size and at the tests' small size: the weights' names and shapes
and a checksum of the seeded weights (and of the grafted AM's), the
embedding flops, the training forward flops per task; at the small size
the reference's chunk and utterance embeddings in float64 and TF32, the
train-mode logits in bf16 and fp8, and the training cell's set-up
readings (the program's checked units against the reference)."""

import hashlib
import json

import numpy as np
import pytest
import torch

import tiny
from harness import audio, core, flops
from harness import weights as W
from reference.extract import embedding

GOLDEN = json.load(open(f"{tiny.BENCH}/tests/golden.json"))
CPU = torch.device("cpu")
SMALL = {"xvector_v2": tiny.XVEC, "cvector_v5": tiny.CVEC}


def sha(tensors):
    h = hashlib.sha256()
    for n in sorted(tensors):
        t = tensors[n].detach().cpu().contiguous()
        h.update(n.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def configs(name):
    full = core.load_json(core.BENCH_DIR / "configs" / f"{name}.json")
    return {"full": full, "tiny": core.merge(full, SMALL[name])}


@pytest.mark.parametrize("name", list(SMALL))
@pytest.mark.parametrize("size", ["full", "tiny"])
def test_the_weights_and_counts_are_as_before(name, size):
    cfg = configs(name)[size]
    want = GOLDEN[name][size]
    kind = core.model_kind(cfg)
    shapes = kind.param_names(cfg)
    names = json.dumps([[n, list(s)] for n, s in shapes.items()]).encode()
    assert hashlib.sha256(names).hexdigest() == want["names"]
    assert sha(W.make(shapes, 12345, CPU, kind)) == want["weights"]
    assert [flops.embed_flops(cfg, f) for f in (25, 300, 10000)] == want["embed_flops"]
    if "am_weights" in want:
        am = {n[len("am."):]: s for n, s in shapes.items() if n.startswith("am.")}
        assert sha(W.make(am, 777, CPU, kind)) == want["am_weights"]
        assert flops.train_forward_flops(cfg, "am", 256, 22) == want["train_forward_flops"]["am"]
        assert [flops.train_forward_flops(cfg, "xvec", 64, f) for f in (200, 314, 400)] == \
            want["train_forward_flops"]["xvec"]


@pytest.mark.parametrize("name", list(SMALL))
def test_the_reference_reads_as_before(name):
    cfg = configs(name)["tiny"]
    want = GOLDEN[name]
    kind = core.model_kind(cfg)
    p = W.make(kind.param_names(cfg), 4242, CPU, kind)
    g = torch.Generator().manual_seed(5)
    feats = torch.randn((60, 23), generator=g)
    mix = core.load_json(core.BENCH_DIR / "traffic" / "extract_shards.json")
    pool = audio.make_pool(np.array([2.7]), mix["audio"], 99, CPU)
    for prec in ("ref", "tf32"):
        assert kind.embed(feats, p, cfg, prec).double().numpy().tolist() == want["embed"][prec]
        got = embedding(pool[0], "spk-x-u1", p, cfg, CPU, prec, model=kind)
        assert got.double().numpy().tolist() == want["utt_embedding"][prec]
    if "forward_train" in want:
        fb = torch.randn((4, 40, 23), generator=g)
        for key, digest in want["forward_train"].items():
            task, prec = key.split(".")
            logits = kind.forward_train(fb, p, cfg, task, prec).detach().double().numpy()
            assert hashlib.sha256(logits.tobytes()).hexdigest() == digest, key


def test_the_training_cells_set_up_readings_are_as_before():
    out = tiny.execute("cvector_v5.train", controls=("fp8",))
    r = json.loads(json.dumps(out.work["readings"], default=str))
    want = GOLDEN["train_setup"]
    for v in ("bf16", "fp8"):
        got = {k: x for k, x in r[v].items() if not k.startswith("window_") and k != "detail"}
        assert got == want[v], v
    first = [d for d in r["bf16"]["detail"] if d["group"] == "first"]
    assert [{k: d[k] for k in w} for d, w in zip(first, want["detail_first"])] == \
        want["detail_first"]
    assert out.work["checked_units"]["set-up"] == want["checked"]
