"""The port's CUDA kernels on the card (marked ``gpu``; skipped without one).

Run on a machine with an NVIDIA Hopper GPU, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``--noconftest`` because tests/conftest.py configures JAX, which the
port's machine need not have.)  Each kernel is compared with its plain
PyTorch version on the same device at small shapes; the training step,
the Muon orthogonalisation and the input staging are held against the CPU,
as are a bf16 model's forward and steps, the on-device backend and
streaming extraction; data-parallel steps run at world size 1 over NCCL
and on two gloo ranks that share the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sepi_tpu_torch.align import viterbi_cuda
from sepi_tpu_torch.config import FrontendConfig
from sepi_tpu_torch.ops import mfcc_cuda
from sepi_tpu_torch.ops.dither import utt_seeds
from sepi_tpu_torch.ops.framing import num_frames

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU build")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dither", [0.0, 1.0])
@pytest.mark.parametrize("snip", [False, True])
def test_mfcc_kernel_matches_plain(cuda, dither, snip):
    cfg = FrontendConfig(dither=dither, snip_edges=snip)
    rng = np.random.default_rng(int(dither) + 2 * snip)
    n = 3 * 8000 + 123
    x = torch.tensor((rng.normal(size=(3, n)) * 3000).astype(np.float32), device=cuda)
    lengths = torch.tensor([n, int(0.61 * n), 207], dtype=torch.int32, device=cuda)
    seeds = torch.tensor(utt_seeds(["a", "b", "c"]), device=cuda) if dither else None
    tmax = int(num_frames(n, cfg))
    before = mfcc_cuda.mfcc_fused.launches
    got, mask = mfcc_cuda.mfcc_fused(x, lengths, cfg, tmax, seeds)
    ref, mref = mfcc_cuda.mfcc_fused_reference(x, lengths, cfg, tmax, seeds)
    torch.cuda.synchronize()
    assert mfcc_cuda.mfcc_fused.launches == before + 1
    assert torch.equal(mask, mref)
    assert float((got - ref).abs().max()) < 2e-3


def test_mfcc_kernel_wide_config(cuda):
    """16 kHz / 40 mel: two passes over 256 bins, energy off."""
    cfg = FrontendConfig(dither=1.0, sample_rate=16000, num_mel_bins=40, num_ceps=40,
                         low_freq=40.0, high_freq=-200.0, use_energy=False)
    x = torch.randn((2, 40000), device=cuda) * 1000
    lengths = torch.tensor([40000, 12345], dtype=torch.int32, device=cuda)
    seeds = torch.tensor([3, 4], dtype=torch.int32, device=cuda)
    got, _ = mfcc_cuda.mfcc_fused(x, lengths, cfg, 250, seeds)
    ref, _ = mfcc_cuda.mfcc_fused_reference(x, lengths, cfg, 250, seeds)
    assert float((got - ref).abs().max()) < 2e-3


SRE8K = {}
HIRES16K = dict(sample_rate=16000, num_mel_bins=40, num_ceps=40, low_freq=40.0,
                high_freq=-200.0, use_energy=False)
# ECAPA-TDNN's frontend (benchmark/configs/ecapa_c1024.json): 80 cepstra of
# 80 bins, whose DCT and cepstra outgrow the kernel's spectral tiles
VOX16K = dict(sample_rate=16000, num_mel_bins=80, num_ceps=80, high_freq=7600.0)
CONFS = {"sre8k": SRE8K, "hires16k": HIRES16K, "vox16k": VOX16K}


@pytest.mark.parametrize("conf", list(CONFS))
@pytest.mark.parametrize("dither", [0.0, 1.0])
@pytest.mark.parametrize("snip", [False, True])
def test_mfcc_kernel_configs_and_short_utterances(cuda, conf, dither, snip):
    """One launch, no tail-patch launches: utterances shorter than a frame,
    than the tail window, and ending inside and at the edge of a block."""
    cfg = FrontendConfig(dither=dither, snip_edges=snip, **CONFS[conf])
    flen, shift = cfg.frame_length, cfg.frame_shift
    rng = np.random.default_rng(17 + int(dither) + 2 * snip)
    n = 70 * shift + flen
    lengths = [n, 64 * shift + shift // 2, 5 * shift, flen + 3, flen - 1, shift // 2 + 1, 1]
    x = (rng.normal(size=(len(lengths), n)) * 2000).astype(np.float32)
    for i, ln in enumerate(lengths):
        x[i, ln:] = 0.0
    x = torch.tensor(x, device=cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    seeds = torch.tensor(utt_seeds([f"u{i}" for i in range(len(lengths))]), device=cuda)
    tmax = int(num_frames(n, cfg))
    before = mfcc_cuda.mfcc_fused.launches
    got, mask = mfcc_cuda.mfcc_fused(x, lens, cfg, tmax, seeds if dither else None)
    ref, mref = mfcc_cuda.mfcc_fused_reference(x, lens, cfg, tmax, seeds if dither else None)
    torch.cuda.synchronize()
    assert mfcc_cuda.mfcc_fused.launches == before + 1
    assert torch.equal(mask, mref)
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) < 2e-3


def test_mfcc_wrapper_rejects_bad_input(cuda):
    cfg = FrontendConfig()
    x = torch.zeros((2, 8000), device=cuda, dtype=torch.float64)
    lengths = torch.tensor([8000, 8000], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        mfcc_cuda.mfcc_fused(x, lengths, cfg, 100)
    with pytest.raises(ValueError):
        mfcc_cuda.mfcc_fused(x.float().t(), lengths, cfg, 100)


def _viterbi_inputs(rng, b, t, s, tlen, skip=4, ties=False):
    if ties:
        emit = rng.integers(-3, 1, size=(b, t, s)).astype(np.float32)
        trans = np.full((b, 3, s), -1e30, np.float32)
        trans[:, 0, :] = trans[:, 1, 1:] = -1.0
        trans[:, 2, skip:] = -1.0
    else:
        emit = rng.normal(size=(b, t, s)).astype(np.float32)
        trans = np.full((b, 3, s), -1e30, np.float32)
        trans[:, 0, :] = np.log(0.6)
        trans[:, 1, 1:] = np.log(0.4)
        trans[:, 2, skip:] = np.where(rng.random((b, s - skip)) < 0.3, np.log(0.2), -1e30)
    return emit, np.asarray(tlen, np.int32), trans


@pytest.mark.parametrize("shape,tlen,ties", [
    ((3, 40, 128), [40, 25, 33], False),
    ((4, 57, 139), [57, 2, 1, 30], False),
    ((2, 33, 1100), [33, 20], False),
    ((3, 24, 128), [24, 11, 1], True),
    ((2, 1, 16), [1, 1], False),
])
def test_viterbi_kernel_matches_plain(cuda, shape, tlen, ties):
    """Backpointers equal over every state; delta within 1e-4 where live
    (> -1e29), equal elsewhere."""
    rng = np.random.default_rng(shape[2])
    emit, tl, trans = (torch.tensor(a, device=cuda)
                       for a in _viterbi_inputs(rng, *shape, tlen, ties=ties))
    before = viterbi_cuda.viterbi_batch.launches
    bp, d = viterbi_cuda.viterbi_batch(emit, tl, trans, 4)
    bp_r, d_r = viterbi_cuda.viterbi_batch_reference(emit, tl, trans, 4)
    torch.cuda.synchronize()
    assert viterbi_cuda.viterbi_batch.launches == before + 1
    assert bp.dtype == torch.int8 and bp.shape == (shape[0], shape[1] - 1, shape[2])
    assert torch.equal(bp, bp_r)
    live = d_r > -1e29
    assert float((d - d_r)[live].abs().max()) <= 1e-4
    assert torch.equal(d[~live], d_r[~live])


@pytest.mark.parametrize("s", [128, 144, 256, 512, 1024, 1100])
@pytest.mark.parametrize("skip", [1, 4, 8])
def test_viterbi_kernel_states_and_skips(cuda, s, skip):
    """The warp kernel (S <= 1024, including K < skip and S not a multiple
    of 32) and the block kernel (S > 1024), with lengths 1, 2 and ragged."""
    rng = np.random.default_rng(1000 * skip + s)
    tlen = [1, 2, 37, 50, 13]
    emit, tl, trans = (torch.tensor(a, device=cuda)
                       for a in _viterbi_inputs(rng, 5, 50, s, tlen, skip=skip))
    bp, d = viterbi_cuda.viterbi_batch(emit, tl, trans, skip)
    bp_r, d_r = viterbi_cuda.viterbi_batch_reference(emit, tl, trans, skip)
    torch.cuda.synchronize()
    assert torch.equal(bp, bp_r)
    live = d_r > -1e29
    assert float((d - d_r)[live].abs().max()) <= 1e-4
    assert torch.equal(d[~live], d_r[~live])


def test_viterbi_wrapper_rejects_bad_input(cuda):
    emit = torch.zeros((2, 8, 16), device=cuda)
    tl = torch.tensor([8, 8], dtype=torch.int32, device=cuda)
    trans = torch.zeros((2, 3, 16), device=cuda)
    with pytest.raises(ValueError):
        viterbi_cuda.viterbi_batch(emit.double(), tl, trans)
    with pytest.raises(ValueError):
        viterbi_cuda.viterbi_batch(emit.transpose(1, 2).contiguous().transpose(1, 2), tl, trans)
    with pytest.raises(ValueError):
        viterbi_cuda.viterbi_batch(emit, tl.long(), trans)
    with pytest.raises(ValueError):
        viterbi_cuda.viterbi_batch(emit, tl, trans.cpu())
    big = viterbi_cuda.MAX_STATES + 1
    with pytest.raises(ValueError):
        viterbi_cuda.viterbi_batch(torch.zeros((1, 2, big), device=cuda), tl[:1],
                                   torch.zeros((1, 3, big), device=cuda))


# ------------------------------------------------------------- training


def _tiny_train_state(device, opt, seed=3):
    from sepi_tpu_torch.models import TdnnSpec, XVector, XVectorConfig, lecun_normal_init
    from sepi_tpu_torch.train import TrainState, build_optimizer

    specs = (TdnnSpec(64, (-2, -1, 0, 1, 2)), TdnnSpec(64, (-2, 0, 2)), TdnnSpec(64, (-3, 0, 3)),
             TdnnSpec(64, (0,)), TdnnSpec(192, (0,)))
    model = XVector(XVectorConfig(feat_dim=23, num_speakers=12, frame_specs=specs, embed_dim=64))
    lecun_normal_init(model, seed)
    model.to(device)
    chain, _ = build_optimizer(opt, 100)
    return chain, TrainState(model, chain.init(dict(model.named_parameters())))


def _train_batches(count=3, b=16, t=120):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(count):
        labels = rng.integers(0, 12, size=b).astype(np.int32)
        feats = rng.normal(size=(b, t, 23)) + np.eye(12, 23)[labels][:, None, :] * 1.5
        out.append((feats.astype(np.float32), labels))
    return out


def _flat(model):
    return {n: p.detach().cpu().double() for n, p in model.named_parameters()}


def test_train_steps_on_the_card_match_the_cpu(cuda):
    """3 momentum-SGD steps from the same weights on the same batches:
    ||p_card - p_cpu|| / ||p_cpu - p_init|| <= 1e-3 over all parameters
    (the bias of a unit active on the whole batch ahead of its batch norm
    has a zero gradient, so its own change is rounding noise); one
    default (Muon) step equal to 1e-4 of the step outside entries whose
    gradient is rounding noise (below 1e-4 of their parameter's largest)."""
    from sepi_tpu_torch.config import OptimizerConfig
    from sepi_tpu_torch.train import make_xvec_step
    from sepi_tpu_torch.train.trainer import _softmax_xent

    torch.backends.cudnn.allow_tf32 = False
    batches = _train_batches()
    for opt, steps in ((OptimizerConfig(preconditioner="none"), 3), (OptimizerConfig(), 1)):
        chain_d, sd = _tiny_train_state(cuda, opt)
        chain_c, sc = _tiny_train_state("cpu", opt)
        p0 = _flat(sc.model)
        probe = _tiny_train_state("cpu", opt)[1].model.train()
        params = dict(probe.named_parameters())
        f, l = batches[0]
        loss = _softmax_xent(probe(torch.from_numpy(f))["logits"], torch.from_numpy(l)).mean()
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        for f, l in batches[:steps]:
            md = make_xvec_step(chain_d)(sd, torch.from_numpy(f).to(cuda),
                                         torch.from_numpy(l).to(cuda), 1.0)
            mc = make_xvec_step(chain_c)(sc, torch.from_numpy(f), torch.from_numpy(l), 1.0)
            assert float(md["objf"]) == pytest.approx(float(mc["objf"]), rel=1e-4, abs=1e-5)
        pd, pc = _flat(sd.model), _flat(sc.model)
        if steps == 3:
            err = sum(float(torch.sum((pd[k] - pc[k]) ** 2)) for k in pc) ** 0.5
            change = sum(float(torch.sum((pc[k] - p0[k]) ** 2)) for k in pc) ** 0.5
            assert err <= 1e-3 * change
            continue
        for k in pc:
            stepsz = float((pc[k] - p0[k]).abs().max())
            keep = grads[k].abs() > 1e-4 * grads[k].abs().max()
            assert float((pd[k] - pc[k]).abs()[keep].max()) <= 1e-4 * stepsz, k


def test_newton_schulz_on_the_card_matches_the_cpu(cuda):
    """The Muon orthogonalisation of the full-size 512 x 5000 output layer
    (Flax orientation, untransposed), fp32 with TF32 off: within 1e-4 of
    the largest entry of the CPU result."""
    from sepi_tpu_torch.train.optim import newton_schulz

    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.normal(size=(5000, 512)).astype(np.float32) * 0.01)
    ref = newton_schulz(w.T)
    got = newton_schulz(w.to(cuda).T).cpu()
    assert got.shape == (512, 5000)
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_staging_and_prefetch_deliver_batches_in_order(cuda):
    """PrefetchLoader over a sampler, then the Trainer's pinned-memory
    staging two units ahead: every unit reaches the card, in order."""
    from sepi_tpu_torch.data import ChunkBatch, PrefetchLoader
    from sepi_tpu_torch.train import Trainer, TrainState

    model = torch.nn.Linear(2, 2).to(cuda)
    tr = Trainer(steps={}, state=TrainState(model, {}), device_prefetch=2)

    def batches():
        for i in range(12):
            f = np.full((4, 8, 3), i, np.float32)
            yield ChunkBatch(f, np.full((4,), i, np.int32), 8)

    loader = PrefetchLoader(batches(), depth=3)
    seen = []
    for kind, task, f, l, w, k in tr._stage(tr._units(loader, 12)):
        assert f.is_cuda and l.is_cuda and kind == "single"
        seen.append((float(f.mean()), int(l[0])))
    loader.close()
    assert seen == [(float(i), i) for i in range(12)]


def test_optimizer_chain_on_the_card_matches_the_cpu(cuda):
    """The same gradients into the default chain (Muon + Adam, clip
    active) on the card and on the CPU, at the full-size x-vector's
    parameter shapes: the updates agree to 1e-5 of their largest entry
    (the Muon matrix to 1e-4), and the global norm of a list of tensors
    agrees to 1e-6."""
    from sepi_tpu_torch.config import OptimizerConfig
    from sepi_tpu_torch.models import V2_XVECTOR, XVector
    from sepi_tpu_torch.train.optim import build_optimizer, global_norm

    model = XVector(dataclasses.replace(V2_XVECTOR, num_speakers=5000))
    rng = np.random.default_rng(5)
    cpu = {n: p.detach().clone() for n, p in model.named_parameters()}
    grads = {n: torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32) * 1e-3)
             for n, p in cpu.items()}
    dev = {n: p.to(cuda) for n, p in cpu.items()}
    gdev = {n: g.to(cuda) for n, g in grads.items()}
    n_cpu, n_dev = float(global_norm(grads.values())), float(global_norm(gdev.values()))
    assert abs(n_dev - n_cpu) <= 1e-6 * n_cpu
    chain, _ = build_optimizer(OptimizerConfig(), 100)
    s_cpu, s_dev = chain.init(cpu), chain.init(dev)
    for _ in range(2):
        u_cpu = chain.update(grads, s_cpu, cpu)
        u_dev = chain.update(gdev, s_dev, dev)
        for n in u_cpu:
            # the Muon matrix within the Newton-Schulz test's 1e-4, the rest 1e-5
            limit = (1e-4 if u_cpu[n].ndim == 2 else 1e-5) * float(u_cpu[n].abs().max())
            err = float((u_dev[n].cpu() - u_cpu[n]).abs().max())
            assert err <= limit, (n, err, limit)


# ------------------------------------------------------------- c-vectors


def _cv_state(kind, device, opt, lr_factors=None, graft_from=None):
    """A narrow v3 (MultitaskCVector), v4 (AdaptedXVector) or v5
    (CombinedCVector) from a seeded Flax-style initialisation."""
    from sepi_tpu_torch.models import TdnnSpec, lecun_normal_init
    from sepi_tpu_torch.models import cvector as cv
    from sepi_tpu_torch.train import TrainState, build_optimizer, graft_subtree

    am = cv.AmConfig(num_senones=40, specs=(
        TdnnSpec(64, (-2, -1, 0, 1, 2)), TdnnSpec(64, (-1, 0, 1)), TdnnSpec(64, (-1, 0, 1)),
        TdnnSpec(64, (-3, 0, 3)), TdnnSpec(16, (-6, -3, 0))))
    kw = dict(num_speakers=12, embed_dim=64, hidden_dim=64, pool_dim=192)
    model = {"am": lambda: cv.AmNet(am),
             "v3": lambda: cv.MultitaskCVector(cv.MultitaskConfig(num_senones=40, **kw)),
             "v4": lambda: cv.AdaptedXVector(cv.AdaptedConfig(am=am, **kw)),
             "v5": lambda: cv.CombinedCVector(cv.CombinedConfig(num_senones=40, am=am, **kw)),
             }[kind]()
    lecun_normal_init(model, 3)
    if graft_from is not None:
        graft_subtree(model, graft_from, "am")
    model.to(device)
    chain, _ = build_optimizer(opt, 100, lr_factors=lr_factors)
    return chain, TrainState(model, chain.init(dict(model.named_parameters())))


def _cv_batches():
    """am, xvec, am: frame egs (16, 8 + 14, 23) with (16, 8) labels, then
    speaker chunks (16, 120, 23)."""
    rng = np.random.default_rng(1)
    am = [(rng.normal(size=(16, 22, 23)).astype(np.float32),
           rng.integers(0, 40, size=(16, 8)).astype(np.int32)) for _ in range(2)]
    return [("am", am[0]), ("xvec", _train_batches(1)[0]), ("am", am[1])]


@pytest.mark.parametrize("kind", ["v3", "v5"])
def test_cvector_steps_on_the_card_match_the_cpu(cuda, kind):
    """Interleaved am, xvec, am momentum-SGD steps from the same weights:
    ||p_card - p_cpu|| / ||p_cpu - p_init|| <= 1e-3 over all parameters,
    the ones a task does not reach included (v5 grafts one AM on both)."""
    from sepi_tpu_torch.config import OptimizerConfig
    from sepi_tpu_torch.train import make_am_step, make_xvec_step

    torch.backends.cudnn.allow_tf32 = False
    opt = OptimizerConfig(preconditioner="none")
    graft = _cv_state("am", "cpu", opt)[1].model if kind == "v5" else None
    factors = {"am": 0.1} if kind == "v5" else None
    chain_d, sd = _cv_state(kind, cuda, opt, factors, graft)
    chain_c, sc = _cv_state(kind, "cpu", opt, factors, graft)
    p0 = _flat(sc.model)
    for task, (f, l) in _cv_batches():
        make = make_am_step if task == "am" else make_xvec_step
        md = make(chain_d, {"task": task})(sd, torch.from_numpy(f).to(cuda),
                                           torch.from_numpy(l).to(cuda), 1.0)
        mc = make(chain_c, {"task": task})(sc, torch.from_numpy(f), torch.from_numpy(l), 1.0)
        assert float(md["objf"]) == pytest.approx(float(mc["objf"]), rel=1e-4, abs=1e-5)
    pd, pc = _flat(sd.model), _flat(sc.model)
    err = sum(float(torch.sum((pd[k] - pc[k]) ** 2)) for k in pc) ** 0.5
    change = sum(float(torch.sum((pc[k] - p0[k]) ** 2)) for k in pc) ** 0.5
    assert err <= 1e-3 * change


def test_frozen_graft_stays_frozen_on_the_card(cuda):
    """v4 with the AM's factor 0 and shrink off (default Muon chain): the
    grafted AM is bit-identical to its source after 10 steps."""
    from sepi_tpu_torch.config import OptimizerConfig
    from sepi_tpu_torch.train import make_xvec_step

    opt = OptimizerConfig(proportional_shrink=0.0)
    source = _cv_state("am", "cpu", opt)[1].model
    chain, st = _cv_state("v4", cuda, opt, {"am": 0.0}, source)
    step = make_xvec_step(chain)
    for f, l in _train_batches(10):
        step(st, torch.from_numpy(f).to(cuda), torch.from_numpy(l).to(cuda), 1.0)
    src = source.state_dict()
    for n, p in st.model.am.named_parameters():
        assert torch.equal(p.cpu(), src[n]), n


def test_entry_points_hold_fp32_under_tf32_flags(cuda):
    """With TF32 turned on for matmuls and cuDNN (cuDNN's is PyTorch's
    default), `nnet2_posteriors` (cuDNN convolutions) and
    `train_v1_frontend` (GEMMs, Cholesky) still compute in float32: their
    results hold against the CPU's, and the caller's flags come back."""
    import copy

    from sepi_tpu_torch.config import IvectorConfig, UbmConfig
    from sepi_tpu_torch.models import Nnet2Config, Nnet2Multisplice, lecun_normal_init
    from sepi_tpu_torch.recipes import nnet2_posteriors, train_v1_frontend

    rng = np.random.default_rng(0)
    hires = {f"u{i}": rng.normal(size=(90 + 7 * i, 40)).astype(np.float32) for i in range(6)}
    centers = rng.normal(size=(4, 12)) * 3.0
    sid = {f"u{i}": (centers[rng.integers(0, 4, 150)] + rng.normal(size=(150, 12))).astype(
        np.float32) for i in range(12)}
    model = Nnet2Multisplice(Nnet2Config(num_senones=300))
    lecun_normal_init(model, 0)
    model_cpu = copy.deepcopy(model)
    # two T-matrix iterations, as the CPU parity tests: T is determined only up
    # to near-flat directions of the likelihood, and five iterations carried
    # the card-CPU gap to 1.04e-3 here
    ubm_cfg, iv_cfg = UbmConfig(num_gauss=8), IvectorConfig(ivector_dim=6, num_iters=2)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        post = nnet2_posteriors(model, None, hires, device="cuda")
        ubm, ext = train_v1_frontend(sid, ubm_cfg, iv_cfg, device="cuda")
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (
            True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    post_c = nnet2_posteriors(model_cpu, None, hires, device="cpu")
    ubm_c, ext_c = train_v1_frontend(sid, ubm_cfg, iv_cfg, device="cpu")
    # log-posteriors: float32 logits agree to ~1e-6, TF32 products move them ~1e-3
    for u in hires:
        assert np.abs(np.log(post[u]) - np.log(post_c[u])).max() <= 1e-4
    for a, b in ((ubm.means, ubm_c.means), (ubm.covars, ubm_c.covars), (ext.t, ext_c.t)):
        a = a.cpu()
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-3


# ------------------------------------------- bf16 compute and the device backend

BF16_U = 2.0 ** -8  # bfloat16 unit roundoff; limits set before the first run on a card
BF16_OUT_TOL, BF16_TRAJ_TOL = 4 * BF16_U, 8 * BF16_U


def test_bf16_forward_and_steps_on_the_card_match_the_cpu(cuda):
    """A narrow x-vector in bf16: an eval-mode forward within 4 u of the
    CPU's (embedding bf16, logits float32), and 3 momentum-SGD steps
    within 8 u in the trajectory measure; parameters stay float32."""
    from sepi_tpu_torch.config import OptimizerConfig
    from sepi_tpu_torch.models import TdnnSpec, XVector, XVectorConfig, lecun_normal_init
    from sepi_tpu_torch.train import TrainState, build_optimizer, make_xvec_step

    specs = (TdnnSpec(64, (-2, -1, 0, 1, 2)), TdnnSpec(64, (-2, 0, 2)), TdnnSpec(64, (-3, 0, 3)),
             TdnnSpec(64, (0,)), TdnnSpec(192, (0,)))
    states = []
    for dev in (cuda, "cpu"):
        model = XVector(XVectorConfig(feat_dim=23, num_speakers=12, frame_specs=specs,
                                      embed_dim=64), dtype="bfloat16")
        lecun_normal_init(model, 3)
        model.to(dev)
        chain, _ = build_optimizer(OptimizerConfig(preconditioner="none"), 100)
        states.append((chain, TrainState(model, chain.init(dict(model.named_parameters())))))
    (chain_d, sd), (chain_c, sc) = states
    p0 = _flat(sc.model)
    batches = _train_batches()
    f0 = torch.from_numpy(batches[0][0])
    sd.model.eval()
    sc.model.eval()
    with torch.no_grad():
        od, oc = sd.model(f0.to(cuda)), sc.model(f0)
    for key, dt in (("embedding_a", torch.bfloat16), ("logits", torch.float32)):
        assert od[key].dtype == oc[key].dtype == dt
        c = oc[key].float()
        assert float((od[key].float().cpu() - c).abs().max()) <= BF16_OUT_TOL * float(
            c.abs().max()), key
    for f, l in batches:
        make_xvec_step(chain_d)(sd, torch.from_numpy(f).to(cuda), torch.from_numpy(l).to(cuda))
        make_xvec_step(chain_c)(sc, torch.from_numpy(f), torch.from_numpy(l))
    pd, pc = _flat(sd.model), _flat(sc.model)
    err = sum(float(torch.sum((pd[k] - pc[k]) ** 2)) for k in pc) ** 0.5
    change = sum(float(torch.sum((pc[k] - p0[k]) ** 2)) for k in pc) ** 0.5
    assert err <= BF16_TRAJ_TOL * change
    assert all(p.dtype == torch.float32 for p in sd.model.parameters())


def test_device_backend_on_the_card_matches_float64(cuda):
    """plda_score_matrix_device, score_trials(device=True), compute_lda_device
    and train_plda_device on the card, with TF32 turned on by the caller,
    against the float64 host path at tests/test_backend_device.py's
    tolerances; the caller's flags come back."""
    from sepi_tpu_torch.backend import (compute_lda, compute_lda_device, plda_score_matrix,
                                        plda_score_matrix_device, score_trials, train_plda,
                                        train_plda_device)
    from sepi_tpu_torch.data import Trial

    rng = np.random.default_rng(0)
    dim, k, utts = 40, 60, 8
    ys = rng.normal(size=(k, dim)) * 2.0
    x = np.concatenate([ys[i] + rng.normal(size=(utts, dim)) for i in range(k)]) + 5.0
    labels = [i for i in range(k) for _ in range(utts)]
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        plda = train_plda(x, labels, num_iters=6)
        enroll, test = rng.normal(size=(300, dim)) + 5.0, rng.normal(size=(400, dim)) + 5.0
        n = rng.integers(1, 5, size=300).astype(np.float64)
        got = plda_score_matrix_device(plda, enroll, test, n).cpu().numpy()
        dev_plda = train_plda_device(x, labels, num_iters=6, block=16)
        lda_d = compute_lda_device(x, labels, 8)
        trials = [Trial("m0", "t0", True), Trial("m0", "t1", False), Trial("m1", "t1", True)]
        vecs_e, vecs_t = {"m0": enroll[0], "m1": enroll[1]}, {"t0": test[0], "t1": test[1]}
        s_dev = score_trials(plda, vecs_e, vecs_t, trials, device=True)
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (
            True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    want = plda_score_matrix(plda, enroll, test, n)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-3 * scale, rtol=1e-3)
    np.testing.assert_allclose(dev_plda.psi, plda.psi, rtol=0.05, atol=0.05)
    s_host = score_trials(plda, vecs_e, vecs_t, trials)
    for key, v in s_host.items():
        assert s_dev[key] == pytest.approx(v, rel=1e-3, abs=1e-3 * scale)
    lda_h = compute_lda(x, labels, 8)
    np.testing.assert_allclose(lda_d.mean, lda_h.mean, atol=1e-4)
    for a, b in zip(lda_h.projection, lda_d.projection):
        assert abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b)) == pytest.approx(1.0,
                                                                                      abs=1e-3)


def test_streaming_embed_on_the_card_matches_whole_utterance(cuda):
    """streaming_embed on the card over 6000 frames in chunks of 997
    against whole-utterance extraction (tests/test_e2e.py:117-138's
    rtol/atol 2e-3)."""
    from sepi_tpu_torch.config import ExtractConfig, OptimizerConfig
    from sepi_tpu_torch.extract import streaming_embed
    from sepi_tpu_torch.recipes import extract_and_score

    model = _tiny_train_state(cuda, OptimizerConfig())[1].model.eval()
    feats = np.random.default_rng(1).normal(size=(6000, 23)).astype(np.float32)
    streamed = streaming_embed(model, feats, chunk=997, device="cuda")
    whole = extract_and_score(model, None, {"u": feats}, ExtractConfig(chunk_size=6000,
                                                                       batch_size=1),
                              model.cfg.min_frames, device="cuda")["u"]
    np.testing.assert_allclose(streamed, whole, rtol=2e-3, atol=2e-3)


def _cli_kaldi_dir(root):
    """A Kaldi data dir of WAVs from a small phonetic corpus, its trials."""
    from sepi_tpu_torch.data import (Dataset, make_phonetic_corpus, save_trials,
                                     write_kaldi_dir, write_wav)

    corpus = make_phonetic_corpus(num_speakers=4, utts_per_speaker=4, seed=41)
    utts = []
    for u in corpus.dataset:
        p = str(root / f"{u.utt_id}.wav")
        write_wav(p, corpus.audio[u.utt_id], 8000)
        utts.append(u.replace(wav=p))
    write_kaldi_dir(Dataset(utts, "cli"), str(root / "data"))
    save_trials(corpus.trials, str(root / "trials"))
    return str(root / "data"), str(root / "trials")


def test_cli_v2_on_the_card(cuda, tmp_path, capsys):
    """`v2` through the command line with its default device (the card)."""
    from sepi_tpu_torch.cli import main

    ddir, trials = _cli_kaldi_dir(tmp_path)
    wd = str(tmp_path / "exp")
    assert main(["v2", "--train-data", ddir, "--enroll-data", ddir, "--trials", trials,
                 "--workdir", wd, "--num-steps", "20", "--min-chunk", "50", "--max-chunk", "100",
                 "--chunk-buckets", "2", "--batch-size", "8"]) == 0
    assert "pooled" in capsys.readouterr().out
    for f in ("xvector.scp", "det_pooled.svg", "metrics.jsonl"):
        assert (tmp_path / "exp" / f).exists()


def test_cli_import_kaldi_forward_on_the_card(cuda, tmp_path):
    """import-kaldi builds the model on the card; its forward matches the
    CPU's within 1e-4 (TF32 off), and export-kaldi writes the bytes back."""
    from sepi_tpu_torch.cli import load_state_dict_file, main
    from sepi_tpu_torch.device import fp32_math
    from sepi_tpu_torch.models import XVector, XVectorConfig
    from sepi_tpu_torch.models.tdnn import TdnnSpec, lecun_normal_init
    from sepi_tpu_torch.utils.nnet3 import export_kaldi_raw, import_kaldi_raw

    cfg = XVectorConfig(num_speakers=7, embed_dim=32, frame_specs=(
        TdnnSpec(64, (-2, -1, 0, 1, 2)), TdnnSpec(64, (-2, 0, 2)), TdnnSpec(64, (-3, 0, 3)),
        TdnnSpec(64, (0,)), TdnnSpec(128, (0,))))
    model = XVector(cfg)
    lecun_normal_init(model, 5)
    raw = str(tmp_path / "final.raw")
    export_kaldi_raw(model, "v2", raw)
    on_card, _, arch = import_kaldi_raw(raw)
    assert arch == "v2" and next(on_card.parameters()).device.type == "cuda"
    assert main(["import-kaldi", "--raw", raw, "--out", str(tmp_path / "imp")]) == 0
    back = XVector(cfg)
    back.load_state_dict(load_state_dict_file(str(tmp_path / "imp" / "model.pt")))
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(4, 200, 23)).astype(np.float32))
    with torch.no_grad(), fp32_math():
        card = back.to("cuda").eval()(x.cuda())["embedding_a"].cpu()
        host = back.cpu()(x)["embedding_a"]
    assert float((card - host).abs().max()) <= 1e-4 * max(1.0, float(host.abs().max()))
    out = str(tmp_path / "back.raw")
    assert main(["export-kaldi", "--model", str(tmp_path / "imp" / "model.pt"), "--arch", "v2",
                 "--out", out]) == 0
    assert open(out, "rb").read() == open(raw, "rb").read()


def test_cli_gauntlet_on_the_card(cuda, tmp_path, monkeypatch, capsys):
    """The gauntlet through the command line (v2 and v5, bootstrap) at a
    tiny scale in place of CI_SCALE."""
    from sepi_tpu_torch.cli import main
    from sepi_tpu_torch.recipes import gauntlet

    tiny = dataclasses.replace(
        gauntlet.CI_SCALE, num_train_speakers=4, num_eval_speakers=4, num_adapt_speakers=2,
        utts_per_speaker=4, eval_utts_per_speaker=5, enroll_utts=2, steps=6, am_steps=6,
        frame_dim=12, pool_dim=16, embed_dim=8, am_dim=12, am_bottleneck=6, batch_size=4,
        am_batch_size=16, align=dataclasses.replace(gauntlet.CI_SCALE.align, num_leaves=16,
                                                    mono_iters=2, refine_iters=1,
                                                    min_count=20.0))
    monkeypatch.setattr(gauntlet, "CI_SCALE", tiny)
    assert main(["gauntlet", "--variants", "v2,v5", "--bootstrap", "20",
                 "--workdir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "v5 vs v2" in out and out.count("[gauntlet:") >= 2


# ------------------------------------------------------------- the mesh


def _mesh_steps_rank(out_path, batches):
    """One rank of a world on the card: 3 momentum-SGD steps of the tiny
    x-vector on the global batches over the mesh; each rank saves its
    state_dict to ``out_path.<rank>``."""
    import torch.distributed as dist

    from sepi_tpu_torch.config import OptimizerConfig
    from sepi_tpu_torch.parallel import make_mesh
    from sepi_tpu_torch.train import make_xvec_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh()
    dev = torch.device("cuda", torch.cuda.current_device())
    chain, st = _tiny_train_state(dev, OptimizerConfig(preconditioner="none"))
    step = make_xvec_step(chain, mesh=mesh)
    for f, l in batches:
        step(st, torch.from_numpy(f).to(dev), torch.from_numpy(l).to(dev), 1.0)
    torch.save({k: v.cpu() for k, v in st.model.state_dict().items()},
               f"{out_path}.{dist.get_rank()}")


def _plain_steps(device, batches):
    from sepi_tpu_torch.config import OptimizerConfig
    from sepi_tpu_torch.train import make_xvec_step

    chain, st = _tiny_train_state(device, OptimizerConfig(preconditioner="none"))
    for f, l in batches:
        make_xvec_step(chain)(st, torch.from_numpy(f).to(device), torch.from_numpy(l).to(device),
                              1.0)
    return {k: v.cpu() for k, v in st.model.state_dict().items()}


def _assert_step_close(got, want):
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def test_nccl_world_of_one_steps_like_the_plain_step(cuda, tmp_path):
    """NCCL starts, and its collectives run in the step, at world size 1:
    the DP steps equal the plain steps within the reference's DP-step
    tolerance (cuDNN's weight gradients vary from run to run)."""
    from sepi_tpu_torch.parallel.dryrun import launch

    torch.backends.cudnn.allow_tf32 = False
    batches = _train_batches()
    launch(1, _mesh_steps_rank, (str(tmp_path / "p"), batches), device="cuda", timeout_s=300)
    _assert_step_close(torch.load(f"{tmp_path / 'p'}.0"), _plain_steps(cuda, batches))


def test_two_gloo_ranks_share_the_card(cuda, tmp_path):
    """Two processes on one card over gloo (NCCL refuses a shared device):
    the ranks end bit-equal and within the DP-step tolerance of one
    process's steps on the global batches."""
    from sepi_tpu_torch.parallel.dryrun import launch

    torch.backends.cudnn.allow_tf32 = False
    batches = _train_batches()
    launch(2, _mesh_steps_rank, (str(tmp_path / "p"), batches), device="cuda", backend="gloo",
           timeout_s=300)
    a, b = (torch.load(f"{tmp_path / 'p'}.{r}") for r in (0, 1))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    _assert_step_close(a, _plain_steps(cuda, batches))


PRESETS = ("MFCC_SRE_IVECTOR", "MFCC_SRE_XVECTOR", "MFCC_SNIP_EDGES", "MFCC_HIRES", "MFCC_ASR")


def _parity_audio(device):
    rng = np.random.default_rng(14)
    n = 3 * 8000
    x = (rng.normal(size=(4, n)) * 3000).astype(np.float32)
    lengths = np.array([n, 17600, 8800, 3200], np.int32)
    x[np.arange(n)[None, :] >= lengths[:, None]] = 0.0
    seeds = utt_seeds([f"p{i}" for i in range(4)])
    return torch.tensor(x, device=device), torch.tensor(lengths, device=device), seeds


@pytest.mark.parametrize("preset", PRESETS)
def test_mfcc_presets_launch_the_kernel(cuda, preset):
    """Every preset lies inside the kernel's gate: under the default mode
    `FeatureExtractor.mfcc` launches it, within 2e-3 of the plain version."""
    from sepi_tpu_torch import config as tcfg
    from sepi_tpu_torch.ops.features import FeatureExtractor

    cfg = getattr(tcfg, preset)
    x, lengths, seeds = _parity_audio(cuda)
    before = mfcc_cuda.mfcc_fused.launches
    got, mask = FeatureExtractor(cfg, cuda).mfcc(x, lengths, utt_seeds=seeds)
    torch.cuda.synchronize()
    assert mfcc_cuda.mfcc_fused.launches == before + 1
    ref, mref = mfcc_cuda.mfcc_fused_reference(x, lengths, cfg, got.shape[1],
                                               torch.tensor(seeds, device=cuda))
    assert torch.equal(mask, mref)
    assert float((got - ref).abs().max()) < 2e-3


@pytest.mark.parametrize("kw", [dict(raw_energy=False), dict(frame_shift_ms=9.125),
                                dict(frame_length_ms=8.0, frame_shift_ms=10.0)],
                         ids=["no_raw_energy", "shift_9125", "shift_over_length"])
@pytest.mark.parametrize("dither", [0.0, 1.0])
def test_stepwise_mfcc_on_the_card_matches_the_cpu(cuda, kw, dither):
    """A config outside the kernel's gate takes the stepwise route on the
    card, with no launch, within 1e-3 of the same route on the CPU."""
    from sepi_tpu_torch.ops.features import FeatureExtractor

    cfg = FrontendConfig(dither=dither, **kw)
    x, lengths, seeds = _parity_audio(cuda)
    before = mfcc_cuda.mfcc_fused.launches
    got, mask = FeatureExtractor(cfg, cuda).mfcc(x, lengths, utt_seeds=seeds)
    assert mfcc_cuda.mfcc_fused.launches == before
    want, wmask = FeatureExtractor(cfg, "cpu").mfcc(x.cpu(), lengths.cpu(), utt_seeds=seeds)
    assert torch.equal(mask.cpu(), wmask)
    assert float((got.cpu() - want).abs().max()) <= 1e-3


def test_mfcc_kernel_failure_raises(cuda, monkeypatch):
    """A config inside the gate never leaves the kernel: a failed launch
    raises instead of running the stepwise route."""
    from sepi_tpu_torch.ops.features import FeatureExtractor

    def fail(*args, **kwargs):
        raise RuntimeError("planted launch failure")

    monkeypatch.setattr(mfcc_cuda, "_launch", fail)
    x, lengths, seeds = _parity_audio(cuda)
    with pytest.raises(RuntimeError, match="planted"):
        FeatureExtractor(FrontendConfig(), cuda).mfcc(x, lengths, utt_seeds=seeds)


def test_graft_entry_on_the_card_matches_the_cpu(cuda):
    from sepi_tpu_torch.graft_entry import entry

    fwd, (model, feats) = entry()
    got = fwd(model, feats)
    fwd_c, (model_c, feats_c) = entry(device="cpu")
    want = fwd_c(model_c, feats_c)
    assert got.device.type == "cuda" and got.shape == (8, 512)
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max())


# the bench at full widths, on small batches: every check, and the kernel's launches
GPU_BENCH = dict(utts=2, secs=10.0, chunks=8, superstep=2, am_chunks=16, pair_superstep=2,
                 plda_models=512, plda_tests=512, extract_iters=2, step_iters=2,
                 superstep_iters=1, plda_iters=2, warmup=1)


def test_bench_checks_hold_on_the_card(cuda):
    """`bench.main` on the card: its checks hold (the MFCC kernel against
    its plain version, embeddings, objectives and moved parameters, the
    trial block against float64), each extraction call launched the
    kernel once, and the line carries the card."""
    from sepi_tpu_torch import bench

    shapes = bench.Shapes(**GPU_BENCH)
    before = mfcc_cuda.mfcc_fused.launches
    line, runs = bench.main(device="cuda", repeats=2, shapes=shapes)
    # the capturing call, the checked replay, the captured and the eager timed calls
    assert mfcc_cuda.mfcc_fused.launches - before == runs["extraction"].calls == 2 + 2 * (
        shapes.warmup + 2 * shapes.extract_iters)
    assert runs["extraction"].embeddings.device.type == "cuda"
    assert runs["extraction"].mfcc_err <= bench.MFCC_TOL
    assert runs["plda"].block_err <= bench.PLDA_RTOL
    assert line["device"] not in ("", "cpu") and "error" not in line
    values = [line["value"], line["vs_baseline"], *line["extra"].values()]
    assert len(values) == 9 and all(v is not None and np.isfinite(v) and v > 0 for v in values)


def test_bench_check_catches_a_planted_kernel_fault(cuda, monkeypatch):
    """The MFCC kernel's output shifted by 0.01 after each launch: the
    extraction stage's check raises instead of reporting a number."""
    from sepi_tpu_torch import bench

    launch = mfcc_cuda._launch

    def faulty(samples, lengths, seeds, cfg, max_frames, c, out, mask):
        launch(samples, lengths, seeds, cfg, max_frames, c, out, mask)
        out.add_(0.01)

    monkeypatch.setattr(mfcc_cuda, "_launch", faulty)
    with pytest.raises(bench.BenchCheckFailed, match="MFCC"):
        bench.bench_extraction(np.random.default_rng(0), device="cuda",
                               shapes=bench.Shapes(**GPU_BENCH), repeats=1)


# ------------------------------------------------------------- the captured step


@pytest.fixture
def deterministic_cudnn(cuda):
    keep = torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = True, False
    yield cuda
    torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = keep


def _tensors(state):
    from sepi_tpu_torch.train.graphs import state_tensors

    return list(state_tensors(state))


def _bit_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(_tensors(a), _tensors(b)))


@pytest.mark.parametrize("opt,dtype", [("muon", "float32"), ("none", "float32"),
                                       ("muon", "bfloat16")])
def test_captured_steps_equal_eager_steps_on_the_card(deterministic_cudnn, opt, dtype):
    """6 captured steps and a K = 3 superstep against the eager steps from
    the same state, bit for bit under deterministic cuDNN."""
    from sepi_tpu_torch.config import OptimizerConfig
    from sepi_tpu_torch.models import TdnnSpec, XVector, XVectorConfig, lecun_normal_init
    from sepi_tpu_torch.train import (TrainState, build_optimizer, graphs, make_superstep,
                                      make_xvec_step)

    dev = deterministic_cudnn
    specs = (TdnnSpec(64, (-2, -1, 0, 1, 2)), TdnnSpec(64, (-2, 0, 2)), TdnnSpec(192, (0,)))
    model = XVector(XVectorConfig(feat_dim=23, num_speakers=12, frame_specs=specs,
                                  embed_dim=64), dtype=dtype)
    lecun_normal_init(model, 3)
    chain, _ = build_optimizer(OptimizerConfig(preconditioner=opt), 100)
    sg = TrainState(model.to(dev), chain.init(dict(model.named_parameters())))
    se = sg.clone()
    batches = [(torch.from_numpy(f).to(dev), torch.from_numpy(l).to(dev))
               for f, l in _train_batches(count=9)]
    step, sstep = make_xvec_step(chain), make_superstep(chain)
    e_step = make_xvec_step(chain, capture=False)
    for f, l in batches[:6]:
        mg, me = step(sg, f, l, 1.0), e_step(se, f, l, 1.0)
        assert all(torch.equal(mg[k], me[k]) for k in me)
    f = torch.stack([b[0] for b in batches[6:]])
    l = torch.stack([b[1] for b in batches[6:]])
    mg = sstep(sg, f, l, torch.ones(3, device=dev))
    me = [e_step(se, f[i], l[i], 1.0) for i in range(3)]
    assert all(torch.equal(mg[k], torch.stack([m[k] for m in me])) for k in mg)
    assert isinstance(step, graphs.StepGraphs) and len(step.graphs) == len(sstep.graphs) == 1
    assert sg.step == se.step == 9 and _bit_equal(sg, se)


def test_captured_step_recaptures_on_a_new_state_on_the_card(deterministic_cudnn, tmp_path):
    """A clone and a loaded checkpoint each get a graph of their own and
    step as the eager step does; the old graph replayed against a replaced
    optimizer state (the planted fault) does not."""
    from sepi_tpu_torch.config import OptimizerConfig
    from sepi_tpu_torch.train import load_checkpoint, make_xvec_step, save_checkpoint

    dev = deterministic_cudnn
    chain, state = _tiny_train_state(dev, OptimizerConfig())
    f, l = (torch.from_numpy(x).to(dev) for x in _train_batches(count=1)[0])
    step, e_step = make_xvec_step(chain), make_xvec_step(chain, capture=False)
    step(state, f, l, 1.0)
    first = next(iter(step.graphs.values()))
    save_checkpoint(state, str(tmp_path), state.step)
    step(state, f, l, 1.0)
    held = []  # alive: a freed state's addresses could be taken by the next one
    for make in (state.clone, lambda: load_checkpoint(state, str(tmp_path))):
        a, b = make(), make()
        held += [a, b]
        step(a, f, l, 1.0)
        e_step(b, f, l, 1.0)
        assert _bit_equal(a, b)
    assert len(step.graphs) == 3
    old = state.opt_state  # noqa: F841  (alive: the old graph writes there)
    state.opt_state = load_checkpoint(state, str(tmp_path)).opt_state
    ref = state.clone()
    e_step(ref, f, l, 1.0)
    first.run(state, f, l, 1.0)
    assert not _bit_equal(state, ref)


def test_failed_capture_raises_on_the_card(cuda, monkeypatch):
    """A capture that fails raises GraphCaptureError and leaves the state
    as it was; capture=True works on a CUDA state."""
    from sepi_tpu_torch.config import OptimizerConfig
    from sepi_tpu_torch.train import graphs, make_xvec_step

    chain, state = _tiny_train_state(cuda, OptimizerConfig())
    f, l = (torch.from_numpy(x).to(cuda) for x in _train_batches(count=1)[0])
    before = [t.clone() for t in _tensors(state)]

    def fail(dev, fn, pool):
        raise RuntimeError("planted capture failure")

    monkeypatch.setattr(graphs.BACKEND, "capture", fail)
    with pytest.raises(graphs.GraphCaptureError, match="planted"):
        make_xvec_step(chain, capture=True)(state, f, l, 1.0)
    assert state.step == 0 and all(torch.equal(a, b) for a, b in zip(before, _tensors(state)))
    monkeypatch.undo()
    m = make_xvec_step(chain, capture=True)(state, f, l, 1.0)
    assert state.step == 1 and bool(torch.isfinite(m["objf"]))


# ------------------------------------------------------------- the compiled serving path


def _serving_model(dev, dtype="float32", seed=4):
    from sepi_tpu_torch.models import TdnnSpec, XVector, XVectorConfig

    specs = (TdnnSpec(64, (-2, -1, 0, 1, 2)), TdnnSpec(64, (-2, 0, 2)), TdnnSpec(192, (0,)))
    model = XVector(XVectorConfig(feat_dim=23, num_speakers=12, frame_specs=specs,
                                  embed_dim=64), dtype=dtype)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) / max(p[0].numel(), 1) ** 0.5)
    return model.to(dev).eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_captured_extractor_equals_eager_on_the_card(deterministic_cudnn, dtype):
    """Every bucket of a short ladder captured, replayed, and after
    load_state_dict and model.to(), bit-equal to capture=False; a graph of
    the replaced weights replays them."""
    from sepi_tpu_torch import graphs
    from sepi_tpu_torch.config import ExtractConfig
    from sepi_tpu_torch.extract import EmbeddingExtractor

    dev = deterministic_cudnn
    cfg = ExtractConfig(chunk_size=400, batch_size=8)
    model = _serving_model(dev, dtype)
    rng = np.random.default_rng(5)
    feats = {f"u{i}": rng.standard_normal((n, 23)).astype(np.float32)
             for i, n in enumerate([25, 40, 90, 150, 300, 400, 1000] + [45] * 10)}
    cap = EmbeddingExtractor(model, cfg, min_frames=15, device=dev)
    eag = EmbeddingExtractor(model, cfg, min_frames=15, device=dev, capture=False)

    def same():
        got, want = cap.extract_utterances(feats), eag.extract_utterances(feats)
        return all(np.array_equal(got[u], want[u]) for u in want)

    graphs.reset_counts()
    assert same() and same()
    assert graphs.call_counts["replays"] > 0 and len(cap.graphs.graphs) == 5
    model.load_state_dict(_serving_model("cpu", dtype, seed=6).state_dict())
    assert same() and graphs.call_counts["captures"] == 5
    old = next(iter(cap.graphs.graphs.values()))
    model.to("cpu").to(dev)
    model.load_state_dict(_serving_model("cpu", dtype, seed=7).state_dict())
    assert same() and graphs.call_counts["captures"] == 10
    x = torch.randn(old.args[1].shape)  # its bucket's rows (the rung) x 25 frames
    m = torch.ones(x.shape[:2], dtype=torch.bool)
    assert not torch.equal(old.run([model, x, m]), eag.graphs(model, x, m))


def test_one_chunk_replays_a_one_row_graph_on_the_card(deterministic_cudnn, monkeypatch):
    """A verification request's one chunk (3,000 frames, the 3,200 bucket):
    replayed from a 1-row graph, bit-equal to capture=False at the same
    rung, and within 1e-6 (relative l2) of the 32-row packing."""
    from sepi_tpu_torch import graphs
    from sepi_tpu_torch.config import ExtractConfig
    from sepi_tpu_torch.extract import EmbeddingExtractor

    dev = deterministic_cudnn
    cfg = ExtractConfig()
    model = _serving_model(dev)
    feats = {"req": np.random.default_rng(9).standard_normal((3000, 23)).astype(np.float32)}
    cap = EmbeddingExtractor(model, cfg, min_frames=15, device=dev)
    eag = EmbeddingExtractor(model, cfg, min_frames=15, device=dev, capture=False)
    graphs.reset_counts()
    cap.extract_utterances(feats)  # the capture
    got = cap.extract_utterances(feats)["req"]
    assert graphs.call_counts == {"captures": 1, "replays": 1}
    (g,) = cap.graphs.graphs.values()
    assert tuple(g.args[1].shape) == (1, 3200, 23)
    assert np.array_equal(got, eag.extract_utterances(feats)["req"])
    monkeypatch.setattr(EmbeddingExtractor, "_rows", lambda self, n: self.cfg.batch_size)
    full = eag.extract_utterances(feats)["req"]
    gap = np.linalg.norm(got.astype(np.float64) - full) / np.linalg.norm(full)
    assert gap <= 1e-6, gap


def test_captured_extraction_through_pinned_blocks_on_the_card(deterministic_cudnn):
    """Extraction staged the one way (`device`): every batch handed to the
    graphs as pinned host tensors, the captured calls bit-equal to
    capture=False, and a second identical call on the held extractor
    takes every pinned block from torch's caching host allocator."""
    from sepi_tpu_torch.config import ExtractConfig
    from sepi_tpu_torch.extract import EmbeddingExtractor

    dev = deterministic_cudnn
    cfg = ExtractConfig(chunk_size=400, batch_size=8)
    model = _serving_model(dev)
    rng = np.random.default_rng(11)
    feats = {f"u{i}": rng.standard_normal((n, 23)).astype(np.float32)
             for i, n in enumerate([25, 40, 90, 150, 300, 400, 1000] + [45] * 10)}
    cap = EmbeddingExtractor(model, cfg, min_frames=15, device=dev)
    eag = EmbeddingExtractor(model, cfg, min_frames=15, device=dev, capture=False)
    run, handed = cap.graphs, []

    def spy(*args):  # flags only: a kept tensor would keep its pinned block
        handed.extend((a.is_cuda, a.is_pinned()) for a in args if isinstance(a, torch.Tensor))
        return run(*args)

    cap.graphs = spy
    first = cap.extract_utterances(feats)
    allocs = torch.cuda.host_memory_stats()["num_host_alloc"]
    second = cap.extract_utterances(feats)
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == allocs
    assert handed and all(pinned and not on_card for on_card, pinned in handed)
    want = eag.extract_utterances(feats)
    assert sorted(first) == sorted(second) == sorted(want)
    assert all(np.array_equal(first[u], want[u]) and np.array_equal(second[u], want[u])
               for u in want)
    assert len(run.graphs) == 5


def test_captured_frontend_chain_equals_eager_on_the_card(deterministic_cudnn):
    """The frontend chain replayed, dithered and with the v1 deltas: equal
    to capture=False; the MFCC launches counted through the replays."""
    from sepi_tpu_torch import graphs
    from sepi_tpu_torch.config import MFCC_SRE_IVECTOR, CmvnConfig, VadConfig
    from sepi_tpu_torch.ops import FeatureExtractor
    from sepi_tpu_torch.ops.deltas import add_deltas
    from sepi_tpu_torch.recipes.pipeline import _frontend_batches

    dev = deterministic_cudnn
    rng = np.random.default_rng(8)
    audio = {f"a{i}": (rng.standard_normal(n) * 1000).astype(np.float32)
             for i, n in enumerate(list(rng.integers(24000, 25000, 12)) + [9000, 41000])}
    for cfg, key, transform in ((FrontendConfig(), 3, None),
                                (MFCC_SRE_IVECTOR, None, lambda f, m: add_deltas(f, m))):
        fe = FeatureExtractor(cfg, dev)
        graphs.reset_counts()
        before = mfcc_cuda.mfcc_fused.launches
        got = list(_frontend_batches(audio, fe, VadConfig(), CmvnConfig(), key, 4,
                                     transform=transform))
        assert mfcc_cuda.mfcc_fused.launches - before == len(got)
        assert graphs.call_counts["replays"] > 0
        want = list(_frontend_batches(audio, fe, VadConfig(), CmvnConfig(), key, 4,
                                      transform=transform, capture=False))
        for g, w in zip(got, want):
            assert g[0] == w[0] and all(np.array_equal(a, b) for a, b in zip(g[1:], w[1:]))


def test_kept_frontend_graphs_replay_bit_equal_on_the_card(deterministic_cudnn, monkeypatch):
    """Verification's frontend: one 10-60 s segment a call, a new
    FeatureExtractor each call.  Once every width has been captured, later
    calls replay the kept graphs (no capture, each batch counted in
    ``frontend.graph_reused``), bit-equal to the first calls and to
    capture=False."""
    from sepi_tpu_torch import graphs
    from sepi_tpu_torch.config import CmvnConfig, VadConfig
    from sepi_tpu_torch.ops import FeatureExtractor
    from sepi_tpu_torch.recipes import pipeline
    from sepi_tpu_torch.utils import logging as L

    monkeypatch.setattr(pipeline, "_KEPT", {})
    dev = deterministic_cudnn
    rng = np.random.default_rng(11)
    audio = {f"r{i}": (rng.standard_normal(n) * 1000 * (1.2 + np.sin(np.arange(n) / 700.0))
                       ).astype(np.float32)
             for i, n in enumerate(rng.integers(80000, 480000, 8))}

    def call(capture=None):
        out = []
        for name, x in audio.items():
            fe = FeatureExtractor(FrontendConfig(), dev)
            out += [(names, *(np.array(a) for a in arrays)) for names, *arrays in
                    pipeline._frontend_batches({name: x}, fe, VadConfig(), CmvnConfig(), None, 16,
                                               capture=capture)]
        return out

    graphs.reset_counts()
    first = call()
    widths = len({b[1].shape for b in first})
    assert graphs.call_counts["captures"] == widths > 1
    L.reset()
    second = call()
    assert graphs.call_counts == {"captures": widths, "replays": 2 * len(audio) - widths}
    assert L.counters()["frontend.graph_reused"] == len(audio)
    want = call(capture=False)
    for a, b, w in zip(first, second, want):
        assert a[0] == b[0] == w[0]
        assert all(x.tobytes() == y.tobytes() == z.tobytes()
                   for x, y, z in zip(a[1:], b[1:], w[1:]))
    nosil = [pipeline.prepare_features_nosil({n: x}, FrontendConfig(), batch_size=16, device=dev)
             for n, x in audio.items()]
    assert graphs.call_counts["captures"] == widths
    for (names, feats, voiced, _), f in zip(first, nosil):
        assert f[names[0]].tobytes() == feats[0][voiced[0].astype(bool)].tobytes()


def test_frontend_batches_staged_in_pinned_memory_on_the_card(deterministic_cudnn, monkeypatch):
    """Two dithered frontend calls in a row on the same audio, each batch
    packed in place into pinned blocks that the second call takes again from
    torch's caching host allocator and handed to the graph on the host (no
    device tensor made by the caller): bit-equal to each other and to
    capture=False; ``frontend.staged_bytes`` counts each batch's samples,
    lengths and seeds in and its three outputs out; the phonetic stream's
    arrays own their memory."""
    from sepi_tpu_torch.config import CmvnConfig, VadConfig
    from sepi_tpu_torch.graphs import CallGraphs
    from sepi_tpu_torch.ops import FeatureExtractor
    from sepi_tpu_torch.recipes import pipeline
    from sepi_tpu_torch.recipes.pipeline import (_frontend_batches, padded_audio_batches,
                                                 prepare_features_phonetic)
    from sepi_tpu_torch.utils import logging as L

    handed = []

    class Spy(CallGraphs):
        def __call__(self, *args):  # flags only: a kept tensor would keep its pinned block
            handed.append([(a.is_pinned(), a.is_cuda) if isinstance(a, torch.Tensor) else a.dtype
                           for a in args])
            return super().__call__(*args)

    monkeypatch.setattr(pipeline, "CallGraphs", Spy)
    monkeypatch.setattr(pipeline, "_KEPT", {})  # the Spy holds this test's graphs

    dev = deterministic_cudnn
    rng = np.random.default_rng(10)
    audio = {f"a{i}": (rng.standard_normal(n) * 1000).astype(np.float32)
             for i, n in enumerate(rng.integers(9000, 41000, 14))}
    fe = FeatureExtractor(FrontendConfig(), dev)

    def batches(capture=None):  # copied out batch by batch, as every caller does
        return [(names, *(np.array(a) for a in arrays)) for names, *arrays in
                _frontend_batches(audio, fe, VadConfig(), CmvnConfig(), 3, 4, capture=capture)]

    first = batches()
    stats = getattr(torch.cuda, "host_memory_stats", None)
    allocs = stats().get("num_host_alloc") if stats else None
    L.reset()
    second = batches()
    staged = L.counters()["frontend.staged_bytes"]
    if allocs is not None:
        assert stats()["num_host_alloc"] == allocs  # every block from the cache
    # samples and lengths in pinned blocks, the seeds a numpy array the graph pins
    assert handed and all(h == [(True, False), (True, False), np.int32] for h in handed)
    want = batches(capture=False)
    for a, b, w in zip(first, second, want):
        assert a[0] == b[0] == w[0]
        assert all(np.array_equal(x, y) and np.array_equal(x, z)
                   for x, y, z in zip(a[1:], b[1:], w[1:]))
    padded = [s.nbytes + 2 * l.nbytes for _, s, l in padded_audio_batches(audio, 4)]
    assert staged == sum(padded) + sum(x.nbytes for g in second for x in g[1:])
    pf = prepare_features_phonetic(audio, FrontendConfig(), key=3, batch_size=4, device=dev)
    for out in (pf.full, pf.voiced, pf.nosil):
        assert all(a.base is None for a in out.values())


def test_captured_eval_step_and_bench_programs_on_the_card(deterministic_cudnn):
    """The eval step and the bench's scoring program replayed, bit-equal to
    the eager calls."""
    from sepi_tpu_torch import bench
    from sepi_tpu_torch.config import OptimizerConfig
    from sepi_tpu_torch.graphs import CallGraphs
    from sepi_tpu_torch.train import make_eval_step

    dev = deterministic_cudnn
    _, state = _tiny_train_state(dev, OptimizerConfig())
    ev, ev_e = make_eval_step(), make_eval_step(capture=False)
    for f, lab in _train_batches(count=3) * 2:
        got, want = ev(state, f, lab), ev_e(state, f, lab)
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert len(ev.graphs.graphs) == 1
    rng = np.random.default_rng(9)
    q = np.linalg.qr(rng.normal(size=(32, 32)))[0]
    inputs = [torch.tensor(np.asarray(a, np.float32), device=dev)
              for a in (rng.normal(size=32), q, rng.uniform(0.1, 5.0, 32),
                        rng.normal(size=(300, 32)), rng.normal(size=(200, 32)))]
    scoring = bench.plda_scoring(dev)
    program = CallGraphs(scoring, device=dev)
    for _ in range(3):
        assert torch.equal(program(*inputs), scoring(*inputs))


def test_failed_inference_capture_raises_on_the_card(cuda, monkeypatch):
    """A capture that fails raises GraphCaptureError, and the extractor
    does not run eagerly in its place."""
    from sepi_tpu_torch import graphs
    from sepi_tpu_torch.config import ExtractConfig
    from sepi_tpu_torch.extract import EmbeddingExtractor

    ext = EmbeddingExtractor(_serving_model(cuda), ExtractConfig(batch_size=4), min_frames=15,
                             device=cuda)

    def fail(dev, fn, pool):
        raise RuntimeError("planted capture failure")

    monkeypatch.setattr(graphs.BACKEND, "capture", fail)
    with pytest.raises(graphs.GraphCaptureError, match="planted"):
        ext.extract_utterances({"u": np.zeros((60, 23), np.float32)})
    assert ext.graphs.graphs == {}


# ------------------------------------------- MFA-Conformer and its score kernel


def _relpos_inputs(b, h, q, t, seed, dev, band_first=False):
    """Seeded ac (B, H, q, t) and bd (B, H, q, q + t - 1); with
    ``band_first`` bd is the model's layout, (H, B, ...) transposed."""
    g = torch.Generator().manual_seed(seed)
    ac = (4 * torch.randn((b, h, q, t), generator=g)).to(dev)
    bd = 4 * torch.randn((h, b, q, q + t - 1), generator=g)
    bd = bd.to(dev).transpose(0, 1) if band_first else bd.transpose(0, 1).contiguous().to(dev)
    return ac, bd


@pytest.mark.parametrize("b,h,q,t,band_first", [
    (2, 4, 5, 7, False), (3, 2, 64, 300, True), (1, 1, 1, 1, False), (2, 4, 17, 1025, True),
    (2, 4, 384, 4997, True)])
def test_relpos_softmax_kernel_matches_plain(cuda, b, h, q, t, band_first):
    """The Triton kernel against its plain version on the card: one launch,
    probabilities within 2e-6 of the plain softmax's (the kernel's exp and
    its sum's order), every key masked in a row of length 0 and the row
    finite and uniform there."""
    from sepi_tpu_torch.ops.relpos_softmax import relpos_softmax, relpos_softmax_reference

    ac, bd = _relpos_inputs(b, h, q, t, b + q + t, cuda, band_first)
    lengths = torch.tensor(([t, 0, max(t // 3, 1)] * b)[:b], dtype=torch.int32, device=cuda)
    want = relpos_softmax_reference(ac, bd, lengths, 0.125)
    before = relpos_softmax.launches
    got = relpos_softmax(ac.clone(), bd, lengths, 0.125)
    torch.cuda.synchronize()
    assert relpos_softmax.launches == before + 1
    assert bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    print(f"relpos_softmax {b}x{h}x{q}x{t}: max gap {err:.3e}")
    assert err < 2e-6
    if b > 1:
        assert torch.allclose(got[1], torch.full_like(got[1], 1.0 / t), rtol=1e-6, atol=0)


def _conformer_weights(cfg, dev, seed=25):
    """Seeded tensors by the reference's names: weights at 1/sqrt(fan_in),
    offsets, u and v around 0, scales and variances away from 1."""
    import sys
    from pathlib import Path

    bench = str(Path(__file__).resolve().parent.parent / "benchmark")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    from reference import conformer as ref

    g = torch.Generator().manual_seed(seed)
    p = {}
    for name, shape in ref.param_names(cfg).items():
        if name.endswith("weight") and len(shape) >= 2:
            p[name] = torch.randn(shape, generator=g) / float(np.prod(shape[1:])) ** 0.5
        elif name.endswith("running_var"):
            p[name] = 0.5 + 1.5 * torch.rand(shape, generator=g)
        elif ref.starts_at_one(name):
            p[name] = 0.5 + torch.rand(shape, generator=g)
        else:
            p[name] = 0.3 * torch.randn(shape, generator=g)
    return ref, {k: v.to(dev) for k, v in p.items()}


def _published_conformer(dev):
    import json
    from pathlib import Path

    from sepi_tpu_torch.models import MfaConformer, MfaConformerConfig

    cfg = json.loads((Path(__file__).resolve().parent.parent / "benchmark" / "configs"
                      / "mfa_conformer.json").read_text())
    names = {f.name for f in dataclasses.fields(MfaConformerConfig)} & set(cfg)
    ref, p = _conformer_weights(cfg, dev)
    model = MfaConformer(MfaConformerConfig(**{k: cfg[k] for k in names})).to(dev).eval()
    model.load_state_dict(p, strict=False)
    return cfg, ref, p, model


@pytest.mark.parametrize("seconds", [30, 150])
def test_conformer_at_published_widths_matches_the_reference_on_the_card(cuda, seconds, monkeypatch):
    """The published MFA-Conformer (6 x 256, 4 heads, FF 2048, k 15) on one
    utterance of 30 s (2,997 subsampled frames, one query block) and 150 s
    (7,497, several blocks), float32 with TF32 off, against the float64
    reference on the card: within the cell's limit of 5e-5."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg, ref, p, model = _published_conformer(cuda)
    t = seconds * 100
    feats = torch.randn((t, 80), generator=torch.Generator().manual_seed(t)).to(cuda)
    with torch.no_grad():
        got = model(feats[None])["embedding"][0]
    want = ref.embed(feats, p, cfg, "ref")
    gap = float((got.double() - want).norm() / want.norm())
    print(f"conformer {seconds} s: gap {gap:.3e}")
    assert gap < 5e-5


def test_conformer_attention_and_a_full_bucket_fit_their_budget_on_the_card(cuda, monkeypatch):
    """A 32-row bucket of 10,000 frames (4,997 subsampled) through
    `CallGraphs`: the replay equals the capturing call; one block's
    attention holds at most its query block's stated budget of scores
    above the inputs and the 8 (B, T', d) tensors around them, and the
    whole forward's peak is recorded."""
    from sepi_tpu_torch.graphs import CallGraphs
    from sepi_tpu_torch.models.conformer import ATTENTION_BLOCK_BYTES, query_rows

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg, _, _, model = _published_conformer(cuda)
    b, t, d = 32, 10000, 256
    ts = (t - 1) // 2 - 2
    budget = ATTENTION_BLOCK_BYTES
    rows = query_rows(b, 4, ts, budget)
    assert 4 * b * 4 * rows * (rows + 2 * ts - 1) <= budget
    g = torch.Generator().manual_seed(7)
    lengths = torch.tensor([t - 37 * i for i in range(b)], dtype=torch.int32, device=cuda)
    x = torch.randn((b, ts, d), generator=g).to(cuda)
    pe = torch.randn((2 * ts - 1, d), generator=g).to(cuda)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        model.blocks[0].mhsa(x, pe, lengths)
    torch.cuda.synchronize()
    attn = torch.cuda.max_memory_allocated() - base
    print(f"attention 32 x {ts}: {rows} query rows a block, peak {attn / 1e9:.3f} GB above its "
          f"inputs (budget {budget / 1e9:.3f} GB)")
    assert attn <= budget + 8 * b * ts * d * 4
    del x, pe
    feats = torch.randn((b, t, 80), generator=g)
    mask = torch.arange(t)[None, :] < torch.tensor([t - 37 * i for i in range(b)])[:, None]
    call = CallGraphs(lambda m, f, k: m(f, k)["embedding"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = call(model, feats, mask)
    second = call(model, feats, mask)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    maps = 4 * b * d * (((t - 3) // 2 + 1) * 39 + ts * 37)
    print(f"bucket 32 x {t}: peak {peak / 1e9:.3f} GB (subsampler maps {maps / 1e9:.3f} GB)")
    assert torch.equal(first, second) and bool(torch.isfinite(first).all())
    assert len(call.graphs) == 1
