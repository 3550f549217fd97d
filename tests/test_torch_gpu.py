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


@pytest.mark.parametrize("conf", ["sre8k", "hires16k"])
@pytest.mark.parametrize("dither", [0.0, 1.0])
@pytest.mark.parametrize("snip", [False, True])
def test_mfcc_kernel_configs_and_short_utterances(cuda, conf, dither, snip):
    """One launch, no tail-patch launches: utterances shorter than a frame,
    than the tail window, and ending inside and at the edge of a block."""
    cfg = FrontendConfig(dither=dither, snip_edges=snip,
                         **(SRE8K if conf == "sre8k" else HIRES16K))
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
    assert mfcc_cuda.mfcc_fused.launches - before == 1 + shapes.warmup + 2 * shapes.extract_iters
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
