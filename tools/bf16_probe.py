"""bf16 on the card: where a V2 step's time goes, and what separates the
card's bf16 training trajectory from the CPU's.

`chip_smoke.py` phase 11a times the full-size V2 x-vector step (5000
speakers, 64 x 200 x 23, Muon) in bf16 beside fp32, and 11b holds 3
momentum-SGD steps of it in bf16 on the card against the CPU.  This probe
splits both:

- speed: forward, forward+backward and the whole step, fp32 and bf16, by
  CUDA events and by the host clock over 20 back-to-back calls; bf16 with
  cuDNN's algorithm search on; and the host operators with the most
  self CPU time in one step of each (torch.profiler);
- agreement: the same init and batches run as card bf16, CPU bf16, CPU
  fp32 and card fp32, in phase 11b's setting and in its first one; the
  distance ||p_a - p_b|| / ||p_b - p_init|| of each pair after 3 steps,
  and what two planted card faults read against 11b's gate (gradients
  scaled by 0.9; one layer's weight gradient lost);
- cpu-study: the CPU-only half-width study that chose 11b's setting and
  its limit before a card read it.

Run from the repo root on a machine with the card (~2 min):

    python3 tools/bf16_probe.py              # speed, then agreement
    python3 tools/bf16_probe.py agreement    # agreement only
    python3 tools/bf16_probe.py cpu-study    # the half-width CPU study (~5 min)
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def speed(cs, env):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sepi_tpu_torch.models import V2_XVECTOR
    from sepi_tpu_torch.train import make_xvec_step
    from sepi_tpu_torch.train.trainer import _softmax_xent

    cfg = dataclasses.replace(V2_XVECTOR, num_speakers=cs.CV_SPEAKERS)
    g = torch.Generator(device="cuda").manual_seed(0)
    feats = torch.randn((cs.TRAIN_B, cs.TRAIN_T, 23), generator=g, device="cuda")
    labels = torch.randint(0, cfg.num_speakers, (cs.TRAIN_B,), generator=g, device="cuda",
                           dtype=torch.int32)
    for dtype in ("float32", "bfloat16"):
        chain, state = cs._train_state(cfg, "cuda", dtype=dtype)
        model = state.model
        params = dict(model.named_parameters())
        step = make_xvec_step(chain)

        def fwd():
            model.train()
            return model(feats)["logits"]

        def fwd_bwd():
            loss = _softmax_xent(fwd(), labels).mean()
            return torch.autograd.grad(loss, list(params.values()))

        def run_step():
            return step(state, feats, labels, 1.0)

        def host_ms(fn, n=20):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n

        with torch.no_grad():
            f_ms = cs.time_ms(fwd)
        fb_ms = cs.time_ms(fwd_bwd)
        st_ms, st_host = cs.time_ms(run_step), host_ms(run_step)
        torch.backends.cudnn.benchmark = True
        try:
            bench_ms = cs.time_ms(run_step)
        finally:
            torch.backends.cudnn.benchmark = False
        run_step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run_step()
            torch.cuda.synchronize()
        rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:12]
        cs.log(f"probe speed on {env['smi']}: {dtype}: forward {f_ms:.3f} ms, forward+backward "
               f"{fb_ms:.3f} ms (host clock over 20: {host_ms(fwd_bwd):.3f} ms), step "
               f"{st_ms:.3f} ms (host clock {st_host:.3f} ms), step with cudnn.benchmark "
               f"{bench_ms:.3f} ms; host self time of one step (ms, calls): " + "; ".join(
                   f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.3f} ({e.count})" for e in rows))
        del state, chain, model, params


def agreement(cs, env):
    """11b's distance ||p_a - p_b|| / ||p_b - p_init|| after 3 steps: card
    bf16 against CPU bf16 (the gate), CPU bf16 against CPU fp32 and card
    fp32 against CPU fp32; and what two planted card faults read against
    CPU bf16: every gradient scaled by 0.9, and tdnn3's weight gradient
    lost.  In 11b's setting (256 chunks from 16 speakers, shrink off) and
    in its first one (16 chunks from all 5000 speakers, shrink 10)."""
    from sepi_tpu_torch.models import V2_XVECTOR

    cfg = dataclasses.replace(V2_XVECTOR, num_speakers=cs.CV_SPEAKERS)
    for batch, speakers, shrink in ((cs.P11B_BATCH, cs.P11B_SPEAKERS, 0.0), (16, 0, 10.0)):
        data = cs.p11b_batches(cfg, batch, speakers)

        def run(dev, dtype, **kw):
            st, p0, _ = cs.p11b_run(cfg, dev, dtype, data, shrink=shrink, **kw)
            return p0, cs._flat(st.model)

        p0, cpu16 = run("cpu", "bfloat16")
        cpu32 = run("cpu", "float32")[1]
        card16, card32 = run("cuda", "bfloat16")[1], run("cuda", "float32")[1]
        scaled = run("cuda", "bfloat16", weight=0.9)[1]
        held = run("cuda", "bfloat16", hold="frames.tdnn3.affine.weight")[1]
        cs.log(f"probe agreement on {env['smi']}: {batch} x {cs.TRAIN_T} from "
               f"{speakers or cfg.num_speakers} speakers, shrink {shrink}: card bf16 vs CPU bf16 "
               f"{cs._traj(card16, cpu16, p0):.3e} (11b's limit {cs.BF16_TRAJ_TOL:.4e}); CPU bf16 "
               f"vs CPU fp32 {cs._traj(cpu16, cpu32, p0):.3e}; card fp32 vs CPU fp32 "
               f"{cs._traj(card32, cpu32, p0):.3e}; planted card faults against CPU bf16: "
               f"gradients x 0.9 {cs._traj(scaled, cpu16, p0):.3e}, tdnn3's weight gradient "
               f"lost {cs._traj(held, cpu16, p0):.3e}")


def cpu_study(cs):
    """The half-width study behind 11b's setting, on the CPU alone (no card):
    the V2 x-vector at half width (1000 speakers), CPU bf16 against CPU
    fp32 after 3 momentum-SGD steps, and an fp32 run with its gradients
    scaled by 0.9 against fp32, with 11b's first setting (16 chunks from
    all speakers, shrink 10) and its present one (256 chunks from 16
    speakers, shrink off)."""
    import numpy as np
    import torch

    from sepi_tpu_torch.config import OptimizerConfig
    from sepi_tpu_torch.models import V2_XVECTOR, TdnnSpec
    from sepi_tpu_torch.train import make_xvec_step

    torch.set_num_threads(6)
    specs = tuple(TdnnSpec(s.dim // 2 if s.dim != 1500 else 750, s.offsets)
                  for s in V2_XVECTOR.frame_specs)
    cfg = dataclasses.replace(V2_XVECTOR, num_speakers=1000, frame_specs=specs, embed_dim=256)

    def batches(batch, nspk):
        rng = np.random.default_rng(11)
        out = []
        offsets = rng.normal(size=(cfg.num_speakers // 100 + 1, cfg.feat_dim)) * 1.5
        spk = rng.choice(cfg.num_speakers, size=nspk, replace=False) if nspk else None
        for _ in range(3):
            lab = (rng.integers(0, cfg.num_speakers, size=batch) if spk is None
                   else rng.choice(spk, size=batch)).astype(np.int32)
            f = rng.normal(size=(batch, 200, cfg.feat_dim)) + offsets[lab // 100][:, None]
            out.append((torch.from_numpy(f.astype(np.float32)), torch.from_numpy(lab)))
        return out

    def run(dtype, data, shrink, weight=1.0):
        opt = OptimizerConfig(preconditioner="none", proportional_shrink=shrink)
        chain, st = cs._train_state(cfg, "cpu", opt, seed=3, dtype=dtype)
        p0 = cs._flat(st.model)
        for f, lab in data:
            make_xvec_step(chain)(st, f, lab, weight)
        return p0, cs._flat(st.model)

    for batch, nspk, shrink in ((16, 0, 10.0), (256, 16, 0.0)):
        data = batches(batch, nspk)
        p0, b16 = run("bfloat16", data, shrink)
        f32 = run("float32", data, shrink)[1]
        scaled = run("float32", data, shrink, 0.9)[1]
        print(f"probe cpu study (half width, 1000 speakers): {batch} x 200 from "
              f"{nspk or 'all'} speakers, shrink {shrink}: bf16 vs fp32 "
              f"{cs._traj(b16, f32, p0):.4f}; fp32 gradients x 0.9 vs fp32 "
              f"{cs._traj(scaled, f32, p0):.4f}", flush=True)


def main() -> int:
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    if sys.argv[1:] == ["cpu-study"]:
        cpu_study(cs)
        return 0
    if not torch.cuda.is_available():
        print("bf16_probe: needs a CUDA device", file=sys.stderr)
        return 2

    env = cs.phase_environment()
    if sys.argv[1:] != ["agreement"]:
        speed(cs, env)
    agreement(cs, env)
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
