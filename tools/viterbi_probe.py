"""Time variants of the Viterbi warp kernel against the kernel as shipped.

`sepi_tpu_torch/csrc/viterbi.cu` loads each step group's emission rows
straight into registers and compiles the aligner's skip 4 in.  This script
builds the shipped source and variants of it made by text substitution,
checks each against the plain version (backpointers equal over every
state), and times them at the s5 path's batch shapes in one process, so one
card and one power state serve every reading:

- ``base``: the source as shipped;
- ``runtime_skip``: skip 4 through the general path, which rotates the
  register array by skip % K at run time and shuffles every register;
- ``l2pf``: an L2 prefetch of each lane's states 64 rows ahead of the step;
- ``ring8``, ``ring32``: a per-warp ring of 8 or 32 emission rows in shared
  memory, each lane filling its own states with cp.async several steps
  ahead (commit and wait groups), instead of loads from device memory;
- ``group2``, ``group8``: groups of 2 steps at K = 16 (S = 257-512), or of
  8 steps at K <= 8 (S <= 256), instead of 4 (skip 4 compiled in).

Each shape is timed base, variants, variants reversed, base: two readings a
variant, and the two base readings give the run-to-run spread.  Needs one
CUDA card and nvcc; run from the repo root:

    python3 tools/viterbi_probe.py
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "build", "viterbi_probe")
SHAPES = [(32, 1024, 128), (32, 1024, 256), (32, 1024, 512)]  # the s5 batches, skip 4
SKIP = 4
RUNTIME_SKIP = [
    ("  if (skip == 4) return launch_warp<K, 4>(emit, t_len, trans, bps, delta, B, T, S, skip, st);\n",
     ""),
]

GROUP = "return K >= 32 ? 1 : (K >= 16 && SKIP == 0 ? 2 : 4);"
GROUP2 = [(GROUP, "return K >= 32 ? 1 : (K >= 16 ? 2 : 4);")]
GROUP8 = [(GROUP, "return K >= 32 ? 1 : (K >= 16 ? (SKIP == 0 ? 2 : 4) : 8);")]

L2PF = [
    ("\n  // step t with the emissions ev; its backpointers into p\n", """
  auto prefetch = [&](int r) {
    if (r < t_end && s0 < S)
      asm volatile("prefetch.global.L2 [%0];\\n" ::"l"(e + (size_t)r * S + s0));
  };
  for (int r = 1; r <= 64; ++r) prefetch(r);

  // step t with the emissions ev; its backpointers into p
"""),
    ("    for (int i = 0; i < G; ++i) load(t + G + i, nxt[i]);\n",
     "    for (int i = 0; i < G; ++i) {\n      load(t + G + i, nxt[i]);\n"
     "      prefetch(t + i + 64);\n    }\n"),
]

LOAD_HEAD = "  auto load = [&](int r, float (&v)[K]) {\n"


def ring(rows: int):
    """Rows are asked for in order 1, 2, ...: row r's wait finds rows up to
    r + rows - 2 issued, and row r + rows - 1 refills the slot of row r - 1,
    which this lane has already read into registers."""
    return [
        (LOAD_HEAD, f"""  constexpr int kRing = {rows};
  extern __shared__ __align__(16) float ring[];  // [kRing][S]
  auto issue = [&](int r) {{
    if (whole && r < t_end) {{
      const float* src = e + (size_t)r * S + s0;
      float* dst = ring + (size_t)(r % kRing) * S + s0;
#pragma unroll
      for (int q = 0; q < K / 4; ++q) {{
        const unsigned sa = (unsigned)__cvta_generic_to_shared(dst + 4 * q);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(sa), "l"(src + 4 * q));
      }}
    }}
    asm volatile("cp.async.commit_group;\\n" ::);
  }};
  for (int r = 1; r < kRing; ++r) issue(r);
  auto load = [&](int r, float (&v)[K]) {{
    if (whole) {{
      asm volatile("cp.async.wait_group %0;\\n" ::"n"(kRing - 2));
      const float4* slot = reinterpret_cast<const float4*>(ring + (size_t)(r % kRing) * S + s0);
#pragma unroll
      for (int q = 0; q < K / 4; ++q) {{
        const float4 f = r < t_end ? slot[q] : make_float4(0.f, 0.f, 0.f, 0.f);
        v[4 * q] = f.x;
        v[4 * q + 1] = f.y;
        v[4 * q + 2] = f.z;
        v[4 * q + 3] = f.w;
      }}
      issue(r + kRing - 1);
      return;
    }}
"""),
        ("  viterbi_warp<K, SKIP><<<B, 32, 0, stream>>>(",
         f"  const size_t ring_smem = {rows} * (size_t)S * sizeof(float);\n"
         "  cudaError_t serr = set_smem((const void*)viterbi_warp<K, SKIP>, ring_smem);\n"
         "  if (serr != cudaSuccess) return serr;\n"
         "  viterbi_warp<K, SKIP><<<B, 32, ring_smem, stream>>>("),
    ]


def variants():
    return {"base": [], "runtime_skip": RUNTIME_SKIP, "l2pf": L2PF, "ring8": ring(8),
            "ring32": ring(32), "group2": GROUP2, "group8": GROUP8}


def build_all():
    from sepi_tpu_torch import build

    src = open(os.path.join(ROOT, "sepi_tpu_torch", "csrc", "viterbi.cu")).read()
    os.makedirs(OUT, exist_ok=True)
    jobs = {}
    for name, subs in variants().items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: anchor not found once: {old[:60]!r}")
            text = text.replace(old, new)
        cu, so = os.path.join(OUT, f"{name}.cu"), os.path.join(OUT, f"lib{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        jobs[name] = (subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log[-3000:]}")
        regs, entry = [], ""  # ptxas names an entry function, then reports its registers
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line
            elif "viterbi_warp" in entry and ("Used" in line or "spill" in line):
                regs.append(line.split(":", 1)[-1].strip())
        print(f"built {name}: warp kernels: " + " | ".join(regs))
        libs[name] = ctypes.CDLL(so)
    return libs


def main() -> int:
    import torch

    from chip_smoke import _viterbi_inputs, nvidia_smi_line, time_ms
    from sepi_tpu_torch import build
    from sepi_tpu_torch.align import viterbi_cuda

    if not torch.cuda.is_available():
        print("viterbi_probe: no CUDA card", file=sys.stderr)
        return 1
    print(nvidia_smi_line())
    libs = build_all()
    names = list(libs)
    order = names + names[::-1]
    results = {}
    for b, t, s in SHAPES:
        args = _viterbi_inputs(b, t, s, [t] * b, 3, "cuda")
        bp_r, _ = viterbi_cuda.viterbi_batch_reference(*args, SKIP)
        for name in names:  # every variant must give the plain version's backpointers
            build._LOADED["viterbi"] = libs[name]
            bp, _ = viterbi_cuda.viterbi_batch(*args, SKIP)
            if not torch.equal(bp, bp_r):
                raise AssertionError(f"{name} at {(b, t, s)}: {int((bp != bp_r).sum())} "
                                     f"backpointers differ from the plain version")
        readings = {n: [] for n in names}
        for name in order:
            build._LOADED["viterbi"] = libs[name]
            readings[name].append(time_ms(lambda: viterbi_cuda.viterbi_batch(*args, SKIP),
                                          iters=20))
        label = f"{b}x{t}x{s}"
        base = sum(readings["base"]) / 2
        spread = abs(readings["base"][0] - readings["base"][1]) / base
        for name in names:
            ms = sum(readings[name]) / 2
            print(f"{label} {name}: {readings[name][0]:.4f} / {readings[name][1]:.4f} ms, "
                  f"mean {ms:.4f} ms ({1e3 * ms / (t - 1):.4f} us a step), "
                  f"{ms / base:.3f}x base (base spread {100 * spread:.1f}%)")
        results[label] = {"readings_ms": readings, "base_spread": spread}
    build._LOADED.pop("viterbi", None)
    print(json.dumps({"viterbi_probe": results, "card": nvidia_smi_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
