"""Build the port's native sources and load them with ctypes.

Each `csrc/*.cu` file has a plain C interface and compiles on its own
with nvcc into a shared library under ``build/sepi_tpu_torch/`` at the
repository root (listed in `.gitignore`), named by a hash of its source
and flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing is built when a module is imported: the first launch builds, and
`build()` builds several sources at once, one nvcc process each, all
started together.

The host libraries of ``native/*.cc`` (the Kaldi ark/scp reader and writer,
the SPHERE decoder) build the same way with ``g++ -O2 -shared -fPIC``
(`load_host`), into the same directory: the port never writes
``native/build/``, where the JAX package builds them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
NATIVE = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "sepi_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

HOST_FLAGS = ("-O2", "-shared", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}
_HOST_LOCK = threading.Lock()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> Optional[Tuple[subprocess.Popen, Path, Path]]:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named sources (default: every csrc/*.cu) in parallel.

    Returns name -> compiler output (ptxas register/shared-memory report;
    empty when the library was already built).  Raises on a failed build.
    """
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    jobs = {n: _start(n) for n in names}
    logs: Dict[str, str] = {}
    failed = []
    for name, job in jobs.items():
        if job is None:
            logs[name] = ""
            continue
        proc, tmp, out = job
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib


def host_library_path(name: str) -> Path:
    src = (NATIVE / f"{name}.cc").read_bytes()
    digest = hashlib.sha1(src + " ".join(HOST_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-host-{digest}.so"


def load_host(name: str) -> ctypes.CDLL:
    """The library of native/<name>.cc, built with g++ at first use."""
    key = f"host:{name}"
    with _HOST_LOCK:
        lib = _LOADED.get(key)
        if lib is None:
            out = host_library_path(name)
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.run(
                    ["g++", *HOST_FLAGS, "-o", str(tmp), str(NATIVE / f"{name}.cc")],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed on native/{name}.cc:\n{proc.stderr}")
                os.replace(tmp, out)
            lib = ctypes.CDLL(str(out))
            _LOADED[key] = lib
    return lib
