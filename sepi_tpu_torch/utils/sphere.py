"""ctypes bindings of the native NIST SPHERE (.sph) reader.

The port's own binding of `native/sphere.cc`, built with g++ at first use
into ``build/sepi_tpu_torch/`` (`build.load_host`).  This is the
framework's `sph2pipe` equivalent: LDC corpora (SRE/SWBD/Fisher) ship
2-channel SPHERE audio, most of it shorten-compressed.

    samples, rate = read_sph("/ldc/sre04/xyz.sph", channel=1)

Samples are float32 at int16 scale (the framework's audio convention,
`data/audio.py`).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import numpy as np

from .. import build

_lock = threading.Lock()
_lib = None

_ERRORS = {
    -1: "cannot open file",
    -2: "bad SPHERE header",
    -3: "unsupported sample coding",
    -4: "truncated payload",
    -5: "bad channel selector",
    -6: "bad shorten stream",
    -7: "out of memory decoding samples",
}


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build.load_host("sphere")
        lp = ctypes.POINTER(ctypes.c_long)
        lib.sph_info.argtypes = [ctypes.c_char_p, lp, lp, lp, ctypes.c_char_p, ctypes.c_long]
        lib.sph_read.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                 ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)), lp]
        lib.sph_free.argtypes = [ctypes.POINTER(ctypes.c_int16)]
        lib.sph_info.restype = lib.sph_read.restype = ctypes.c_int
        lib.sph_free.restype = None
        _lib = lib
        return lib


def sph_info(path: str) -> Tuple[int, int, int, str]:
    """(sample_rate, channels, samples_per_channel, coding) of a .sph file."""
    lib = _load()
    rate, ch, n = ctypes.c_long(), ctypes.c_long(), ctypes.c_long()
    coding = ctypes.create_string_buffer(128)
    rc = lib.sph_info(path.encode(), ctypes.byref(rate), ctypes.byref(ch),
                      ctypes.byref(n), coding, 128)
    if rc != 0:
        raise ValueError(f"{path}: {_ERRORS.get(rc, rc)}")
    return rate.value, ch.value, n.value, coding.value.decode()


def read_sph(path: str, channel: int = 1) -> Tuple[np.ndarray, int]:
    """Decode one channel of a SPHERE file -> (float32 @ int16 scale, rate).

    ``channel`` is 1-based (the LDC/sph2pipe `-c` convention); 0 returns
    all channels interleaved.
    """
    lib = _load()
    out = ctypes.POINTER(ctypes.c_int16)()
    n = ctypes.c_long()
    rc = lib.sph_read(path.encode(), channel, ctypes.byref(out), ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"{path}: {_ERRORS.get(rc, rc)}")
    try:
        x = np.ctypeslib.as_array(out, shape=(n.value,)).astype(np.float32)
    finally:
        lib.sph_free(out)
    rate, _, _, _ = sph_info(path)
    return x, rate
