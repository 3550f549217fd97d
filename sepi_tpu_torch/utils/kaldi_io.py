"""ctypes bindings of the native Kaldi ark/scp reader and writer.

The port's own binding of `native/kaldi_io.cc` (the source the JAX
package builds too; see it for the formats covered).  The library is
built with g++ at first use into ``build/sepi_tpu_torch/``
(`build.load_host`).  Usage::

    feats = {key: read_matrix(path, off) for key, (path, off) in read_scp("feats.scp")}
    with ArkWriter("emb.ark", "emb.scp") as w:
        w.put_vector("utt1", x)

The alignment readers (`iter_int_vector_ark`, `read_ali_ark`,
`read_ali_dir`) are pure Python over streamed binary archives, as the
reference's are; `read_feats_scp` goes through the binding.
"""

from __future__ import annotations

import ctypes
import glob
import gzip
import os
import threading
from typing import Iterator, Tuple

import numpy as np

from .. import build

_lock = threading.Lock()
_lib = None

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build.load_host("kaldi_io")
        lib.ki_read_matrix.argtypes = [
            ctypes.c_char_p, ctypes.c_long, _I32P, _I32P, ctypes.POINTER(_F32P)]
        lib.ki_read_vector.argtypes = [
            ctypes.c_char_p, ctypes.c_long, _I32P, ctypes.POINTER(_F32P)]
        lib.ki_read_int_vector.argtypes = [
            ctypes.c_char_p, ctypes.c_long, _I32P, ctypes.POINTER(_I32P)]
        lib.ki_writer_open.restype = ctypes.c_void_p
        lib.ki_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        for fn in (lib.ki_writer_put_matrix, lib.ki_writer_put_compressed_matrix,
                   lib.ki_writer_put_compressed_matrix2):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, _F32P, ctypes.c_int32,
                           ctypes.c_int32]
        lib.ki_writer_put_vector.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, _F32P, ctypes.c_int32]
        lib.ki_writer_put_int_vector.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, _I32P, ctypes.c_int32]
        lib.ki_writer_close.argtypes = [ctypes.c_void_p]
        lib.ki_free.argtypes = [ctypes.c_void_p]
        for fn in (lib.ki_read_matrix, lib.ki_read_vector, lib.ki_read_int_vector,
                   lib.ki_writer_put_matrix, lib.ki_writer_put_compressed_matrix,
                   lib.ki_writer_put_compressed_matrix2, lib.ki_writer_put_vector,
                   lib.ki_writer_put_int_vector):
            fn.restype = ctypes.c_int
        lib.ki_writer_close.restype = lib.ki_free.restype = None
        _lib = lib
        return lib


def read_scp(path: str) -> Iterator[Tuple[str, Tuple[str, int]]]:
    """Yield (key, (ark_path, offset)) from an scp file."""
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            key, ref = parts[0], parts[1]
            ark, _, off = ref.rpartition(":")
            yield key, (ark, int(off))


def _take(lib, data, shape) -> np.ndarray:
    try:
        return np.ctypeslib.as_array(data, shape=shape).copy()
    finally:
        lib.ki_free(data)


def read_matrix(ark_path: str, offset: int) -> np.ndarray:
    """One float matrix entry (FM, DM or any compressed form) as float32."""
    lib = _load()
    rows, cols, data = ctypes.c_int32(), ctypes.c_int32(), _F32P()
    rc = lib.ki_read_matrix(ark_path.encode(), offset, ctypes.byref(rows),
                            ctypes.byref(cols), ctypes.byref(data))
    if rc != 0:
        raise IOError(f"ki_read_matrix({ark_path}:{offset}) failed rc={rc}")
    return _take(lib, data, (rows.value, cols.value))


def read_vector(ark_path: str, offset: int) -> np.ndarray:
    lib = _load()
    n, data = ctypes.c_int32(), _F32P()
    rc = lib.ki_read_vector(ark_path.encode(), offset, ctypes.byref(n), ctypes.byref(data))
    if rc != 0:
        raise IOError(f"ki_read_vector({ark_path}:{offset}) failed rc={rc}")
    return _take(lib, data, (n.value,))


def read_int_vector(ark_path: str, offset: int) -> np.ndarray:
    lib = _load()
    n, data = ctypes.c_int32(), _I32P()
    rc = lib.ki_read_int_vector(ark_path.encode(), offset, ctypes.byref(n),
                                ctypes.byref(data))
    if rc != 0:
        raise IOError(f"ki_read_int_vector({ark_path}:{offset}) failed rc={rc}")
    return _take(lib, data, (n.value,))


def iter_int_vector_ark(fileobj) -> Iterator[Tuple[str, np.ndarray]]:
    """(key, int32 vector) entries of a streamed binary ark (alignment
    archives have no scp): per entry key ' ' '\\0' 'B' <size byte 4>
    <int32 count> <raw int32 data>.  A text-format entry, a wrong size
    byte, a negative or overlong count, or trailing garbage raises."""
    data = fileobj.read()
    pos, n = 0, len(data)
    while pos < n:
        sp = data.find(b" ", pos)
        if sp < 0:
            if data[pos:].strip():
                raise ValueError("trailing garbage in int-vector ark")
            break
        key = data[pos:sp].decode()
        pos = sp + 1
        if data[pos:pos + 2] != b"\x00B":
            raise ValueError(f"{key}: not a binary ark entry (text-format archives are "
                             "not supported; write with --binary=true)")
        pos += 2
        if data[pos:pos + 1] != b"\x04":
            raise ValueError(f"{key}: expected int32 size byte")
        pos += 1
        if pos + 4 > n:
            raise ValueError(f"{key}: truncated count")
        cnt = int(np.frombuffer(data, "<i4", 1, pos)[0])
        pos += 4
        if cnt < 0 or pos + 4 * cnt > n:
            raise ValueError(f"{key}: corrupt count {cnt}")
        yield key, np.frombuffer(data, "<i4", cnt, pos).copy()
        pos += 4 * cnt


def read_ali_ark(path: str) -> dict:
    """One alignment archive, gzipped (`ali.1.gz`, the form
    `steps/align_fmllr.sh` writes) or plain -> {utt: (T,) int32}."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return dict(iter_int_vector_ark(f))


def read_feats_scp(scp_path: str) -> dict:
    """A Kaldi feats.scp -> {utt: (T, D) float32}, any mix of FM/DM/CM/
    CM2/CM3 entries."""
    return {key: read_matrix(path, off) for key, (path, off) in read_scp(scp_path)}


def read_ali_dir(ali_dir: str, pattern: str = "ali.*.gz") -> dict:
    """A Kaldi alignment directory (the `exp/tri6a_4k_ali` analog): every
    ``ali.N.gz`` job shard merged into one {utt: labels}."""
    paths = sorted(glob.glob(os.path.join(ali_dir, pattern)))
    if not paths:
        raise FileNotFoundError(f"no {pattern} under {ali_dir}")
    out: dict = {}
    for p in paths:
        out.update(read_ali_ark(p))
    return out


class ArkWriter:
    """Write float matrices / vectors / int vectors to ark(+scp)."""

    def __init__(self, ark_path: str, scp_path: str = ""):
        self._lib = _load()
        self._w = self._lib.ki_writer_open(ark_path.encode(), scp_path.encode())
        if not self._w:
            raise IOError(f"cannot open {ark_path} / {scp_path}")

    def _put(self, fn, key: str, x: np.ndarray, *dims) -> None:
        ptr = x.ctypes.data_as(_I32P if x.dtype == np.int32 else _F32P)
        rc = fn(self._w, key.encode(), ptr, *dims)
        if rc:
            raise IOError(f"{fn.__name__}({key}) rc={rc}")

    def put_matrix(self, key: str, x: np.ndarray) -> None:
        x = np.ascontiguousarray(x, np.float32)
        self._put(self._lib.ki_writer_put_matrix, key, x, x.shape[0], x.shape[1])

    def put_compressed_matrix(self, key: str, x: np.ndarray) -> None:
        """Write as Kaldi CompressedMatrix (format 1, ~8-bit lossy)."""
        x = np.ascontiguousarray(x, np.float32)
        self._put(self._lib.ki_writer_put_compressed_matrix, key, x, x.shape[0], x.shape[1])

    def put_compressed_matrix2(self, key: str, x: np.ndarray) -> None:
        """Write as Kaldi CompressedMatrix format 2 (uint16/element,
        global linear quantization — kTwoByte)."""
        x = np.ascontiguousarray(x, np.float32)
        self._put(self._lib.ki_writer_put_compressed_matrix2, key, x, x.shape[0], x.shape[1])

    def put_vector(self, key: str, x: np.ndarray) -> None:
        x = np.ascontiguousarray(x, np.float32)
        self._put(self._lib.ki_writer_put_vector, key, x, x.shape[0])

    def put_int_vector(self, key: str, x: np.ndarray) -> None:
        x = np.ascontiguousarray(x, np.int32)
        self._put(self._lib.ki_writer_put_int_vector, key, x, x.shape[0])

    def close(self) -> None:
        if self._w:
            self._lib.ki_writer_close(self._w)
            self._w = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
