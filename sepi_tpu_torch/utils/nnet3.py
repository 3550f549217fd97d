"""Kaldi binary stream primitives (the wire layer of nnet3 ``.raw`` interop).

A copy of the stream primitives of `sepi_tpu/utils/nnet3.py`:
`Nnet3ParseError`, `_Reader`, `_Scalar` and `_Writer`.  The wire format is
the published Kaldi binary stream protocol (io-funcs.h semantics: ``\\0B``
magic, space-terminated tokens, size-prefixed basic types,
``FM``/``FV``/``DM``/``DV`` matrix markers).  `utils.kaldi_models` writes
and reads the backend's artifacts through them; the nnet3 model reader and
writer are not ported yet.
"""

from __future__ import annotations

import dataclasses
import io
import struct

import numpy as np


class Nnet3ParseError(ValueError):
    pass


class _Reader:
    def __init__(self, data: bytes):
        self.buf = data
        self.pos = 0

    def _peek(self, n: int) -> bytes:
        return self.buf[self.pos : self.pos + n]

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise Nnet3ParseError(
                f"unexpected EOF at offset {self.pos} (wanted {n} bytes)")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def skip_ws(self) -> None:
        while self.pos < len(self.buf) and self.buf[self.pos : self.pos + 1].isspace():
            self.pos += 1

    def read_token(self) -> str:
        """Space/newline-delimited token; consumes ONE trailing space."""
        self.skip_ws()
        start = self.pos
        while self.pos < len(self.buf) and not self.buf[self.pos : self.pos + 1].isspace():
            self.pos += 1
        tok = self.buf[start : self.pos].decode("latin-1")
        if not tok:
            raise Nnet3ParseError(f"EOF while reading token at offset {start}")
        if self._peek(1) == b" ":
            self.pos += 1
        return tok

    def expect_token(self, want: str) -> None:
        got = self.read_token()
        if got != want:
            raise Nnet3ParseError(
                f"expected token {want!r}, got {got!r} at offset {self.pos}")

    def read_line(self) -> str:
        end = self.buf.find(b"\n", self.pos)
        if end < 0:
            end = len(self.buf)
        line = self.buf[self.pos : end].decode("latin-1")
        self.pos = min(end + 1, len(self.buf))
        return line

    # ---- basic types (WriteBasicType wire format) ----

    def read_int32(self) -> int:
        size = self._take(1)[0]
        if size != 4:
            raise Nnet3ParseError(f"int32 size prefix {size} != 4 at {self.pos}")
        return struct.unpack("<i", self._take(4))[0]

    def read_float(self) -> float:
        size = self._take(1)[0]
        if size == 4:
            return struct.unpack("<f", self._take(4))[0]
        if size == 8:
            return struct.unpack("<d", self._take(8))[0]
        raise Nnet3ParseError(f"float size prefix {size} at {self.pos}")

    def read_bool(self) -> bool:
        c = self._take(1)
        if c == b"T":
            return True
        if c == b"F":
            return False
        raise Nnet3ParseError(f"bool byte {c!r} at {self.pos}")

    # ---- matrices / vectors ----

    def read_vector(self) -> np.ndarray:
        marker = self.read_token()
        if marker not in ("FV", "DV"):
            raise Nnet3ParseError(f"vector marker {marker!r} at {self.pos}")
        dim = self.read_int32()
        dt = np.float32 if marker == "FV" else np.float64
        return np.frombuffer(self._take(dim * dt().itemsize), dtype=dt).copy()

    def read_matrix(self) -> np.ndarray:
        marker = self.read_token()
        if marker not in ("FM", "DM"):
            raise Nnet3ParseError(f"matrix marker {marker!r} at {self.pos}")
        rows = self.read_int32()
        cols = self.read_int32()
        dt = np.float32 if marker == "FM" else np.float64
        data = np.frombuffer(self._take(rows * cols * dt().itemsize), dtype=dt)
        return data.reshape(rows, cols).copy()

    def sniff_value(self):
        """Read the value following a field token, by leading bytes.

        Returns an int/float ambiguous scalar as `_Scalar` (raw bytes kept)
        so callers can pick the interpretation; bools and arrays are
        unambiguous.
        """
        self_pos = self.pos
        head = self._peek(3)
        if len(head) >= 3 and head[0:1] in (b"F", b"D") and head[1:2] in (b"V", b"M") and head[2:3] == b" ":
            if head[1:2] == b"V":
                return self.read_vector()
            return self.read_matrix()
        if head[:1] in (b"T", b"F"):
            return self.read_bool()
        if head[:1] == b"\x04":
            self._take(1)
            return _Scalar(self._take(4))
        if head[:1] == b"\x08":
            self._take(1)
            return _Scalar(self._take(8))
        if head[:1] == b"<":
            raise Nnet3ParseError(
                f"nested structure at offset {self_pos} — component type "
                "not in the supported v1-v5 zoo")
        raise Nnet3ParseError(f"unrecognized value bytes {head!r} at {self_pos}")


@dataclasses.dataclass
class _Scalar:
    """4- or 8-byte basic type whose int/float reading is caller's choice."""

    raw: bytes

    @property
    def as_int(self) -> int:
        if len(self.raw) == 4:
            return struct.unpack("<i", self.raw)[0]
        return struct.unpack("<q", self.raw)[0]

    @property
    def as_float(self) -> float:
        if len(self.raw) == 4:
            return struct.unpack("<f", self.raw)[0]
        return struct.unpack("<d", self.raw)[0]


class _Writer:
    def __init__(self):
        self.out = io.BytesIO()

    def token(self, tok: str) -> None:
        self.out.write(tok.encode("latin-1") + b" ")

    def raw(self, data: bytes) -> None:
        self.out.write(data)

    def int32(self, v: int) -> None:
        self.out.write(b"\x04" + struct.pack("<i", int(v)))

    def float32(self, v: float) -> None:
        self.out.write(b"\x04" + struct.pack("<f", float(v)))

    def float64(self, v: float) -> None:
        self.out.write(b"\x08" + struct.pack("<d", float(v)))

    def bool(self, v: bool) -> None:
        self.out.write(b"T" if v else b"F")

    def vector(self, x: np.ndarray, double: bool = False) -> None:
        x = np.asarray(x)
        self.token("DV" if double else "FV")
        self.int32(x.shape[0])
        self.out.write(x.astype(np.float64 if double else np.float32).tobytes())

    def matrix(self, x: np.ndarray) -> None:
        x = np.asarray(x)
        self.token("FM")
        self.int32(x.shape[0])
        self.int32(x.shape[1])
        self.out.write(x.astype(np.float32).tobytes())

    def field(self, tok: str, value, kind: str) -> None:
        self.token(f"<{tok}>")
        if kind == "int":
            self.int32(value)
        elif kind == "float":
            self.float32(value)
        elif kind == "double":
            self.float64(value)
        elif kind == "bool":
            self.bool(value)
        elif kind == "vector":
            self.vector(value)
        elif kind == "dvector":
            self.vector(value, double=True)
        elif kind == "matrix":
            self.matrix(value)
        else:
            raise ValueError(kind)

    def getvalue(self) -> bytes:
        return self.out.getvalue()
