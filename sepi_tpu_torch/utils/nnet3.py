"""Kaldi nnet3 ``.raw`` model interop — import and export.

A port of `sepi_tpu/utils/nnet3.py`.  A user migrating from the Kaldi
reference has trained ``final.raw`` files (written by
``nnet3-copy``/``nnet3-init``, `run_xvector_new.sh:131-150`); this module
loads a Kaldi-trained v1-v5 network straight into the matching port model
(`models.XVector`, `AmNet`, `MultitaskCVector`, `AdaptedXVector`,
`CombinedCVector`) and writes a port model back to a Kaldi-readable raw
file.  For the same weights both packages write the same bytes.

The wire format is the published Kaldi binary stream protocol
(io-funcs.h semantics: ``\\0B`` magic, space-terminated tokens,
size-prefixed basic types, ``FM``/``FV``/``DM``/``DV`` matrix markers);
`utils.kaldi_models` reads and writes the backend's artifacts through the
same primitives (`_Reader`, `_Scalar`, `_Writer`).  Component bodies are
parsed generically as ``<Token> value`` sequences, so optional tokens
(natural-gradient state, ReLU self-repair stats) never break the reader.

Component zoo (xconfig ``relu-batchnorm-layer`` / ``stats-layer`` /
``output-layer``): NaturalGradientAffineComponent / AffineComponent,
RectifiedLinearComponent, BatchNormComponent, LogSoftmaxComponent,
StatisticsExtractionComponent, StatisticsPoolingComponent.

The layer maps name parameters by their path in the reference's Flax tree
(``("segment", "tdnn6")``); `bridge.flax_variables_from_state_dict` and
`bridge.state_dict_from_flax` carry a port `state_dict` to that layout and
back, so one mapping serves both packages.

Batch-norm semantics: Kaldi's BatchNormComponent (test mode) computes
``y = (x - mean) * target_rms / sqrt(var + eps)`` with *no learned
scale*; the port's `TdnnLayer` batch norm is
``y = (x - m) / sqrt(v + 1e-3) * s`` with a learned per-feature ``s``.
Import folds any epsilon/target-rms difference into ``s`` exactly; export
folds ``s`` into the written variance
(``var' = target_rms^2 (v + 1e-3) / s^2 - eps``), with target-rms 1 as the
reference writes it, or the smallest power of two that keeps every
``var' >= 0`` where the reference refuses a trained layer (`_export_rbn`).

Supported graphs (component names from the reference builders):
  am  — tdnn1..tdnn5 + output
  v2  — tdnn1..tdnn7 + stats + output
  v3  — tdnn1..k shared, tdnn*_am, tdnn*_xvec, stats_xvec, output_am, output
  v4  — tdnn1..5 (grafted AM) + tdnn1_xvec..7_xvec + stats + output
  v5  — tdnn1_share + tdnn*_am + tdnn1..5 (pretrained AM) + tdnn*_xvec
        + stats_xvec + output_am + output
"""

from __future__ import annotations

import dataclasses
import io
import re
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

__all__ = [
    "KaldiComponent",
    "KaldiNnet",
    "Nnet3ParseError",
    "read_nnet3_raw",
    "write_nnet3_raw",
    "detect_arch",
    "import_kaldi_raw",
    "export_kaldi_raw",
]


class Nnet3ParseError(ValueError):
    pass


class _Reader:
    def __init__(self, data: bytes):
        self.buf = data
        self.pos = 0

    def _peek(self, n: int) -> bytes:
        return self.buf[self.pos : self.pos + n]

    def _take(self, n: int) -> bytes:
        if n < 0:
            # a corrupt size field: the reference's reader steps backwards
            # here and re-reads the same bytes forever
            raise Nnet3ParseError(f"negative length {n} at offset {self.pos}")
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


# --------------------------------------------------------------------------
# model representation
# --------------------------------------------------------------------------


@dataclasses.dataclass
class KaldiComponent:
    name: str
    type: str  # e.g. "NaturalGradientAffineComponent"
    fields: Dict[str, object]  # token (no <>) -> value

    def matrix(self, tok: str) -> np.ndarray:
        v = self.fields.get(tok)
        if not isinstance(v, np.ndarray) or v.ndim != 2:
            raise Nnet3ParseError(f"{self.name}: <{tok}> is not a matrix")
        return v

    def vector(self, tok: str) -> np.ndarray:
        v = self.fields.get(tok)
        if not isinstance(v, np.ndarray) or v.ndim != 1:
            raise Nnet3ParseError(f"{self.name}: <{tok}> is not a vector")
        return v

    def scalar_float(self, tok: str, default: Optional[float] = None) -> float:
        v = self.fields.get(tok)
        if v is None:
            if default is None:
                raise Nnet3ParseError(f"{self.name}: missing <{tok}>")
            return default
        if isinstance(v, _Scalar):
            return v.as_float
        return float(v)

    def scalar_int(self, tok: str, default: Optional[int] = None) -> int:
        v = self.fields.get(tok)
        if v is None:
            if default is None:
                raise Nnet3ParseError(f"{self.name}: missing <{tok}>")
            return default
        if isinstance(v, _Scalar):
            return v.as_int
        return int(v)


@dataclasses.dataclass
class KaldiNnet:
    config_lines: List[str]
    components: Dict[str, KaldiComponent]
    component_order: List[str]

    def node_inputs(self) -> Dict[str, str]:
        """component-node name -> its input descriptor string."""
        out = {}
        for line in self.config_lines:
            m = re.match(r"component-node name=(\S+) component=(\S+) input=(.*)$",
                         line.strip())
            if m:
                out[m.group(1)] = m.group(3).strip()
        return out

    def input_dim(self) -> int:
        for line in self.config_lines:
            m = re.match(r"input-node name=input dim=(\d+)", line.strip())
            if m:
                return int(m.group(1))
        raise Nnet3ParseError("no `input-node name=input dim=...` config line")


# --------------------------------------------------------------------------
# read / write the Nnet3 container
# --------------------------------------------------------------------------


def read_nnet3_raw(path: str) -> KaldiNnet:
    """Parse a binary nnet3 raw model file into components + config lines."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"\x00B":
        raise Nnet3ParseError(
            f"{path}: no Kaldi binary magic — text-format models are not "
            "supported; convert with `nnet3-copy --binary=true in.raw out.raw`")
    r = _Reader(data[2:])
    first = r.read_token()
    if first == "<TransitionModel>":
        # an .mdl (TransitionModel + AmNnetSimple, `nnet3-am-copy` input):
        # the transition model is alignment-topology baggage this import
        # has no use for (the s5 stage owns topology here) — skip to the
        # wrapped <Nnet3> and ignore the trailing contexts/priors.
        end = r.buf.find(b"</TransitionModel> ", r.pos)
        nnet_at = r.buf.find(b"<Nnet3> ", max(end, r.pos))
        if end < 0 or nnet_at < 0:
            raise Nnet3ParseError(
                f"{path}: .mdl without a <Nnet3> section — if this is an "
                "nnet2 model use utils.nnet2_io instead")
        r.pos = nnet_at
        first = r.read_token()
    if first == "<Nnet>":
        raise Nnet3ParseError(
            f"{path}: this is a *nnet2* model (the v1 DNN/i-vector recipe's "
            "format) — import it with utils.nnet2_io.import_kaldi_nnet2 "
            "(the CLI dispatches there automatically)")
    if first != "<Nnet3>":
        raise Nnet3ParseError(f"{path}: expected <Nnet3>, got {first!r}")

    # Node section: text config lines up to a blank line.
    config_lines: List[str] = []
    while True:
        if r.pos >= len(r.buf):
            raise Nnet3ParseError(f"{path}: EOF inside the node-config section")
        line = r.read_line().strip()
        if line:
            config_lines.append(line)
        elif config_lines:
            break  # blank line after at least one node line = end of section
        # leading blank (the newline right after "<Nnet3> ") is skipped

    r.expect_token("<NumComponents>")
    n = r.read_int32()
    if not (0 < n < 10000):
        raise Nnet3ParseError(f"implausible NumComponents {n}")
    components: Dict[str, KaldiComponent] = {}
    order: List[str] = []
    for _ in range(n):
        r.expect_token("<ComponentName>")
        name = r.read_token()
        opening = r.read_token()
        if not (opening.startswith("<") and opening.endswith(">")):
            raise Nnet3ParseError(f"component {name}: bad type tag {opening!r}")
        ctype = opening[1:-1]
        closing = f"</{ctype}>"
        fields: Dict[str, object] = {}
        while True:
            tok = r.read_token()
            if tok == closing:
                break
            if not (tok.startswith("<") and tok.endswith(">")):
                raise Nnet3ParseError(
                    f"component {name} ({ctype}): unexpected token {tok!r}")
            fields[tok[1:-1]] = r.sniff_value()
        components[name] = KaldiComponent(name, ctype, fields)
        order.append(name)
    r.expect_token("</Nnet3>")
    return KaldiNnet(config_lines, components, order)


# canonical field schemas for writing (2018-era nnet3 component formats)
_WRITE_SCHEMAS = {
    "NaturalGradientAffineComponent": (
        ("LearningRate", "float"),
        ("LinearParams", "matrix"),
        ("BiasParams", "vector"),
        ("RankIn", "int"),
        ("RankOut", "int"),
        ("UpdatePeriod", "int"),
        ("NumSamplesHistory", "float"),
        ("Alpha", "float"),
    ),
    "RectifiedLinearComponent": (
        ("Dim", "int"),
        ("ValueAvg", "dvector"),
        ("DerivAvg", "dvector"),
        ("Count", "double"),
        ("NumDimsSelfRepaired", "double"),
        ("NumDimsProcessed", "double"),
    ),
    "LogSoftmaxComponent": (
        ("Dim", "int"),
        ("ValueAvg", "dvector"),
        ("DerivAvg", "dvector"),
        ("Count", "double"),
        ("NumDimsSelfRepaired", "double"),
        ("NumDimsProcessed", "double"),
    ),
    "BatchNormComponent": (
        ("Dim", "int"),
        ("BlockDim", "int"),
        ("Epsilon", "float"),
        ("TargetRms", "float"),
        ("TestMode", "bool"),
        ("Count", "double"),
        ("StatsMean", "dvector"),
        ("StatsVar", "dvector"),
    ),
    "StatisticsExtractionComponent": (
        ("InputDim", "int"),
        ("InputPeriod", "int"),
        ("OutputPeriod", "int"),
        # sic: the token carries Kaldi's historical spelling on the wire
        ("IncludeVarinance", "bool"),
    ),
    "StatisticsPoolingComponent": (
        ("InputDim", "int"),
        ("InputPeriod", "int"),
        ("LeftContext", "int"),
        ("RightContext", "int"),
        ("NumLogCountFeatures", "int"),
        ("OutputStddevs", "bool"),
        ("VarianceFloor", "float"),
    ),
}


def write_nnet3_raw(nnet: KaldiNnet, path: str) -> None:
    """Serialize a KaldiNnet to a binary nnet3 raw file.

    Components are written with the canonical 2018 field sequences
    (_WRITE_SCHEMAS); fields absent from ``component.fields`` get neutral
    defaults (zero stats, default NG state) so a round-trip of an
    imported model preserves everything it parsed.
    """
    w = _Writer()
    w.raw(b"\x00B")
    w.token("<Nnet3>")
    w.raw(b"\n")
    for line in nnet.config_lines:
        w.raw(line.encode("latin-1") + b"\n")
    w.raw(b"\n")
    w.token("<NumComponents>")
    w.int32(len(nnet.component_order))
    for name in nnet.component_order:
        comp = nnet.components[name]
        schema = _WRITE_SCHEMAS.get(comp.type)
        if schema is None:
            raise Nnet3ParseError(f"no write schema for component type {comp.type}")
        w.token("<ComponentName>")
        w.token(name)
        w.token(f"<{comp.type}>")
        for tok, kind in schema:
            w.field(tok, _field_or_default(comp, tok, kind), kind)
        w.token(f"</{comp.type}>")
        w.raw(b"\n")
    w.token("</Nnet3>")
    with open(path, "wb") as f:
        f.write(w.getvalue())


def _field_or_default(comp: KaldiComponent, tok: str, kind: str):
    v = comp.fields.get(tok)
    if v is not None:
        if isinstance(v, _Scalar):
            return v.as_int if kind == "int" else v.as_float
        return v
    dim = None
    if kind in ("vector", "dvector"):
        if "LinearParams" in comp.fields:
            dim = comp.matrix("LinearParams").shape[0]
        else:
            dim = comp.scalar_int("Dim")
        return np.zeros(dim)
    defaults = {
        "LearningRate": 0.001, "RankIn": 20, "RankOut": 80,
        "UpdatePeriod": 4, "NumSamplesHistory": 2000.0, "Alpha": 4.0,
        "Count": 0.0, "NumDimsSelfRepaired": 0.0, "NumDimsProcessed": 0.0,
        "BlockDim": comp.scalar_int("Dim", 0), "Epsilon": 1e-3,
        "TargetRms": 1.0, "TestMode": False,
    }
    if tok in defaults:
        return defaults[tok]
    raise Nnet3ParseError(f"{comp.name}: no value or default for <{tok}>")


# --------------------------------------------------------------------------
# descriptor parsing (splice validation)
# --------------------------------------------------------------------------


def _parse_append(desc: str) -> List[Tuple[str, int]]:
    """'Append(Offset(x,-2), x, Offset(x,2))' -> [(x,-2),(x,0),(x,2)].

    A bare node name parses as a single zero-offset term.
    """
    desc = desc.strip()
    m = re.fullmatch(r"Append\((.*)\)", desc)
    terms = []
    inner = m.group(1) if m else desc
    depth = 0
    cur = ""
    parts = []
    for ch in inner:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    if cur.strip():
        parts.append(cur)
    for p in parts:
        p = p.strip()
        om = re.fullmatch(r"Offset\((\S+?)\s*,\s*(-?\d+)\)", p)
        if om:
            terms.append((om.group(1), int(om.group(2))))
        elif re.fullmatch(r"[\w.\-]+", p):
            terms.append((p, 0))
        else:
            raise Nnet3ParseError(f"unsupported descriptor term {p!r} in {desc!r}")
    return terms


# --------------------------------------------------------------------------
# architecture detection + layer maps
# --------------------------------------------------------------------------


def detect_arch(nnet: KaldiNnet) -> str:
    """Classify a parsed model as one of am/v2/v3/v4/v5 by its names."""
    names = set(nnet.components)
    has = lambda n: f"{n}.affine" in names
    am_branch = any(n.endswith("_am.affine") for n in names)
    xvec_branch = any(n.endswith("_xvec.affine") for n in names)
    if has("tdnn1_share"):
        return "v5"
    if am_branch and xvec_branch:
        return "v3"
    if xvec_branch and has("tdnn1") and has("tdnn1_xvec"):
        return "v4"
    if has("tdnn6") and has("tdnn7"):
        return "v2"
    if has("tdnn1") and "output.affine" in names:
        return "am"
    raise Nnet3ParseError(
        f"cannot classify model; component names: {sorted(names)[:12]}...")


def _num_shared(nnet: KaldiNnet, suffix: str) -> int:
    """v3: shared layers tdnn1..k before tdnn{k+1}_am."""
    names = set(nnet.components)
    for k in range(1, 5):
        if f"tdnn{k + 1}{suffix}.affine" in names:
            return k
    raise Nnet3ParseError(f"no tdnn*{suffix} branch found")


def _num_shared_v5(nnet: KaldiNnet) -> int:
    """v5: shared layers are tdnn1_share..tdnnK_share (_2share/_3share)."""
    names = set(nnet.components)
    k = sum(1 for i in range(1, 5) if f"tdnn{i}_share.affine" in names)
    if not k:
        raise Nnet3ParseError("no tdnn*_share layers found")
    return k


@dataclasses.dataclass(frozen=True)
class _LayerMap:
    flax_path: Tuple[str, ...]  # under params/, e.g. ("frames", "tdnn1")
    kaldi: str                  # kaldi layer name, e.g. "tdnn1"
    kind: str                   # "rbn" (relu-batchnorm-layer) | "output"


def _xvector_maps() -> List[_LayerMap]:
    maps = [_LayerMap(("frames", f"tdnn{i}"), f"tdnn{i}", "rbn") for i in range(1, 6)]
    maps += [
        _LayerMap(("segment", "tdnn6"), "tdnn6", "rbn"),
        _LayerMap(("segment", "tdnn7"), "tdnn7", "rbn"),
        _LayerMap(("segment", "output"), "output", "output"),
    ]
    return maps


def _am_maps() -> List[_LayerMap]:
    maps = [_LayerMap(("frames", f"tdnn{i}"), f"tdnn{i}", "rbn") for i in range(1, 6)]
    maps.append(_LayerMap(("output",), "output", "output"))
    return maps


def _multitask_maps(num_shared: int) -> List[_LayerMap]:
    maps = [
        _LayerMap(("shared", f"tdnn{i}"), f"tdnn{i}", "rbn")
        for i in range(1, num_shared + 1)
    ]
    # AM branch: kaldi tdnn{k+1}_am..tdnn7_am -> ours am_branch/tdnn1..(7-k)
    for j, k in enumerate(range(num_shared + 1, 8), start=1):
        maps.append(_LayerMap(("am_branch", f"tdnn{j}"), f"tdnn{k}_am", "rbn"))
    maps.append(_LayerMap(("output_am",), "output_am", "output"))
    # xvec branch: kaldi tdnn{k+1}_xvec..tdnn5_xvec -> ours xvec_branch/tdnn1..
    for j, k in enumerate(range(num_shared + 1, 6), start=1):
        maps.append(_LayerMap(("xvec_branch", f"tdnn{j}"), f"tdnn{k}_xvec", "rbn"))
    maps += [
        _LayerMap(("segment", "tdnn6"), "tdnn6_xvec", "rbn"),
        _LayerMap(("segment", "tdnn7"), "tdnn7_xvec", "rbn"),
        _LayerMap(("segment", "output"), "output", "output"),
    ]
    return maps


def _adapted_maps() -> List[_LayerMap]:
    maps = [
        _LayerMap(("am", "frames", f"tdnn{i}"), f"tdnn{i}", "rbn")
        for i in range(1, 6)
    ]
    maps += [
        _LayerMap(("xvec_branch", f"tdnn{i}"), f"tdnn{i}_xvec", "rbn")
        for i in range(1, 5)
    ]
    maps += [
        _LayerMap(("tdnn5",), "tdnn5_xvec", "rbn"),
        _LayerMap(("segment", "tdnn6"), "tdnn6_xvec", "rbn"),
        _LayerMap(("segment", "tdnn7"), "tdnn7_xvec", "rbn"),
        _LayerMap(("segment", "output"), "output", "output"),
    ]
    return maps


def _combined_maps(num_shared: int = 1) -> List[_LayerMap]:
    maps = [
        _LayerMap(("shared", f"tdnn{j}"), f"tdnn{j}_share", "rbn")
        for j in range(1, num_shared + 1)
    ]
    for j, k in enumerate(range(num_shared + 1, 8), start=1):
        maps.append(_LayerMap(("am_branch", f"tdnn{j}"), f"tdnn{k}_am", "rbn"))
    maps.append(_LayerMap(("output_am",), "output_am", "output"))
    maps += [
        _LayerMap(("am", "frames", f"tdnn{i}"), f"tdnn{i}", "rbn")
        for i in range(1, 6)
    ]
    for j, k in enumerate(range(num_shared + 1, 5), start=1):
        maps.append(_LayerMap(("xvec_branch", f"tdnn{j}"), f"tdnn{k}_xvec", "rbn"))
    maps += [
        _LayerMap(("tdnn5",), "tdnn5_xvec", "rbn"),
        _LayerMap(("segment", "tdnn6"), "tdnn6_xvec", "rbn"),
        _LayerMap(("segment", "tdnn7"), "tdnn7_xvec", "rbn"),
        _LayerMap(("segment", "output"), "output", "output"),
    ]
    return maps


def _arch_maps(arch: str, nnet: Optional[KaldiNnet] = None) -> List[_LayerMap]:
    if arch == "v2":
        return _xvector_maps()
    if arch == "am":
        return _am_maps()
    if arch == "v3":
        ns = _num_shared(nnet, "_am") if nnet is not None else 1
        return _multitask_maps(ns)
    if arch == "v4":
        return _adapted_maps()
    if arch == "v5":
        ns = _num_shared_v5(nnet) if nnet is not None else 1
        return _combined_maps(ns)
    raise ValueError(f"unknown arch {arch!r}")


# --------------------------------------------------------------------------
# import: KaldiNnet -> (model, variables)
# --------------------------------------------------------------------------

_OUR_BN_EPS = 1e-3  # TdnnLayer's flax BatchNorm epsilon


def _import_rbn(nnet: KaldiNnet, kaldi_name: str):
    """One relu-batchnorm-layer -> (kernel, bias, bn_scale, bn_mean, bn_var).

    kernel is (k, in, out) with splice taps ordered ascending, matching
    TdnnLayer's VALID dilated conv.
    """
    aff = nnet.components.get(f"{kaldi_name}.affine")
    bn = nnet.components.get(f"{kaldi_name}.batchnorm")
    if aff is None or bn is None:
        raise Nnet3ParseError(f"missing components for layer {kaldi_name}")
    w = aff.matrix("LinearParams")  # (out, k*in)
    b = aff.vector("BiasParams")
    inputs = nnet.node_inputs().get(f"{kaldi_name}.affine")
    if inputs is None:
        raise Nnet3ParseError(f"no component-node line for {kaldi_name}.affine")
    terms = _parse_append(inputs)
    offsets = [o for _, o in terms]
    srcs = {s for s, _ in terms}
    if len(srcs) > 1:
        # merge layer (tdnn5_xvec in v4/v5): Append(tdnn4_xvec, am_bn) —
        # two different sources, each at offset 0; column blocks ordered
        # as listed, which matches append_streams([xv, am]).
        if offsets != [0] * len(offsets):
            raise Nnet3ParseError(
                f"{kaldi_name}: multi-source splice with nonzero offsets "
                f"{offsets} is not a supported graph shape")
        k = 1
    else:
        if offsets != sorted(offsets):
            raise Nnet3ParseError(
                f"{kaldi_name}: splice offsets {offsets} not ascending")
        k = len(offsets)
    out_dim, spliced = w.shape
    if spliced % k:
        raise Nnet3ParseError(
            f"{kaldi_name}: LinearParams cols {spliced} not divisible by "
            f"splice width {k}")
    in_dim = spliced // k
    kernel = np.stack(
        [w[:, i * in_dim : (i + 1) * in_dim].T for i in range(k)], axis=0
    )  # (k, in, out)

    mean = bn.vector("StatsMean").astype(np.float64)
    var = bn.vector("StatsVar").astype(np.float64)
    eps = bn.scalar_float("Epsilon", 1e-3)
    t_rms = bn.scalar_float("TargetRms", 1.0)
    count = bn.scalar_float("Count", 0.0)
    if count <= 0:
        # untrained stats: identity normalization (Kaldi would refuse
        # test mode; we import as mean 0 / var 1, scale target-rms)
        mean = np.zeros_like(mean)
        var = np.ones_like(var)
    # ours: (x - m)/sqrt(v + OUR_EPS) * s  ==  kaldi: (x - m) * t/sqrt(v+eps)
    scale = t_rms * np.sqrt(var + _OUR_BN_EPS) / np.sqrt(var + eps)
    return (
        kernel.astype(np.float32),
        b.astype(np.float32),
        scale.astype(np.float32),
        mean.astype(np.float32),
        var.astype(np.float32),
    )


def _import_output(nnet: KaldiNnet, kaldi_name: str):
    aff = nnet.components.get(f"{kaldi_name}.affine")
    if aff is None:
        raise Nnet3ParseError(f"missing component {kaldi_name}.affine")
    w = aff.matrix("LinearParams")
    b = aff.vector("BiasParams")
    return w.T.astype(np.float32), b.astype(np.float32)


def _set_path(tree: dict, path: Tuple[str, ...], leaf_updates: dict) -> None:
    node = tree
    for p in path:
        if p not in node:
            raise Nnet3ParseError(
                f"model has no parameter subtree {'/'.join(path)} "
                f"(missing {p!r}; have {sorted(node)})")
        node = node[p]
    for k, v in leaf_updates.items():
        if k not in node:
            raise Nnet3ParseError(
                f"{'/'.join(path)}: no leaf {k!r} (have {sorted(node)})")
        if tuple(node[k].shape) != tuple(v.shape):
            raise Nnet3ParseError(
                f"{'/'.join(path)}/{k}: shape {v.shape} != model "
                f"{tuple(node[k].shape)}")
        node[k] = v


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def load_variables(nnet: KaldiNnet, template_variables, arch: str):
    """Fill a ``{'params', 'batch_stats'}`` numpy tree in the reference's
    layout (`bridge.flax_variables_from_state_dict` of the matching port
    model) from a parsed Kaldi model; dims are validated leaf by leaf.
    Returns a new tree; the template is not mutated."""
    for comp in nnet.components.values():
        if comp.type == "StatisticsPoolingComponent":
            if comp.scalar_int("NumLogCountFeatures", 0) != 0:
                raise Nnet3ParseError(
                    f"{comp.name}: num-log-count-features != 0 — this "
                    "stats config has no sepi_tpu equivalent")
            if comp.fields.get("OutputStddevs") is False:
                raise Nnet3ParseError(
                    f"{comp.name}: mean-only stats pooling is not the "
                    "mean+stddev layer the v1-v5 graphs use")

    variables = _tree_map(np.array, dict(template_variables))
    params = variables["params"]
    bstats = variables.get("batch_stats", {})
    for m in _arch_maps(arch, nnet):
        if m.kind == "rbn":
            kernel, bias, scale, mean, var = _import_rbn(nnet, m.kaldi)
            _set_path(params, m.flax_path + ("affine",),
                      {"kernel": kernel, "bias": bias})
            _set_path(params, m.flax_path + ("batchnorm",), {"scale": scale})
            _set_path(bstats, m.flax_path + ("batchnorm",),
                      {"mean": mean, "var": var})
        else:
            kernel, bias = _import_output(nnet, m.kaldi)
            _set_path(params, m.flax_path, {"kernel": kernel, "bias": bias})
    return variables


def _build_model(arch: str, nnet: KaldiNnet):
    """Instantiate the matching port model with dims read off the file.

    Splice patterns are the fixed reference shapes (validated against the
    config lines during load); layer *widths* are read from the affine
    components so non-default-width variants (e.g. the `_expand` family)
    import too.
    """
    from ..models import (  # the port's models
        AdaptedConfig,
        AdaptedXVector,
        AmConfig,
        AmNet,
        CombinedConfig,
        CombinedCVector,
        MultitaskConfig,
        MultitaskCVector,
        XVector,
        XVectorConfig,
    )

    feat_dim = nnet.input_dim()

    def rows(name: str) -> int:
        comp = nnet.components.get(f"{name}.affine")
        if comp is None:
            raise Nnet3ParseError(f"arch {arch}: missing layer {name}")
        return comp.matrix("LinearParams").shape[0]

    if arch == "v2":
        base = XVectorConfig()
        specs = tuple(
            dataclasses.replace(s, dim=rows(f"tdnn{i + 1}"))
            for i, s in enumerate(base.frame_specs)
        )
        cfg = dataclasses.replace(
            base, feat_dim=feat_dim, num_speakers=rows("output"),
            frame_specs=specs, embed_dim=rows("tdnn6"))
        return XVector(cfg), cfg
    if arch == "am":
        base = AmConfig()
        specs = tuple(
            dataclasses.replace(s, dim=rows(f"tdnn{i + 1}"))
            for i, s in enumerate(base.specs)
        )
        cfg = dataclasses.replace(base, feat_dim=feat_dim,
                                  num_senones=rows("output"), specs=specs)
        return AmNet(cfg), cfg
    if arch == "v3":
        ns = _num_shared(nnet, "_am")
        cfg = dataclasses.replace(
            MultitaskConfig(), feat_dim=feat_dim,
            num_speakers=rows("output"), num_senones=rows("output_am"),
            num_shared=ns, hidden_dim=rows("tdnn1"),
            pool_dim=rows("tdnn5_xvec"), embed_dim=rows("tdnn6_xvec"))
        return MultitaskCVector(cfg), cfg
    if arch in ("v4", "v5"):
        am_base = AmConfig()
        am_specs = tuple(
            dataclasses.replace(s, dim=rows(f"tdnn{i + 1}"))
            for i, s in enumerate(am_base.specs)
        )
        am_cfg = dataclasses.replace(am_base, feat_dim=feat_dim, specs=am_specs)
        if arch == "v4":
            cfg = dataclasses.replace(
                AdaptedConfig(), feat_dim=feat_dim,
                num_speakers=rows("output"), am=am_cfg,
                hidden_dim=rows("tdnn1_xvec"), pool_dim=rows("tdnn5_xvec"),
                embed_dim=rows("tdnn6_xvec"))
            return AdaptedXVector(cfg), cfg
        cfg = dataclasses.replace(
            CombinedConfig(), feat_dim=feat_dim,
            num_speakers=rows("output"), num_senones=rows("output_am"),
            am=am_cfg, num_shared=_num_shared_v5(nnet),
            hidden_dim=rows("tdnn1_share"),
            pool_dim=rows("tdnn5_xvec"), embed_dim=rows("tdnn6_xvec"))
        return CombinedCVector(cfg), cfg
    raise ValueError(arch)


def import_kaldi_raw(path: str, arch: Optional[str] = None, device: DeviceLike = "cuda"):
    """Load a Kaldi nnet3 raw model -> (model, state_dict, arch).

    arch is auto-detected from component names unless given.  The model
    is the port's (`models.XVector`, `AmNet` or a c-vector) in eval mode
    on ``device``, its parameters filled from the file; ``state_dict`` is
    the same weights on the host.  Multitask models take the usual
    ``task=`` kwarg.  A parameter the layer maps do not fill, or one whose
    shape differs from the model's, raises `Nnet3ParseError`.
    """
    from ..bridge import flax_variables_from_state_dict, state_dict_from_flax

    dev = resolve_device(device)
    nnet = read_nnet3_raw(path)
    arch = arch or detect_arch(nnet)
    model, cfg = _build_model(arch, nnet)
    want = model.state_dict()
    # the reference's layout of the model's own parameters, NaN-filled so
    # any leaf the layer maps fail to cover is a loud error, never a
    # silently-initialised parameter
    template = _tree_map(lambda a: np.full(a.shape, np.nan, np.float32),
                         flax_variables_from_state_dict(want))
    variables = load_variables(nnet, template, arch)
    unfilled = ["/".join(p) for p, leaf in _tree_leaves(variables)
                if np.isnan(leaf).any()]
    if unfilled:
        raise Nnet3ParseError(
            f"arch {arch}: import left model leaves unfilled: {unfilled}")
    got = state_dict_from_flax(variables)  # the template's leaves: the model's keys
    model.load_state_dict(got, strict=True)
    return model.to(dev).eval(), got, arch


# --------------------------------------------------------------------------
# export: (model variables) -> KaldiNnet
# --------------------------------------------------------------------------


def _splice_desc(src: str, offsets: Tuple[int, ...]) -> str:
    if tuple(offsets) == (0,):
        return src
    terms = [f"Offset({src}, {o})" if o else src for o in offsets]
    return f"Append({', '.join(terms)})"


def _export_rbn(name: str, kernel: np.ndarray, bias: np.ndarray,
                scale: np.ndarray, mean: np.ndarray, var: np.ndarray,
                count: float = 1.0):
    """(k,in,out) conv + our batchnorm -> kaldi affine + relu + batchnorm.

    The learned scale is folded into the written variance:
    ``var' = t^2 (v + OUR_EPS)/s^2 - eps`` so that Kaldi's test-mode scale
    ``t/sqrt(var' + eps)`` equals ours exactly.  The target RMS ``t`` is 1,
    as the reference writes it, unless a dimension's scale is too large for
    that (``s^2 > (v + OUR_EPS)/eps``: a trained layer with dead or
    low-variance units, where the reference refuses to export); then ``t``
    is the smallest power of two (exact in float32) that keeps every
    ``var' >= 0``.  Kaldi's batch norm has no sign, so a scale <= 0 has no
    Kaldi form and raises.
    """
    k, in_dim, out_dim = kernel.shape
    w = np.concatenate([kernel[i].T for i in range(k)], axis=1)  # (out, k*in)
    aff = KaldiComponent(f"{name}.affine", "NaturalGradientAffineComponent",
                         {"LinearParams": w.astype(np.float32),
                          "BiasParams": bias.astype(np.float32)})
    relu = KaldiComponent(f"{name}.relu", "RectifiedLinearComponent",
                          {"Dim": _Scalar(struct.pack("<i", out_dim))})
    s = scale.astype(np.float64)
    v = var.astype(np.float64)
    eps = 1e-3
    if np.any(s <= 0):
        raise Nnet3ParseError(
            f"{name}: batch-norm scale {s.min():.3g} <= 0 has no Kaldi "
            "BatchNormComponent form (its test-mode scale is positive)")
    t_rms = 1.0
    var_out = (v + _OUR_BN_EPS) / np.maximum(s, 1e-20) ** 2 - eps
    while np.any(var_out < 0):
        t_rms *= 2.0
        var_out = t_rms ** 2 * (v + _OUR_BN_EPS) / np.maximum(s, 1e-20) ** 2 - eps
    bn = KaldiComponent(
        f"{name}.batchnorm", "BatchNormComponent",
        {"Dim": _Scalar(struct.pack("<i", out_dim)),
         "BlockDim": _Scalar(struct.pack("<i", out_dim)),
         "Epsilon": _Scalar(struct.pack("<f", eps)),
         "TargetRms": _Scalar(struct.pack("<f", t_rms)),
         "TestMode": False,
         "Count": _Scalar(struct.pack("<d", max(count, 1.0))),
         "StatsMean": mean.astype(np.float64),
         "StatsVar": var_out})
    return aff, relu, bn


def _get_path(tree, path: Tuple[str, ...]):
    node = tree
    for p in path:
        node = node[p]
    return node


def export_kaldi_raw(state, arch: str, path: str,
                     max_chunk_size: int = 10000) -> None:
    """Write a port model, or its ``state_dict``, as a Kaldi nnet3 raw file.

    Emits the same node names/graph the reference's builders generate for
    that arch, so downstream Kaldi tooling (`nnet3-xvector-compute` with
    `output-node input=tdnn6.affine` rewrites, `nnet3-info`, ...) sees a
    familiar model.  Stats components use the 0:1:1:max_chunk_size window
    (`run_xvector_new.sh:106`).
    """
    from ..bridge import flax_variables_from_state_dict

    if isinstance(state, torch.nn.Module):
        state = state.state_dict()
    variables = flax_variables_from_state_dict(state)
    params = variables["params"]
    bstats = variables.get("batch_stats", {})
    if arch == "v3":
        maps = _multitask_maps(_infer_num_shared_from_params(params))
    elif arch == "v5":
        maps = _combined_maps(_infer_num_shared_from_params(params))
    else:
        maps = _arch_maps(arch, None)

    components: Dict[str, KaldiComponent] = {}
    order: List[str] = []
    dims: Dict[str, int] = {}

    def add(c: KaldiComponent):
        components[c.name] = c
        order.append(c.name)

    for m in maps:
        if m.kind == "rbn":
            aff = _get_path(params, m.flax_path + ("affine",))
            sc = _get_path(params, m.flax_path + ("batchnorm",))["scale"]
            st = _get_path(bstats, m.flax_path + ("batchnorm",))
            a, r, bn = _export_rbn(m.kaldi, np.asarray(aff["kernel"]),
                                   np.asarray(aff["bias"]), np.asarray(sc),
                                   np.asarray(st["mean"]), np.asarray(st["var"]))
            for c in (a, r, bn):
                add(c)
            dims[m.kaldi] = np.asarray(aff["kernel"]).shape[2]
        else:
            leaf = _get_path(params, m.flax_path)
            w = np.asarray(leaf["kernel"]).T  # (out, in)
            add(KaldiComponent(f"{m.kaldi}.affine",
                               "NaturalGradientAffineComponent",
                               {"LinearParams": w.astype(np.float32),
                                "BiasParams": np.asarray(leaf["bias"], np.float32)}))
            add(KaldiComponent(f"{m.kaldi}.log-softmax", "LogSoftmaxComponent",
                               {"Dim": _Scalar(struct.pack("<i", w.shape[0]))}))
            dims[m.kaldi] = w.shape[0]

    config_lines, stats_comps = _graph_lines(arch, maps, params, dims,
                                             max_chunk_size)
    for c in stats_comps:
        add(c)
    write_nnet3_raw(KaldiNnet(config_lines, components, order), path)


def _infer_num_shared_from_params(params) -> int:
    shared = params.get("shared", {})
    return sum(1 for k in shared if k.startswith("tdnn"))


def _stats_components(name: str, in_dim: int, max_chunk: int):
    """stats-layer 'mean+stddev(0:1:1:max)' -> extraction+pooling comps."""
    ext = KaldiComponent(
        f"{name}-extraction-0-{max_chunk}", "StatisticsExtractionComponent",
        {"InputDim": _Scalar(struct.pack("<i", in_dim)),
         "InputPeriod": _Scalar(struct.pack("<i", 1)),
         "OutputPeriod": _Scalar(struct.pack("<i", 1)),
         "IncludeVarinance": True})
    pool = KaldiComponent(
        f"{name}-pooling-0-{max_chunk}", "StatisticsPoolingComponent",
        {"InputDim": _Scalar(struct.pack("<i", 1 + 2 * in_dim)),
         "InputPeriod": _Scalar(struct.pack("<i", 1)),
         "LeftContext": _Scalar(struct.pack("<i", 0)),
         "RightContext": _Scalar(struct.pack("<i", max_chunk)),
         "NumLogCountFeatures": _Scalar(struct.pack("<i", 0)),
         "OutputStddevs": True,
         "VarianceFloor": _Scalar(struct.pack("<f", 1e-10))})
    return ext, pool


def _rbn_lines(name: str, input_desc: str) -> List[str]:
    return [
        f"component-node name={name}.affine component={name}.affine "
        f"input={input_desc}",
        f"component-node name={name}.relu component={name}.relu "
        f"input={name}.affine",
        f"component-node name={name}.batchnorm component={name}.batchnorm "
        f"input={name}.relu",
    ]


def _output_lines(name: str, input_desc: str) -> List[str]:
    return [
        f"component-node name={name}.affine component={name}.affine "
        f"input={input_desc}",
        f"component-node name={name}.log-softmax component={name}.log-softmax "
        f"input={name}.affine",
        f"output-node name={name} input={name}.log-softmax objective=linear",
    ]


def _stats_lines(name: str, input_desc: str, max_chunk: int) -> List[str]:
    e = f"{name}-extraction-0-{max_chunk}"
    p = f"{name}-pooling-0-{max_chunk}"
    return [
        f"component-node name={e} component={e} input={input_desc}",
        f"component-node name={p} component={p} input={e}",
    ]


# per-arch graph wiring: (kaldi layer name, input descriptor builder)
_PREFIX_OFFSETS = ((-2, -1, 0, 1, 2), (-2, 0, 2), (-3, 0, 3), (0,))
_AM_OFFSETS = ((-2, -1, 0, 1, 2), (-1, 0, 1), (-1, 0, 1), (-3, 0, 3), (-6, -3, 0))


def _graph_lines(arch: str, maps, params, dims: Dict[str, int],
                 max_chunk: int):
    """Emit the reference-shaped config lines + stats components."""
    feat_dim = None
    for m in maps:
        if m.kind == "rbn":
            aff = _get_path(params, m.flax_path + ("affine",))
            feat_dim_cand = np.asarray(aff["kernel"]).shape[1]
            feat_dim = feat_dim_cand
            break
    lines = [f"input-node name=input dim={feat_dim}"]
    stats_comps: List[KaldiComponent] = []

    def bn(n):
        return f"{n}.batchnorm"

    if arch == "v2":
        specs = _PREFIX_OFFSETS + ((0,), (0,))
        prev = "input"
        for i in range(1, 6):
            offs = specs[i - 1] if i <= 4 else (0,)
            lines += _rbn_lines(f"tdnn{i}", _splice_desc(prev, offs))
            prev = bn(f"tdnn{i}")
        e, p = _stats_components("stats", dims["tdnn5"], max_chunk)
        stats_comps += [e, p]
        lines += _stats_lines("stats", prev, max_chunk)
        lines += _rbn_lines("tdnn6", f"stats-pooling-0-{max_chunk}")
        lines += _rbn_lines("tdnn7", bn("tdnn6"))
        lines += _output_lines("output", bn("tdnn7"))
    elif arch == "am":
        prev = "input"
        for i in range(1, 6):
            lines += _rbn_lines(f"tdnn{i}", _splice_desc(prev, _AM_OFFSETS[i - 1]))
            prev = bn(f"tdnn{i}")
        lines += _output_lines("output", prev)
    elif arch == "v3":
        ns = _infer_num_shared_from_params(params)
        prev = "input"
        for i in range(1, ns + 1):
            lines += _rbn_lines(f"tdnn{i}", _splice_desc(prev, _PREFIX_OFFSETS[i - 1]))
            prev = bn(f"tdnn{i}")
        shared_out = prev
        prev = shared_out
        for k in range(ns + 1, 8):
            offs = _PREFIX_OFFSETS[k - 1] if k <= 4 else (0,)
            lines += _rbn_lines(f"tdnn{k}_am", _splice_desc(prev, offs))
            prev = bn(f"tdnn{k}_am")
        lines += _output_lines("output_am", prev)
        prev = shared_out
        for k in range(ns + 1, 6):
            offs = _PREFIX_OFFSETS[k - 1] if k <= 4 else (0,)
            lines += _rbn_lines(f"tdnn{k}_xvec", _splice_desc(prev, offs))
            prev = bn(f"tdnn{k}_xvec")
        e, p = _stats_components("stats_xvec", dims["tdnn5_xvec"], max_chunk)
        stats_comps += [e, p]
        lines += _stats_lines("stats_xvec", prev, max_chunk)
        lines += _rbn_lines("tdnn6_xvec", f"stats_xvec-pooling-0-{max_chunk}")
        lines += _rbn_lines("tdnn7_xvec", bn("tdnn6_xvec"))
        lines += _output_lines("output", bn("tdnn7_xvec"))
    elif arch in ("v4", "v5"):
        if arch == "v5":
            ns = _infer_num_shared_from_params(params)
            prev = "input"
            for j in range(1, ns + 1):
                lines += _rbn_lines(f"tdnn{j}_share",
                                    _splice_desc(prev, _PREFIX_OFFSETS[j - 1]))
                prev = bn(f"tdnn{j}_share")
            shared_out = prev
            for k in range(ns + 1, 8):
                offs = _PREFIX_OFFSETS[k - 1] if k <= 4 else (0,)
                lines += _rbn_lines(f"tdnn{k}_am", _splice_desc(prev, offs))
                prev = bn(f"tdnn{k}_am")
            lines += _output_lines("output_am", prev)
            xvec_src = shared_out
            xvec_range = range(ns + 1, 5)
        else:
            xvec_src = "input"
            xvec_range = range(1, 5)
        # the pretrained AM (names tdnn1..5)
        prev = "input"
        for i in range(1, 6):
            lines += _rbn_lines(f"tdnn{i}", _splice_desc(prev, _AM_OFFSETS[i - 1]))
            prev = bn(f"tdnn{i}")
        am_node = bn("tdnn5")
        prev = xvec_src
        for k in xvec_range:
            lines += _rbn_lines(f"tdnn{k}_xvec",
                                _splice_desc(prev, _PREFIX_OFFSETS[k - 1]))
            prev = bn(f"tdnn{k}_xvec")
        lines += _rbn_lines("tdnn5_xvec", f"Append({prev}, {am_node})")
        stats_name = "stats" if arch == "v4" else "stats_xvec"
        e, p = _stats_components(stats_name, dims["tdnn5_xvec"], max_chunk)
        stats_comps += [e, p]
        lines += _stats_lines(stats_name, bn("tdnn5_xvec"), max_chunk)
        lines += _rbn_lines("tdnn6_xvec", f"{stats_name}-pooling-0-{max_chunk}")
        lines += _rbn_lines("tdnn7_xvec", bn("tdnn6_xvec"))
        lines += _output_lines("output", bn("tdnn7_xvec"))
    else:
        raise ValueError(arch)
    return lines, stats_comps
