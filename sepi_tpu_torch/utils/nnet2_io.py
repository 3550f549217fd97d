"""Kaldi *nnet2* model import — the v1 DNN/i-vector acoustic model.

The reference's DNN-posterior recipe trains a p-norm multisplice TDNN
with the 2014-era nnet2 toolkit and ships it as ``final.mdl``
(`egs/sre/v1/local/dnn/run_nnet2_multisplice.sh:47-61`
via `sid/nnet2/train_multisplice_accel2.sh`); `init_full_ubm_from_dnn.sh:
100-105` then evaluates it with ``nnet-am-compute`` for senone
posteriors.  A migrating user's trained artifact is that ``final.mdl``:
this module loads it straight into `models.nnet2.Nnet2Multisplice`
variables so `recipes.nnet2_recipe.nnet2_posteriors` can serve the
DNN/i-vector path without retraining.

File layout handled (both forms):
  final.mdl   <TransitionModel> ... </TransitionModel> <Nnet> ... </Nnet>
              <priors Vector>          (the nnet2 AmNnet serialization)
  raw nnet    <Nnet> ... </Nnet>

The wire format is the published Kaldi binary protocol (``\\0B`` magic,
space-terminated tokens, size-prefixed basic types) — implemented from
the spec, not from Kaldi sources; like `utils/nnet3.py`, component
bodies are parsed as generic ``<Token> value`` sequences so optional
fields and natural-gradient state never break the reader.  The
transition model is opaque baggage for this purpose and is skipped by
its closing token (alignment topology lives in the s5 stage here).

Component zoo (what `run_nnet2_multisplice.sh` graphs contain):
  SpliceComponent                    temporal splicing (Context int-vector)
  FixedAffineComponent               the LDA-like preprocessing transform —
                                     FOLDED exactly into the first layer's
                                     affine (both are linear maps on the
                                     spliced input)
  AffineComponent{,Preconditioned,PreconditionedOnline}
  PnormComponent                     group p-norm (P must be 2)
  NormalizeComponent                 unit-RMS renormalization
  SoftmaxComponent                   posterior head
  FixedScaleComponent                folded into the preceding affine

Mapping to the model: a splice over offsets ``(c_1..c_k)`` feeding an
affine with weight ``W`` becomes a VALID dilated conv whose kernel tap
``j`` is the transposed block ``W[:, j*D:(j+1)*D]`` — identical math.

A port of `sepi_tpu/utils/nnet2_io.py`: the layers are assembled in the
reference's Flax layout (``layer{i}/affine/kernel`` (k, in, out)) and go
through `bridge.nnet2_state_dict_from_flax` into the port's
`models.nnet2.Nnet2Multisplice`, so both packages import the same weights.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device
from .nnet3 import _Reader, _Scalar

__all__ = ["Nnet2ParseError", "read_nnet2_components", "import_kaldi_nnet2"]


class Nnet2ParseError(ValueError):
    pass


_AFFINE_TYPES = (
    "AffineComponent",
    "AffineComponentPreconditioned",
    "AffineComponentPreconditionedOnline",
    "NaturalGradientAffineComponent",
)
_STATELESS_SKIP = ("NoOpComponent",)


def _read_int_vector(r: _Reader) -> np.ndarray:
    """WriteIntegerVector wire form: elem-size char, RAW int32 count, data.

    Kaldi's WriteIntegerVector (io-funcs-inl.h) writes the element count
    as a bare little-endian int32 immediately after the element-size
    char — unlike WriteBasicType scalars it carries NO size-prefix byte
    of its own, so ``read_int32`` (which expects one) must not be used.
    """
    size = r._take(1)[0]
    if size != 4:
        raise Nnet2ParseError(f"int-vector element size {size} != 4")
    count = struct.unpack("<i", r._take(4))[0]
    if count < 0 or count > 1_000_000:
        raise Nnet2ParseError(f"implausible int-vector count {count}")
    return np.frombuffer(r._take(4 * count), "<i4").copy()


def _read_component(r: _Reader) -> Tuple[str, Dict[str, object]]:
    opening = r.read_token()
    if not (opening.startswith("<") and opening.endswith(">")):
        raise Nnet2ParseError(f"bad component type tag {opening!r}")
    ctype = opening[1:-1]
    closing = f"</{ctype}>"
    fields: Dict[str, object] = {}
    while True:
        tok = r.read_token()
        if tok == closing:
            break
        if not (tok.startswith("<") and tok.endswith(">")):
            raise Nnet2ParseError(
                f"component {ctype}: unexpected token {tok!r}")
        name = tok[1:-1]
        if name == "Context":
            fields[name] = _read_int_vector(r)
        else:
            fields[name] = r.sniff_value()
    return ctype, fields


def read_nnet2_components(path: str):
    """Parse a nnet2 final.mdl / raw net.

    Returns (components: [(type, fields)], priors: (N,) or None).
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"\x00B":
        raise Nnet2ParseError(
            f"{path}: no Kaldi binary magic — text-format models are not "
            "supported")
    r = _Reader(data[2:])
    first = r.read_token()
    if first == "<TransitionModel>":
        # opaque for posterior extraction; skip to its closing token.
        # The closing-token byte sequence can occur coincidentally inside
        # the TM's binary payload, so accept an occurrence only when the
        # wrapped net's opening token follows it directly (Kaldi writes
        # "</TransitionModel> <Nnet> " with single-space separators).
        at = r.pos
        while True:
            end = r.buf.find(b"</TransitionModel> ", at)
            if end < 0:
                raise Nnet2ParseError(
                    f"{path}: unterminated <TransitionModel>")
            nxt = end + len(b"</TransitionModel> ")
            if r.buf[nxt : nxt + 7] == b"<Nnet> " or (
                r.buf[nxt : nxt + 8] == b"<Nnet3> "
            ):
                r.pos = nxt
                break
            at = end + 1
        first = r.read_token()
    if first == "<Nnet3>":
        raise Nnet2ParseError(
            f"{path}: this is an nnet3 model — use utils.nnet3 "
            "(`nnet3-am-copy --raw=true` form) instead")
    if first != "<Nnet>":
        raise Nnet2ParseError(f"{path}: expected <Nnet>, got {first!r}")
    r.expect_token("<NumComponents>")
    n = r.read_int32()
    if not (0 < n < 1000):
        raise Nnet2ParseError(f"implausible NumComponents {n}")
    r.expect_token("<Components>")
    comps = [_read_component(r) for _ in range(n)]
    r.expect_token("</Components>")
    r.expect_token("</Nnet>")
    priors = None
    r.skip_ws()
    if r.pos < len(r.buf) and r._peek(2) in (b"FV", b"DV"):
        priors = r.read_vector().astype(np.float64)
    return comps, priors


def _matf(fields, tok, ctype) -> np.ndarray:
    v = fields.get(tok)
    if not isinstance(v, np.ndarray) or v.ndim != 2:
        raise Nnet2ParseError(f"{ctype}: missing matrix <{tok}>")
    return v.astype(np.float64)


def _vecf(fields, tok, ctype) -> np.ndarray:
    v = fields.get(tok)
    if not isinstance(v, np.ndarray) or v.ndim != 1:
        raise Nnet2ParseError(f"{ctype}: missing vector <{tok}>")
    return v.astype(np.float64)


def _scalar(fields, tok, as_int=False):
    v = fields.get(tok)
    if not isinstance(v, _Scalar):
        return None
    return v.as_int if as_int else v.as_float


@dataclasses.dataclass
class _Layer:
    offsets: Tuple[int, ...]
    weight: np.ndarray  # (out, k*in) effective affine (fixed transforms folded)
    bias: np.ndarray  # (out,)
    pnorm_out: Optional[int] = None  # None for the output affine
    group: Optional[int] = None


def _assemble_layers(comps) -> Tuple[List[_Layer], int]:
    """Fold splice/fixed-affine/scale structure into effective layers."""
    layers: List[_Layer] = []
    pending_offsets: Tuple[int, ...] = (0,)
    pending_fixed: Optional[Tuple[np.ndarray, np.ndarray]] = None
    feat_dim: Optional[int] = None
    saw_softmax = False
    for ctype, fields in comps:
        if ctype in _STATELESS_SKIP:
            continue
        if ctype == "SpliceComponent":
            ctx = fields.get("Context")
            if ctx is None:
                # oldest writers: <LeftContext>/<RightContext> ints
                lc = _scalar(fields, "LeftContext", as_int=True)
                rc = _scalar(fields, "RightContext", as_int=True)
                if lc is None or rc is None:
                    raise Nnet2ParseError("SpliceComponent without context")
                ctx = np.arange(-lc, rc + 1)
            pending_offsets = tuple(int(c) for c in ctx)
            if feat_dim is None:
                feat_dim = _scalar(fields, "InputDim", as_int=True)
            cc = _scalar(fields, "ConstComponentDim", as_int=True)
            if cc:
                raise Nnet2ParseError(
                    "SpliceComponent with const-component (i-vector input) "
                    "is not part of the multisplice posterior net")
        elif ctype == "FixedAffineComponent":
            w = _matf(fields, "LinearParams", ctype)
            b = _vecf(fields, "BiasParams", ctype)
            if pending_fixed is not None:  # chain of fixed transforms
                pw, pb = pending_fixed
                b = w @ pb + b
                w = w @ pw
            pending_fixed = (w, b)
        elif ctype in _AFFINE_TYPES:
            w = _matf(fields, "LinearParams", ctype)
            b = _vecf(fields, "BiasParams", ctype)
            if pending_fixed is not None:
                fw, fb = pending_fixed
                b = w @ fb + b
                w = w @ fw
                pending_fixed = None
            layers.append(_Layer(pending_offsets, w, b))
            pending_offsets = (0,)
        elif ctype == "FixedScaleComponent":
            s = _vecf(fields, "Scales", ctype)
            if not layers or layers[-1].pnorm_out is not None:
                raise Nnet2ParseError(
                    "FixedScaleComponent not directly after an affine")
            layers[-1].weight = s[:, None] * layers[-1].weight
            layers[-1].bias = s * layers[-1].bias
        elif ctype == "PnormComponent":
            p = _scalar(fields, "P")
            if p is not None and abs(p - 2.0) > 1e-6:
                raise Nnet2ParseError(f"PnormComponent P={p}: only p=2 maps "
                                      "to models.nnet2.PnormLayer")
            in_dim = _scalar(fields, "InputDim", as_int=True)
            out_dim = _scalar(fields, "OutputDim", as_int=True)
            if not layers or layers[-1].pnorm_out is not None:
                raise Nnet2ParseError("PnormComponent without a preceding "
                                      "affine")
            if in_dim != layers[-1].weight.shape[0] or in_dim % out_dim:
                raise Nnet2ParseError(
                    f"pnorm dims {in_dim}->{out_dim} inconsistent with "
                    f"affine out {layers[-1].weight.shape[0]}")
            layers[-1].pnorm_out = out_dim
            layers[-1].group = in_dim // out_dim
        elif ctype == "NormalizeComponent":
            if not layers or layers[-1].pnorm_out is None:
                raise Nnet2ParseError("NormalizeComponent outside a pnorm "
                                      "block")
        elif ctype == "SoftmaxComponent":
            saw_softmax = True
        else:
            raise Nnet2ParseError(
                f"component type {ctype} is not in the p-norm multisplice "
                "zoo (SumGroup/Dct/Dropout variants are not used by "
                "run_nnet2_multisplice.sh)")
    if pending_fixed is not None:
        raise Nnet2ParseError(
            "trailing FixedAffineComponent with no following affine to "
            "fold into — unsupported graph (silently dropping it would "
            "import a numerically wrong network)")
    if not saw_softmax:
        raise Nnet2ParseError("no SoftmaxComponent — not a posterior net")
    if feat_dim is None:
        # no splice at the input: take it from the first affine
        k = len(layers[0].offsets)
        feat_dim = layers[0].weight.shape[1] // k
    return layers, int(feat_dim)


def import_kaldi_nnet2(path: str, device: DeviceLike = "cuda"):
    """final.mdl -> (Nnet2Multisplice, state_dict, Nnet2Config, priors).

    The model is the port's, in eval mode on ``device`` with the file's
    weights; ``state_dict`` holds the same weights on the host.  Both plug
    straight into `recipes.nnet2_recipe.nnet2_posteriors(model, state_dict,
    feats)`.
    """
    from ..bridge import nnet2_state_dict_from_flax
    from ..models.nnet2 import Nnet2Config, Nnet2Multisplice
    from ..models.tdnn import TdnnSpec

    dev = resolve_device(device)
    comps, priors = read_nnet2_components(path)
    layers, feat_dim = _assemble_layers(comps)
    if len(layers) < 2:
        raise Nnet2ParseError("fewer than two affine layers")
    hidden, out = layers[:-1], layers[-1]
    if out.pnorm_out is not None:
        raise Nnet2ParseError("output affine is followed by a pnorm — "
                              "unexpected graph")
    pnorm_dims = {l.pnorm_out for l in hidden}
    groups = {l.group for l in hidden}
    if len(pnorm_dims) != 1 or len(groups) != 1:
        raise Nnet2ParseError(
            f"heterogeneous pnorm dims {pnorm_dims}/groups {groups}: "
            "Nnet2Config assumes the uniform multisplice architecture")
    pnorm_out, group = pnorm_dims.pop(), groups.pop()
    cfg = Nnet2Config(
        feat_dim=feat_dim,
        num_senones=out.weight.shape[0],
        pnorm_output_dim=pnorm_out,
        group_size=group,
        specs=tuple(TdnnSpec(pnorm_out, l.offsets) for l in hidden),
    )
    model = Nnet2Multisplice(cfg)

    params: Dict[str, Dict[str, Dict[str, np.ndarray]]] = {}
    in_dim = feat_dim
    for i, l in enumerate(hidden):
        k = len(l.offsets)
        if l.weight.shape[1] != k * in_dim:
            raise Nnet2ParseError(
                f"layer {i}: affine in {l.weight.shape[1]} != "
                f"{k} taps x {in_dim}")
        kernel = np.stack(
            [l.weight[:, j * in_dim : (j + 1) * in_dim].T for j in range(k)]
        ).astype(np.float32)  # (k, in, out)
        params[f"layer{i}"] = {"affine": {"kernel": kernel,
                                          "bias": l.bias.astype(np.float32)}}
        in_dim = pnorm_out
    if out.offsets != (0,):
        raise Nnet2ParseError("spliced output affine is not supported")
    if out.weight.shape[1] != in_dim:
        raise Nnet2ParseError(
            f"output affine in {out.weight.shape[1]} != {in_dim}")
    params["output"] = {"kernel": out.weight.T.astype(np.float32),
                        "bias": out.bias.astype(np.float32)}
    state_dict = nnet2_state_dict_from_flax({"params": params})
    model.load_state_dict(state_dict, strict=True)
    return model.to(dev).eval(), state_dict, cfg, priors
