"""Every public name of the JAX package has a counterpart in the port.

The test walks both packages' ASTs (no import, so nothing runs) and fails
on any public name of a `sepi_tpu` module, package export, or function,
method or constructor keyword that has no counterpart in the same module
of `sepi_tpu_torch`, unless `ALLOWED` lists it with the reason.  The
allow-list holds the port's idiom, once: Pallas-only knobs, PRNG keys
that became seeds, Flax variables and fields that became an `nn.Module`
or a state_dict, optax transformations that became the port's in-place
chain.  A stale entry (one that no longer differs) fails too, so the next
comparison stays mechanical.

Below the walk: the ``batched=`` keyword of the aligners (both values give
the reference's alignments) and `graft_entry.entry` against
`__graft_entry__.entry` through `bridge.py`.
"""

import ast
import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
REF, PORT = REPO / "sepi_tpu", REPO / "sepi_tpu_torch"

torch.set_num_threads(2)

# reference module -> the port's module of another name
RENAMED = {
    "ops/mfcc_pallas.py": "ops/mfcc_cuda.py",  # the Pallas MFCC -> csrc/mfcc.cu's wrapper
    "align/viterbi_pallas.py": "align/viterbi_cuda.py",  # the Pallas Viterbi -> csrc/viterbi.cu's
}
# reference modules the port has no counterpart of, with the reason
NOT_PORTED = {
    "utils/compile_cache.py": "the JAX compile cache: torch compiles nothing per program, "
                              "and build.py caches its nvcc builds by source hash",
}
# the entry points of the repository's top-level __graft_entry__.py
GRAFT_ENTRY = {"entry": "graft_entry.py", "dryrun_multichip": "parallel/dryrun.py"}

_PALLAS = "a Pallas kernel knob: the CUDA kernel picks its own tiles, precision and layout"
_KEY = "a JAX PRNG key: the port dithers and draws from explicit seeds or generators"
_FLAX_VARS = "Flax variables/params: the port passes the nn.Module (or its state_dict)"
_FLAX_MODEL = "the Flax model argument: the port's steps take the module from the state"
_FLAX_FIELD = ("a Flax dataclass field: batch norm's decay is the port's BatchNorm(decay=) "
               "default, and Flax's naming and stream plumbing have no torch counterpart")
_FLAX_TRAIN = "Flax's train= flag: torch modules switch with .train() / .eval()"

ALLOWED: Dict[str, str] = {
    # Pallas-only knobs
    "ops/mfcc_pallas.py:T_TILE": _PALLAS,
    "ops/mfcc_pallas.py:mfcc_fused(interpret)": _PALLAS,
    "ops/mfcc_pallas.py:mfcc_fused(t_tile)": _PALLAS,
    "ops/mfcc_pallas.py:mfcc_fused(precision)": _PALLAS + " (3xTF32 products)",
    "align/viterbi_pallas.py:viterbi_batch(interpret)": _PALLAS,
    "align/viterbi_pallas.py:viterbi_batch(bp_bits)": _PALLAS + " (int8 backpointers)",
    "align/viterbi_pallas.py:viterbi_batch(unroll)": _PALLAS,
    "align/mono.py:align_corpus(use_pallas)": "the port's alignment always runs the kernel",
    "align/mono.py:align_graphs(use_pallas)": "the port's alignment always runs the kernel",
    "align/tied.py:refine_tied_aligner(use_pallas)": "the port's alignment always runs the "
                                                     "kernel",
    # PRNG keys -> seeds
    "ops/dither.py:utt_seeds(key)": _KEY,
    "ops/features.py:mfcc(key)": _KEY,
    "ops/features.py:fbank(key)": _KEY,
    "ops/features.py:FeatureExtractor.mfcc(key)": _KEY,
    "ops/features.py:FeatureExtractor.fbank(key)": _KEY,
    "ops/framing.py:frame_signal(key)": _KEY,
    "train/trainer.py:create_train_state(rng)": _KEY + " (seed=)",
    # Flax variables / params / model -> the module or its state_dict
    "extract.py:streaming_embed(variables)": _FLAX_VARS,
    "extract.py:EmbeddingExtractor(variables)": _FLAX_VARS,
    "utils/nnet3.py:export_kaldi_raw(variables)": _FLAX_VARS,
    "train/graft.py:graft_subtree(target_variables)": _FLAX_VARS,
    "train/graft.py:graft_subtree(source_variables)": _FLAX_VARS,
    "train/optim.py:subtree_lr_factors(params)": _FLAX_VARS + " (parameter names)",
    "train/trainer.py:TrainState(params)": _FLAX_VARS,
    "train/trainer.py:TrainState(batch_stats)": _FLAX_VARS + " (its buffers)",
    "classical/gmm.py:accumulate_stats(gmm_params)": "the GMM pytree: the port passes its "
                                                     "GMM object (gmm=)",
    "classical/gmm.py:accumulate_stats_sharded(gmm_params)": "the GMM pytree: the port passes "
                                                             "its GMM object (gmm=)",
    "train/trainer.py:create_train_state(sample_feats)": "Flax traces the model on a sample "
                                                         "batch; torch needs none",
    "train/trainer.py:create_train_state(model_kwargs)": "Flax's init-time call arguments; "
                                                         "torch builds every branch eagerly",
    "train/trainer.py:make_xvec_step(model)": _FLAX_MODEL,
    "train/trainer.py:make_am_step(model)": _FLAX_MODEL,
    "train/trainer.py:make_superstep(model)": _FLAX_MODEL,
    "train/trainer.py:make_eval_step(model)": _FLAX_MODEL,
    "train/trainer.py:finalize_batch_stats(model)": _FLAX_MODEL,
    "recipes/pipeline.py:make_task_supersteps(model)": _FLAX_MODEL,
    # optax transformations -> the port's in-place chain (train/optim.OptimizerChain)
    "train/optim.py:proportional_shrink(schedule)": "an optax transformation with its lr "
                                                    "schedule: the port's shrink takes the "
                                                    "step's lr",
    # Flax module fields and call flags
    "models/tdnn.py:TdnnLayer(bn_momentum)": _FLAX_FIELD,
    "models/tdnn.py:TdnnStack(bn_momentum)": _FLAX_FIELD,
    "models/tdnn.py:TdnnStack(name_prefix)": _FLAX_FIELD,
    "models/tdnn.py:SegmentHead(bn_momentum)": _FLAX_FIELD,
    "models/xvector.py:XVector(bn_momentum)": _FLAX_FIELD,
    "models/cvector.py:AmNet(bn_momentum)": _FLAX_FIELD,
    "models/cvector.py:MultitaskCVector(bn_momentum)": _FLAX_FIELD,
    "models/cvector.py:AdaptedXVector(bn_momentum)": _FLAX_FIELD,
    "models/cvector.py:CombinedCVector(bn_momentum)": _FLAX_FIELD,
    "models/xvector.py:XVector.setup": "Flax's submodule hook: torch builds them in __init__",
    "models/tdnn.py:TdnnStack.__call__(stream)": "Flax's Stream input: the port's "
                                                 "TdnnStack.stream(Stream) method",
    "models/cvector.py:AmNet.__call__(with_logits)": "a constructor argument in the port "
                                                     "(AmNet(cfg, with_logits=))",
    "models/tdnn.py:TdnnLayer.__call__(train)": _FLAX_TRAIN,
    "models/tdnn.py:TdnnStack.__call__(train)": _FLAX_TRAIN,
    "models/tdnn.py:SegmentHead.__call__(train)": _FLAX_TRAIN,
    "models/xvector.py:XVector.trunk(train)": _FLAX_TRAIN,
    "models/xvector.py:XVector.head(train)": _FLAX_TRAIN,
    "models/xvector.py:XVector.__call__(train)": _FLAX_TRAIN,
    "models/cvector.py:AmNet.__call__(train)": _FLAX_TRAIN,
    "models/cvector.py:MultitaskCVector.__call__(train)": _FLAX_TRAIN,
    "models/cvector.py:AdaptedXVector.__call__(train)": _FLAX_TRAIN,
    "models/cvector.py:CombinedCVector.__call__(train)": _FLAX_TRAIN,
}


# ------------------------------------------------------------------ the walk


@dataclasses.dataclass
class Module:
    """What one module binds at its top level (statements under a
    top-level ``if`` or ``try`` included, a ``__main__`` block not)."""

    names: Set[str]
    defs: Dict[str, ast.FunctionDef]
    classes: Dict[str, ast.ClassDef]
    aliases: Dict[str, str]  # name = other_name
    imports: Dict[str, Tuple[int, Optional[str], str]]  # name -> (level, module, name)
    plain_imports: Set[str]
    exports: Set[str]  # __all__


def _main_guard(node) -> bool:
    t = node.test
    return (isinstance(t, ast.Compare) and isinstance(t.left, ast.Name)
            and t.left.id == "__name__")


def _top(body):
    for node in body:
        if isinstance(node, ast.If) and _main_guard(node):
            continue  # a script's own variables
        if isinstance(node, ast.If):
            yield from _top(node.body)
            yield from _top(node.orelse)
        elif isinstance(node, ast.Try):
            yield from _top(node.body)
            for h in node.handlers:
                yield from _top(h.body)
        else:
            yield node


def parse_module(source: str) -> Module:
    m = Module(set(), {}, {}, {}, {}, set(), set())
    for n in _top(ast.parse(source).body):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            m.names.add(n.name)
            m.defs[n.name] = n
        elif isinstance(n, ast.ClassDef):
            m.names.add(n.name)
            m.classes[n.name] = n
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            flat = [e for t in targets for e in (t.elts if isinstance(t, ast.Tuple) else [t])]
            for e in flat:
                if isinstance(e, ast.Name):
                    m.names.add(e.id)
                    if isinstance(n.value, ast.Name):
                        m.aliases[e.id] = n.value.id
                    if e.id == "__all__" and isinstance(n.value, (ast.List, ast.Tuple)):
                        m.exports |= {c.value for c in n.value.elts
                                      if isinstance(c, ast.Constant)}
        elif isinstance(n, ast.ImportFrom):
            for al in n.names:
                name = al.asname or al.name
                m.names.add(name)
                m.imports[name] = (n.level, n.module, al.name)
        elif isinstance(n, ast.Import):
            for al in n.names:
                name = (al.asname or al.name).split(".")[0]
                m.names.add(name)
                m.plain_imports.add(name)
    return m


def public_names(rel: str, m: Module) -> Set[str]:
    """A module's public names: what it defines (not what it imports for
    its own use); a package's ``__init__`` also its imports and
    ``__all__``."""
    init = rel.endswith("__init__.py")
    out = set(m.exports)
    for name in m.names:
        if name.startswith("_") or name in m.plain_imports:
            continue
        if name in m.imports and not init:
            continue
        out.add(name)
    return out


def _params(fn: ast.FunctionDef) -> Tuple[List[str], bool]:
    """(keyword-capable parameter names, takes **kwargs)."""
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return [n for n in names if n not in ("self", "cls")], a.kwarg is not None


def _fields(cls: ast.ClassDef) -> List[str]:
    return [s.target.id for s in cls.body
            if isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name)]


def _methods(cls: ast.ClassDef) -> Dict[str, ast.FunctionDef]:
    return {s.name: s for s in cls.body if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))}


class Package:
    """A package's modules, parsed once, with names resolved across its
    relative imports and aliases."""

    def __init__(self, root: Path, sources: Optional[Dict[str, str]] = None):
        self.root = root
        if sources is None:
            sources = {str(p.relative_to(root)): p.read_text() for p in root.rglob("*.py")}
        self.modules = {rel: parse_module(src) for rel, src in sources.items()}

    def _target(self, rel: str, level: int, module: Optional[str]) -> Optional[str]:
        parts = Path(rel).parent.parts
        if level == 0 or level - 1 > len(parts):
            return None
        base = list(parts[:len(parts) - (level - 1)])
        mod = base + (module.split(".") if module else [])
        for cand in ("/".join(mod) + ".py", "/".join(mod + ["__init__.py"])):
            if cand.lstrip("/") in self.modules:
                return cand.lstrip("/")
        return None

    def resolve(self, rel: str, name: str, depth: int = 0):
        """The FunctionDef or ClassDef that ``name`` in module ``rel``
        stands for, following aliases and relative imports; None where it
        leaves the package or binds something else."""
        m = self.modules.get(rel)
        if m is None or depth > 8:
            return None
        if name in m.defs:
            return m.defs[name]
        if name in m.classes:
            return m.classes[name]
        if name in m.aliases:
            return self.resolve(rel, m.aliases[name], depth + 1)
        if name in m.imports:
            level, module, orig = m.imports[name]
            target = self._target(rel, level, module)
            if target is not None:
                return self.resolve(target, orig, depth + 1)
            sub = self._target(rel, level, f"{module}.{orig}" if module else orig)
            return None if sub is None else self.modules[sub]
        return None

    def class_methods(self, rel: str, cls: ast.ClassDef, depth: int = 0):
        """A class's methods, with those of its bases in the package."""
        out = {}
        for base in cls.bases:
            if isinstance(base, ast.Name) and depth < 8:
                b = self.resolve(rel, base.id)
                if isinstance(b, ast.ClassDef):
                    out.update(self.class_methods(rel, b, depth + 1))
        out.update(_methods(cls))
        return out

    def class_fields(self, rel: str, cls: ast.ClassDef, depth: int = 0) -> List[str]:
        out = []
        for base in cls.bases:
            if isinstance(base, ast.Name) and depth < 8:
                b = self.resolve(rel, base.id)
                if isinstance(b, ast.ClassDef):
                    out += self.class_fields(rel, b, depth + 1)
        return out + _fields(cls)


def _missing_keywords(ref_fn, port_fn) -> List[str]:
    rp, _ = _params(ref_fn)
    pp, kwargs = _params(port_fn)
    return [] if kwargs else [p for p in rp if p not in pp]


def _public_method(name: str) -> bool:
    return not name.startswith("_") or name in ("__init__", "__call__")


def compare_module(rel: str, ref: Package, port: Package, port_rel: str) -> List[str]:
    """Every difference of reference module ``rel`` against the port's
    ``port_rel``, as allow-list keys."""
    out = []
    rm, pm = ref.modules[rel], port.modules[port_rel]
    for name in sorted(public_names(rel, rm)):
        if name not in pm.names:
            out.append(f"{rel}:{name}")
            continue
        if name not in rm.defs and name not in rm.classes:
            continue  # an import or alias: its keywords are checked where it is defined
        r, p = ref.resolve(rel, name), port.resolve(port_rel, name)
        if isinstance(r, ast.FunctionDef) and isinstance(p, ast.FunctionDef):
            out += [f"{rel}:{name}({k})" for k in _missing_keywords(r, p)]
        elif isinstance(r, ast.ClassDef) and isinstance(p, ast.ClassDef):
            out += _compare_class(rel, name, r, p, ref, port, port_rel)
    return out


def _compare_class(rel, name, r, p, ref, port, port_rel) -> List[str]:
    out = []
    rmeth = ref.class_methods(rel, r)
    pmeth = port.class_methods(port_rel, p)
    # constructor keywords: the dataclass (or Flax) fields, or __init__'s
    pinit = _params(pmeth["__init__"]) if "__init__" in pmeth else ([], False)
    pctor = set(port.class_fields(port_rel, p)) | set(pinit[0])
    rctor = list(ref.class_fields(rel, r))
    if "__init__" in _methods(r):
        rctor += _params(_methods(r)["__init__"])[0]
    if not pinit[1]:
        out += [f"{rel}:{name}({f})" for f in dict.fromkeys(rctor) if f not in pctor]
    for mname, rfn in _methods(r).items():
        if not _public_method(mname) or mname == "__init__":
            continue
        target = mname
        if mname == "__call__" and "__call__" not in pmeth and "forward" in pmeth:
            target = "forward"  # a Flax module's call is a torch module's forward
        if target not in pmeth:
            out.append(f"{rel}:{name}.{mname}")
            continue
        out += [f"{rel}:{name}.{mname}({k})" for k in _missing_keywords(rfn, pmeth[target])]
    return out


def graft_entry_differences(ref: Package, port: Package) -> List[str]:
    g = parse_module((REPO / "__graft_entry__.py").read_text())
    out = []
    for name, port_rel in GRAFT_ENTRY.items():
        p = port.resolve(port_rel, name)
        if not isinstance(p, ast.FunctionDef):
            out.append(f"__graft_entry__.py:{name}")
        else:
            out += [f"__graft_entry__.py:{name}({k})" for k in _missing_keywords(g.defs[name], p)]
    missing = set(public_names("__graft_entry__.py", g)) - set(GRAFT_ENTRY)
    return out + [f"__graft_entry__.py:{n}" for n in sorted(missing)]


REF_PKG, PORT_PKG = Package(REF), Package(PORT)
REF_MODULES = sorted(r for r in REF_PKG.modules if r not in NOT_PORTED)


def _differences(rel: str) -> List[str]:
    return compare_module(rel, REF_PKG, PORT_PKG, RENAMED.get(rel, rel))


def test_every_reference_module_has_a_counterpart():
    missing = [r for r in REF_PKG.modules
               if RENAMED.get(r, r) not in PORT_PKG.modules and r not in NOT_PORTED]
    assert missing == []
    for r in list(NOT_PORTED) + list(RENAMED):
        assert r in REF_PKG.modules, f"stale entry {r}"
    for r in NOT_PORTED:
        assert r not in PORT_PKG.modules, f"{r} is ported now: drop it from NOT_PORTED"


@pytest.mark.parametrize("rel", REF_MODULES)
def test_module_names_and_keywords_have_counterparts(rel):
    """Public names, package exports, and function, method and constructor
    keywords of the reference module, outside `ALLOWED`."""
    unlisted = [d for d in _differences(rel) if d not in ALLOWED]
    assert unlisted == [], f"{rel}: no counterpart in sepi_tpu_torch for {unlisted}"


def test_graft_entry_has_counterparts():
    assert graft_entry_differences(REF_PKG, PORT_PKG) == []


def test_allow_list_is_current():
    """Every allow-listed difference still exists, so the list shrinks as
    the port grows."""
    found = {d for rel in REF_MODULES for d in _differences(rel)}
    assert sorted(set(ALLOWED) - found) == []


def test_walk_sees_the_packages():
    """The walk compares what it should: hundreds of names, the exports of
    the package inits, and the keywords of known functions."""
    names = sum(len(public_names(r, REF_PKG.modules[r])) for r in REF_MODULES)
    assert names > 400, names
    assert "plda_score_matrix_sharded" in public_names("backend/__init__.py",
                                                       REF_PKG.modules["backend/__init__.py"])
    fn = PORT_PKG.resolve("train/__init__.py", "am_train_step")
    assert isinstance(fn, ast.FunctionDef) and fn.name == "make_am_step"
    assert "spectral_mode" in _params(_methods(
        PORT_PKG.modules["ops/features.py"].classes["FeatureExtractor"])["__init__"])[0]


def test_walk_flags_a_missing_name_export_and_keyword():
    """Planted gaps in a synthetic pair of packages are all reported."""
    ref = Package(Path("ref"), {
        "__init__.py": "from .mod import f, G, H\n__all__ = ['f', 'G', 'H', 'K']\n",
        "mod.py": ("import numpy as np\nfrom .other import helper\nX = 1\n"
                   "def f(a, key=None, new=2):\n    pass\n"
                   "class G:\n    field: int = 0\n    def __call__(self, x, train=False):\n"
                   "        pass\n    def extra(self):\n        pass\n"
                   "H = f\n"),
        "other.py": "def helper():\n    pass\n",
    })
    port = Package(Path("port"), {
        "__init__.py": "from .mod import f, G\n",
        "mod.py": ("import numpy as np\ndef f(a):\n    pass\n"
                   "class G:\n    def __init__(self, field=0):\n        pass\n"
                   "    def forward(self, x):\n        pass\n"),
        "other.py": "def helper():\n    pass\n",
    })
    got = set(compare_module("__init__.py", ref, port, "__init__.py")
              + compare_module("mod.py", ref, port, "mod.py"))
    assert got == {"__init__.py:H", "__init__.py:K", "mod.py:X", "mod.py:f(key)",
                   "mod.py:f(new)", "mod.py:G.__call__(train)", "mod.py:G.extra",
                   "mod.py:H"}, got


# ----------------------------------------------------- batched= and entry()


def test_batched_keyword_gives_equal_alignments():
    """Both values of ``batched`` on the aligners give the same alignments,
    equal to the reference's per-utterance and batched routes."""
    from test_torch_align import J_LEX, SENTENCES, T_LEX, _bridge, _speak

    from sepi_tpu.align import mono as jm
    from sepi_tpu_torch.align import mono as tm
    from sepi_tpu_torch.align import tied as tt

    rng = np.random.default_rng(21)
    features, transcripts = {}, {}
    for i, words in enumerate(SENTENCES * 2):
        features[f"u{i:02d}"], _ = _speak(rng, words)
        transcripts[f"u{i:02d}"] = words
    j = jm.train_mono_aligner(features, transcripts, J_LEX, num_iters=2)
    t = _bridge(j)
    want = jm.align_corpus(j, features, transcripts, J_LEX, batched=False)
    want_b = jm.align_corpus(j, features, transcripts, J_LEX, batched=True, use_pallas=False)
    for batched in (False, True):
        got = tm.align_corpus(t, features, transcripts, T_LEX, batched=batched, device="cpu")
        for u in features:
            np.testing.assert_array_equal(got[u], want[u])
            np.testing.assert_array_equal(got[u], want_b[u])
    kw = dict(num_leaves=len(T_LEX.phones) * 3 + 4, mono_iters=2, min_count=10.0)
    tied = {b: tt.train_tied_aligner(features, transcripts, T_LEX, batched=b, device="cpu",
                                     **kw) for b in (False, True)}
    np.testing.assert_array_equal(tied[False].tree.dense_table(), tied[True].tree.dense_table())
    sen = {b: tied[True].senone_alignments(features, transcripts, batched=b, device="cpu")
           for b in (False, True)}
    ref = {b: tt.refine_tied_aligner(tied[True], features, transcripts, num_iters=1,
                                     batched=b, device="cpu") for b in (False, True)}
    for u in features:
        np.testing.assert_array_equal(sen[False][u], sen[True][u])
        np.testing.assert_array_equal(ref[False].alignments[u], ref[True].alignments[u])


EMB_TOL = 1e-4  # of the embedding's scale


def test_graft_entry_matches_reference_entry():
    """`graft_entry.entry(device="cpu")` against `__graft_entry__.entry()`:
    the same example features, and the reference's initial weights bridged
    into the port's model give its embedding within 1e-4 of its scale."""
    import __graft_entry__ as jentry

    from sepi_tpu_torch.bridge import xvector_state_dict_from_flax
    from sepi_tpu_torch.graft_entry import entry

    jfwd, (variables, jfeats) = jentry.entry()
    fwd, (model, feats) = entry(device="cpu")
    np.testing.assert_array_equal(feats.numpy(), np.asarray(jfeats))
    assert model.cfg.num_speakers == 5000 and not model.training
    own = fwd(model, feats)
    assert own.shape == (8, 512) and torch.isfinite(own).all()
    model.load_state_dict(xvector_state_dict_from_flax(
        {k: _np_tree(v) for k, v in variables.items()}))
    got = fwd(model, feats).numpy()
    want = np.asarray(jfwd(variables, jfeats))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= EMB_TOL * scale, (np.abs(got - want).max(), scale)


def _np_tree(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.array(tree, copy=True)
