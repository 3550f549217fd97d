"""Durable stage artifacts — the --stage resume system.

The reference's resumability (SURVEY.md §5 "Checkpoint / resume") rests
on every phase writing durable artifacts and `--stage N` skipping
completed work.  Here a stage is a pure function whose output is cached
on disk keyed by a content hash of its configuration: re-running a
recipe skips every stage whose inputs haven't changed — the same
property, without manual stage numbers.

Artifacts are dicts of numpy arrays (npz) + a JSON meta sidecar.  Nested
dicts flatten with '/' separators.

A copy of `sepi_tpu/utils/artifacts.py`: the same keys for the same
configs, and the same files, so a workdir of either package resumes in
the other.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np


def config_key(*objs: Any) -> str:
    """Stable hash of (nested) configs/values used as the cache key."""

    def canon(o):
        if isinstance(o, Mapping):
            return {str(k): canon(v) for k, v in sorted(o.items())}
        if isinstance(o, (list, tuple)):
            return [canon(v) for v in o]
        if isinstance(o, np.ndarray):
            return ["ndarray", o.shape, str(o.dtype), hashlib.sha1(o.tobytes()).hexdigest()]
        if hasattr(o, "__dataclass_fields__"):
            return {f: canon(getattr(o, f)) for f in sorted(o.__dataclass_fields__)}
        return repr(o)

    blob = json.dumps([canon(o) for o in objs], sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def _flatten(d: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(d: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in d.items():
        parts = k.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


class ArtifactCache:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _paths(self, stage: str, key: str):
        base = os.path.join(self.root, f"{stage}-{key}")
        return base + ".npz", base + ".json"

    def has(self, stage: str, key: str) -> bool:
        return os.path.exists(self._paths(stage, key)[0])

    def save(self, stage: str, key: str, arrays: Mapping[str, Any], meta: Optional[Dict] = None):
        npz, js = self._paths(stage, key)
        tmp = npz + ".tmp.npz"
        np.savez(tmp, **_flatten(arrays))
        os.replace(tmp, npz)  # write-to-temp-then-rename, like the reference
        with open(js, "w") as f:
            json.dump(meta or {}, f)

    def load(self, stage: str, key: str):
        npz, js = self._paths(stage, key)
        with np.load(npz, allow_pickle=False) as z:
            arrays = _unflatten({k: z[k] for k in z.files})
        meta = json.load(open(js)) if os.path.exists(js) else {}
        return arrays, meta

    def stage(
        self,
        name: str,
        key_objs: Any,
        fn: Callable[[], Mapping[str, Any]],
        meta: Optional[Dict] = None,
        log: Optional[Callable[[str], None]] = None,
    ) -> Dict[str, Any]:
        """Run-or-load: the --stage skip, keyed by config content."""
        key = config_key(key_objs)
        if self.has(name, key):
            if log:
                log(f"[{name}] cached ({key})")
            return self.load(name, key)[0]
        if log:
            log(f"[{name}] running ({key})")
        out = fn()
        self.save(name, key, out, meta)
        return self.load(name, key)[0]

    def stage_store(
        self,
        name: str,
        key_objs: Any,
        fn: Callable[[], Any],
        log: Optional[Callable[[str], None]] = None,
    ):
        """Feature-store artifact kind: the corpus-scale sibling of
        `stage`.

        ``fn`` returns an ITERATOR of (utt_id, (T, D) array) pairs; they
        stream straight into a memory-mapped `data.featstore.FeatStore`
        (one utterance resident at a time), and a cache hit reopens the
        mmap without recompute.  The returned store is a Mapping whose
        rows are lazy mmap views, so samplers/extraction consume it
        exactly like a features dict while RSS stays flat at any corpus
        size — the `prepare_feats_for_egs.sh` disk-streaming property
        that monolithic npz artifacts lack.
        """
        from ..data.featstore import FeatStore

        key = config_key(key_objs)
        prefix = os.path.join(self.root, f"{name}-{key}.store")
        if os.path.exists(prefix + ".json") and os.path.exists(prefix + ".npy"):
            if log:
                log(f"[{name}] cached ({key})")
            return FeatStore.open(prefix)
        if log:
            log(f"[{name}] running ({key})")
        return FeatStore.write_stream(prefix, fn())
