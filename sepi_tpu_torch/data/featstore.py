"""On-disk feature store and background minibatch prefetch.

Port of `sepi_tpu/data/featstore.py`.  The durable artifact of a feature
stage is a memory-mapped store: one flat ``.npy`` of float32 frames and a
``.json`` index (utt -> (row offset, rows)), the reference's layout, so
each package opens a store the other wrote.  Prefetch is a background
thread that keeps a bounded queue of ready minibatches ahead of the card
(the reference's ``ark,bg:`` reader).

Usage::

    FeatStore.write("feats", features_dict)        # once, durable
    store = FeatStore.open("feats")                # mmap, zero-copy rows
    sampler = ChunkSampler(store, dataset, ...)    # Mapping interface
    for batch in PrefetchLoader(iter(sampler), depth=4): ...

The rows of an opened store are read-only views: the samplers and the
extractor copy them into their batches, so nothing writes through them.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Dict, Iterable, Iterator, Mapping, Optional

import numpy as np

from ..utils.logging import span


class FeatStore(Mapping):
    """Memory-mapped utt -> (T, D) feature table.

    Rows for one utterance are contiguous, so slicing a chunk out of an
    utterance touches only the pages it needs — sampling cost is
    independent of corpus size (the property the reference buys with its
    per-archive egs dumps, without the multi-TB duplication).
    """

    def __init__(self, data: np.ndarray, index: Dict[str, tuple]):
        self._data = data
        self._index = index

    @classmethod
    def write(cls, path_prefix: str, features: Mapping[str, np.ndarray]) -> "FeatStore":
        """One-shot write of an in-memory dict (tests / small corpora)."""
        return cls.write_stream(path_prefix, features.items())

    @classmethod
    def write_stream(cls, path_prefix: str,
                     items: Iterable[tuple]) -> "FeatStore":
        """Stream (utt_id, (T, D) array) pairs into a store.

        The corpus-scale entry point: holds ONE utterance's features at a
        time (the `prepare_feats_for_egs.sh` disk-streaming property), so
        driver RSS stays flat however large the feature set is.  The .npy
        header is written with a placeholder shape and patched on close —
        the total row count isn't known up front.
        """
        os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
        w = _StreamWriter(path_prefix)
        try:
            for u, f in items:
                w.add(u, f)
        except BaseException:
            w.abort()
            raise
        w.close()
        return cls.open(path_prefix)

    @classmethod
    def open(cls, path_prefix: str) -> "FeatStore":
        with open(path_prefix + ".json") as fh:
            meta = json.load(fh)
        data = np.load(path_prefix + ".npy", mmap_mode="r")
        return cls(data, {k: tuple(v) for k, v in meta["index"].items()})

    # -- Mapping interface (works anywhere a features dict is accepted) --
    def __getitem__(self, utt: str) -> np.ndarray:
        off, n = self._index[utt]
        return self._data[off : off + n]

    def __iter__(self):
        return iter(self._index)

    def __len__(self):
        return len(self._index)

    def __contains__(self, utt):
        return utt in self._index


class _StreamWriter:
    """Incremental writer behind `FeatStore.write_stream`.

    Appends float32 rows to ``<prefix>.npy.tmp`` behind a placeholder
    .npy header (total row count is unknown until the stream ends), then
    patches the header with the final shape and renames both files into
    place — write-temp-then-rename isolation, like the reference's
    feature dumps.
    """

    def __init__(self, path_prefix: str):
        self.prefix = path_prefix
        self._f = open(path_prefix + ".npy.tmp", "wb")
        self._dim: Optional[int] = None
        self._off = 0
        self._index: Dict[str, tuple] = {}
        self._hdr_len = 0

    @staticmethod
    def _header(shape) -> bytes:
        import io

        buf = io.BytesIO()
        np.lib.format.write_array_header_1_0(
            buf, {"descr": "<f4", "fortran_order": False, "shape": shape}
        )
        return buf.getvalue()

    def add(self, utt: str, feats: np.ndarray) -> None:
        f = np.ascontiguousarray(feats, np.float32)
        if f.ndim != 2:
            raise ValueError(f"{utt}: expected (T, D) features, got {f.shape}")
        if self._dim is None:
            self._dim = int(f.shape[1])
            # placeholder with the widest plausible row count so the
            # final header can only be the same length or shorter
            hdr = self._header((10**15, self._dim))
            self._hdr_len = len(hdr)
            self._f.write(hdr)
        elif f.shape[1] != self._dim:
            raise ValueError(f"{utt}: dim {f.shape[1]} != {self._dim}")
        if utt in self._index:
            raise ValueError(f"duplicate utterance {utt}")
        self._f.write(f.tobytes())
        self._index[utt] = (self._off, int(f.shape[0]))
        self._off += int(f.shape[0])

    def close(self) -> None:
        if self._dim is None:  # empty stream: a valid, empty store
            self._dim = 0
            hdr = self._header((0, 0))
            self._hdr_len = len(hdr)
            self._f.write(hdr)
        else:
            hdr = self._header((self._off, self._dim))
            if len(hdr) < self._hdr_len:  # pad before the closing newline
                hdr = hdr[:-1] + b" " * (self._hdr_len - len(hdr)) + b"\n"
            elif len(hdr) > self._hdr_len:
                raise RuntimeError("npy header grew past its placeholder")
            self._f.seek(0)
            self._f.write(hdr)
        self._f.close()
        with open(self.prefix + ".json.tmp", "w") as fh:
            json.dump({"dim": self._dim, "index": self._index}, fh)
        os.replace(self.prefix + ".npy.tmp", self.prefix + ".npy")
        os.replace(self.prefix + ".json.tmp", self.prefix + ".json")

    def abort(self) -> None:
        self._f.close()
        for suffix in (".npy.tmp", ".json.tmp"):
            try:
                os.remove(self.prefix + suffix)
            except FileNotFoundError:
                pass


class PrefetchLoader:
    """Wraps a batch iterator; a daemon thread keeps up to ``depth``
    batches ready.  An exception in the producer reaches the consumer at
    its next ``__next__``.  Each draw is the span ``train.sample``
    (`utils.logging`), on the producer thread's own stack."""

    _DONE = object()

    def __init__(self, it: Iterable, depth: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = False
        self._thread = threading.Thread(target=self._run, args=(iter(it),), daemon=True)
        self._thread.start()

    def _run(self, it: Iterator):
        try:
            while True:
                with span("train.sample"):
                    item = next(it, self._DONE)
                if item is self._DONE:
                    break
                while not self._stop:
                    try:
                        self._q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if self._stop:
                    return
        except BaseException as e:  # handed to the consumer
            self._err = e
        finally:
            if not self._stop:
                self._q.put(self._DONE)

    def close(self) -> None:
        """Stop the producer and join it.  Callers reuse the wrapped
        sampler right after (calibration draws), and its RNG state is not
        thread-safe, so this returns only once the thread has exited; the
        producer sees the flag at its next put (0.2 s poll)."""
        self._stop = True
        try:  # unblock a producer waiting on a full queue
            self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
