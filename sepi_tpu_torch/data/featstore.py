"""Background minibatch prefetch (the reference's ``ark,bg:`` reader).

Port of `PrefetchLoader` from `sepi_tpu/data/featstore.py`; the mmap
`FeatStore` is not ported yet.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional


class PrefetchLoader:
    """Wraps a batch iterator; a daemon thread keeps up to ``depth``
    batches ready.  An exception in the producer reaches the consumer at
    its next ``__next__``."""

    _DONE = object()

    def __init__(self, it: Iterable, depth: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = False
        self._thread = threading.Thread(target=self._run, args=(iter(it),), daemon=True)
        self._thread.start()

    def _run(self, it: Iterator):
        try:
            for item in it:
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
