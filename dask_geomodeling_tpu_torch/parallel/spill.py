"""Disk spilling for scheduler intermediates (dask.distributed analog).

Counterpart of dask_geomodeling_tpu/parallel/spill.py, copied.

dask.distributed workers spill least-recently-used task results to disk
when memory passes a watermark; this buffer does the same for the host
schedulers' intermediate-result cache, gated by
``geomodeling.scheduler-memory-limit`` (bytes of in-memory payload
before spilling starts).  Values pickle to files under a private
temporary directory; reads unpickle transparently and promote the value
back to memory.
"""
import os
import pickle
import shutil
import tempfile
import threading
from collections import OrderedDict

import numpy as np

__all__ = ["SpillBuffer"]


def _payload_bytes(value):
    """Approximate in-memory size: ndarray payloads dominate here."""
    if isinstance(value, np.ndarray):
        return value.nbytes
    if isinstance(value, dict):
        return sum(_payload_bytes(v) for v in value.values()) + 64
    if isinstance(value, (list, tuple)):
        return sum(_payload_bytes(v) for v in value) + 64
    return 64


class SpillBuffer:
    """A dict of task results that keeps at most ``limit`` payload bytes
    in memory, spilling the least recently used entries to disk."""

    def __init__(self, limit, directory=None):
        self.limit = int(limit)
        self._hot = OrderedDict()  # key -> (value, nbytes)
        self._hot_bytes = 0
        self._spilled = {}  # key -> file path
        self._dir = tempfile.mkdtemp(
            prefix="geomodeling-spill-", dir=directory
        )
        self._lock = threading.RLock()
        self._counter = 0
        #: observability: how many spills/restores happened
        self.n_spilled = 0
        self.n_restored = 0

    def _evict_to_limit(self):
        while self._hot_bytes > self.limit and len(self._hot) > 1:
            key, (value, nbytes) = self._hot.popitem(last=False)
            self._hot_bytes -= nbytes
            path = os.path.join(self._dir, "spill-%d.pkl" % self._counter)
            self._counter += 1
            with open(path, "wb") as f:
                pickle.dump(value, f, protocol=pickle.HIGHEST_PROTOCOL)
            self._spilled[key] = path
            self.n_spilled += 1

    def __setitem__(self, key, value):
        with self._lock:
            self.pop(key, None)
            nbytes = _payload_bytes(value)
            self._hot[key] = (value, nbytes)
            self._hot_bytes += nbytes
            self._evict_to_limit()

    def __getitem__(self, key):
        with self._lock:
            if key in self._hot:
                value, nbytes = self._hot[key]
                self._hot.move_to_end(key)
                return value
            path = self._spilled.pop(key)
            with open(path, "rb") as f:
                value = pickle.load(f)
            os.remove(path)
            self.n_restored += 1
            # promote back to memory (it is about to be consumed)
            nbytes = _payload_bytes(value)
            self._hot[key] = (value, nbytes)
            self._hot_bytes += nbytes
            self._evict_to_limit()
            return value

    def __contains__(self, key):
        with self._lock:
            return key in self._hot or key in self._spilled

    def pop(self, key, default=None):
        with self._lock:
            if key in self._hot:
                value, nbytes = self._hot.pop(key)
                self._hot_bytes -= nbytes
                return value
            path = self._spilled.pop(key, None)
            if path is None:
                return default
            with open(path, "rb") as f:
                value = pickle.load(f)
            os.remove(path)
            return value

    def __len__(self):
        with self._lock:
            return len(self._hot) + len(self._spilled)

    def close(self):
        with self._lock:
            self._hot.clear()
            self._spilled.clear()
            shutil.rmtree(self._dir, ignore_errors=True)
