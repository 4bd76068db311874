"""The port's configuration: a thread-safe key/value store.

Counterpart of dask_geomodeling_tpu/config.py (``Config``), holding only
the keys the port reads.  There is no executor switch: the port always
runs its torch twins, on the device ``geomodeling.torch-device`` names
unless the caller passes one.

Usage::

    from dask_geomodeling_tpu_torch.config import config
    with config.set({"geomodeling.tile-size": 256}):
        ...
"""
import threading
from contextlib import ContextDecorator

__all__ = ["config", "defaults"]

defaults = {
    # device of the entry points when the caller passes none
    "geomodeling.torch-device": "cuda",
    # tile edge of the batched tile runtime (pixels); a vals request
    # larger than one tile runs as tiles
    "geomodeling.tile-size": 512,
    # tiles per batch of the tile runtime
    "geomodeling.tile-batch": 64,
    # warp resampling of the sources: "nearest" (GDAL's
    # GRA_NearestNeighbour, the reference's choice) or "bilinear"
    "geomodeling.warp-interpolation": "nearest",
}

_MISSING = object()


class Config:
    """Thread-safe key/value configuration with context-manager overrides."""

    def __init__(self, values):
        self._lock = threading.RLock()
        self._values = dict(values)

    def get(self, key, default=KeyError):
        with self._lock:
            if key in self._values:
                return self._values[key]
        if default is KeyError:
            raise KeyError(key)
        return default

    def set(self, values=None, **kwargs):
        """Set config values; returns a context manager restoring old values.

        Accepts a dict of dotted keys and/or keyword arguments with ``__``
        as the dot separator.
        """
        updates = dict(values or {})
        for key, val in kwargs.items():
            updates[key.replace("__", ".")] = val
        with self._lock:
            old = {k: self._values.get(k, _MISSING) for k in updates}
            self._values.update(updates)
        return _ConfigRestore(self, old)

    def _restore(self, old):
        with self._lock:
            for key, val in old.items():
                if val is _MISSING:
                    self._values.pop(key, None)
                else:
                    self._values[key] = val


class _ConfigRestore(ContextDecorator):
    def __init__(self, cfg, old):
        self._cfg = cfg
        self._old = old

    def __enter__(self):
        return self._cfg

    def __exit__(self, *exc):
        self._cfg._restore(self._old)
        return False


config = Config(defaults)
