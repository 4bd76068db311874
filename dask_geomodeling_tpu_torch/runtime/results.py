"""Opt-in cross-request result cache for raster serving workloads.

Counterpart of dask_geomodeling_tpu/runtime/results.py.  A tile server
renders the same (view, tile) pairs again and again; this LRU answers
them at the ``get_data`` boundary, keyed by the same tokens the graph
dedup uses, plus the device a vals request resolved to: a CPU answer is
never handed to a request for the card (the two may differ in the last
bits, e.g. on a cross-CRS bilinear warp).  A time or meta request runs on
the host whatever the device, and is keyed without one.

Off by default (``geomodeling.result-cache-size`` = 0 bytes): responses
of file-backed sources can go stale when files change on disk.  Serving
deployments with immutable inputs opt in; call :func:`clear` after
updating inputs.

Stored responses are frozen (ndarrays copied read-only); hits hand out
shallow dict copies sharing the read-only arrays, so an accidental
in-place mutation raises instead of corrupting the cache.
"""
import threading
from collections import OrderedDict

import numpy as np

__all__ = ["get_or_compute", "clear", "stats"]

_LOCK = threading.Lock()
_CACHE = OrderedDict()  # key -> (frozen_response, nbytes)
_BYTES = [0]
_STATS = {"hits": 0, "misses": 0, "evictions": 0}


def _freeze(response):
    """(frozen response, approximate nbytes); None for uncacheable."""
    if response is None:
        return None, 64
    if not isinstance(response, dict):
        return _MISS, 0  # only the protocol's dict responses are cached
    frozen = {}
    nbytes = 128
    for key, value in response.items():
        if isinstance(value, np.ndarray):
            value = value.copy()
            value.setflags(write=False)
            nbytes += value.nbytes
        elif isinstance(value, (list, tuple)):
            # remember the container kind so hits round-trip it exactly
            value = (_WasList if isinstance(value, list) else tuple)(value)
            nbytes += 64 * (len(value) + 1)
        elif isinstance(value, (int, float, str, bytes, type(None), np.generic)):
            nbytes += 64
        else:
            return _MISS, 0  # unknown payload: do not cache
        frozen[key] = value
    return frozen, nbytes


def _thaw(frozen):
    if frozen is None:
        return None
    return {
        key: list(value) if isinstance(value, _WasList) else value
        for key, value in frozen.items()
    }


class _WasList(tuple):
    """A tuple remembering its source was a list (thawed back to one)."""

    __slots__ = ()


class _Miss:
    __slots__ = ()


_MISS = _Miss()


def get_or_compute(block, request, compute, max_bytes, device=None):
    """The cached response for (block, request, device), computing on a
    miss."""
    from dask_geomodeling_tpu_torch.core.tokens import tokenize

    parts = [block.token, request]
    if device is not None:
        parts.append(str(device))
    key = tokenize(parts)
    with _LOCK:
        entry = _CACHE.get(key)
        if entry is not None:
            _CACHE.move_to_end(key)
            _STATS["hits"] += 1
            return _thaw(entry[0])
        _STATS["misses"] += 1
    response = compute()
    frozen, nbytes = _freeze(response)
    if frozen is _MISS or nbytes > max_bytes:
        return response
    with _LOCK:
        if key not in _CACHE:
            _CACHE[key] = (frozen, nbytes)
            _BYTES[0] += nbytes
        while _BYTES[0] > max_bytes and _CACHE:
            _, (_, evicted) = _CACHE.popitem(last=False)
            _BYTES[0] -= evicted
            _STATS["evictions"] += 1
    # the caller gets its own freshly computed response back (mutable
    # arrays, original container types) — only later HITS see frozen
    # copies, so enabling the cache never changes miss-path semantics
    return response


def clear():
    """Drop all cached responses and zero the counters (call after
    inputs change on disk)."""
    with _LOCK:
        _CACHE.clear()
        _BYTES[0] = 0
        for key in _STATS:
            _STATS[key] = 0


def stats():
    """{"hits", "misses", "evictions", "entries", "bytes"} counters."""
    with _LOCK:
        out = dict(_STATS)
        out["entries"] = len(_CACHE)
        out["bytes"] = _BYTES[0]
        return out
