"""Per-request executor routing for ``geomodeling.executor = "auto"``.

Counterpart of dask_geomodeling_tpu/runtime/router.py, with its choices
and constants: per (view, request size) the request runs on the host
(``compute_host``, the route "numpy") or on the card (the tile runtime
or ``compute_torch``, the route "torch"), by measured rates:

- the first request of a kind runs on the host (it produces the host
  rate),
- the next two eligible requests run on the card: the first card run
  only warms (its time holds one-off costs: kernel builds, the caches
  of a first request), the second produces the card rate,
- every request after that takes the measured winner; the card must win
  by ``geomodeling.auto-margin``, a borderline card rate gets one more
  measured run, and every 32 host routes one request measures the card
  again.

Requests too small to amortize a launch (``geomodeling.auto-min-device-px``)
and non-vals requests always run on the host.  Rates are exponential
moving averages (weight 0.4) keyed by (view token, log2 size bucket),
kept for 4096 keys (LRU) and saved to ``geomodeling.router-state``
every 32 measurements and at exit.

The JAX package's failure path is not copied: there a device exception
serves the request from the host and, repeated, pins the key to the
host.  In the port a card error raises to the caller, measures nothing
and pins nothing.
"""
import atexit
import collections
import json
import math
import os
import threading
import time

__all__ = ["choose", "route_of", "state_of", "record", "reset", "stats", "save", "load",
           "timed_route"]

_EMA_ALPHA = 0.4

#: routing-table entries kept (LRU); bounds long-running services
_MAX_ROUTES = 4096

#: measurement updates between automatic state saves (when
#: ``geomodeling.router-state`` names a file)
_SAVE_EVERY = 32

#: host-routed requests between card refresh probes: a key whose card
#: rate measured slow once must not stay on the host forever, since the
#: EMA only moves on runs that happen
_REFRESH_EVERY = 32

_lock = threading.Lock()
#: (view_token, bucket) -> state dict, LRU-ordered
_routes = collections.OrderedDict()
_loaded_from = [None]  # router-state path already loaded this process
_dirty = [0]


def _state_path():
    from dask_geomodeling_tpu_torch.config import config

    return config.get("geomodeling.router-state", None)


def _maybe_load_locked():
    """Seed the table from the configured state file, once per path: a
    restarted service keeps its measured routes instead of exploring
    every view again."""
    path = _state_path()
    if path is None or _loaded_from[0] == path:
        return
    _loaded_from[0] = path
    try:
        with open(path) as f:
            entries = json.load(f)
    except (OSError, ValueError):
        return
    for key_text, state in entries.items():
        token, _, bucket = key_text.rpartition(":")
        try:
            key = (token, int(bucket))
        except ValueError:
            continue
        if key not in _routes and isinstance(state, dict):
            _routes[key] = {
                "numpy": state.get("numpy"),
                "torch": state.get("torch"),
                "torch_runs": int(state.get("torch_runs", 0)),
                "host_streak": 0,
            }


def _autosave_snapshot_locked():
    """(path, payload) to write after releasing the lock, or None:
    serialization and disk I/O must not run while other request threads
    wait on ``_lock``."""
    path = _state_path()
    if path is None:
        return None
    _dirty[0] += 1
    if _dirty[0] < _SAVE_EVERY:
        return None
    _dirty[0] = 0
    return path, _snapshot_locked()


def _snapshot_locked():
    return {"%s:%d" % key: dict(state) for key, state in _routes.items()}


def _write_state(path, payload):
    tmp = "%s.tmp.%d" % (path, os.getpid())
    try:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)  # atomic: concurrent writers last-win whole
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def save(path=None):
    """Persist the routing table now (otherwise it autosaves every
    ``_SAVE_EVERY`` measurements when ``geomodeling.router-state`` is
    set)."""
    with _lock:
        target = path or _state_path()
        payload = _snapshot_locked() if target else None
    if target:
        _write_state(target, payload)


def load(path=None):
    """Merge a saved routing table into the live one (missing keys only)."""
    with _lock:
        if path is not None:
            _loaded_from[0] = None
            from dask_geomodeling_tpu_torch.config import config

            with config.set({"geomodeling.router-state": path}):
                _maybe_load_locked()
        else:
            _maybe_load_locked()


def _key(view, request):
    out_px = int(request.get("width", 0)) * int(request.get("height", 0))
    bucket = int(math.log2(out_px)) if out_px > 0 else 0
    return (view.token, bucket)


def _state(key):
    _maybe_load_locked()
    state = _routes.get(key)
    if state is None:
        state = {
            "numpy": None,  # Mpx/s EMA
            "torch": None,
            "torch_runs": 0,
            "host_streak": 0,  # host routes since the last card run
        }
        _routes[key] = state
        while len(_routes) > _MAX_ROUTES:
            _routes.popitem(last=False)
    else:
        _routes.move_to_end(key)
    return state


def _route(state, eligible, margin):
    """(route, the key's host streak after it): the policy of ``choose``
    on a key's state, with no side effect."""
    streak = state["host_streak"]
    if not eligible or state["numpy"] is None:
        return "numpy", streak
    if state["torch_runs"] < 2 or state["torch"] is None:
        return "torch", streak
    # hysteresis toward the host: the card must win by a clear margin, or
    # close-call noise flips the route
    if state["torch"] >= margin * state["numpy"]:
        return "torch", 0
    # second chance: one borderline card measurement does not decide the
    # route; one more measured run blends in first.  Clear losers (the
    # card under half the host rate) stop at once
    if state["torch_runs"] < 3 and state["torch"] >= 0.5 * state["numpy"]:
        return "torch", streak
    # refresh probe: every _REFRESH_EVERY host routes, one request
    # measures the card again
    streak += 1
    if streak >= _REFRESH_EVERY:
        return "torch", 0
    return "numpy", streak


def _margin():
    from dask_geomodeling_tpu_torch.config import config

    return config.get("geomodeling.auto-margin", 1.15)


def choose(view, request, eligible):
    """Return "numpy" or "torch" for this request.

    ``eligible`` is the caller's static gate (vals mode, size threshold);
    the router only ever returns "torch" when it holds.
    """
    key = _key(view, request)
    with _lock:
        state = _state(key)
        route, state["host_streak"] = _route(state, eligible, _margin())
        return route


def route_of(view, request, eligible=True):
    """The route ``choose`` would return for this request now, changing
    nothing: no table entry is made or moved, and no streak counts."""
    with _lock:
        _maybe_load_locked()
        state = _routes.get(_key(view, request))
        if state is None:
            return "numpy"
        return _route(state, eligible, _margin())[0]


def state_of(view, request):
    """A copy of the measured state of this request's key ("numpy" and
    "torch": the rates' EMAs in Mpx/s, "torch_runs"), None when the
    table has no entry for it."""
    with _lock:
        state = _routes.get(_key(view, request))
        return None if state is None else dict(state)


def record(view, request, executor, elapsed):
    """Record a measured execution."""
    key = _key(view, request)
    out_px = int(request.get("width", 0)) * int(request.get("height", 0))
    if out_px <= 0 or elapsed <= 0:
        return
    rate = out_px / 1e6 / elapsed
    with _lock:
        state = _state(key)
        if executor == "torch":
            state["torch_runs"] += 1
            if state["torch_runs"] < 2:
                # the first card run pays one-off costs: warm-up only
                return
        old = state[executor]
        state[executor] = rate if old is None else _EMA_ALPHA * rate + (1 - _EMA_ALPHA) * old
        snapshot = _autosave_snapshot_locked()
    if snapshot is not None:
        _write_state(*snapshot)


class timed_route:
    """Context manager: time a routed execution and record it.  The
    caller's block must end with the values in host memory, so that the
    card's time is not only that of its asynchronous launches."""

    def __init__(self, view, request, executor):
        self._view = view
        self._request = request
        self._executor = executor

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            # an aborted run measures nothing; it raises on
            record(self._view, self._request, self._executor, time.perf_counter() - self._t0)
        return False


def reset(reseed=True):
    """Forget all in-memory measurements.

    With ``geomodeling.router-state`` configured (the default: a user
    cache file), the persisted table is read back at once, so a serving
    process that resets keeps its learned routes.  ``reseed=False``
    explores from scratch (what benchmarks and tests want)."""
    with _lock:
        _routes.clear()
        _dirty[0] = 0
        if reseed:
            _loaded_from[0] = None  # force a fresh read of the state file
            _maybe_load_locked()
        else:
            _loaded_from[0] = _state_path()  # mark as consumed: no re-seed


def _save_at_exit():
    """Final autosave: short-lived processes rarely reach the
    every-32-measurements autosave, yet their measurements are what the
    next process wants."""
    try:
        with _lock:
            path = _state_path()
            payload = _snapshot_locked() if path and _routes else None
        if payload:
            _write_state(path, payload)
    except Exception:
        pass  # interpreter teardown: never raise


atexit.register(_save_at_exit)


def stats():
    """A snapshot of the routing table (diagnostics)."""
    with _lock:
        return {k: dict(v) for k, v in _routes.items()}
