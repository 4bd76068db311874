"""The port's configuration: a thread-safe key/value store.

Counterpart of dask_geomodeling_tpu/config.py (``Config``), holding only
the keys the port reads, with the JAX package's defaults where it has the
key.  ``geomodeling.executor`` picks how a raster vals request runs:
"torch" (the default) runs the torch twins on the device
``geomodeling.torch-device`` names unless the caller passes one,
"numpy" runs the numpy processes on the host under the configured
``scheduler`` (``core/graphs.py:compute``), and
"auto" routes each request between the two by their measured rates
(runtime/router.py).  The JAX package defaults to "auto"; the port
defaults to the card.

Usage::

    from dask_geomodeling_tpu_torch.config import config
    with config.set({"geomodeling.tile-size": 256}):
        ...

As in the JAX package, ``DASK_GEOMODELING__*`` and ``DASK_SCHEDULER``
environment variables override the defaults when the module loads
(``_env_overrides``, dask.config's convention).
"""
import os
import threading
from contextlib import ContextDecorator

__all__ = ["config", "defaults"]

defaults = {
    # device of the entry points when the caller passes none
    "geomodeling.torch-device": "cuda",
    # how a raster vals request runs: "torch" (the twins on the device),
    # "numpy" (the numpy processes on the host, compute()) or "auto"
    # (routed per (view, size bucket) by measured rates, runtime/router.py)
    "geomodeling.executor": "torch",
    # "auto" considers the card only for requests of at least this many
    # pixels; smaller ones run on the host.  chip_smoke.py's auto-routing
    # tables (three runs, NVIDIA H100 80GB HBM3, 700.00 W): at 64^2 the
    # host won on all three views in every run, at 128^2 the card won on
    # the headline view in every run; so 128^2
    "geomodeling.auto-min-device-px": 128 * 128,
    # under "auto", the card's measured rate must exceed margin times the
    # host's before a request kind is routed to it (hysteresis: close
    # calls stay on the host).  Same tables: the closest calls were the
    # sheet views at 256^2 (the card at 1.00-1.94 times the host's rate,
    # settling either way from run to run) and the headline at 128^2
    # (1.18-2.33); the JAX package's 1.15 is kept
    "geomodeling.auto-margin": 1.15,
    # the router's table survives restarts in this file (None: not kept);
    # the port's own name, so it never reads the JAX package's rates
    "geomodeling.router-state": os.path.join(
        os.path.expanduser("~"), ".cache", "dask_geomodeling_tpu_torch", "router-state.json"),
    # scheduler of compute() off the "torch" executor (the host routes of
    # get_data under "numpy" and "auto"): sync | threads |
    # processes (core/scheduler.py)
    "scheduler": None,
    # in-memory byte budget of the pooled schedulers' intermediate
    # results; beyond it, the least recently used spill to disk
    # (parallel/spill.py).  None/0: unlimited
    "geomodeling.scheduler-memory-limit": None,
    # tile edge of the batched tile runtime (pixels); a vals request
    # larger than one tile runs as tiles
    "geomodeling.tile-size": 512,
    # tiles per batch of the tile runtime
    "geomodeling.tile-batch": 64,
    # warp resampling of the sources: "nearest" (GDAL's
    # GRA_NearestNeighbour, the reference's choice) or "bilinear"
    "geomodeling.warp-interpolation": "nearest",
    # the file sandbox (geo/safefiles.py): relative paths resolve against
    # the root; with strict paths, a path must stay inside it
    "geomodeling.root": "/",
    "geomodeling.strict-file-paths": False,
    # GeoTIFFs and VRTs above this pixel count are read window by window
    # (only the blocks a request touches decode); smaller files decode
    # whole into the read cache (runtime/pipeline.py)
    "geomodeling.windowed-read-limit": 64 * (1024**2),
    # requests at 2x or more coarser resolution read the best overview
    # level of a pyramided GeoTIFF (off: the reference reads full
    # resolution)
    "geomodeling.use-overviews": False,
    # the most features a geometry request returns when it sets no limit
    # (GeometryFileSource raises above it; Rasterize asks for at most it)
    "geomodeling.geometry-limit": 10000,
    # GeoPackages above this many BYTES answer a request's bbox through
    # their gpkg_rtree_index (only the rows it touches decode) instead of
    # the parse-whole-file read cache; None disables
    "geomodeling.vector-windowed-read-limit": 16 * 1024 * 1024,
    # where to_file of a geometry writes its partial files (None: the
    # system's temporary directory)
    "temporary_directory": None,
    # byte budget of the cross-request result cache at the raster
    # get_data boundary (runtime/results.py); 0 = off (a file-backed
    # response can go stale when the file changes)
    "geomodeling.result-cache-size": 0,
    # accept raw view JSON in the WMS ``layers``/``coverage`` parameter;
    # wms_serve.main turns it off whenever named layers are registered
    "geomodeling.wms-json-layers": True,
    # module prefixes a deserialized view may import its classes from
    # (None: the whole port); checked before any import
    "geomodeling.block-import-paths": None,
    # the pixel budget of AggregateRaster's raster request when the block
    # sets no max_pixels (the JAX package's key and default)
    "geomodeling.raster-limit": 12 * (1024**2),
    # NTv2 grid-shift files per datum name, e.g. {"NZGD49": ".../nz.gsb"}:
    # upgrades that datum's WGS84 leg from Helmert (~0.5 m) to grid
    # interpolation (geo/ntv2.py, read where crs._datum_shift runs)
    "geomodeling.ntv2-grids": None,
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


def _env_overrides(environ=None):
    """Environment overrides, dask.config's convention (the reference
    rides dask.config, reference config.py:1-12, so deployments set
    ``DASK_GEOMODELING__RASTER_LIMIT=...``-style variables): strip the
    ``DASK_`` prefix, lowercase, ``__`` nests, ``_`` maps to ``-``;
    values parse as Python literals with a plain-string fallback.
    ``DASK_SCHEDULER`` sets the top-level ``scheduler`` key."""
    import ast

    out = {}
    for key, raw in (os.environ if environ is None else environ).items():
        if key == "DASK_SCHEDULER":
            out["scheduler"] = raw
            continue
        if not key.startswith("DASK_GEOMODELING__"):
            continue
        name = (
            key[len("DASK_GEOMODELING__"):]
            .lower()
            .replace("__", ".")
            .replace("_", "-")
        )
        if not name:
            continue
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        out["geomodeling." + name] = value
    return out


config = Config({**defaults, **_env_overrides()})
