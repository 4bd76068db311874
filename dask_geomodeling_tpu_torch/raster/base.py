"""RasterBlock, BaseSingle, and ``get_data``, the port's entry point for a
raster request.

Counterparts of dask_geomodeling_tpu/raster/base.py (``RasterBlock``,
``BaseSingle``) and of its ``RasterBlock._get_data_uncached``.  A time or
meta request runs through ``compute_metadata`` on the host.  A vals
request runs as ``geomodeling.executor`` says:

- "torch" (the default): on the device, as batched tiles
  (runtime/tiles.py) when it is larger than ``geomodeling.tile-size``,
  else (or when its tiles plan differently) through ``compute_torch``;
- "numpy": the numpy processes on the host, under the configured
  ``scheduler`` (``core/graphs.py:compute``);
- "auto": one of the two, chosen per (view, size bucket) by the
  router's measured rates (runtime/router.py); requests below
  ``geomodeling.auto-min-device-px`` pixels run on the host.

There is no fallback: a failure on the device raises, under "auto" too.
"""
from datetime import datetime as Datetime

from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.core import Block, arg, expect_instance

__all__ = ["RasterBlock", "BaseSingle", "get_data"]


def get_data(view, *, device=None, **request):
    """Evaluate ``request`` on ``view`` with the torch twins on ``device``
    (``None``: ``geomodeling.torch-device``, the card by default), or as
    ``geomodeling.executor`` says otherwise (the module's docstring).  A time
    or meta request holds no pixels: it runs the numpy processes on the
    host and resolves no device, so the blocks that ask their sources for
    times while planning (the temporal ones) can do so on any machine.  A
    tiled request whose tiles plan differently (``NotLowerable`` from
    ``evaluate_tiled``) runs whole through ``compute_torch`` on the same
    device, as the JAX package's ``get_data`` falls back to its staged
    executor.

    With ``geomodeling.result-cache-size`` above 0, whole responses are
    LRU-cached across requests by (view token, request token, device) in
    runtime/results.py, the tile server's reuse layer; a vals request
    resolves its device first, so it enters the key (none under the
    "numpy" executor, which runs on the host)."""
    cache_bytes = config.get("geomodeling.result-cache-size", 0)
    if not cache_bytes:
        return _get_data_uncached(view, device, request)
    from dask_geomodeling_tpu_torch.device import resolve_device
    from dask_geomodeling_tpu_torch.runtime import results

    key_device = None  # a time or meta request runs on the host
    if request.get("mode") not in ("time", "meta") and (
            config.get("geomodeling.executor", "torch") != "numpy"):
        device = key_device = resolve_device(device)
    return results.get_or_compute(
        view, request, lambda: _get_data_uncached(view, device, request), int(cache_bytes),
        device=key_device,
    )


EXECUTORS = ("torch", "numpy", "auto")


def _get_data_uncached(view, device, request):
    from dask_geomodeling_tpu_torch.core.graphs import compute
    from dask_geomodeling_tpu_torch.runtime.host import compute_metadata

    if request.get("mode") in ("time", "meta"):
        return compute_metadata(*view.get_compute_graph(**request))
    executor = config.get("geomodeling.executor", "torch")
    if executor not in EXECUTORS:
        raise ValueError("geomodeling.executor is %r, not one of %s" % (executor, EXECUTORS))
    if executor == "numpy":
        return compute(*view.get_compute_graph(**request))
    if executor == "auto" and request.get("mode") == "vals":
        from dask_geomodeling_tpu_torch.device import resolve_device
        from dask_geomodeling_tpu_torch.runtime import router

        device = resolve_device(device)  # the card asked for and absent raises
        pixels = (request.get("width") or 0) * (request.get("height") or 0)
        eligible = pixels >= config.get("geomodeling.auto-min-device-px", 65536)
        if router.choose(view, request, eligible) == "torch":
            # the values come back in host memory, so the clock holds the
            # card's whole run, not only its launches
            with router.timed_route(view, request, "torch"):
                return _on_device(view, device, request)
        with router.timed_route(view, request, "numpy"):
            # compute() reads the executor, "auto": the scheduler's route
            return compute(*view.get_compute_graph(**request))
    return _on_device(view, device, request)


def _on_device(view, device, request):
    """The card's route: batched tiles, else ``compute_torch``."""
    from dask_geomodeling_tpu_torch.runtime.executor import NotLowerable, compute_torch
    from dask_geomodeling_tpu_torch.runtime.tiles import evaluate_tiled

    tile_size = config.get("geomodeling.tile-size", 512)
    width = request.get("width") or 0
    height = request.get("height") or 0
    fetches = getattr(type(view).process, "torch_fetch_inputs", False)
    if request.get("mode") == "vals" and max(width, height) > tile_size and not fetches:
        try:
            return evaluate_tiled(view, request, tile_size=tile_size, device=device)
        except NotLowerable:
            pass  # the whole request, on the same device
    return compute_torch(*view.get_compute_graph(**request), device=device)


def _operator(block_name, reflected=False, unary=False, const=None):
    """An operator overload that builds the named elemwise block lazily
    (the elemwise module imports this one)."""
    if unary:

        def method(self):
            import dask_geomodeling_tpu_torch.raster as blocks

            cls = getattr(blocks, block_name)
            return cls(self) if const is None else cls(self, const)

    elif reflected:

        def method(self, other):
            import dask_geomodeling_tpu_torch.raster as blocks

            return getattr(blocks, block_name)(other, self)

    else:

        def method(self, other):
            import dask_geomodeling_tpu_torch.raster as blocks

            return getattr(blocks, block_name)(self, other)

    method.__doc__ = "Build a %s block from this raster." % block_name
    return method


class RasterBlock(Block):
    """The base block for temporal rasters.

    Attributes (None when empty): ``period``, ``timedelta``, ``extent``
    (WGS84), ``footprint`` (the data's box as an ``Extent`` in its own
    projection: the JAX package's ``geometry``, which the port keeps as a
    box), ``dtype``, ``fillvalue``, ``projection``, ``geo_transform``,
    ``temporal``.  Request fields: ``mode`` ('vals'|'time'|'meta'),
    ``bbox``, ``projection``, ``width``, ``height``, ``start``, ``stop``.
    Response: None or a dict with ``values`` (bands, height, width) and
    ``no_data_value``, or ``time``, or ``meta``.
    """

    DEFAULT_ORIGIN = Datetime(1970, 1, 1, 0, 0)

    def get_data(self, device=None, **request):
        """Evaluate the request on ``device`` (see ``get_data``)."""
        return get_data(self, device=device, **request)

    def to_file(self, *args, **kwargs):
        """Export data from this block to a file on disk; see
        :func:`dask_geomodeling_tpu_torch.raster.sinks.to_file`."""
        from dask_geomodeling_tpu_torch.raster.sinks import to_file

        return to_file(self, *args, **kwargs)

    def __len__(self):
        """Number of temporal bands."""
        span = self.period
        if span is None:
            return 0
        first, last = span
        if first == last:
            return 1
        step = self.timedelta
        if step is None:
            time_axis = self.get_data(mode="time", start=first, stop=last)
            return len(time_axis["time"])
        return 1 + int((last - first).total_seconds() // step.total_seconds())

    __add__ = __radd__ = _operator("Add")
    __mul__ = __rmul__ = _operator("Multiply")
    __neg__ = _operator("Multiply", unary=True, const=-1)
    __sub__ = _operator("Subtract")
    __truediv__ = _operator("Divide")
    __pow__ = _operator("Power")
    __eq__ = _operator("Equal")
    __ne__ = _operator("NotEqual")
    __gt__ = _operator("Greater")
    __ge__ = _operator("GreaterEqual")
    __lt__ = _operator("Less")
    __le__ = _operator("LessEqual")
    __invert__ = _operator("Invert", unary=True)
    __and__ = _operator("And")
    __or__ = _operator("Or")
    __xor__ = _operator("Xor")

    # Equal/NotEqual overload __eq__; Blocks stay hashable by identity
    __hash__ = Block.__hash__


class BaseSingle(RasterBlock):
    """Base class for raster blocks wrapping a single raster ("store");
    every raster attribute delegates to the store unless a subclass
    overrides it."""

    def __init__(self, store, *args):
        expect_instance(store, RasterBlock, "store")
        super().__init__(store, *args)

    store = arg(0)

    def __len__(self):
        return len(self.store)


def _delegate(attribute):
    return property(lambda self: getattr(self.store, attribute))


for _attribute in (
    "extent",
    "period",
    "timedelta",
    "temporal",
    "dtype",
    "fillvalue",
    "footprint",
    "projection",
    "geo_transform",
):
    setattr(BaseSingle, _attribute, _delegate(_attribute))
del _attribute
