"""``get_data``: the port's entry point for a raster request.

Counterpart of dask_geomodeling_tpu/raster/base.py:
RasterBlock._get_data_uncached.  A vals request larger than
``geomodeling.tile-size`` runs as batched tiles (runtime/tiles.py); any
other request runs through ``compute_torch``.  There is no router and no
fallback: a failure raises.
"""
from dask_geomodeling_tpu.config import config
from dask_geomodeling_tpu_torch.runtime.executor import compute_torch, plan_graph
from dask_geomodeling_tpu_torch.runtime.tiles import evaluate_tiled

__all__ = ["get_data"]


def get_data(view, *, device=None, **request):
    """Evaluate ``request`` on ``view`` (a JAX-package Block) with the
    torch twins on ``device``; returns what ``view.get_data`` returns."""
    tile_size = config.get("geomodeling.tile-size", 512)
    width = request.get("width") or 0
    height = request.get("height") or 0
    if request.get("mode") == "vals" and max(width, height) > tile_size:
        return evaluate_tiled(view, request, tile_size=tile_size, device=device)
    return compute_torch(*plan_graph(view, request), device=device)
