"""Constructive geometry operations: Buffer and Simplify.

Counterpart of dask_geomodeling_tpu/geometry/constructive.py: buffering
transforms the features into a working projection, buffers there
(geo/_buffer.py) and transforms back; an extent request grows its box by
the distance the same way; simplification's tolerance defaults to the
request's ``min_size``.  Host nodes: they run their numpy processes.
"""
import numbers

from dask_geomodeling_tpu_torch.core import arg
from dask_geomodeling_tpu_torch.geo import Extent
from dask_geomodeling_tpu_torch.geometry.base import BaseSingle

__all__ = ["Buffer", "Simplify"]


def _buffer_features(data, plan):
    frame = data["features"]
    if len(frame) == 0:
        return data
    request_srs = data["projection"]
    grown = (
        frame.geometry.to_crs(plan["buf_srs"])
        .buffer(plan["distance"], plan["resolution"])
        .to_crs(request_srs)
    )
    return {"features": frame.set_geometry(grown), "projection": request_srs}


def _buffer_extent(data, plan):
    if not data["extent"]:
        return data
    request_srs = data["projection"]
    grown = (
        Extent(data["extent"], request_srs)
        .transformed(plan["buf_srs"])
        .buffered(plan["distance"])
        .transformed(request_srs)
    )
    return {"extent": grown.bbox, "projection": request_srs}


class Buffer(BaseSingle):
    """Buffer features by a distance measured in the given projection.

    Args:
      source (GeometryBlock): features to buffer
      distance (float): buffer distance in projection units
      projection (str): projection the buffering is computed in
      resolution (int): points per quarter circle (default 16)
    """

    def __init__(self, source, distance, projection, resolution=16):
        if not isinstance(distance, numbers.Real):
            raise TypeError("Argument 'distance' must be a float or int.")
        if not isinstance(projection, str):
            raise TypeError("Argument 'projection' must be a str.")
        if not isinstance(resolution, int):
            raise TypeError("Argument 'resolution' must be an int.")
        super().__init__(source, distance, projection, resolution)

    distance = arg(1)
    projection = arg(2)
    resolution = arg(3)

    def get_sources_and_requests(self, **request):
        plan = {
            "distance": self.distance,
            "buf_srs": self.projection,
            "resolution": self.resolution,
        }
        return [(self.source, request), (plan, None)]

    @staticmethod
    def process(data, plan):
        if "features" in data:
            return _buffer_features(data, plan)
        if "extent" in data:
            return _buffer_extent(data, plan)
        raise NotImplementedError("Unknown mode in Buffer.process")


class Simplify(BaseSingle):
    """Simplify feature geometries with a tolerance (default: the request's
    ``min_size``)."""

    def __init__(self, source, tolerance=None, preserve_topology=True):
        super().__init__(
            source,
            None if tolerance is None else float(tolerance),
            bool(preserve_topology),
        )

    tolerance = arg(1)
    preserve_topology = arg(2)

    def get_sources_and_requests(self, **request):
        plan = {
            "tolerance": self.tolerance or request.get("min_size") or 0.0,
            "preserve_topology": self.preserve_topology,
        }
        return [(self.source, request), (plan, None)]

    @staticmethod
    def process(data, plan):
        if "features" not in data:
            return data  # extents are assumed unchanged by simplification
        simplified = data["features"].geometry.simplify(
            plan["tolerance"], preserve_topology=plan["preserve_topology"]
        )
        return {
            "features": data["features"].set_geometry(simplified),
            "projection": data["projection"],
        }
