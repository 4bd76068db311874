"""Geometry blocks: the ported subset of dask_geomodeling_tpu/geometry.

GeometryWKTSource, the base classes and zonal statistics
(AggregateRaster, AggregateRasterAboveThreshold).  Not ported:
GeometryFileSource (it waits for the vector readers), the field, set,
text, merge, constructive and geometry operations, GeometryTiler and the
sinks.
"""
from dask_geomodeling_tpu_torch.geometry.base import (  # noqa: F401
    BaseSingle,
    BaseSingleSeries,
    GeometryBlock,
    GetSeriesBlock,
    SeriesBlock,
    SetSeriesBlock,
)
from dask_geomodeling_tpu_torch.geometry.sources import GeometryWKTSource  # noqa: F401
from dask_geomodeling_tpu_torch.geometry.aggregate import (  # noqa: F401
    AggregateRaster,
    AggregateRasterAboveThreshold,
)
