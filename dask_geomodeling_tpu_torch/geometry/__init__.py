"""Geometry blocks: the ported subset of dask_geomodeling_tpu/geometry.

The sources (GeometryFileSource, GeometryWKTSource), the base classes,
the field operations, Area, GeometryTiler, GeometryFileSink and zonal
statistics (AggregateRaster, AggregateRasterAboveThreshold).  Not ported:
the set, text, merge and constructive operations.
"""
from dask_geomodeling_tpu_torch.geometry.base import (  # noqa: F401
    BaseSingle,
    BaseSingleSeries,
    GeometryBlock,
    GetSeriesBlock,
    SeriesBlock,
    SetSeriesBlock,
)
from dask_geomodeling_tpu_torch.geometry.sources import (  # noqa: F401
    GeometryFileSource,
    GeometryWKTSource,
)
from dask_geomodeling_tpu_torch.geometry.field_operations import (  # noqa: F401
    Classify,
    ClassifyFromColumns,
    Add,
    Subtract,
    Multiply,
    Divide,
    FloorDivide,
    Power,
    Modulo,
    Equal,
    NotEqual,
    Greater,
    GreaterEqual,
    Less,
    LessEqual,
    And,
    Or,
    Xor,
    Invert,
    Where,
    Mask,
    Round,
    Interp,
    Choose,
)
from dask_geomodeling_tpu_torch.geometry.geom_operations import Area  # noqa: F401
from dask_geomodeling_tpu_torch.geometry.parallelize import GeometryTiler  # noqa: F401
from dask_geomodeling_tpu_torch.geometry.aggregate import (  # noqa: F401
    AggregateRaster,
    AggregateRasterAboveThreshold,
)
from dask_geomodeling_tpu_torch.geometry.sinks import GeometryFileSink  # noqa: F401
