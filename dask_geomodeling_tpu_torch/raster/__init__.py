"""Raster blocks with their numpy processes and torch twins.

Importing this package registers every twin (registry.py).
"""
from dask_geomodeling_tpu_torch.raster.base import BaseSingle, RasterBlock, get_data  # noqa: F401
from dask_geomodeling_tpu_torch.raster.sources import MemorySource  # noqa: F401
from dask_geomodeling_tpu_torch.raster.elemwise import (  # noqa: F401
    Add,
    And,
    Divide,
    Equal,
    Exp,
    FillNoData,
    Greater,
    GreaterEqual,
    Invert,
    IsData,
    IsNoData,
    Less,
    LessEqual,
    Log,
    Log10,
    Multiply,
    NotEqual,
    Or,
    Power,
    Subtract,
    Xor,
)
from dask_geomodeling_tpu_torch.raster.misc import (  # noqa: F401
    Classify,
    Clip,
    Mask,
    MaskBelow,
    Rasterize,
    RasterizeWKT,
    Reclassify,
    Step,
)
from dask_geomodeling_tpu_torch.raster.reduction import Max  # noqa: F401
from dask_geomodeling_tpu_torch.raster.combine import Group  # noqa: F401
from dask_geomodeling_tpu_torch.raster.spatial import (  # noqa: F401
    Dilate,
    HillShade,
    MovingMax,
    Place,
    Smooth,
)
from dask_geomodeling_tpu_torch.raster.temporal import (  # noqa: F401
    Cumulative,
    Resample,
    Shift,
    Snap,
    TemporalAggregate,
    TemporalSum,
)
