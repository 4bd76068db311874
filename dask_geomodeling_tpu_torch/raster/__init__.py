"""Torch twins of the raster process functions.

Importing this package registers every twin (registry.py).
"""
from dask_geomodeling_tpu_torch.raster import (  # noqa: F401
    elemwise,
    misc,
    sources,
    spatial,
)
from dask_geomodeling_tpu_torch.raster.base import get_data  # noqa: F401
