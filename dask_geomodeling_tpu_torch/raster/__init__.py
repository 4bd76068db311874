"""Raster blocks with their numpy processes and torch twins.

Importing this package registers every twin (registry.py).
"""
from dask_geomodeling_tpu_torch.raster.base import BaseSingle, RasterBlock, get_data  # noqa: F401
from dask_geomodeling_tpu_torch.raster.sources import MemorySource  # noqa: F401
from dask_geomodeling_tpu_torch.raster.elemwise import Add, Multiply, Subtract  # noqa: F401
from dask_geomodeling_tpu_torch.raster.misc import Classify, Reclassify  # noqa: F401
from dask_geomodeling_tpu_torch.raster.spatial import HillShade, MovingMax, Smooth  # noqa: F401
