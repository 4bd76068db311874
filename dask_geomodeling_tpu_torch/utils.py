"""Flat utils namespace (counterpart of dask_geomodeling_tpu/utils.py).

Everything lives in :mod:`dask_geomodeling_tpu_torch.geo`; this module
re-exports it, with ``create_dataset`` and ``Dataset``, the in-memory
stand-in of a GDAL dataset.
"""
import numpy as np

from dask_geomodeling_tpu_torch.geo import *  # noqa: F401,F403
from dask_geomodeling_tpu_torch.geo import (  # noqa: F401 (not in geo's __all__)
    shapely_from_wkt,
    shapely_transform,
)
from dask_geomodeling_tpu_torch.geo.crs import get_sr


def create_dataset(array, geo_transform=None, projection=None, no_data_value=None):
    """An in-memory raster dataset over a (bands, height, width) numpy
    array, with the small GDAL-dataset surface the JAX package's has
    (geo transform, projection WKT, nodata, array access).  The array is
    referenced, not copied.
    """
    array = np.asarray(array)
    if array.ndim != 3:
        raise ValueError("Expected a (bands, height, width) array")

    class _MemoryDataset:
        RasterCount = array.shape[0]
        RasterYSize = array.shape[1]
        RasterXSize = array.shape[2]

        def __init__(self):
            self.array = array

        def ReadAsArray(self):
            return self.array

        def GetGeoTransform(self):
            return tuple(geo_transform) if geo_transform else (0, 1, 0, 0, 0, -1)

        def GetProjection(self):
            return get_sr(projection).ExportToWkt() if projection else ""

        def GetNoDataValue(self):
            return no_data_value

        def FlushCache(self):
            pass

    return _MemoryDataset()


class Dataset:
    """Context manager around :func:`create_dataset`.

    Usage::

        with Dataset(array, geo_transform=..., projection=...) as dataset:
            ...
    """

    def __init__(self, array, **kwargs):
        self.array = array
        self.dataset = create_dataset(array, **kwargs)

    def __enter__(self):
        return self.dataset

    def __exit__(self, exc_type, exc_value, traceback):
        self.close()

    def close(self):
        self.dataset.FlushCache()
