"""Geo foundation: dtypes, transforms, the CRS layer, band snapping, the
resample calendar (geo/calendar.py), the geometry engine
(geo/geometry.py), the pandas-free feature frame (geo/features.py) and
the numpy rasterizer (geo/rasterize.py).

The flat namespace is the JAX package's ``geo`` namespace but for
``get_index_jax``, which works on JAX arrays only.
"""
from dask_geomodeling_tpu_torch.geo.dtypes import (  # noqa: F401
    dtype_for_statistic,
    get_dtype_max,
    get_dtype_min,
    get_footprint,
    get_index,
    get_int_dtype,
    get_rounded_repr,
    get_uint_dtype,
    parse_percentile_statistic,
)
from dask_geomodeling_tpu_torch.geo.geotransform import Extent, GeoTransform  # noqa: F401
from dask_geomodeling_tpu_torch.geo.crs import (  # noqa: F401
    SpatialReference,
    TransformException,
    crs_to_srs,
    get_crs,
    get_epsg_or_wkt,
    get_projection,
    get_sr,
    get_transform_func,
    transform_extent,
    transform_min_size,
    transform_points,
)
from dask_geomodeling_tpu_torch.geo.timeutils import (  # noqa: F401
    dt_to_ms,
    filter_none,
    find_neigbours,
    ms_to_dt,
    normalize_offset,
    offset_to_timedelta,
    snap_start_stop,
)
from dask_geomodeling_tpu_torch.geo.safefiles import safe_abspath, safe_file_url  # noqa: F401
from dask_geomodeling_tpu_torch.geo.measurements import percentile  # noqa: F401
from dask_geomodeling_tpu_torch.geo.rasterize import rasterize_geoseries  # noqa: F401
from dask_geomodeling_tpu_torch.geo.features import GeoDataFrame, GeoSeries  # noqa: F401
from dask_geomodeling_tpu_torch.geo import geometry  # noqa: F401
from dask_geomodeling_tpu_torch.geo.geometry import WKTReadingError  # noqa: F401


def shapely_transform(geom, src_srs, dst_srs):
    """Transform a geometry between CRSes (the JAX package's name, kept)."""
    if src_srs.upper() == dst_srs.upper():
        return geom
    func = get_transform_func(src_srs, dst_srs)
    result = geometry.transform(func, geom)
    result.srs = dst_srs
    return result


def shapely_from_wkt(wkt):
    """Parse WKT (the JAX package's name, kept)."""
    return geometry.from_wkt(wkt)
