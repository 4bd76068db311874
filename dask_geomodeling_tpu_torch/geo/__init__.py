"""Geo foundation: dtypes, transforms, the CRS subset, band snapping and
the resample calendar (geo/calendar.py)."""
from dask_geomodeling_tpu_torch.geo.dtypes import (  # noqa: F401
    dtype_for_statistic,
    get_dtype_max,
    get_dtype_min,
    get_footprint,
    get_index,
    get_int_dtype,
    get_uint_dtype,
    parse_percentile_statistic,
)
from dask_geomodeling_tpu_torch.geo.geotransform import Extent, GeoTransform  # noqa: F401
from dask_geomodeling_tpu_torch.geo.crs import (  # noqa: F401
    get_epsg_or_wkt,
    get_projection,
    get_sr,
    transform_extent,
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
