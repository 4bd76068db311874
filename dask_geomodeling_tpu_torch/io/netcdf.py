"""The CF conventions shared by the gridded-container readers.

Counterpart of part of dask_geomodeling_tpu/io/netcdf.py, copied: the
two helpers that the Zarr reader (io/zarr.py) assembles its payload
with, ``_crs_from_atts`` (the CRS from ``grid_mapping``/``spatial_ref``/
``crs_wkt`` attributes) and ``_assemble_raster`` (orientation,
geotransform from cell centres, ``scale_factor``/``add_offset``
unpacking, the fill).  The netCDF reader itself is not ported: ``.nc``,
``.cdf``, ``.nc3``, ``.nc4``, ``.h5`` and ``.hdf5`` files raise
NotImplementedError naming this module of the JAX package.
"""
import numpy as np

__all__ = []


def _crs_from_atts(gatts, variables, data_var):
    """CF georeferencing: explicit WKT beats grid_mapping translation."""
    mapping = None
    name = data_var["atts"].get("grid_mapping")
    if isinstance(name, str):
        for var in variables:
            if var["name"] == name.strip():
                mapping = var["atts"]
                break
    for source in (mapping or {}, gatts):
        for key in ("spatial_ref", "crs_wkt"):
            wkt = source.get(key)
            if isinstance(wkt, str) and wkt.strip():
                return wkt.strip()
    if mapping is not None:
        epsg = mapping.get("epsg_code")
        if isinstance(epsg, str) and epsg.strip():
            return (
                epsg.strip()
                if epsg.strip().upper().startswith("EPSG")
                else "EPSG:" + epsg.strip()
            )
        gm = mapping.get("grid_mapping_name")
        if isinstance(gm, str) and gm.strip() == "latitude_longitude":
            return "EPSG:4326"
    return "EPSG:4326"


def _assemble_raster(gatts, variables, data_var, array, xs, ys, spacing=None):
    """Shared CF assembly: orientation, geotransform, packing, CRS.

    ``variables`` is the attribute-bearing variable list (dicts with
    "name" and "atts"); ``xs``/``ys`` are cell-center coordinates along
    the last two axes.  ``spacing`` supplies (dx, dy) in storage order for
    windowed callers whose coordinate slice may be a single element (a
    1-px window must not fabricate a 1.0-unit cell size).
    """
    from dask_geomodeling_tpu_torch.geo.dtypes import get_dtype_max
    from dask_geomodeling_tpu_torch.raster.sources import RasterData

    if array.ndim == 2:
        array = array[None]
    elif array.ndim > 3:
        array = array.reshape((-1,) + array.shape[-2:])

    default_dx, default_dy = spacing if spacing is not None else (1.0, -1.0)
    dx = float(xs[1] - xs[0]) if len(xs) > 1 else float(default_dx)
    dy = float(ys[1] - ys[0]) if len(ys) > 1 else float(default_dy)
    if dy > 0:  # south-up storage: flip rows into the north-up contract
        array = array[:, ::-1, :]
        ys = ys[::-1]
        dy = -dy
    geo_transform = (
        float(xs[0]) - dx / 2,
        dx,
        0.0,
        float(ys[0]) - dy / 2,
        0.0,
        dy,
    )

    atts = data_var["atts"]

    def scalar(name):
        value = atts.get(name)
        if value is None:
            return None
        arr = np.asarray(value)
        return float(arr.ravel()[0]) if arr.size else None

    fill = scalar("_FillValue")
    if fill is None:
        fill = scalar("missing_value")
    scale = scalar("scale_factor")
    offset = scalar("add_offset")
    array = np.ascontiguousarray(array)
    if scale is not None or offset is not None:
        unpacked = array.astype(np.float32) * (
            1.0 if scale is None else scale
        ) + (0.0 if offset is None else offset)
        if fill is not None:
            mask = array == np.asarray(fill, array.dtype)
            fill = float(np.finfo(np.float32).max)
            unpacked[mask] = fill
        array = unpacked
    else:
        # a native-endian copy: torch takes no big-endian buffer
        array = array.astype(array.dtype.newbyteorder("="))

    if fill is None:
        fill = float(get_dtype_max(array.dtype))

    label = atts.get("long_name") or atts.get("units") or data_var["name"]
    return RasterData(
        array=array,
        projection=_crs_from_atts(gatts, variables, data_var),
        geo_transform=geo_transform,
        no_data_value=float(fill),
        metadata=[str(label)] * array.shape[0],
    )
