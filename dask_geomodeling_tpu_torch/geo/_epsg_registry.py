"""Data-driven EPSG registry: resolve any EPSG code from the compact
parameter table ``epsg.json.gz``.

Counterpart of dask_geomodeling_tpu/geo/_epsg_registry.py.  The port
reads its own copy of the table (817 geographic + 5459 projected CRSes),
beside this module; ``tools/gen_epsg_registry.py`` generates it from
PROJ's EPSG database, so resolving a code needs no external library.

Resolution order in :func:`crs._registry_get` is hand registry first (the
curated entries pin datums shared with WKT parsing), then this table.

Table layout (see the generator docstring): angles in Greenwich degrees,
lengths in metres, helmert as position-vector (tx ty tz rx ry rz ds)
toward WGS84; projection longitude parameters stay relative to the prime
meridian and are shifted back here.
"""
import gzip
import json
import os
from functools import lru_cache

__all__ = ["resolve"]


@lru_cache(maxsize=1)
def _table():
    path = os.path.join(os.path.dirname(__file__), "epsg.json.gz")
    with gzip.open(path, "rb") as fh:
        return json.load(fh)


def resolve(code):
    """Return a SpatialReference for an EPSG ``code`` from the table, or
    None when the code is absent (the caller raises "unsupported code").

    Raises TransformException with an actionable message (the method name
    and the WKT escape hatch) for codes whose projection method is
    knowingly out of scope.
    """
    from . import crs

    table = _table()
    key = str(code)
    entry = table["geographic"].get(key)
    if entry is not None:
        return _geographic_sr(crs, code, entry)
    entry = table["projected"].get(key)
    if entry is not None:
        return _projected_sr(crs, code, entry)
    method = table["unsupported"].get(key)
    if method is not None:
        raise crs.TransformException(
            "EPSG:%d uses the %r projection method, which this framework "
            "does not implement. Pass the CRS as WKT with a supported "
            "method, or reproject the data upstream." % (code, method)
        )
    return None


def _geographic_sr(crs, code, entry):
    name, a, rf, helmert, pm = entry[:5]
    deg_factor = entry[5] if len(entry) > 5 else 1.0
    datum = crs._intern_datum(name, a, rf, helmert)
    if pm or deg_factor != 1.0:
        projection = crs._ShiftedGeographicProjection(pm, deg_factor)
    else:
        projection = crs._GeographicProjection()
    return crs.SpatialReference(code, name, datum, projection)


def _projected_sr(crs, code, entry):
    name, geod, method, params = entry[:4]
    unit_factor = entry[4] if len(entry) > 4 else 1.0
    sx = entry[5] if len(entry) > 5 else 1
    sy = entry[6] if len(entry) > 6 else 1
    base = _table()["geographic"].get(str(geod))
    if base is None:
        return None
    base_name, a, rf, helmert, pm = base[:5]
    datum = crs._intern_datum(base_name, a, rf, helmert)
    ell = crs._ellipsoid(crs.DATUMS[datum][0])
    params = dict(params)
    if pm:
        # stored longitudes are relative to the CRS prime meridian; the
        # projection classes work in Greenwich degrees
        for lon_key in ("central_meridian", "longitude_of_center"):
            if lon_key in params:
                params[lon_key] = params[lon_key] + pm
                break
        else:
            params["central_meridian"] = pm
    projection = crs._build_projection(method, ell, params)
    if unit_factor != 1.0 or sx != 1 or sy != 1:
        projection = crs._AxisAdjustedProjection(
            projection,
            unit_factor,
            sx,
            sy,
            params.get("false_easting", 0.0),
            params.get("false_northing", 0.0),
        )
    return crs.SpatialReference(code, name, datum, projection)
