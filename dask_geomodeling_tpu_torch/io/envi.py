"""ENVI raster format: ``.hdr`` text header + flat binary data file.

Counterpart of dask_geomodeling_tpu/io/envi.py, copied: the same
RasterData payload as the JAX reader, and the JAX writer's bytes.

Layout: a text header (first line ``ENVI``, then ``key = value`` entries
where ``{...}`` values may span lines) describing a sidecar-less binary
file holding the samples at ``header offset`` bytes, in ``interleave``
order — ``bsq`` (band-sequential), ``bil`` (band-interleaved-by-line) or
``bip`` (band-interleaved-by-pixel).  Georeferencing comes from
``map info`` (pixel-anchored origin) plus an optional
``coordinate system string`` WKT.

``read_envi`` accepts either the data file or the ``.hdr`` path;
``write_envi`` emits a BSQ pair readable by ENVI/GDAL.
``has_envi_header`` and ``_paths_of`` tell the read cache which paths
are ENVI pairs and which two files a pair's cache stamp folds in.
"""
import os

import numpy as np

__all__ = ["read_envi", "write_envi", "has_envi_header"]

#: ENVI "data type" codes <-> numpy dtypes
_DTYPES = {
    1: "u1", 2: "i2", 3: "i4", 4: "f4", 5: "f8",
    6: "c8", 9: "c16", 12: "u2", 13: "u4", 14: "i8", 15: "u8",
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

_DATA_SUFFIXES = ("", ".img", ".dat", ".bsq", ".bil", ".bip", ".envi", ".raw")


def _parse_header(text):
    """Header text -> {lowercased key: str | [str, ...]}."""
    body = text.strip()
    if not body.lower().startswith("envi"):
        raise IOError("Not an ENVI header (missing ENVI magic line)")
    entries = {}
    # join brace-continued lines so each entry is a single logical line;
    # ';' comments count only at line start — semicolons are legal inside
    # braced values (e.g. tool-written descriptions)
    logical = []
    depth = 0
    for line in body.splitlines()[1:]:
        stripped = line.strip()
        if not stripped or (depth == 0 and stripped.startswith(";")):
            continue
        if depth:
            logical[-1] += " " + stripped
        else:
            logical.append(stripped)
        depth += stripped.count("{") - stripped.count("}")
    for line in logical:
        if "=" not in line:
            continue
        key, value = line.split("=", 1)
        key = " ".join(key.lower().split())
        value = value.strip()
        if value.startswith("{"):
            inner = value.strip("{}").strip()
            if key == "coordinate system string":
                entries[key] = inner  # WKT: commas are structure, keep whole
            else:
                entries[key] = [part.strip() for part in inner.split(",")]
        else:
            entries[key] = value
    return entries


def _scalar(value):
    """Unwrap a single-element braced value; tools brace scalars freely."""
    if isinstance(value, list) and len(value) == 1:
        return value[0]
    return value


def has_envi_header(path):
    """True when an ENVI ``.hdr`` sits next to ``path`` (either naming)."""
    return os.path.exists(path + ".hdr") or os.path.exists(
        os.path.splitext(path)[0] + ".hdr"
    )


def _paths_of(path):
    """(header_path, data_path) for either half of an ENVI pair."""
    if path.lower().endswith(".hdr"):
        header = path
        stem = path[:-4]
        for suffix in _DATA_SUFFIXES:
            candidate = stem + suffix
            if candidate != header and os.path.exists(candidate):
                return header, candidate
        raise IOError("No ENVI data file next to '{}'".format(path))
    for header in (path + ".hdr", os.path.splitext(path)[0] + ".hdr"):
        if os.path.exists(header):
            return header, path
    raise IOError("No ENVI header (.hdr) next to '{}'".format(path))


def _projection_of(entries):
    wkt = entries.get("coordinate system string")
    if wkt:
        return wkt
    map_info = entries.get("map info")
    if not map_info:
        return None
    name = map_info[0].lower()
    if name.startswith("geographic"):
        return "EPSG:4326"
    if name == "utm" and len(map_info) >= 9:
        zone = int(float(map_info[7]))
        south = map_info[8].strip().lower().startswith("s")
        return "EPSG:%d" % ((32700 if south else 32600) + zone)
    return None


def _geo_transform_of(entries):
    map_info = entries.get("map info")
    if not map_info or len(map_info) < 7:
        return (0.0, 1.0, 0.0, 0.0, 0.0, -1.0)
    # fields: name, ref pixel x/y (1-based), ref easting/northing, sizes
    ref_x, ref_y, easting, northing, size_x, size_y = (
        float(v) for v in map_info[1:7]
    )
    origin_x = easting - (ref_x - 1.0) * size_x
    origin_y = northing + (ref_y - 1.0) * size_y
    return (origin_x, size_x, 0.0, origin_y, 0.0, -size_y)


def read_envi(path):
    """Read an ENVI pair (data or .hdr path) into a RasterData payload."""
    from dask_geomodeling_tpu_torch.raster.sources import RasterData

    header_path, data_path = _paths_of(path)
    with open(header_path) as stream:
        entries = _parse_header(stream.read())

    width = int(_scalar(entries["samples"]))
    height = int(_scalar(entries["lines"]))
    bands = int(_scalar(entries.get("bands", 1)))
    code = int(_scalar(entries["data type"]))
    if code not in _DTYPES:
        raise NotImplementedError("ENVI data type %d is not supported" % code)
    dtype = np.dtype(_DTYPES[code])
    if int(_scalar(entries.get("byte order", 0))):
        dtype = dtype.newbyteorder(">")
    offset = int(_scalar(entries.get("header offset", 0)))
    interleave = str(_scalar(entries.get("interleave", "bsq"))).lower()

    count = width * height * bands
    raw = np.fromfile(data_path, dtype=dtype, count=count, offset=offset)
    if raw.size != count:
        raise IOError(
            "ENVI data file '%s' holds %d values, expected %d"
            % (data_path, raw.size, count)
        )
    if interleave == "bsq":
        array = raw.reshape(bands, height, width)
    elif interleave == "bil":
        array = raw.reshape(height, bands, width).transpose(1, 0, 2)
    elif interleave == "bip":
        array = raw.reshape(height, width, bands).transpose(2, 0, 1)
    else:
        raise NotImplementedError(
            "ENVI interleave '%s' is not supported" % interleave
        )
    array = np.ascontiguousarray(array.astype(dtype.newbyteorder("=")))

    no_data_value = entries.get("data ignore value")
    if no_data_value is not None:
        no_data_value = float(_scalar(no_data_value))

    names = entries.get("band names")
    metadata = (
        [str(n) for n in names]
        if isinstance(names, list) and len(names) == bands
        else [None] * bands
    )
    return RasterData(
        array=array,
        projection=_projection_of(entries),
        geo_transform=_geo_transform_of(entries),
        no_data_value=no_data_value,
        metadata=metadata,
    )


def write_envi(path, array, geo_transform=None, projection=None,
               no_data_value=None, band_names=None):
    """Write (bands, h, w) ``array`` as a BSQ ENVI pair at ``path``."""
    array = np.asarray(array)
    if array.ndim == 2:
        array = array[None]
    dtype = array.dtype.newbyteorder("=")
    code = _DTYPE_CODES.get(np.dtype(dtype))
    if code is None:
        raise NotImplementedError(
            "dtype %s has no ENVI data type code" % array.dtype
        )
    bands, height, width = array.shape

    lines = [
        "ENVI",
        "samples = %d" % width,
        "lines = %d" % height,
        "bands = %d" % bands,
        "header offset = 0",
        "file type = ENVI Standard",
        "data type = %d" % code,
        "interleave = bsq",
        "byte order = %d" % (0 if dtype.byteorder in "=|<" else 1),
    ]
    if geo_transform is not None:
        ox, dx, rot_x, oy, rot_y, dy = (float(v) for v in geo_transform)
        if rot_x or rot_y or dy > 0:
            # 'map info' holds only north-up, axis-aligned grids
            raise NotImplementedError(
                "ENVI map info cannot represent rotated or south-up "
                "geotransforms: %r" % (geo_transform,)
            )
        lines.append(
            "map info = {Arbitrary, 1, 1, %r, %r, %r, %r, units=Meters}"
            % (ox, oy, dx, abs(dy))
        )
    if projection is not None:
        if str(projection).upper().startswith("EPSG:"):
            from dask_geomodeling_tpu_torch.geo.crs import get_sr

            projection = get_sr(projection).ExportToWkt()
        lines.append("coordinate system string = {%s}" % projection)
    if no_data_value is not None:
        lines.append("data ignore value = %r" % float(no_data_value))
    if band_names:
        lines.append(
            "band names = {%s}" % ", ".join(str(n) for n in band_names)
        )

    if path.lower().endswith(".hdr"):
        header_path = path
        data_path = os.path.splitext(path)[0] + ".img"
    else:
        header_path = path + ".hdr"
        data_path = path
    with open(header_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    np.ascontiguousarray(array.astype(dtype)).tofile(data_path)
