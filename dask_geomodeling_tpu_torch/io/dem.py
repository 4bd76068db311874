"""Elevation rasters: SRTM ``.hgt`` tiles and DTED ``.dt0/.dt1/.dt2``.

Counterpart of dask_geomodeling_tpu/io/dem.py, copied: the same
RasterData payload (int16 array, geotransform, nodata, EPSG:4326) as the
JAX readers, so ``RasterFileSource`` serves both formats.

SRTM ``.hgt`` is a bare big-endian int16 grid whose georeferencing
lives in the *filename* (``N34W119.hgt`` names the south-west corner of
a 1°x1° cell); the grid is node-registered with both edges included, so
an n-sample row spans exactly one degree at 1/(n-1) degree spacing and
the GDAL-convention geotransform shifts the origin half a sample
outward (pixel-is-point exposed as pixel-is-area).  Void cells are
-32768.

DTED carries its georeferencing in ASCII headers (UHL + DSI + ACC)
followed by one data record per longitude column: a 0xAA sentinel,
block/longitude/latitude counts, the column's elevations south-to-north
as big-endian *sign-magnitude* int16, and a 32-bit checksum.  Void
cells are -32767 (0xFFFF in sign-magnitude).
"""
import os
import re

import numpy as np

__all__ = ["read_hgt", "read_dted"]

_WGS84 = "EPSG:4326"

#: SW-corner tile name: N34W119, s01e072, optionally with suffixes
#: (``n34_w119_1arc_v3.hgt`` style names keep the leading fields).
_HGT_NAME = re.compile(r"([NSns])(\d{1,2})[_ ]?([EWew])(\d{1,3})")


def _raster_data(array, geo_transform, no_data):
    from dask_geomodeling_tpu_torch.raster.sources import RasterData

    return RasterData(
        array=array,
        projection=_WGS84,
        geo_transform=tuple(geo_transform),
        no_data_value=no_data,
        metadata=[""] * array.shape[0],
    )


def read_hgt(path):
    """Read an SRTM ``.hgt`` tile (georeferenced by its filename)."""
    match = _HGT_NAME.search(os.path.basename(path))
    if match is None:
        raise ValueError(
            "SRTM tile name must carry the SW corner "
            "(like N34W119.hgt): %r" % os.path.basename(path)
        )
    lat = int(match.group(2)) * (1 if match.group(1) in "Nn" else -1)
    lon = int(match.group(4)) * (1 if match.group(3) in "Ee" else -1)

    raw = np.fromfile(path, dtype=">i2")
    n = int(round(len(raw) ** 0.5))
    if n * n != len(raw) or n < 2:
        raise ValueError(
            "SRTM payload is not a square int16 grid: %d samples" % len(raw)
        )
    # rows run north->south already; node registration -> half-sample shift
    values = raw.reshape(1, n, n).astype(np.int16)
    res = 1.0 / (n - 1)
    geo_transform = (lon - res / 2, res, 0.0, lat + 1 + res / 2, 0.0, -res)
    return _raster_data(values, geo_transform, -32768.0)


def _dms(text, degree_digits):
    """Signed degrees from a DDDMMSSH / DDMMSSH header field."""
    text = text.strip()
    hemisphere = text[-1].upper()
    digits = text[:-1].rjust(degree_digits + 4, "0")
    degrees = int(digits[:degree_digits])
    minutes = int(digits[degree_digits : degree_digits + 2])
    seconds = int(digits[degree_digits + 2 : degree_digits + 4])
    value = degrees + minutes / 60.0 + seconds / 3600.0
    return -value if hemisphere in "SW" else value


def read_dted(path, check_checksums=False):
    """Read a DTED level 0/1/2 elevation file (.dt0/.dt1/.dt2)."""
    with open(path, "rb") as stream:
        raw = stream.read()
    if len(raw) < 80 + 648 + 2700 or raw[:4] != b"UHL1":
        raise ValueError("not a DTED file (missing UHL record): %s" % path)
    header = raw[:80].decode("ascii", "replace")
    lon = _dms(header[4:12], 3)
    lat = _dms(header[12:20], 3)
    # intervals are tenths of arcseconds
    dlon = int(header[20:24]) / 36000.0
    dlat = int(header[24:28]) / 36000.0
    n_cols = int(header[47:51])  # longitude lines (records)
    n_rows = int(header[51:55])  # latitude points per record

    data_start = 80 + 648 + 2700
    record_size = 12 + 2 * n_rows  # sentinel+count(4) + counts(4) + checksum(4)
    need = data_start + n_cols * record_size
    if len(raw) < need:
        raise ValueError(
            "truncated DTED data block: have %d bytes, need %d"
            % (len(raw), need)
        )
    records = np.frombuffer(
        raw, np.uint8, n_cols * record_size, data_start
    ).reshape(n_cols, record_size)
    if not (records[:, 0] == 0xAA).all():
        bad = int(np.argmin(records[:, 0] == 0xAA))
        raise ValueError("DTED record %d lacks the 0xAA sentinel" % bad)
    if check_checksums:
        body = records[:, :-4].astype(np.uint64).sum(axis=1)
        stated = (
            records[:, -4:]
            .copy()
            .view(">u4")
            .reshape(n_cols)
            .astype(np.uint64)
        )
        if not (body == stated).all():
            bad = int(np.argmin(body == stated))
            raise ValueError("DTED record %d fails its checksum" % bad)

    # elevations: big-endian sign-magnitude int16, south->north per record
    magnitude = records[:, 8:-4].copy().view(">u2").reshape(n_cols, n_rows)
    magnitude = magnitude.astype(np.int32)
    values = np.where(
        magnitude & 0x8000, -(magnitude & 0x7FFF), magnitude
    ).astype(np.int16)
    # (cols, south->north rows) -> north-up (rows, cols)
    values = values.T[::-1].reshape(1, n_rows, n_cols).copy()
    geo_transform = (
        lon - dlon / 2,
        dlon,
        0.0,
        lat + (n_rows - 1) * dlat + dlat / 2,
        0.0,
        -dlat,
    )
    return _raster_data(values, geo_transform, -32767.0)
