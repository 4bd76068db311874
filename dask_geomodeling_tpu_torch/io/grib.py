"""GRIB edition-1 and edition-2 raster sources (native decoder).

Counterpart of dask_geomodeling_tpu/io/grib.py, copied: the same
RasterData payload (float64 bands, ``_FILL`` as nodata, one metadata
string per band), the same grids, georeferencing and proj4 strings, and
the same errors and messages, with two differences.

- The packed values are read by shifting each out of the bytes that
  hold it, not by expanding the stream into one int64 per bit: values of
  one width as rows of that many bytes, 8 values a row (``_fixed_fields``),
  values of mixed widths each from the 8 bytes at its first bit
  (``_bit_fields``).  A field of a million 12-bit values stays a few
  arrays of a million.  Complex packing (templates 5.2 and 5.3) is
  decoded without a loop over its groups: each group's first bit is a
  cumulative sum of length x width over the groups before it, each
  value's its group's plus its rank times the width, and only the groups
  with bits are read (a dry rain field's are few).  The integers, missing
  flags and truncation errors are the JAX loop's, bit for bit, for every
  group width the JAX loop reads without overflowing int64 (a list of
  group widths or lengths packed in 64 bits or more, which only a corrupt
  section 5 declares, raises here where that loop decodes the overflowed
  numbers).
- Template 5.40 (JPEG 2000) raises NotImplementedError: the JAX package
  decodes its codestream with Pillow's OpenJPEG binding, and the port has
  no JPEG 2000 decoder (a constant field, 0 bits per value, needs none
  and decodes).

Weather and precipitation feeds commonly ship as GRIB2, with long
archives (ERA-40-era reanalyses, legacy HIRLAM output) still in GRIB1.
This module decodes both editions natively and returns the same
RasterData payload as the GeoTIFF codec, so ``RasterFileSource`` serves
``.grib``/``.grb``/``.grib2``/``.grb2``/``.gb2`` files (read whole);
editions may even be mixed within one file (messages stack into bands as
long as their grids agree).

Edition-1 subset: explicit-GDS messages on grids 0 (regular lat/lon,
millidegree coordinates), 1 (Mercator), 3 (Lambert conformal) and 5
(polar stereographic, 60-degree true scale), simple packing (IBM-float
reference value, constant fields via nbits=0), bitmaps, decimal/binary
scaling, and the PDS reference-time/century, parameter, level, and
forecast-offset metadata.  Quasi-regular ("thinned") latitude/longitude
and Gaussian grids (the PL row-count list) regularize to ni=max(counts)
columns by value-preserving nearest-neighbour row expansion.  Spherical
harmonics, second-order packing, and pre-defined (GDS-less) grids or
bitmaps are rejected with clear errors.

Edition-2 subset (the envelope of common NWP products):

- multi-message files: every decoded field becomes one band, in file
  order; repeated sections 2-7 inside one message are honoured
- grid definition templates 3.0 (regular latitude/longitude), 3.10
  (Mercator), 3.20 (polar stereographic) and 3.30 (Lambert conformal) —
  the projected grids map onto the port's CRS layer through proj4
  definitions carrying the earth's ``+a`` and ``+b`` (code table 3.2);
  all four scanning-mode axes orders plus consecutive-j and
  boustrophedon layouts are normalised to north-up row-major arrays
- data representation templates 5.0 (simple packing), 5.2 (complex
  packing, incl. primary missing-value management), 5.3 (complex
  packing with spatial differencing of orders 1 and 2), 5.41 (PNG
  packing, decoded with the port's PNG codec) and 5.42 (CCSDS/AEC
  recompression through the system libaec, io/ccsds.py)
- bitmap section indicators 0 (bitmap present), 254 (reuse previous)
  and 255 (none)
- reference time (section 1) and forecast offset (product templates
  carrying the common octet layout, e.g. 4.0/4.1/4.2/4.8) are exposed
  in per-band metadata strings

Quasi-regular (thinned) template-3.0 grids regularize like edition 1
(per-row counts, nearest-neighbour expansion — value-preserving, so
bitmap holes stay holes; wgrib2's default expansion interpolates
linearly instead).  All multi-octet integers are big-endian; signed
fields use GRIB's sign-magnitude convention (MSB = sign).
"""
import struct
from datetime import datetime

import numpy as np

__all__ = ["read_grib"]

_FILL = float(np.finfo("f4").max)  # sentinel far outside physical ranges

# earth shapes (code table 3.2) that fix the sphere/ellipsoid without
# explicit radii; entries are (a, b) in metres
_EARTH_SHAPES = {
    0: (6367470.0, 6367470.0),
    2: (6378160.0, 6356775.0),  # IAU 1965
    4: (6378137.0, 6356752.314140347),  # GRS80
    5: (6378137.0, 6356752.314245179),  # WGS84
    6: (6371229.0, 6371229.0),
    8: (6371200.0, 6371200.0),
    9: (6377563.396, 6356256.909),  # Airy 1830 (OSGB)
}

# code table 4.2 short names for the common meteorological /
# hydrological products (discipline, category, number) — the subset
# GDAL's GRIB driver surfaces as GRIB_ELEMENT for everyday NWP files
_PARAMETERS = {
    (0, 0, 0): "TMP", (0, 0, 2): "POT", (0, 0, 4): "TMAX", (0, 0, 5): "TMIN",
    (0, 0, 6): "DPT",
    (0, 1, 0): "SPFH", (0, 1, 1): "RH", (0, 1, 7): "PRATE", (0, 1, 8): "APCP",
    (0, 1, 11): "SNOD", (0, 1, 13): "WEASD", (0, 1, 52): "TPRATE",
    (0, 2, 2): "UGRD", (0, 2, 3): "VGRD", (0, 2, 1): "WIND", (0, 2, 22): "GUST",
    (0, 3, 0): "PRES", (0, 3, 1): "PRMSL", (0, 3, 5): "HGT",
    (0, 4, 7): "DSWRF", (0, 5, 3): "DLWRF",
    (0, 6, 1): "TCDC",
    (0, 7, 6): "CAPE", (0, 7, 7): "CIN",
    (1, 0, 0): "FFLDG", (1, 1, 0): "CPPOP",
    (2, 0, 0): "LAND", (2, 0, 2): "TSOIL",
    (10, 3, 0): "WTMP",
}

# code table 4.5 fixed-surface types -> (label, unit exponent handling)
_SURFACES = {
    1: "surface",
    2: "cloud base",
    3: "cloud top",
    4: "0C isotherm",
    6: "maximum wind",
    7: "tropopause",
    100: "isobaric (Pa)",
    101: "mean sea level",
    102: "altitude above MSL (m)",
    103: "height above ground (m)",
    106: "depth below land (m)",
    108: "pressure above ground (Pa)",
    200: "entire atmosphere",
}

_TIME_UNITS = {  # code table 4.4 -> (label, seconds)
    0: ("m", 60),
    1: ("h", 3600),
    2: ("d", 86400),
    10: ("h", 3 * 3600),
    11: ("h", 6 * 3600),
    12: ("h", 12 * 3600),
    13: ("s", 1),
}


def _u(buf, start, n):
    """Big-endian unsigned int of ``n`` octets at 0-based ``start``."""
    return int.from_bytes(buf[start : start + n], "big")


def _s(buf, start, n):
    """GRIB sign-magnitude signed int of ``n`` octets."""
    raw = _u(buf, start, n)
    sign_bit = 1 << (8 * n - 1)
    if raw & sign_bit:
        return -(raw & (sign_bit - 1))
    return raw


def _bit_fields(data, offsets, widths):
    """The unsigned fields of ``widths`` bits (0 or more; an int64 array
    like ``offsets``) that start at the bit ``offsets`` of the big-endian
    stream ``data``, each inside it, as int64: the JAX package's ``bits @
    weights``, whose weights of 2**64 and above are 0, so a field of 64
    bits or more keeps its last 64, in two's complement.  Each field is
    shifted out of the 8 bytes from its first byte (9 for a width above
    57)."""
    offsets = np.asarray(offsets, np.int64)
    widths = np.asarray(widths, np.int64)
    if offsets.size == 0:
        return np.zeros(offsets.shape, np.int64)
    wide = int(widths.max()) > 57
    if wide:  # the last 64 bits of a wider field
        offsets = offsets + np.maximum(widths - 64, 0)
        widths = np.minimum(widths, 64)
    raw = np.frombuffer(bytes(data) + bytes(9), np.uint8)
    first = offsets >> 3
    shift = (offsets & 7).astype(np.uint64)
    octets = np.lib.stride_tricks.as_strided(raw, (raw.size - 8, 8), (1, 1))
    window = octets[first].view(">u8")[:, 0].astype(np.uint64) << shift
    if wide:
        window |= raw[first + 8].astype(np.uint64) >> (np.uint64(8) - shift)
    # a shift by 64 gives 0: a zero-width field
    return (window >> (np.uint64(64) - widths.astype(np.uint64))).view(np.int64)


def _fixed_fields(data, nbits, count, offset_bits):
    """``count`` fields of ``nbits`` (1 to 57) bits from the byte-aligned
    ``offset_bits`` of ``data`` (all inside it): 8 fields fill ``nbits``
    bytes, so the stream is read as rows of ``nbits`` bytes and each of a
    row's 8 fields shifted out of the fixed bytes that hold it."""
    rows = -(-count // 8)
    start = offset_bits // 8
    raw = bytes(data[start : start + rows * nbits])
    raw = np.frombuffer(raw + bytes(rows * nbits - len(raw)), np.uint8).reshape(rows, nbits)
    fields = np.empty((rows, 8), np.int64)
    for k in range(8):
        first, shift = divmod(k * nbits, 8)
        span = (shift + nbits + 7) // 8
        window = raw[:, first].astype(np.uint64)
        for j in range(1, span):
            window = (window << np.uint64(8)) | raw[:, first + j]
        fields[:, k] = ((window >> np.uint64(8 * span - shift - nbits))
                        & np.uint64((1 << nbits) - 1)).view(np.int64)
    return fields.reshape(-1)[:count]


def _fields(data, nbits, count, offset_bits):
    """``count`` fields of ``nbits`` bits from ``offset_bits`` on (checked
    inside ``data``)."""
    if offset_bits % 8 == 0 and nbits <= 57:
        return _fixed_fields(data, nbits, count, offset_bits)
    offsets = offset_bits + np.arange(count, dtype=np.int64) * nbits
    return _bit_fields(data, offsets, np.full(count, nbits, np.int64))


def _unpack_bits(data, nbits, count, offset_bits=0):
    """``count`` unsigned ints of ``nbits`` each from a packed bitstream."""
    if count == 0:
        return np.zeros(0, dtype=np.int64)
    if nbits == 0:
        return np.zeros(count, dtype=np.int64)
    size = 8 * len(data)
    need = offset_bits + count * nbits
    if size < need:
        raise ValueError("GRIB bitstream truncated: need %d bits, have %d"
                         % (need, size))
    return _fields(data, nbits, count, offset_bits)


class _GribError(ValueError):
    pass


def _earth_radii(tpl, base):
    """(a, b) in metres from the shape-of-earth octets at ``base``
    (octet 15 of section 3 templates; scale factors follow)."""
    shape = tpl[base]
    if shape == 1:
        scale = tpl[base + 1]
        radius = _u(tpl, base + 2, 4) / (10.0 ** scale)
        return radius, radius
    if shape in (3, 7):  # major/minor specified (km / m)
        to_m = 1000.0 if shape == 3 else 1.0
        a = _u(tpl, base + 7, 4) / (10.0 ** tpl[base + 6]) * to_m
        b = _u(tpl, base + 12, 4) / (10.0 ** tpl[base + 11]) * to_m
        return a, b
    if shape in _EARTH_SHAPES:
        return _EARTH_SHAPES[shape]
    raise _GribError("Unsupported GRIB shape of earth: %d" % shape)


def _normalize(values, ni, nj, scan):
    """(nj, ni) array, row 0 = first scan row, from the point sequence,
    normalising consecutive-j (0x20) and boustrophedon (0x10) layouts."""
    if scan & 0x20:  # adjacent points in j direction are consecutive
        grid = values.reshape(ni, nj).T.copy()
        if scan & 0x10:  # alternate columns reverse
            grid[:, 1::2] = grid[::-1, 1::2]
    else:
        grid = values.reshape(nj, ni)
        if scan & 0x10:  # alternate rows reverse direction
            grid = grid.copy()
            grid[1::2] = grid[1::2, ::-1]
    return grid


class _Grid:
    """Decoded grid definition: array normaliser + georeferencing."""

    def __init__(self, ni, nj, scan, geo_transform, projection, key):
        self.ni = ni
        self.nj = nj
        self.scan = scan
        self.geo_transform = geo_transform
        self.projection = projection
        self.key = key  # grids must match across messages to stack

    @property
    def npoints(self):
        return self.ni * self.nj

    def to_array(self, values):
        grid = _normalize(values, self.ni, self.nj, self.scan)
        if self.scan & 0x40:  # +j scans south->north: flip to north-up
            grid = grid[::-1]
        if self.scan & 0x80:  # -i scans east->west: flip to west-origin
            grid = grid[:, ::-1]
        return grid


class _ThinnedGrid(_Grid):
    """Quasi-regular ("thinned"/reduced) grid: rows carry their own point
    counts; each expands to the regular ni = max(counts) columns by
    nearest-neighbour pixel-center mapping.  Nearest is value-preserving:
    bitmap holes stay holes and no value outside the row's own alphabet
    is invented (wgrib2's default expansion interpolates linearly; GDAL
    regularizes similarly — the convention difference is documented in
    the module docstring)."""

    def __init__(self, row_counts, nj, scan, geo_transform, projection, key):
        row_counts = [int(count) for count in row_counts]
        super().__init__(
            max(row_counts), nj, scan, geo_transform, projection,
            key + (tuple(row_counts),),
        )
        if scan & 0x20:
            raise _GribError(
                "Thinned GRIB grids with consecutive-j scanning are not "
                "supported"
            )
        self.row_counts = row_counts

    @property
    def npoints(self):
        return sum(self.row_counts)

    def to_array(self, values):
        rows = np.empty((self.nj, self.ni), values.dtype)
        offset = 0
        for j, count in enumerate(self.row_counts):
            row = values[offset : offset + count]
            offset += count
            if count == self.ni:
                rows[j] = row
            else:
                src = ((np.arange(self.ni) + 0.5) * count / self.ni).astype(
                    np.int64
                )
                rows[j] = row[np.minimum(src, count - 1)]
        if self.scan & 0x10:  # boustrophedon: alternate rows reverse
            rows[1::2] = rows[1::2, ::-1]
        if self.scan & 0x40:  # +j scans south->north: flip to north-up
            rows = rows[::-1]
        if self.scan & 0x80:  # -i scans east->west: flip to west-origin
            rows = rows[:, ::-1]
        return rows


def _angle_unit(tpl):
    """Degrees per stored unit from basic angle octets 39-46: the unit
    is basic/subdivisions when both are given; a zero/missing basic
    angle (or missing subdivisions) means the 1e-6 degree default."""
    basic = _u(tpl, 38, 4)
    subdiv = _u(tpl, 42, 4)
    if basic in (0, 0xFFFFFFFF) or subdiv in (0, 0xFFFFFFFF):
        return 1e-6
    return float(basic) / float(subdiv)


def _grid_latlon(tpl, row_counts=None):
    """Grid template 3.0: regular latitude/longitude; with ``row_counts``
    the thinned variant (Ni missing, per-row point counts)."""
    ni = _u(tpl, 30, 4)
    nj = _u(tpl, 34, 4)
    if row_counts is not None:
        if len(row_counts) != nj:
            raise _GribError(
                "Thinned GRIB grid: %d row counts for %d rows"
                % (len(row_counts), nj)
            )
        ni = max(int(count) for count in row_counts)
    elif ni == 0xFFFFFFFF or nj == 0xFFFFFFFF:
        raise _GribError(
            "Thinned GRIB grid without a per-row point-count list"
        )
    unit = _angle_unit(tpl)
    la1 = _s(tpl, 46, 4) * unit
    lo1 = _s(tpl, 50, 4) * unit
    flags = tpl[54]
    la2 = _s(tpl, 55, 4) * unit
    lo2 = _s(tpl, 59, 4) * unit
    scan = tpl[71]
    # i/j increments: given when resolution flags say so, else derived
    di = _u(tpl, 63, 4) * unit if flags & 0x20 else None
    dj = _u(tpl, 67, 4) * unit if flags & 0x10 else None
    if row_counts is not None:
        # thinned rows share no Di: derive it from the corners at the
        # regularized width, then wrap the per-row expansion
        regular = _latlon_grid(ni, nj, la1, lo1, la2, lo2, None, dj, scan)
        return _ThinnedGrid(
            row_counts, nj, regular.scan, regular.geo_transform,
            regular.projection, regular.key,
        )
    return _latlon_grid(ni, nj, la1, lo1, la2, lo2, di, dj, scan)


def _latlon_grid(ni, nj, la1, lo1, la2, lo2, di, dj, scan):
    """Shared geographic-grid tail (editions 1 and 2): increments may be
    None (derive from the corner points) and corners may be in any scan
    order; the geotransform is always west-origin north-up."""
    if di is None:
        span = (lo2 - lo1) % 360.0 if not scan & 0x80 else (lo1 - lo2) % 360.0
        di = span / (ni - 1) if ni > 1 else 1.0
    if dj is None:
        dj = abs(la2 - la1) / (nj - 1) if nj > 1 else 1.0
    # west edge / north edge after normalisation
    lon_w = lo2 if scan & 0x80 else lo1
    lat_n = la1 if not scan & 0x40 else la2
    if lon_w >= 180.0:
        lon_w -= 360.0
    # grid points are nodes: expose pixel-is-point as pixel-is-area
    geo_transform = (lon_w - di / 2.0, di, 0.0, lat_n + dj / 2.0, 0.0, -dj)
    key = ("latlon", ni, nj, round(lon_w, 9), round(lat_n, 9),
           round(di, 12), round(dj, 12))
    return _Grid(ni, nj, scan, geo_transform, "EPSG:4326", key)


def _grid_lambert(tpl):
    """Grid template 3.30: Lambert conformal on the framework's LCC CRS."""
    a, b = _earth_radii(tpl, 14)
    ni = _u(tpl, 30, 4)
    nj = _u(tpl, 34, 4)
    la1 = _s(tpl, 38, 4) * 1e-6
    lo1 = _s(tpl, 42, 4) * 1e-6
    lad = _s(tpl, 47, 4) * 1e-6
    lov = _s(tpl, 51, 4) * 1e-6
    dx = _u(tpl, 55, 4) * 1e-3
    dy = _u(tpl, 59, 4) * 1e-3
    scan = tpl[64]
    latin1 = _s(tpl, 65, 4) * 1e-6
    latin2 = _s(tpl, 69, 4) * 1e-6
    if lov > 180.0:
        lov -= 360.0
    proj4 = (
        "+proj=lcc +lat_1=%.9g +lat_2=%.9g +lat_0=%.9g +lon_0=%.9g "
        "+x_0=0 +y_0=0 +a=%.9g +b=%.9g +units=m +no_defs"
        % (latin1, latin2, lad, lov, a, b)
    )
    return _projected_grid(tpl, ni, nj, la1, lo1, dx, dy, scan, proj4, "lcc")


def _projected_grid(tpl, ni, nj, la1, lo1, dx, dy, scan, proj4, kind):
    """Shared tail for projected grids: anchor the first grid point."""
    from dask_geomodeling_tpu_torch.geo.crs import get_transform_func

    if lo1 > 180.0:
        lo1 -= 360.0
    x1, y1 = get_transform_func("EPSG:4326", proj4)(
        np.array([lo1]), np.array([la1])
    )
    x1, y1 = float(x1[0]), float(y1[0])
    x_w = x1 - (ni - 1) * dx if scan & 0x80 else x1
    y_n = y1 + (nj - 1) * dy if scan & 0x40 else y1
    geo_transform = (x_w - dx / 2.0, dx, 0.0, y_n + dy / 2.0, 0.0, -dy)
    key = (kind, ni, nj, proj4, round(x_w, 6), round(y_n, 6),
           round(dx, 6), round(dy, 6))
    return _Grid(ni, nj, scan, geo_transform, proj4, key)


def _grid_mercator(tpl):
    """Grid template 3.10: Mercator with a standard parallel (LaD)."""
    a, b = _earth_radii(tpl, 14)
    ni = _u(tpl, 30, 4)
    nj = _u(tpl, 34, 4)
    la1 = _s(tpl, 38, 4) * 1e-6
    lo1 = _s(tpl, 42, 4) * 1e-6
    lad = _s(tpl, 47, 4) * 1e-6
    scan = tpl[59]
    di = _u(tpl, 64, 4) * 1e-3
    dj = _u(tpl, 68, 4) * 1e-3
    proj4 = (
        "+proj=merc +lat_ts=%.9g +lon_0=0 +x_0=0 +y_0=0 "
        "+a=%.9g +b=%.9g +units=m +no_defs" % (lad, a, b)
    )
    return _projected_grid(tpl, ni, nj, la1, lo1, di, dj, scan, proj4, "merc")


def _grid_polar_stereographic(tpl):
    """Grid template 3.20: polar stereographic (north or south)."""
    a, b = _earth_radii(tpl, 14)
    ni = _u(tpl, 30, 4)
    nj = _u(tpl, 34, 4)
    la1 = _s(tpl, 38, 4) * 1e-6
    lo1 = _s(tpl, 42, 4) * 1e-6
    lad = _s(tpl, 47, 4) * 1e-6
    lov = _s(tpl, 51, 4) * 1e-6
    dx = _u(tpl, 55, 4) * 1e-3
    dy = _u(tpl, 59, 4) * 1e-3
    south = bool(tpl[63] & 0x80)
    scan = tpl[64]
    if lov > 180.0:
        lov -= 360.0
    proj4 = (
        "+proj=stere +lat_0=%d +lat_ts=%.9g +lon_0=%.9g +x_0=0 +y_0=0 "
        "+a=%.9g +b=%.9g +units=m +no_defs"
        % (-90 if south else 90, lad, lov, a, b)
    )
    return _projected_grid(tpl, ni, nj, la1, lo1, dx, dy, scan, proj4, "ps")


def _parse_grid(section3):
    if section3[5] != 0:
        raise _GribError(
            "Only grid definition source 0 is supported (got %d)"
            % section3[5]
        )
    template = _u(section3, 12, 2)
    list_octets = section3[10]
    if list_octets:
        # quasi-regular ("thinned"): per-row point counts trail section 3
        if section3[11] != 1:
            raise _GribError(
                "Quasi-regular GRIB grids: only per-row point-count "
                "lists (interpretation 1) are supported, got %d"
                % section3[11]
            )
        if template != 0:
            raise _GribError(
                "Quasi-regular GRIB grids are only supported on the "
                "latitude/longitude template (3.0), got 3.%d" % template
            )
        nj = _u(section3, 34, 4)
        tail = len(section3) - nj * list_octets
        if tail < 72:
            raise _GribError("Thinned GRIB grid: point-count list truncated")
        counts = [
            _u(section3, tail + k * list_octets, list_octets)
            for k in range(nj)
        ]
        return _grid_latlon(section3, counts)
    if template == 0:
        return _grid_latlon(section3)
    if template == 10:
        return _grid_mercator(section3)
    if template == 20:
        return _grid_polar_stereographic(section3)
    if template == 30:
        return _grid_lambert(section3)
    raise _GribError(
        "Unsupported GRIB grid definition template 3.%d (supported: 3.0 "
        "lat/lon, 3.10 Mercator, 3.20 polar stereographic, 3.30 Lambert "
        "conformal)" % template
    )


def _scale(packed, R, E, D):
    # corrupt scale octets can overflow to inf; the values stay values
    with np.errstate(all="ignore"):
        return (R + packed.astype(np.float64) * (2.0 ** E)) / (10.0 ** D)


def _decode_simple(sec5, sec7, npts):
    """Data template 7.0: simple packing."""
    R = struct.unpack(">f", sec5[11:15])[0]
    E = _s(sec5, 15, 2)
    D = _s(sec5, 17, 2)
    nbits = sec5[19]
    if nbits == 0:
        return np.full(npts, _scale(np.zeros(1), R, E, D)[0]), None
    packed = _unpack_bits(sec7[5:], nbits, npts)
    return _scale(packed, R, E, D), None


def _complex_groups(sec5, sec7, npts, data_offset_bits):
    """Shared group unpacking for templates 7.2/7.3: integer field +
    missing mask (missing-value management 0 or 1)."""
    nbits = sec5[19]
    missing_mgmt = sec5[22]
    if missing_mgmt not in (0, 1):
        raise _GribError(
            "GRIB complex packing: missing value management %d is not "
            "supported (0 and 1 are)" % missing_mgmt
        )
    ng = _u(sec5, 31, 4)
    width_ref = sec5[35]
    width_bits = sec5[36]
    len_ref = _u(sec5, 37, 4)
    len_inc = sec5[41]
    last_len = _u(sec5, 42, 4)
    len_bits = sec5[46]

    stream = sec7[5:]
    size = 8 * len(stream)  # the bits of the data stream

    def take(offset_bits, width, count):
        if width == 0 or count == 0:
            return np.zeros(count, dtype=np.int64)
        end = offset_bits + count * width
        if end > size:
            raise _GribError(
                "GRIB bitstream truncated: need %d bits, have %d"
                % (end, size)
            )
        return _fields(stream, width, count, offset_bits)

    pos = data_offset_bits
    refs = take(pos, nbits, ng)
    pos += ng * nbits
    pos += (-pos) % 8  # groups are byte-aligned between the three lists
    widths = take(pos, width_bits, ng) + width_ref
    pos += ng * width_bits
    pos += (-pos) % 8
    lengths = take(pos, len_bits, ng) * len_inc + len_ref
    pos += ng * len_bits
    pos += (-pos) % 8
    if ng:
        lengths[-1] = last_len
    total = int(lengths.sum())
    if total != npts:
        raise _GribError(
            "GRIB complex packing: group lengths sum to %d, expected %d"
            % (total, npts)
        )
    if ng and (widths.min() < 0 or lengths.min() < 0):
        raise _GribError(
            "GRIB complex packing: group widths or lengths overflow 64 bits"
        )

    # each group's bits, and where they start: the groups follow one
    # another without alignment; a group's bit count saturates at one
    # past the stream (it ends beyond it either way, and its product
    # could overflow)
    reads = (widths > 0) & (lengths > 0)
    clipped = np.minimum(widths, size + 1)
    inside = lengths <= size // np.maximum(clipped, 1)
    counts = np.where(reads, np.where(inside, lengths * clipped, size + 1), 0)
    ends = pos + np.cumsum(counts)
    short = reads & (ends > size)
    if short.any():
        g = int(np.argmax(short))  # the first group the loop finds short
        raise _GribError(
            "GRIB bitstream truncated: need %d bits, have %d"
            % (int(ends[g] - counts[g]) + int(lengths[g]) * int(widths[g]), size)
        )

    # the values of the groups that have bits, each at its group's first
    # bit plus its rank in the group times the width; the other groups'
    # values are their references
    field = np.repeat(refs, lengths)
    read = np.flatnonzero(reads)
    counts_read = lengths[read]
    rank = np.arange(int(counts_read.sum()), dtype=np.int64) - np.repeat(
        np.cumsum(counts_read) - counts_read, counts_read)
    width = np.repeat(widths[read], counts_read)
    index = np.repeat((np.cumsum(lengths) - lengths)[read], counts_read) + rank
    vals = _bit_fields(stream, np.repeat((ends - counts)[read], counts_read) + rank * width,
                       width)
    field[index] += vals
    missing = None
    if missing_mgmt:
        # all ones in the group's width; a zero-width group's reference
        # all ones in nbits (an all-ones mask of 64 bits or more matches
        # no int64, as in the loop)
        ones_ref = (widths == 0) & (0 < nbits < 64) & (refs == (1 << min(nbits, 63)) - 1)
        missing = np.repeat(ones_ref, lengths)
        ones = (np.int64(1) << np.minimum(width, 63)) - 1
        missing[index] = (width < 64) & (vals == ones)
    return field, missing


def _decode_complex(sec5, sec7, npts):
    """Data template 7.2: complex packing."""
    R = struct.unpack(">f", sec5[11:15])[0]
    E = _s(sec5, 15, 2)
    D = _s(sec5, 17, 2)
    field, missing = _complex_groups(sec5, sec7, npts, 0)
    values = _scale(field, R, E, D)
    return values, missing


def _decode_complex_diff(sec5, sec7, npts):
    """Data template 7.3: complex packing with spatial differencing."""
    R = struct.unpack(">f", sec5[11:15])[0]
    E = _s(sec5, 15, 2)
    D = _s(sec5, 17, 2)
    order = sec5[47]
    nb = sec5[48]  # octets per extra descriptor
    if order not in (1, 2):
        raise _GribError(
            "GRIB spatial differencing order %d is not supported" % order
        )
    if sec5[22] != 0:
        raise _GribError(
            "GRIB spatial differencing with missing-value management "
            "is not supported"
        )
    # initial value(s) + overall minimum precede the packed groups
    initials = [_s(sec7, 5 + i * nb, nb) for i in range(order)]
    gmin = _s(sec7, 5 + order * nb, nb)
    field, _ = _complex_groups(sec5, sec7, npts, (order + 1) * nb * 8)
    diffs = field + gmin
    if order == 1:
        diffs[0] = initials[0]
        values = np.cumsum(diffs)
    elif npts == 1:
        values = np.array([initials[0]], dtype=np.int64)
    else:
        # second differences: integrate twice from the two seed values
        # (positions 0..order-1 of the packed stream are placeholders)
        first = np.cumsum(
            np.concatenate(([initials[1] - initials[0]], diffs[2:]))
        )
        values = np.concatenate(
            ([initials[0]], initials[0] + np.cumsum(first))
        )
    return _scale(values, R, E, D), None


def _decode_jpeg2000_packed(sec5, sec7, npts):
    """Data template 7.40: the data section is a JPEG2000 codestream.  A
    constant field decodes; any other raises NotImplementedError: the port
    has no JPEG 2000 decoder (the JAX package decodes it with Pillow's
    OpenJPEG binding)."""
    R = struct.unpack(">f", sec5[11:15])[0]
    E = _s(sec5, 15, 2)
    D = _s(sec5, 17, 2)
    nbits = sec5[19]
    if nbits == 0:
        return np.full(npts, _scale(np.zeros(1), R, E, D)[0]), None
    raise NotImplementedError(
        "decoding GRIB data representation template 5.40 (JPEG 2000 "
        "packing) is not ported: the port has no JPEG 2000 decoder; "
        "dask_geomodeling_tpu/io/grib.py decodes it with Pillow"
    )


def _decode_ccsds_packed(sec5, sec7, npts):
    """Data template 7.42: CCSDS/AEC recompression, decoded through the
    system libaec (io/ccsds.py) — the template's flags octet is libaec's
    flag word by WMO definition, exactly how the reference's GDAL build
    links the same library."""
    from dask_geomodeling_tpu_torch.io.ccsds import aec_decode

    R = struct.unpack(">f", sec5[11:15])[0]
    E = _s(sec5, 15, 2)
    D = _s(sec5, 17, 2)
    nbits = sec5[19]
    if nbits == 0:
        return np.full(npts, _scale(np.zeros(1), R, E, D)[0]), None
    flags = sec5[21]
    block_size = sec5[22]
    rsi = _u(sec5, 23, 2)
    nbytes = (nbits + 7) // 8
    if nbytes == 3 and not flags & 0x02:  # no AEC_DATA_3BYTE: 4-byte cells
        nbytes = 4
    raw = aec_decode(
        bytes(sec7[5:]), npts * nbytes, nbits, block_size, rsi, flags
    )
    if len(raw) < npts * nbytes:
        raise _GribError(
            "GRIB CCSDS packing: decoded %d bytes, expected %d"
            % (len(raw), npts * nbytes)
        )
    msb = bool(flags & 0x04)  # AEC_DATA_MSB
    if nbytes == 3:  # AEC_DATA_3BYTE cells
        triplets = (
            np.frombuffer(raw[: npts * 3], np.uint8)
            .reshape(npts, 3)
            .astype(np.int64)
        )
        if msb:
            packed = (triplets[:, 0] << 16) | (triplets[:, 1] << 8) | triplets[:, 2]
        else:
            packed = (triplets[:, 2] << 16) | (triplets[:, 1] << 8) | triplets[:, 0]
    else:
        cell = {1: "u1", 2: "u2", 4: "u4"}[nbytes]
        packed = np.frombuffer(
            raw[: npts * nbytes], (">" if msb else "<") + cell
        ).astype(np.int64)
    return _scale(packed, R, E, D), None


def _decode_png_packed(sec5, sec7, npts):
    """Data template 7.41: PNG packing."""
    from dask_geomodeling_tpu_torch.io.png import decode_png_bytes

    R = struct.unpack(">f", sec5[11:15])[0]
    E = _s(sec5, 15, 2)
    D = _s(sec5, 17, 2)
    nbits = sec5[19]
    if nbits == 0:
        return np.full(npts, _scale(np.zeros(1), R, E, D)[0]), None
    bands, _ = decode_png_bytes(bytes(sec7[5:]), source="<grib>")
    if bands.shape[0] == 1:
        packed = bands[0].astype(np.int64).ravel()
    else:
        # 24/32-bit samples arrive as RGB(A) byte planes: recombine
        packed = np.zeros(bands.shape[1:], dtype=np.int64).ravel()
        for plane in bands.astype(np.int64):
            packed = (packed << 8) | plane.ravel()
    if packed.size != npts:
        raise _GribError(
            "GRIB PNG packing: %d samples decoded, expected %d"
            % (packed.size, npts)
        )
    return _scale(packed, R, E, D), None


def _ref_time(sec1):
    return datetime(
        _u(sec1, 12, 2), sec1[14], sec1[15], sec1[16], sec1[17],
        min(sec1[18], 59),
    )


def _level_label(sec4):
    """'level=isobaric (Pa) 50000' style text from the fixed-surface
    octets of the common product templates."""
    if len(sec4) < 34:
        return ""
    surface_type = sec4[22]
    if surface_type in (0, 255):
        return ""
    label = _SURFACES.get(surface_type, "surface type %d" % surface_type)
    scale = _s(sec4, 23, 1)
    value = _u(sec4, 24, 4)
    if value != 0xFFFFFFFF and sec4[23] != 255:
        return " level=%s %g" % (label, value / (10.0 ** scale))
    return " level=%s" % label


def _forecast_label(sec4):
    """Human-readable forecast offset from the common product octets."""
    template = _u(sec4, 7, 2)  # octets 8-9 of section 4
    if len(sec4) < 22 or template > 15:
        return ""
    unit = sec4[17]
    value = _s(sec4, 18, 4)
    label, _seconds = _TIME_UNITS.get(unit, ("?", 0))
    if label == "h" and unit in (10, 11, 12):
        value *= {10: 3, 11: 6, 12: 12}[unit]
    return "+%d%s" % (value, label)


# ---------------------------------------------------------- edition 1

# WMO table 2 (versions 1-3) parameter indicators -> GDAL-style names
_GRIB1_PARAMETERS = {
    1: "PRES", 2: "PRMSL", 6: "GP", 7: "HGT", 11: "TMP", 15: "TMAX",
    16: "TMIN", 17: "DPT", 32: "WIND", 33: "UGRD", 34: "VGRD",
    39: "VVEL", 51: "SPFH", 52: "RH", 54: "PWAT", 59: "PRATE",
    61: "APCP", 65: "WEASD", 66: "SNOD", 71: "TCDC", 81: "LAND",
    85: "TSOIL", 91: "ICEC", 101: "WVHGT",
}

# WMO table 3 level-type indicators (the 2-octet value's meaning)
_GRIB1_SURFACES = {
    1: "surface",
    2: "cloud base",
    3: "cloud top",
    4: "0C isotherm",
    7: "tropopause",
    100: "isobaric (hPa)",
    102: "mean sea level",
    103: "altitude above MSL (m)",
    105: "height above ground (m)",
    111: "depth below surface (cm)",
    200: "entire atmosphere",
}

_GRIB1_TIME_UNITS = {0: ("m", 60), 1: ("h", 3600), 2: ("d", 86400),
                     10: ("h", 3 * 3600), 11: ("h", 6 * 3600),
                     12: ("h", 12 * 3600), 254: ("s", 1)}


def _ibm_float(raw):
    """IBM System/360 single-precision float (the BDS reference value R;
    edition 2 switched to IEEE 754)."""
    sign = -1.0 if raw & 0x80000000 else 1.0
    exponent = ((raw >> 24) & 0x7F) - 64
    mantissa = (raw & 0xFFFFFF) / float(1 << 24)
    return sign * mantissa * 16.0 ** exponent


def _grib1_earth(flags):
    """Resolution/component flag bit 0x40 picks the oblate IAU-1965
    spheroid; unset means the 6367.47 km sphere (code table 7)."""
    return (6378160.0, 6356775.0) if flags & 0x40 else (6367470.0, 6367470.0)


def _grib1_row_counts(gds, nj):
    """Edition-1 per-row point counts (the PL list): octet 5 locates the
    PV/PL block; any vertical parameters (octet 4) come first."""
    nv, location = gds[3], gds[4]
    if location in (0, 0xFF):
        raise _GribError(
            "Thinned GRIB-1 grid without a per-row point-count list"
        )
    start = location - 1 + nv * 4
    if start + 2 * nj > len(gds):
        raise _GribError("Thinned GRIB-1 grid: point-count list truncated")
    return [_u(gds, start + 2 * k, 2) for k in range(nj)]


def _grib1_grid(gds):
    """A _Grid from an edition-1 Grid Description Section (coordinates
    in millidegrees, increments in millidegrees or metres by type)."""
    rep = gds[5]
    ni, nj = _u(gds, 6, 2), _u(gds, 8, 2)
    thinned = ni == 0xFFFF
    if nj == 0xFFFF or (thinned and rep not in (0, 4)):
        raise _GribError(
            "Quasi-regular (thinned) GRIB-1 grids are only supported on "
            "latitude/longitude and Gaussian representations"
        )
    la1 = _s(gds, 10, 3) * 1e-3
    lo1 = _s(gds, 13, 3) * 1e-3
    flags = gds[16]

    if rep in (0, 4) and thinned:
        # thinned latitude/longitude; Gaussian (rep 4, e.g. ECMWF reduced
        # N-grids) exposes rows as equally spaced between the corner
        # latitudes — the standard regularization approximation (true
        # Gaussian latitudes deviate by a fraction of a row near poles)
        counts = _grib1_row_counts(gds, nj)
        la2 = _s(gds, 17, 3) * 1e-3
        lo2 = _s(gds, 20, 3) * 1e-3
        scan = gds[27]
        regular = _latlon_grid(
            max(counts), nj, la1, lo1, la2, lo2, None, None, scan
        )
        return _ThinnedGrid(
            counts, nj, regular.scan, regular.geo_transform,
            regular.projection, regular.key,
        )

    if rep == 0:  # regular latitude/longitude
        la2 = _s(gds, 17, 3) * 1e-3
        lo2 = _s(gds, 20, 3) * 1e-3
        scan = gds[27]
        di = dj = None
        if flags & 0x80:  # direction increments given (0xFFFF = missing)
            if _u(gds, 23, 2) != 0xFFFF:
                di = _u(gds, 23, 2) * 1e-3
            if _u(gds, 25, 2) != 0xFFFF:
                dj = _u(gds, 25, 2) * 1e-3
        return _latlon_grid(ni, nj, la1, lo1, la2, lo2, di, dj, scan)

    a, b = _grib1_earth(flags)
    if rep == 1:  # Mercator
        latin = _s(gds, 23, 3) * 1e-3
        scan = gds[27]
        di = _u(gds, 28, 3) * 1.0
        dj = _u(gds, 31, 3) * 1.0
        proj4 = (
            "+proj=merc +lat_ts=%.9g +lon_0=0 +x_0=0 +y_0=0 "
            "+a=%.9g +b=%.9g +units=m +no_defs" % (latin, a, b)
        )
        return _projected_grid(gds, ni, nj, la1, lo1, di, dj, scan,
                               proj4, "merc")
    if rep == 3:  # Lambert conformal
        lov = _s(gds, 17, 3) * 1e-3
        dx = _u(gds, 20, 3) * 1.0
        dy = _u(gds, 23, 3) * 1.0
        scan = gds[27]
        latin1 = _s(gds, 28, 3) * 1e-3
        latin2 = _s(gds, 31, 3) * 1e-3
        if lov > 180.0:
            lov -= 360.0
        proj4 = (
            "+proj=lcc +lat_1=%.9g +lat_2=%.9g +lat_0=%.9g +lon_0=%.9g "
            "+x_0=0 +y_0=0 +a=%.9g +b=%.9g +units=m +no_defs"
            % (latin1, latin2, latin1, lov, a, b)
        )
        return _projected_grid(gds, ni, nj, la1, lo1, dx, dy, scan,
                               proj4, "lcc")
    if rep == 5:  # polar stereographic (true scale fixed at 60 deg)
        lov = _s(gds, 17, 3) * 1e-3
        dx = _u(gds, 20, 3) * 1.0
        dy = _u(gds, 23, 3) * 1.0
        south = bool(gds[26] & 0x80)
        scan = gds[27]
        if lov > 180.0:
            lov -= 360.0
        proj4 = (
            "+proj=stere +lat_0=%d +lat_ts=%d +lon_0=%.9g +x_0=0 +y_0=0 "
            "+a=%.9g +b=%.9g +units=m +no_defs"
            % (-90 if south else 90, -60 if south else 60, lov, a, b)
        )
        return _projected_grid(gds, ni, nj, la1, lo1, dx, dy, scan,
                               proj4, "ps")
    raise _GribError(
        "Unsupported GRIB1 data representation type %d (supported: 0 "
        "lat/lon, 1 Mercator, 3 Lambert conformal, 5 polar "
        "stereographic)" % rep
    )


def _grib1_decode(bds, npacked, D):
    """Unpack an edition-1 Binary Data Section (simple packing only)."""
    flags = bds[3] >> 4
    if flags & 0x8:
        raise _GribError("GRIB1 spherical-harmonic data is not supported")
    if flags & 0x4:
        raise _GribError("GRIB1 second-order packing is not supported")
    E = _s(bds, 4, 2)
    R = _ibm_float(_u(bds, 6, 4))
    nbits = bds[10]
    scale = 10.0 ** -D
    if nbits == 0:  # constant field: every point equals the reference
        return np.full(npacked, R * scale)
    X = _unpack_bits(bds[11:], nbits, npacked)
    return (R + X.astype(np.float64) * 2.0 ** E) * scale


def _grib1_ref_time(pds):
    century = pds[24] if len(pds) > 24 else 20
    year = (century - 1) * 100 + pds[12]
    return datetime(year, pds[13], pds[14], pds[15], pds[16])


def _grib1_meta(pds):
    parameter = pds[8]
    meta = "GRIB1 parameter=%d" % parameter
    element = _GRIB1_PARAMETERS.get(parameter)
    if element:
        meta += " element=%s" % element
    level_type = pds[9]
    surface = _GRIB1_SURFACES.get(level_type)
    if surface:
        meta += ' level="%d %s"' % (_u(pds, 10, 2), surface)
    trange = pds[20]
    unit = _GRIB1_TIME_UNITS.get(pds[17])
    if unit is not None:
        forecast = _u(pds, 18, 2) if trange == 10 else pds[18]
        label, seconds = unit
        if label == "h" and seconds > 3600:  # 3/6/12-hour units
            forecast *= seconds // 3600
        meta += " forecastTime=+%d%s" % (forecast, label)
    meta += " refTime=%s" % _grib1_ref_time(pds).isoformat()
    return meta


def _read_grib1_message(buf, idx, grid, bands, metadata):
    """Decode one edition-1 message in place; returns (grid, total_len)."""
    total = _u(buf, idx + 4, 3)
    message = buf[idx : idx + total]
    if message[-4:] != b"7777":
        raise _GribError("GRIB message missing 7777 end marker")

    pos = 8
    pds = message[pos : pos + _u(message, pos, 3)]
    pos += len(pds)
    has_gds = bool(pds[7] & 0x80)
    has_bms = bool(pds[7] & 0x40)
    D = _s(pds, 26, 2)

    if not has_gds:
        raise _GribError(
            "GRIB1 message uses a pre-defined grid (no GDS, grid id %d); "
            "only messages carrying an explicit Grid Description Section "
            "are supported" % pds[6]
        )
    gds = message[pos : pos + _u(message, pos, 3)]
    pos += len(gds)
    grid_here = _grib1_grid(gds)
    if grid is not None and grid_here.key != grid.key:
        raise _GribError(
            "GRIB messages define different grids; cannot stack fields "
            "into one raster"
        )
    grid = grid_here

    bitmap = None
    if has_bms:
        bms = message[pos : pos + _u(message, pos, 3)]
        pos += len(bms)
        if _u(bms, 4, 2) != 0:
            raise _GribError(
                "Pre-defined GRIB1 bitmaps (table reference %d) are not "
                "supported" % _u(bms, 4, 2)
            )
        bitmap = _unpack_bits(bms[6:], 1, grid.npoints).astype(bool)

    bds = message[pos : pos + _u(message, pos, 3)]
    npacked = int(bitmap.sum()) if bitmap is not None else grid.npoints
    values = _grib1_decode(bds, npacked, D)
    if bitmap is not None:
        full = np.full(grid.npoints, _FILL)
        full[bitmap] = values
        values = full
    bands.append(grid.to_array(values))
    metadata.append(_grib1_meta(pds))
    return grid, total


def read_grib(path):
    """Read a GRIB1/GRIB2 file into a RasterData payload (one band per
    field)."""
    from dask_geomodeling_tpu_torch.raster.sources import RasterData

    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"GRIB":
        raise IOError("Not a GRIB file: '%s'" % path)
    try:
        return _read_grib_messages(buf, path, RasterData)
    except (struct.error, IndexError, KeyError, OverflowError,
            TypeError) as e:
        # low-level parse failures on corrupt/truncated streams surface
        # as the format error serving code already handles
        raise _GribError(
            "Corrupt or truncated GRIB file '%s': %r" % (path, e)
        )


def _read_grib_messages(buf, path, RasterData):
    bands = []
    metadata = []
    grid = None
    pos = 0
    while pos < len(buf):
        # seek the next message indicator (files may carry padding)
        idx = buf.find(b"GRIB", pos)
        if idx < 0:
            break
        if buf[idx + 7] == 1:
            grid, total = _read_grib1_message(buf, idx, grid, bands, metadata)
            if total <= 8:
                raise _GribError("Corrupt GRIB1 message length %d" % total)
            pos = idx + total
            continue
        if buf[idx + 7] != 2:
            raise _GribError(
                "Only GRIB editions 1 and 2 are supported (got edition %d)"
                % buf[idx + 7]
            )
        discipline = buf[idx + 6]
        total = _u(buf, idx + 8, 8)
        if total <= 16:
            raise _GribError("Corrupt GRIB2 message length %d" % total)
        message = buf[idx : idx + total]
        if message[-4:] != b"7777":
            raise _GribError("GRIB message missing 7777 end marker")
        pos = idx + total

        sec1 = sec3 = sec4 = sec5 = None
        bitmap = None
        mpos = 16
        while mpos < total - 4:
            length = _u(message, mpos, 4)
            if length < 5:
                raise _GribError(
                    "Corrupt GRIB section header: length %d at offset %d"
                    % (length, mpos)
                )
            number = message[mpos + 4]
            section = message[mpos : mpos + length]
            if number == 1:
                sec1 = section
            elif number == 3:
                sec3 = section
                grid_here = _parse_grid(section)
                if grid is not None and grid_here.key != grid.key:
                    raise _GribError(
                        "GRIB messages define different grids; cannot "
                        "stack fields into one raster"
                    )
                # keep the message's own grid: equal keys normalise to
                # the same georeferencing but scanning modes may differ
                grid = grid_here
            elif number == 4:
                sec4 = section
            elif number == 5:
                sec5 = section
            elif number == 6:
                indicator = section[5]
                if indicator == 0:
                    nbm = grid.npoints if grid else 0
                    bitmap = _unpack_bits(section[6:], 1, nbm).astype(bool)
                elif indicator == 254:
                    pass  # previously defined bitmap applies
                elif indicator == 255:
                    bitmap = None
                else:
                    raise _GribError(
                        "Pre-defined GRIB bitmaps (indicator %d) are not "
                        "supported" % indicator
                    )
            elif number == 7:
                if sec3 is None or sec5 is None:
                    raise _GribError("GRIB data section before grid/packing")
                npts = _u(sec5, 5, 4)
                template = _u(sec5, 9, 2)
                if template == 0:
                    values, missing = _decode_simple(sec5, section, npts)
                elif template == 2:
                    values, missing = _decode_complex(sec5, section, npts)
                elif template == 3:
                    values, missing = _decode_complex_diff(sec5, section, npts)
                elif template == 40:
                    values, missing = _decode_jpeg2000_packed(
                        sec5, section, npts
                    )
                elif template == 41:
                    values, missing = _decode_png_packed(sec5, section, npts)
                elif template == 42:
                    values, missing = _decode_ccsds_packed(
                        sec5, section, npts
                    )
                else:
                    raise _GribError(
                        "Unsupported GRIB data representation template "
                        "5.%d (supported: 5.0, 5.2, 5.3, 5.40, 5.41, 5.42)"
                        % template
                    )
                if missing is not None:
                    values = values.copy()
                    values[missing] = _FILL
                if bitmap is not None:
                    full = np.full(grid.npoints, _FILL)
                    full[bitmap] = values
                    values = full
                elif values.size != grid.npoints:
                    raise _GribError(
                        "GRIB field has %d points, grid %d"
                        % (values.size, grid.npoints)
                    )
                bands.append(grid.to_array(values))
                meta = "GRIB discipline=%d" % discipline
                if sec4 is not None:
                    element = _PARAMETERS.get(
                        (discipline, sec4[9], sec4[10])
                    )
                    if element:
                        meta += " element=%s" % element
                    meta += " parameterCategory=%d parameterNumber=%d" % (
                        sec4[9], sec4[10],
                    )
                    meta += _level_label(sec4)
                    forecast = _forecast_label(sec4)
                    if forecast:
                        meta += " forecastTime=%s" % forecast
                if sec1 is not None:
                    meta += " refTime=%s" % _ref_time(sec1).isoformat()
                metadata.append(meta)
            mpos += length

    if not bands:
        raise _GribError("GRIB file contains no decodable fields: '%s'" % path)
    array = np.stack(bands)
    return RasterData(
        array=array,
        projection=grid.projection,
        geo_transform=grid.geo_transform,
        no_data_value=_FILL,
        metadata=metadata,
    )
