"""Coordinate reference systems and transforms: the subset the port's paths
use.

Counterpart of dask_geomodeling_tpu/geo/crs.py, copied for three CRSes
and giving the same float64 bits (the coarse warp grid and the numpy
ground truth both rest on them):

- EPSG:4326, WGS 84 geographic;
- EPSG:3857, spherical ("web") Mercator on the WGS84 semi-major axis;
- EPSG:28992, Amersfoort / RD New: oblique stereographic (EPSG method
  9809) on the Bessel ellipsoid, with the 7-parameter position-vector
  Helmert shift to WGS84 (EPSG transformation 15934) through geocentric
  coordinates.

Each writes and reads the WKT the JAX package's ``ExportToWkt`` gives for
it (a GeoTIFF's PAM sidecar and a VRT carry one); a WKT is read by the
EPSG authority that closes it, the JAX package's shortcut for such text.
Any other CRS raises NotImplementedError naming it.  The JAX package's
other projection families, its general WKT/proj4 parsing and its NTv2
grid shifts are not ported.
"""
import re
from functools import lru_cache

import numpy as np

__all__ = [
    "SpatialReference",
    "get_sr",
    "get_projection",
    "get_epsg_or_wkt",
    "transform_points",
    "transform_extent",
    "get_transform_func",
]


# ellipsoids: (semi-major axis a, inverse flattening 1/f)
ELLIPSOIDS = {
    "WGS84": (6378137.0, 298.257223563),
    "bessel": (6377397.155, 299.1528128),
}

# datums: ellipsoid + position-vector Helmert to WGS84
# (tx, ty, tz [m], rx, ry, rz [arcsec], ds [ppm]); None = WGS84 itself
DATUMS = {
    "WGS84": ("WGS84", None),
    # Amersfoort to WGS84 (EPSG transformation 15934)
    "Amersfoort": (
        "bessel",
        (565.417, 50.3319, 465.552, -0.398957, 0.343988, -1.87740, 4.0725),
    ),
}

_ARCSEC = np.pi / (180.0 * 3600.0)


class _Ellipsoid:
    def __init__(self, a, inv_f):
        self.a = a
        self.f = 0.0 if np.isinf(inv_f) else 1.0 / inv_f
        self.e2 = self.f * (2.0 - self.f)
        self.e = np.sqrt(self.e2)
        self.b = a * (1.0 - self.f)


@lru_cache(maxsize=None)
def _ellipsoid(name):
    return _Ellipsoid(*ELLIPSOIDS[name])


# --- geodetic <-> geocentric, Helmert ---


def _geodetic_to_geocentric(ell, lon, lat):
    lam = np.radians(lon)
    phi = np.radians(lat)
    sin_phi = np.sin(phi)
    nu = ell.a / np.sqrt(1.0 - ell.e2 * sin_phi**2)
    x = nu * np.cos(phi) * np.cos(lam)
    y = nu * np.cos(phi) * np.sin(lam)
    z = nu * (1.0 - ell.e2) * sin_phi
    return x, y, z


def _geocentric_to_geodetic(ell, x, y, z):
    lam = np.arctan2(y, x)
    p = np.hypot(x, y)
    # iterated prime-vertical correction (converges in a few rounds)
    phi = np.arctan2(z, p * (1.0 - ell.e2))
    for _ in range(3):
        sin_phi = np.sin(phi)
        nu = ell.a / np.sqrt(1.0 - ell.e2 * sin_phi**2)
        phi = np.arctan2(z + ell.e2 * nu * sin_phi, p)
    return np.degrees(lam), np.degrees(phi)


def _helmert(params, x, y, z, inverse=False):
    tx, ty, tz, rx, ry, rz = (
        params[0],
        params[1],
        params[2],
        params[3] * _ARCSEC,
        params[4] * _ARCSEC,
        params[5] * _ARCSEC,
    )
    scale = 1.0 + params[6] * 1e-6
    if not inverse:
        # position-vector convention (EPSG 9606)
        x2 = tx + scale * (x - rz * y + ry * z)
        y2 = ty + scale * (rz * x + y - rx * z)
        z2 = tz + scale * (-ry * x + rx * y + z)
        return x2, y2, z2
    # exact inverse of the linearized transform
    u, v, w = (x - tx) / scale, (y - ty) / scale, (z - tz) / scale
    det = 1.0 + rx * rx + ry * ry + rz * rz
    x2 = (u * (1 + rx * rx) + v * (rz + rx * ry) + w * (rx * rz - ry)) / det
    y2 = (u * (rx * ry - rz) + v * (1 + ry * ry) + w * (rx + ry * rz)) / det
    z2 = (u * (ry + rx * rz) + v * (ry * rz - rx) + w * (1 + rz * rz)) / det
    return x2, y2, z2


# --- projections (operate in the CRS's own datum) ---


class _GeographicProjection:
    is_geographic = True

    def forward(self, lon, lat):
        return lon, lat

    def inverse(self, x, y):
        return x, y


class _WebMercator:
    """Spherical Mercator on the WGS84 semi-major axis (EPSG:3857)."""

    is_geographic = False
    R = 6378137.0

    def forward(self, lon, lat):
        lat = np.clip(np.asarray(lat, dtype=float), -89.9999999, 89.9999999)
        x = self.R * np.radians(lon)
        y = self.R * np.log(np.tan(np.pi / 4.0 + np.radians(lat) / 2.0))
        return x, y

    def inverse(self, x, y):
        lon = np.degrees(np.asarray(x, dtype=float) / self.R)
        lat = np.degrees(
            2.0 * np.arctan(np.exp(np.asarray(y, dtype=float) / self.R)) - np.pi / 2.0
        )
        return lon, lat


class _ObliqueStereographic:
    """Oblique stereographic projection, EPSG method 9809 (RD New)."""

    is_geographic = False

    def __init__(self, ell, lon0, lat0, k0, false_easting, false_northing):
        self.ell = ell
        self.k0 = k0
        self.fe = false_easting
        self.fn = false_northing
        e, e2 = ell.e, ell.e2
        phi0 = np.radians(lat0)
        self.lam0 = np.radians(lon0)
        sin0, cos0 = np.sin(phi0), np.cos(phi0)
        rho0 = ell.a * (1 - e2) / (1 - e2 * sin0**2) ** 1.5
        nu0 = ell.a / np.sqrt(1 - e2 * sin0**2)
        self.R = np.sqrt(rho0 * nu0)
        self.n = np.sqrt(1 + (e2 * cos0**4) / (1 - e2))
        s1 = (1 + sin0) / (1 - sin0)
        s2 = (1 - e * sin0) / (1 + e * sin0)
        w1 = (s1 * s2**e) ** self.n
        sin_chi0 = (w1 - 1) / (w1 + 1)
        self.c = (
            (self.n + sin0) * (1 - sin_chi0) / ((self.n - sin0) * (1 + sin_chi0))
        )
        w2 = self.c * w1
        self.chi0 = np.arcsin((w2 - 1) / (w2 + 1))
        self.big_lam0 = self.lam0

    def forward(self, lon, lat):
        e = self.ell.e
        phi = np.radians(np.asarray(lat, dtype=float))
        lam = np.radians(np.asarray(lon, dtype=float))
        sin_phi = np.sin(phi)
        w = (
            self.c
            * (
                (1 + sin_phi)
                / (1 - sin_phi)
                * ((1 - e * sin_phi) / (1 + e * sin_phi)) ** e
            )
            ** self.n
        )
        chi = np.arcsin((w - 1) / (w + 1))
        big_lam = self.n * (lam - self.lam0) + self.big_lam0
        dl = big_lam - self.big_lam0
        b = 1 + np.sin(chi) * np.sin(self.chi0) + np.cos(chi) * np.cos(
            self.chi0
        ) * np.cos(dl)
        x = self.fe + 2 * self.R * self.k0 * np.cos(chi) * np.sin(dl) / b
        y = self.fn + 2 * self.R * self.k0 * (
            np.sin(chi) * np.cos(self.chi0)
            - np.cos(chi) * np.sin(self.chi0) * np.cos(dl)
        ) / b
        return x, y

    def inverse(self, x, y):
        e = self.ell.e
        de = np.asarray(x, dtype=float) - self.fe
        dn = np.asarray(y, dtype=float) - self.fn
        rk2 = 2 * self.R * self.k0
        g = rk2 * np.tan(np.pi / 4 - self.chi0 / 2)
        h = 2 * rk2 * np.tan(self.chi0) + g
        i = np.arctan2(de, h + dn)
        j = np.arctan2(de, g - dn) - i
        chi = self.chi0 + 2 * np.arctan2(dn - de * np.tan(j / 2), rk2)
        big_lam = j + 2 * i + self.big_lam0
        lam = (big_lam - self.big_lam0) / self.n + self.lam0
        # isometric latitude, then iterate for phi
        psi = 0.5 * np.log((1 + np.sin(chi)) / (self.c * (1 - np.sin(chi)))) / self.n
        phi = 2 * np.arctan(np.exp(psi)) - np.pi / 2
        for _ in range(6):
            sin_phi = np.sin(phi)
            psi_i = np.log(
                np.tan(phi / 2 + np.pi / 4)
                * ((1 - e * sin_phi) / (1 + e * sin_phi)) ** (e / 2)
            )
            phi = phi - (psi_i - psi) * np.cos(phi) * (1 - e * e * sin_phi * sin_phi) / (
                1 - e * e
            )
        return np.degrees(lam), np.degrees(phi)


class SpatialReference:
    """A CRS: a datum plus a projection, identified by its EPSG code."""

    def __init__(self, code, name, datum, projection):
        self.code = code
        self.name = name
        self.datum = datum  # key into DATUMS
        self.projection = projection

    @property
    def is_geographic(self):
        return self.projection.is_geographic

    @property
    def ellipsoid(self):
        return _ellipsoid(DATUMS[self.datum][0])

    @property
    def helmert_to_wgs84(self):
        return DATUMS[self.datum][1]

    def IsGeographic(self):
        return self.is_geographic

    def ExportToWkt(self):
        """The JAX package's WKT of this CRS."""
        return _WKT[self.code]

    def __repr__(self):
        return "<SpatialReference EPSG:{} {}>".format(self.code, self.name)

    def __eq__(self, other):
        return isinstance(other, SpatialReference) and self.code == other.code

    def __hash__(self):
        return hash(self.code)


@lru_cache(maxsize=None)
def _registry_get(code):
    if code == 4326:
        return SpatialReference(4326, "WGS 84", "WGS84", _GeographicProjection())
    if code in (3857, 900913, 3785):
        return SpatialReference(
            3857, "WGS 84 / Pseudo-Mercator", "WGS84", _WebMercator()
        )
    if code == 28992:
        return SpatialReference(
            28992,
            "Amersfoort / RD New",
            "Amersfoort",
            _ObliqueStereographic(
                _ellipsoid("bessel"),
                lon0=5.0 + 23.0 / 60 + 15.5 / 3600,
                lat0=52.0 + 9.0 / 60 + 22.178 / 3600,
                k0=0.9999079,
                false_easting=155000.0,
                false_northing=463000.0,
            ),
        )
    raise NotImplementedError(
        "EPSG:%d is not ported; the port knows EPSG:4326, EPSG:3857 and "
        "EPSG:28992" % code
    )


_EPSG_RE = re.compile(r"^(?:EPSG|epsg):(\d+)$")
#: an OGC URN or URL naming an EPSG code (GeoJSON's legacy named crs,
#: GML's srsName)
_URN_RE = re.compile(
    r"^(?:urn:ogc:def:crs:EPSG:[^:]*:|https?://www\.opengis\.net/def/crs/EPSG/[^/]*/)(\d+)$",
    re.IGNORECASE,
)
#: OGC's lon/lat WGS84 (WMS 1.3's CRS:84, GeoJSON's CRS84 URN)
_CRS84_RE = re.compile(r"^(urn:ogc:def:crs:OGC:[\d.]*:|OGC:)?CRS:?84$", re.IGNORECASE)
#: the EPSG authority closing a WKT text
_WKT_AUTH_RE = re.compile(r'AUTHORITY\[\"EPSG\",\s*\"?(\d+)\"?\]\s*\]\s*$')

#: dask_geomodeling_tpu.geo.crs's ExportToWkt() of each CRS of the subset
_WKT = {
    4326: 'GEOGCS["WGS 84",DATUM["WGS84",SPHEROID["WGS84",6378137.0,298.257223563]],'
    'PRIMEM["Greenwich",0],UNIT["degree",0.0174532925199433],AUTHORITY["EPSG","4326"]]',
    3857: 'PROJCS["WGS 84 / Pseudo-Mercator",GEOGCS["WGS84",DATUM["WGS84",SPHEROID['
    '"WGS84",6378137.0,298.257223563]],PRIMEM["Greenwich",0],UNIT["degree",'
    '0.0174532925199433]],UNIT["metre",1],AUTHORITY["EPSG","3857"]]',
    28992: 'PROJCS["Amersfoort / RD New",GEOGCS["Amersfoort",DATUM["Amersfoort",SPHEROID['
    '"Amersfoort",6377397.155,299.1528128],TOWGS84[565.417,50.3319,465.552,-0.398957,'
    '0.343988,-1.8774,4.0725]],PRIMEM["Greenwich",0],UNIT["degree",0.0174532925199433]],'
    'PROJECTION["Oblique_Stereographic"],PARAMETER["latitude_of_origin",52.156160555555552],'
    'PARAMETER["central_meridian",5.3876388888888895],PARAMETER["scale_factor",'
    '0.99990789999999996],PARAMETER["false_easting",155000],PARAMETER["false_northing",'
    '463000],UNIT["metre",1],AUTHORITY["EPSG","28992"]]',
}


@lru_cache(maxsize=32)
def get_sr(user_input):
    """The SpatialReference of an 'EPSG:xxxx' string, an EPSG integer, an
    OGC URN or URL of an EPSG code, OGC's CRS:84, or a WKT closed by an
    EPSG authority.
    Axis order is traditional GIS (x = lon first)."""
    if isinstance(user_input, SpatialReference):
        return user_input
    if isinstance(user_input, int):
        return _registry_get(user_input)
    text = str(user_input).strip()
    match = _EPSG_RE.match(text)
    if match:
        return _registry_get(int(match.group(1)))
    if text.isdigit():
        return _registry_get(int(text))
    match = _URN_RE.match(text)
    if match:
        return _registry_get(int(match.group(1)))
    if _CRS84_RE.match(text):
        return _registry_get(4326)
    match = _WKT_AUTH_RE.search(text)
    if match and "[" in text:
        return _registry_get(int(match.group(1)))
    raise NotImplementedError(
        "spatial reference %r is not ported; the port knows EPSG:4326, "
        "EPSG:3857 and EPSG:28992" % text[:80]
    )


def get_projection(sr):
    """The canonical user string ('EPSG:xxxx') for ``sr``."""
    if isinstance(sr, str):
        return sr
    return "EPSG:{}".format(get_sr(sr).code)


def get_epsg_or_wkt(text):
    """'EPSG:<code>' of a spatial reference."""
    return "EPSG:{}".format(get_sr(text).code)


def _same_datum(a, b):
    return a.datum == b.datum or (
        a.helmert_to_wgs84 is None and b.helmert_to_wgs84 is None
    )


def _datum_shift(src, dst, lon, lat):
    """Geographic coordinates src datum -> dst datum, through one
    geocentric chain of Helmert shifts."""
    gx, gy, gz = _geodetic_to_geocentric(src.ellipsoid, lon, lat)
    if src.helmert_to_wgs84 is not None:
        gx, gy, gz = _helmert(src.helmert_to_wgs84, gx, gy, gz)
    if dst.helmert_to_wgs84 is not None:
        gx, gy, gz = _helmert(dst.helmert_to_wgs84, gx, gy, gz, inverse=True)
    return _geocentric_to_geodetic(dst.ellipsoid, gx, gy, gz)


def transform_points(x, y, src_srs, dst_srs):
    """Transform coordinate arrays from src to dst; returns (x, y) arrays.
    Out-of-domain points come out as NaN."""
    src = get_sr(src_srs)
    dst = get_sr(dst_srs)
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    if src == dst:
        return x, y
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        lon, lat = src.projection.inverse(x, y)
        if not _same_datum(src, dst):
            lon, lat = _datum_shift(src, dst, lon, lat)
        return dst.projection.forward(lon, lat)


@lru_cache(maxsize=100)
def get_transform_func(src_srs, dst_srs):
    """Cached point-transform callable ``f(x, y) -> (x, y)`` between two
    CRSes of the subset."""
    src = get_sr(src_srs)
    dst = get_sr(dst_srs)

    def func(x, y):
        return transform_points(x, y, src, dst)

    return func


def transform_extent(bbox, src_srs, dst_srs):
    """Transform a bbox by transforming its corner points."""
    x1, y1, x2, y2 = bbox
    xs = np.array([x1, x2, x2, x1])
    ys = np.array([y1, y1, y2, y2])
    tx, ty = transform_points(xs, ys, src_srs, dst_srs)
    return float(tx.min()), float(ty.min()), float(tx.max()), float(ty.max())
