"""Coordinate reference systems and transforms, on the host in float64.

Counterpart of dask_geomodeling_tpu/geo/crs.py, ported whole as numpy
(the JAX package's ``xp`` parameter, which traces the math into XLA, is
left out: the port's warp computes its coarse grid of source indices on
the host and interpolates it on the card, ops/warp.py).  It gives the
JAX package's float64 bits for every CRS it knows:

- every code of the EPSG table (``geo/epsg.json.gz``, the port's own
  copy, read by ``geo/_epsg_registry.py``): 817 geographic and 5459
  projected CRSes over 33 projection methods, after the hand registry
  (``_registry_get``) and the ESRI codes (``_esri_registry_get``);
- Mercator (spherical and variants A/B), transverse Mercator (Krüger
  series, and the zoned variant), oblique stereographic (RD New), LCC
  (1SP, 2SP, Michigan, Belgium, near-conformal), LAEA, Albers, polar
  stereographic A/B/C, equidistant cylindrical, Cassini (and hyperbolic
  Cassini), Hotine A/B (Swiss), Laborde, Krovak (and modified), Colombia
  urban, NZMG, Guam, the Tunisia mining grid, polyconic, Bonne,
  sinusoidal, cylindrical equal area, Mollweide, Robinson, Van der
  Grinten, Eckert IV, Miller, Gall, Equal Earth, azimuthal equidistant
  (Vincenty geodesics), orthographic and gnomonic; non-metre units,
  south/west axes and non-Greenwich prime meridians wrap them;
- WKT1, WKT2, ESRI-WKT and proj4 parsing for all of these methods, and
  OGC URN/URL, CRS84, compound and ``+init=epsg:`` identifiers;
- 7-parameter Helmert datum shifts (position-vector convention) through
  geocentric coordinates, upgraded to NTv2 grid interpolation where
  ``geomodeling.ntv2-grids`` registers a grid for a datum (geo/ntv2.py).

Transforms are exposed through ``get_sr``, ``get_crs``, ``get_projection``,
``get_epsg_or_wkt``, ``get_transform_func`` (LRU-cached),
``transform_points``, ``transform_extent`` and ``transform_min_size``.
A CRS the module cannot parse raises ``TransformException``.
"""
import math
import re
from functools import lru_cache

import numpy as np

__all__ = [
    "SpatialReference",
    "TransformException",
    "get_sr",
    "get_crs",
    "crs_to_srs",
    "get_projection",
    "get_epsg_or_wkt",
    "get_transform_func",
    "transform_points",
    "transform_extent",
    "transform_min_size",
]


class TransformException(Exception):
    """Raised on errors while transforming between spatial references."""


# --- ellipsoids: (semi-major axis a, inverse flattening 1/f) ---

ELLIPSOIDS = {
    "WGS84": (6378137.0, 298.257223563),
    "GRS80": (6378137.0, 298.257222101),
    "bessel": (6377397.155, 299.1528128),
    "airy": (6377563.396, 299.3249646),
    "intl": (6378388.0, 297.0),  # International 1924 (Hayford)
    "sphere": (6378137.0, float("inf")),  # web mercator sphere
    "clrk66": (6378206.4, 294.9786982),  # Clarke 1866 (NAD27)
    "krass": (6378245.0, 298.3),  # Krassowsky 1940 (Pulkovo)
    "GRS67": (6378160.0, 298.247167427),
    "authalic": (6371000.0, float("inf")),  # ESRI 53xxx sphere
    "clrk80ign": (6378249.2, 293.4660212936269),  # Clarke 1880 IGN (NTF)
    "WGS72": (6378135.0, 298.26),
    "mod_airy": (6377340.189, 299.3249646),  # Airy Modified (Ireland)
    "aust_SA": (6378160.0, 298.25),  # GRS 1967 Modified / SAD69
}

# --- datums: ellipsoid + position-vector Helmert to WGS84 ---
# (tx, ty, tz [m], rx, ry, rz [arcsec], ds [ppm]); None = identical to WGS84

DATUMS = {
    "WGS84": ("WGS84", None),
    "ETRS89": ("GRS80", None),  # treated as coincident with WGS84
    # Amersfoort to WGS84 (EPSG transformation 15934)
    "Amersfoort": (
        "bessel",
        (565.417, 50.3319, 465.552, -0.398957, 0.343988, -1.87740, 4.0725),
    ),
    # OSGB36 to WGS84 (EPSG transformation 1314)
    "OSGB36": (
        "airy",
        (446.448, -125.157, 542.060, 0.1502, 0.2470, 0.8421, -20.4894),
    ),
    # NZGD49 to WGS84 (EPSG transformation 1564; position-vector rotation
    # convention, so the published coordinate-frame signs are negated)
    "NZGD49": (
        "intl",
        (59.47, -5.04, 187.44, -0.47, 0.10, -1.024, -4.5993),
    ),
    # NAD27 to WGS84 (the CONUS mean 3-parameter shift, EPSG 1173)
    "NAD27": ("clrk66", (-8.0, 160.0, 176.0, 0.0, 0.0, 0.0, 0.0)),
    # ED50 to WGS84 (mean European 3-parameter shift, EPSG 1133)
    "ED50": ("intl", (-87.0, -98.0, -121.0, 0.0, 0.0, 0.0, 0.0)),
    # Pulkovo 1942 to WGS84 (EPSG 1267, position vector)
    "Pulkovo42": (
        "krass",
        (25.0, -141.0, -78.5, 0.0, -0.35, -0.736, 0.0),
    ),
    # CH1903 to WGS84 (geocentric translations, EPSG 1676)
    "CH1903": ("bessel", (674.374, 15.056, 405.346, 0.0, 0.0, 0.0, 0.0)),
    # Reseau National Belge 1972 to WGS84 (EPSG 15929, position vector)
    "BD72": (
        "intl",
        (-106.8686, 52.2978, -103.7239, 0.3366, -0.457, 1.8422, -1.2747),
    ),
    # S-JTSK to WGS84 (the common 3-parameter shift, EPSG 1622-family)
    "S-JTSK": ("bessel", (589.0, 76.0, 480.0, 0.0, 0.0, 0.0, 0.0)),
    # DHDN to WGS84 (EPSG 1777, position vector)
    "DHDN": (
        "bessel",
        (598.1, 73.7, 418.2, 0.202, 0.045, -2.455, 6.7),
    ),
    # HD72 to WGS84 (EPSG 1448)
    "HD72": ("GRS67", (52.17, -71.82, -14.9, 0.0, 0.0, 0.0, 0.0)),
    # NTF to WGS84 (the standard 3-parameter shift, EPSG 1193)
    "NTF": ("clrk80ign", (-168.0, -60.0, 320.0, 0.0, 0.0, 0.0, 0.0)),
    # MGI (Austria) to WGS84 (EPSG 1618, position vector)
    "MGI": (
        "bessel",
        (577.326, 90.129, 463.919, 5.137, 1.474, 5.297, 2.4232),
    ),
    # GGRS87 to WGS84 (EPSG 1272, geocentric translations)
    "GGRS87": ("GRS80", (-199.87, 74.79, 246.62, 0.0, 0.0, 0.0, 0.0)),
    # WGS 72 to WGS84 (EPSG 1237, position vector)
    "WGS72": ("WGS72", (0.0, 0.0, 4.5, 0.0, 0.0, 0.554, 0.2263)),
    # TM65 / Geodetic Datum of 1965 to WGS84 (EPSG 1641, position vector)
    "TM65": (
        "mod_airy",
        (482.5, -130.6, 564.6, -1.042, -0.214, -0.631, 8.15),
    ),
    # SAD69 to WGS84 (the mean 3-parameter shift, EPSG 1864-family)
    "SAD69": ("aust_SA", (-57.0, 1.0, -41.0, 0.0, 0.0, 0.0, 0.0)),
    # Luxembourg 1930 to WGS84 (position vector)
    "LUREF": (
        "intl",
        (-189.681, 18.3463, -42.7695, -0.33746, -3.09264, 2.53861, 0.4598),
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
    unit = "degree"

    def forward(self, lon, lat):
        return lon, lat

    def inverse(self, x, y):
        return x, y


class _WebMercator:
    """Spherical Mercator on the WGS84 semi-major axis (EPSG:3857)."""

    is_geographic = False
    unit = "metre"
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


class _Mercator:
    """Ellipsoidal Mercator variant A (EPSG method 9804, e.g. EPSG:3395)."""

    is_geographic = False
    unit = "metre"

    def __init__(self, ell, lon0=0.0, k0=1.0, false_easting=0.0, false_northing=0.0):
        self.ell = ell
        self.lam0 = np.radians(lon0)
        self.k0 = k0
        self.fe = false_easting
        self.fn = false_northing

    def forward(self, lon, lat):
        e = self.ell.e
        lat = np.clip(np.asarray(lat, dtype=float), -89.9999999, 89.9999999)
        phi = np.radians(lat)
        lam = np.radians(np.asarray(lon, dtype=float))
        sin_phi = np.sin(phi)
        # wrap into +-pi of the central meridian (Pacific grids like
        # EPSG:3832 put lon0=150 with data across the antimeridian)
        dl = (lam - self.lam0 + np.pi) % (2 * np.pi) - np.pi
        x = self.fe + self.ell.a * self.k0 * dl
        y = self.fn + self.ell.a * self.k0 * np.log(
            np.tan(np.pi / 4.0 + phi / 2.0)
            * ((1.0 - e * sin_phi) / (1.0 + e * sin_phi)) ** (e / 2.0)
        )
        return x, y

    def inverse(self, x, y):
        e = self.ell.e
        ak0 = self.ell.a * self.k0
        lam = (np.asarray(x, dtype=float) - self.fe) / ak0 + self.lam0
        t = np.exp(-(np.asarray(y, dtype=float) - self.fn) / ak0)
        phi = np.pi / 2.0 - 2.0 * np.arctan(t)
        for _ in range(6):
            sin_phi = np.sin(phi)
            phi = np.pi / 2.0 - 2.0 * np.arctan(
                t * ((1.0 - e * sin_phi) / (1.0 + e * sin_phi)) ** (e / 2.0)
            )
        return np.degrees(lam), np.degrees(phi)


class _TransverseMercator:
    """Ellipsoidal transverse Mercator, 4th-order Krüger series in n.

    Series coefficients follow Karney (2011), "Transverse Mercator with an
    accuracy of a few nanometers" (public-domain formulas).
    """

    is_geographic = False
    unit = "metre"

    def __init__(self, ell, lon0, lat0, k0, false_easting, false_northing):
        self.ell = ell
        self.lon0 = lon0
        self.k0 = k0
        self.fe = false_easting
        self.fn = false_northing
        n = ell.f / (2.0 - ell.f)
        self.A = ell.a / (1 + n) * (1 + n**2 / 4 + n**4 / 64)
        self.alpha = (
            n / 2 - 2 * n**2 / 3 + 5 * n**3 / 16 + 41 * n**4 / 180,
            13 * n**2 / 48 - 3 * n**3 / 5 + 557 * n**4 / 1440,
            61 * n**3 / 240 - 103 * n**4 / 140,
            49561 * n**4 / 161280,
        )
        self.beta = (
            n / 2 - 2 * n**2 / 3 + 37 * n**3 / 96 - n**4 / 360,
            n**2 / 48 + n**3 / 15 - 437 * n**4 / 1440,
            17 * n**3 / 480 - 37 * n**4 / 840,
            4397 * n**4 / 161280,
        )
        # northing offset of the latitude of origin
        self.m0 = 0.0
        if lat0 != 0.0:
            xi0, _ = self._conformal_xi_eta(np.asarray(lat0, float), np.asarray(0.0))
            self.m0 = self.k0 * self.A * float(xi0)

    def _conformal_xi_eta(self, lat, dlon):
        e = self.ell.e
        phi = np.radians(lat)
        lam = np.radians(dlon)
        s = np.sin(phi)
        t = np.sinh(np.arctanh(s) - e * np.arctanh(e * s))
        xi_p = np.arctan2(t, np.cos(lam))
        eta_p = np.arcsinh(np.sin(lam) / np.hypot(t, np.cos(lam)))
        xi = xi_p
        eta = eta_p
        for j, (a_j,) in enumerate(zip(self.alpha), start=1):
            xi = xi + a_j * np.sin(2 * j * xi_p) * np.cosh(2 * j * eta_p)
            eta = eta + a_j * np.cos(2 * j * xi_p) * np.sinh(2 * j * eta_p)
        return xi, eta

    def forward(self, lon, lat):
        lon = np.asarray(lon, dtype=float)
        lat = np.asarray(lat, dtype=float)
        dlon = (lon - self.lon0 + 180.0) % 360.0 - 180.0
        xi, eta = self._conformal_xi_eta(lat, dlon)
        x = self.fe + self.k0 * self.A * eta
        y = self.fn - self.m0 + self.k0 * self.A * xi
        return x, y

    def inverse(self, x, y):
        e = self.ell.e
        eta = (np.asarray(x, dtype=float) - self.fe) / (self.k0 * self.A)
        xi = (np.asarray(y, dtype=float) - self.fn + self.m0) / (self.k0 * self.A)
        xi_p = xi
        eta_p = eta
        for j, (b_j,) in enumerate(zip(self.beta), start=1):
            xi_p = xi_p - b_j * np.sin(2 * j * xi) * np.cosh(2 * j * eta)
            eta_p = eta_p - b_j * np.cos(2 * j * xi) * np.sinh(2 * j * eta)
        t = np.sin(xi_p) / np.hypot(np.sinh(eta_p), np.cos(xi_p))
        lam = np.arctan2(np.sinh(eta_p), np.cos(xi_p))
        # invert the conformal latitude: s = tanh(asinh(t) + e*atanh(e*s))
        s = np.tanh(np.arcsinh(t))
        for _ in range(8):
            s = np.tanh(np.arcsinh(t) + e * np.arctanh(e * s))
        lat = np.degrees(np.arcsin(np.clip(s, -1.0, 1.0)))
        lon = self.lon0 + np.degrees(lam)
        return lon, lat


class _ObliqueStereographic:
    """Oblique stereographic projection, EPSG method 9809 (RD New)."""

    is_geographic = False
    unit = "metre"

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
            phi = phi - (psi_i - psi) * np.cos(phi) * (1 - e2s(e, sin_phi)) / (
                1 - e * e
            )
        return np.degrees(lam), np.degrees(phi)


def e2s(e, sin_phi):
    """The recurring term e^2 * sin^2(phi) of the ellipsoidal series."""
    return e * e * sin_phi * sin_phi


class _LambertConformalConic:
    """Lambert conformal conic: 2 standard parallels (EPSG method 9802) or,
    with ``lat1 == lat2 == lat0``, the 1SP form with its ``k0`` scale at
    the latitude of origin (EPSG method 9801).  ``ell_k`` is the Michigan
    variant's ellipsoid scaling factor (method 1051: every radius scales
    by K, equivalent to PROJ's k_0 mapping of the method)."""

    is_geographic = False
    unit = "metre"

    def __init__(
        self, ell, lon0, lat0, lat1, lat2, false_easting, false_northing,
        k0=1.0, ell_k=1.0,
    ):
        self.ell = ell
        self.lam0 = np.radians(lon0)
        self.fe = false_easting
        self.fn = false_northing
        e = ell.e

        def m(phi):
            return np.cos(phi) / np.sqrt(1 - ell.e2 * np.sin(phi) ** 2)

        def t(phi):
            sin_phi = np.sin(phi)
            return np.tan(np.pi / 4 - phi / 2) / (
                (1 - e * sin_phi) / (1 + e * sin_phi)
            ) ** (e / 2)

        self._t = t
        phi0, phi1, phi2 = (np.radians(v) for v in (lat0, lat1, lat2))
        m1 = m(phi1)
        t0, t1 = t(phi0), t(phi1)
        if phi1 == phi2:
            # 1SP limit: the cone touches at phi1, n -> sin(phi1)
            self.n = np.sin(phi1)
        else:
            m2, t2 = m(phi2), t(phi2)
            self.n = (np.log(m1) - np.log(m2)) / (np.log(t1) - np.log(t2))
        self.big_f = ell_k * k0 * m1 / (self.n * t1**self.n)
        self.rho0 = ell.a * self.big_f * t0**self.n

    def forward(self, lon, lat):
        phi = np.radians(np.asarray(lat, dtype=float))
        lam = np.radians(np.asarray(lon, dtype=float))
        rho = self.ell.a * self.big_f * self._t(phi) ** self.n
        # wrap the longitude delta into +-pi so CRSes whose central
        # meridian sits across the antimeridian from the data (e.g. the
        # deprecated EPSG:2155) project to the near cone aspect
        dl = (lam - self.lam0 + np.pi) % (2 * np.pi) - np.pi
        theta = self.n * dl
        x = self.fe + rho * np.sin(theta)
        y = self.fn + self.rho0 - rho * np.cos(theta)
        return x, y

    def inverse(self, x, y):
        e = self.ell.e
        de = np.asarray(x, dtype=float) - self.fe
        dn = self.rho0 - (np.asarray(y, dtype=float) - self.fn)
        rho = np.sign(self.n) * np.sqrt(de**2 + dn**2)
        t_prime = (rho / (self.ell.a * self.big_f)) ** (1.0 / self.n)
        # southern cones (n < 0) need both components sign-corrected, or
        # theta lands in the wrong quadrant (EPSG 9802 inverse)
        theta = np.arctan2(np.sign(self.n) * de, np.sign(self.n) * dn)
        lam = theta / self.n + self.lam0
        phi = np.pi / 2 - 2 * np.arctan(t_prime)
        for _ in range(6):
            sin_phi = np.sin(phi)
            phi = np.pi / 2 - 2 * np.arctan(
                t_prime * ((1 - e * sin_phi) / (1 + e * sin_phi)) ** (e / 2)
            )
        return np.degrees(lam), np.degrees(phi)


class _LambertAzimuthalEqualArea:
    """Lambert azimuthal equal area, ellipsoidal (EPSG method 9820)."""

    is_geographic = False
    unit = "metre"

    def __init__(self, ell, lon0, lat0, false_easting, false_northing):
        self.ell = ell
        self.lam0 = np.radians(lon0)
        self.fe = false_easting
        self.fn = false_northing
        e, e2 = ell.e, ell.e2

        def q(sin_phi):
            if e == 0:  # spherical limit (e.g. EPSG:2163 US Atlas sphere)
                return 2.0 * sin_phi
            return (1 - e2) * (
                sin_phi / (1 - e2 * sin_phi**2)
                - (1 / (2 * e)) * np.log((1 - e * sin_phi) / (1 + e * sin_phi))
            )

        self._q = q
        phi0 = np.radians(lat0)
        self.qp = q(1.0)
        # polar aspects (EPSG 9820): the oblique formulation degenerates at
        # the poles (d -> 0); EASE-Grid 2.0 North/South (EPSG 6931/6932)
        # and the WGS84 Arctic LAEA zones (3571-3576) take these branches
        self.pole = 0
        if lat0 > 89.9999999:
            self.pole = 1
        elif lat0 < -89.9999999:
            self.pole = -1
        if self.pole == 0:
            q0 = q(np.sin(phi0))
            self.beta0 = np.arcsin(q0 / self.qp)
            self.rq = ell.a * np.sqrt(self.qp / 2)
            m0 = np.cos(phi0) / np.sqrt(1 - e2 * np.sin(phi0) ** 2)
            self.d = ell.a * m0 / (self.rq * np.cos(self.beta0))

    def forward(self, lon, lat):
        phi = np.radians(np.asarray(lat, dtype=float))
        lam = np.radians(np.asarray(lon, dtype=float))
        dl = (lam - self.lam0 + np.pi) % (2 * np.pi) - np.pi
        if self.pole:
            q = self._q(np.sin(phi))
            rho = self.ell.a * np.sqrt(
                np.maximum(self.qp - self.pole * q, 0.0)
            )
            x = self.fe + rho * np.sin(dl)
            y = self.fn - self.pole * rho * np.cos(dl)
            return x, y
        beta = np.arcsin(
            np.clip(self._q(np.sin(phi)) / self.qp, -1.0, 1.0)
        )
        b = self.rq * np.sqrt(
            2.0
            / (
                1
                + np.sin(self.beta0) * np.sin(beta)
                + np.cos(self.beta0) * np.cos(beta) * np.cos(dl)
            )
        )
        x = self.fe + b * self.d * np.cos(beta) * np.sin(dl)
        y = self.fn + (b / self.d) * (
            np.cos(self.beta0) * np.sin(beta)
            - np.sin(self.beta0) * np.cos(beta) * np.cos(dl)
        )
        return x, y

    def inverse(self, x, y):
        e2 = self.ell.e2
        e4, e6 = e2**2, e2**3
        if self.pole:
            ex = np.asarray(x, dtype=float) - self.fe
            ny = np.asarray(y, dtype=float) - self.fn
            rho = np.hypot(ex, ny)
            q = self.pole * (self.qp - (rho / self.ell.a) ** 2)
            beta = np.arcsin(np.clip(q / self.qp, -1.0, 1.0))
            lam = self.lam0 + np.arctan2(ex, -self.pole * ny)
        else:
            ex = (np.asarray(x, dtype=float) - self.fe) / self.d
            ny = (np.asarray(y, dtype=float) - self.fn) * self.d
            rho = np.sqrt(ex**2 + ny**2)
            rho_safe = np.where(rho == 0, 1.0, rho)
            ce = 2 * np.arcsin(np.clip(rho / (2 * self.rq), -1.0, 1.0))
            beta = np.arcsin(
                np.clip(
                    np.cos(ce) * np.sin(self.beta0)
                    + (ny * np.sin(ce) * np.cos(self.beta0)) / rho_safe,
                    -1.0,
                    1.0,
                )
            )
            lam = self.lam0 + np.arctan2(
                ex * np.sin(ce),
                rho * np.cos(self.beta0) * np.cos(ce)
                - ny * np.sin(self.beta0) * np.sin(ce),
            )
        # authalic latitude -> geodetic latitude (series)
        phi = (
            beta
            + (e2 / 3 + 31 * e4 / 180 + 517 * e6 / 5040) * np.sin(2 * beta)
            + (23 * e4 / 360 + 251 * e6 / 3780) * np.sin(4 * beta)
            + (761 * e6 / 45360) * np.sin(6 * beta)
        )
        return np.degrees(lam), np.degrees(phi)


class _AlbersEqualArea:
    """Albers equal area conic, ellipsoidal (EPSG method 9822)."""

    is_geographic = False
    unit = "metre"

    def __init__(self, ell, lon0, lat0, sp1, sp2, false_easting, false_northing):
        self.ell = ell
        self.lam0 = np.radians(lon0)
        self.fe = false_easting
        self.fn = false_northing
        e, e2 = ell.e, ell.e2

        def q(sin_phi):
            if e == 0:  # spherical limit
                return 2.0 * sin_phi
            return (1 - e2) * (
                sin_phi / (1 - e2 * sin_phi**2)
                - (1 / (2 * e)) * np.log((1 - e * sin_phi) / (1 + e * sin_phi))
            )

        def m(phi):
            return np.cos(phi) / np.sqrt(1 - e2 * np.sin(phi) ** 2)

        self._q = q
        self.qp = q(1.0)
        phi1, phi2 = np.radians(sp1), np.radians(sp2)
        m1, m2 = m(phi1), m(phi2)
        q1, q2 = q(np.sin(phi1)), q(np.sin(phi2))
        if abs(sp1 - sp2) < 1e-12:
            self.n = np.sin(phi1)
        else:
            self.n = (m1**2 - m2**2) / (q2 - q1)
        self.c = m1**2 + self.n * q1
        self.rho0 = ell.a * np.sqrt(self.c - self.n * q(np.sin(np.radians(lat0)))) / self.n

    def forward(self, lon, lat):
        phi = np.radians(np.asarray(lat, dtype=float))
        lam = np.radians(np.asarray(lon, dtype=float))
        q = self._q(np.sin(phi))
        rho = self.ell.a * np.sqrt(self.c - self.n * q) / self.n
        dl = (lam - self.lam0 + np.pi) % (2 * np.pi) - np.pi
        theta = self.n * dl
        x = self.fe + rho * np.sin(theta)
        y = self.fn + self.rho0 - rho * np.cos(theta)
        return x, y

    def inverse(self, x, y):
        e2 = self.ell.e2
        e4, e6 = e2**2, e2**3
        de = np.asarray(x, dtype=float) - self.fe
        dn = self.rho0 - (np.asarray(y, dtype=float) - self.fn)
        rho = np.sqrt(de**2 + dn**2)
        theta = np.arctan2(np.sign(self.n) * de, np.sign(self.n) * dn)
        lam = self.lam0 + theta / self.n
        q = (self.c - (rho * self.n / self.ell.a) ** 2) / self.n
        beta = np.arcsin(np.clip(q / self.qp, -1.0, 1.0))
        # authalic -> geodetic latitude series (same as LAEA)
        phi = (
            beta
            + (e2 / 3 + 31 * e4 / 180 + 517 * e6 / 5040) * np.sin(2 * beta)
            + (23 * e4 / 360 + 251 * e6 / 3780) * np.sin(4 * beta)
            + (761 * e6 / 45360) * np.sin(6 * beta)
        )
        return np.degrees(lam), np.degrees(phi)


class _PolarStereographic:
    """Polar stereographic, ellipsoidal (EPSG method 9810 variant A /
    9829 variant B via a standard parallel / 9830 variant C, whose false
    origin sits on the standard parallel instead of the pole)."""

    is_geographic = False
    unit = "metre"

    def __init__(
        self, ell, lon0, k0=None, standard_parallel=None,
        false_easting=0.0, false_northing=0.0, north=True,
        variant_c=False,
    ):
        self.ell = ell
        self.lam0 = np.radians(lon0)
        self.fe = false_easting
        self.fn = false_northing
        self.sign = 1.0 if north else -1.0
        e = ell.e
        self._root = np.sqrt((1 + e) ** (1 + e) * (1 - e) ** (1 - e))
        if k0 is None:
            # variant B/C: scale from the standard parallel, computed in
            # the north-mirrored frame the forward/inverse also use
            phi_f = np.radians(abs(standard_parallel))
            sin_f = np.sin(phi_f)
            t_f = np.tan(np.pi / 4 - phi_f / 2) * (
                (1 + e * sin_f) / (1 - e * sin_f)
            ) ** (e / 2)
            m_f = np.cos(phi_f) / np.sqrt(1 - ell.e2 * sin_f**2)
            k0 = m_f * self._root / (2 * t_f)
            if variant_c:
                # false origin on the standard parallel: shift the
                # northing by rho_F toward the pole (EPSG 9830)
                rho_f = ell.a * m_f
                self.fn = false_northing + self.sign * rho_f
        self.k0 = k0

    def _t(self, phi):
        e = self.ell.e
        sin_phi = np.sin(phi)
        return np.tan(np.pi / 4 - phi / 2) * (
            (1 + e * sin_phi) / (1 - e * sin_phi)
        ) ** (e / 2)

    def forward(self, lon, lat):
        # computed in the north-mirrored frame; the southern aspect flips
        # BOTH axes back (EPSG 9810/9829 south: E = FE + rho sin(lam-lam0),
        # N = FN + rho cos(lam-lam0) — the +cos is the tell-tale)
        phi = self.sign * np.radians(np.asarray(lat, dtype=float))
        lam = self.sign * (np.radians(np.asarray(lon, dtype=float)) - self.lam0)
        rho = 2 * self.ell.a * self.k0 * self._t(phi) / self._root
        x = self.fe + self.sign * rho * np.sin(lam)
        y = self.fn - self.sign * rho * np.cos(lam)
        return x, y

    def inverse(self, x, y):
        e = self.ell.e
        de = self.sign * (np.asarray(x, dtype=float) - self.fe)
        dn = self.sign * (np.asarray(y, dtype=float) - self.fn)
        rho = np.hypot(de, dn)
        t = rho * self._root / (2 * self.ell.a * self.k0)
        phi = np.pi / 2 - 2 * np.arctan(t)
        for _ in range(6):
            sin_phi = np.sin(phi)
            phi = np.pi / 2 - 2 * np.arctan(
                t * ((1 - e * sin_phi) / (1 + e * sin_phi)) ** (e / 2)
            )
        lam = self.lam0 + self.sign * np.arctan2(de, -dn)
        return np.degrees(lam), self.sign * np.degrees(phi)


def _rectifying_series(ell):
    """(A, forward, inverse) meridian-arc series in the third flattening:
    M(phi) = A * (phi + sum fwd_j sin(2j phi)) and its inverse
    phi(mu) = mu + sum inv_j sin(2j mu) (Karney/Snyder rectifying
    latitude, accurate to n^4)."""
    n = ell.f / (2.0 - ell.f)
    big_a = ell.a / (1 + n) * (1 + n**2 / 4 + n**4 / 64)
    forward = (
        -3 * n / 2 + 9 * n**3 / 16,
        15 * n**2 / 16 - 15 * n**4 / 32,
        -35 * n**3 / 48,
        315 * n**4 / 512,
    )
    inverse = (
        3 * n / 2 - 27 * n**3 / 32,
        21 * n**2 / 16 - 55 * n**4 / 32,
        151 * n**3 / 96,
        1097 * n**4 / 512,
    )
    return big_a, forward, inverse


def _meridian_arc(big_a, coeffs, phi):
    mu = phi
    for j, c in enumerate(coeffs, start=1):
        mu = mu + c * np.sin(2 * j * phi)
    return big_a * mu


def _inverse_meridian_arc(big_a, coeffs, arc):
    mu = arc / big_a
    phi = mu
    for j, c in enumerate(coeffs, start=1):
        phi = phi + c * np.sin(2 * j * mu)
    return phi


class _EquidistantCylindrical:
    """Equidistant cylindrical, ellipsoidal (EPSG method 1028; spherical
    9823 is the e=0 case).  True scale along the standard parallel and
    along every meridian."""

    is_geographic = False
    unit = "metre"

    def __init__(self, ell, lon0, lat1, lat0, false_easting, false_northing):
        self.ell = ell
        self.lon0 = lon0
        self.fe = false_easting
        self.fn = false_northing
        phi1 = np.radians(lat1)
        self.nu1_cos = (
            ell.a * np.cos(phi1) / np.sqrt(1 - ell.e2 * np.sin(phi1) ** 2)
        )
        self.big_a, self._fwd, self._inv = _rectifying_series(ell)
        self.m0 = _meridian_arc(self.big_a, self._fwd, np.radians(lat0))

    def forward(self, lon, lat):
        lon = np.asarray(lon, dtype=float)
        phi = np.radians(np.asarray(lat, dtype=float))
        dlam = np.radians((lon - self.lon0 + 180.0) % 360.0 - 180.0)
        x = self.fe + self.nu1_cos * dlam
        y = self.fn + _meridian_arc(self.big_a, self._fwd, phi) - self.m0
        return x, y

    def inverse(self, x, y):
        x = np.asarray(x, dtype=float)
        y = np.asarray(y, dtype=float)
        lam = (x - self.fe) / self.nu1_cos
        phi = _inverse_meridian_arc(self.big_a, self._inv, y - self.fn + self.m0)
        return self.lon0 + np.degrees(lam), np.degrees(phi)


class _CassiniSoldner:
    """Cassini-Soldner, ellipsoidal (EPSG method 9806).  True scale along
    the central meridian; Snyder's series forms."""

    is_geographic = False
    unit = "metre"

    def __init__(self, ell, lon0, lat0, false_easting, false_northing):
        self.ell = ell
        self.lon0 = lon0
        self.fe = false_easting
        self.fn = false_northing
        self.big_a, self._fwd, self._inv = _rectifying_series(ell)
        self.m0 = _meridian_arc(self.big_a, self._fwd, np.radians(lat0))

    def forward(self, lon, lat):
        ell = self.ell
        lon = np.asarray(lon, dtype=float)
        phi = np.radians(np.asarray(lat, dtype=float))
        dlam = np.radians((lon - self.lon0 + 180.0) % 360.0 - 180.0)
        sin_phi, cos_phi, tan_phi = np.sin(phi), np.cos(phi), np.tan(phi)
        nu = ell.a / np.sqrt(1 - ell.e2 * sin_phi**2)
        big_a = dlam * cos_phi
        big_t = tan_phi**2
        big_c = ell.e2 * cos_phi**2 / (1 - ell.e2)
        x = self.fe + nu * (
            big_a
            - big_t * big_a**3 / 6
            - (8 - big_t + 8 * big_c) * big_t * big_a**5 / 120
        )
        m = _meridian_arc(self.big_a, self._fwd, phi)
        y = self.fn + m - self.m0 + nu * tan_phi * (
            big_a**2 / 2 + (5 - big_t + 6 * big_c) * big_a**4 / 24
        )
        return x, y

    def inverse(self, x, y):
        ell = self.ell
        x = np.asarray(x, dtype=float)
        y = np.asarray(y, dtype=float)
        phi1 = _inverse_meridian_arc(
            self.big_a, self._inv, self.m0 + (y - self.fn)
        )
        sin1, cos1, tan1 = np.sin(phi1), np.cos(phi1), np.tan(phi1)
        w1 = 1 - ell.e2 * sin1**2
        nu1 = ell.a / np.sqrt(w1)
        rho1 = ell.a * (1 - ell.e2) / w1**1.5
        big_t1 = tan1**2
        big_d = (x - self.fe) / nu1
        phi = phi1 - (nu1 * tan1 / rho1) * (
            big_d**2 / 2 - (1 + 3 * big_t1) * big_d**4 / 24
        )
        lam = (
            big_d - big_t1 * big_d**3 / 3 + (1 + 3 * big_t1) * big_t1 * big_d**5 / 15
        ) / cos1
        return self.lon0 + np.degrees(lam), np.degrees(phi)


class _HotineObliqueMercator:
    """Hotine oblique Mercator, ellipsoidal: EPSG method 9812 (variant A,
    false grid coordinates at the projection's natural origin) and 9815
    (variant B, false grid coordinates at the projection centre).

    Formulas per EPSG Guidance Note 7-2 §3.2.6.
    """

    is_geographic = False
    unit = "metre"

    def __init__(
        self,
        ell,
        lonc,
        latc,
        azimuth,
        rectified_grid_angle,
        k0,
        false_easting,
        false_northing,
        variant="B",
    ):
        self.ell = ell
        self.fe = false_easting
        self.fn = false_northing
        self.variant = variant
        e, e2 = ell.e, ell.e2
        phi_c = np.radians(latc)
        lam_c = np.radians(lonc)
        alpha_c = np.radians(azimuth)
        self.gamma_c = np.radians(rectified_grid_angle)

        sin_c, cos_c = np.sin(phi_c), np.cos(phi_c)
        self.B = np.sqrt(1 + e2 * cos_c**4 / (1 - e2))
        self.A = (
            ell.a * self.B * k0 * np.sqrt(1 - e2) / (1 - e2 * sin_c**2)
        )
        t_c = np.tan(np.pi / 4 - phi_c / 2) / (
            (1 - e * sin_c) / (1 + e * sin_c)
        ) ** (e / 2)
        big_d = self.B * np.sqrt(1 - e2) / (cos_c * np.sqrt(1 - e2 * sin_c**2))
        dd = max(big_d * big_d, 1.0)
        big_f = big_d + np.sqrt(dd - 1) * np.sign(phi_c)
        self.H = big_f * t_c**self.B
        big_g = (big_f - 1 / big_f) / 2
        self.gamma0 = np.arcsin(np.sin(alpha_c) / big_d)
        # azimuth 90 (Swiss somerc): G*tan(gamma0) == 1 exactly, but
        # rounding can push it past 1 -> NaN without the clip
        self.lam0 = lam_c - np.arcsin(
            np.clip(big_g * np.tan(self.gamma0), -1.0, 1.0)
        ) / self.B
        # variant B: the (u, v) origin shifts to the projection centre
        if abs(azimuth - 90.0) < 1e-12:
            self.uc = self.A * (lam_c - self.lam0)
        else:
            self.uc = (self.A / self.B) * np.arctan2(
                np.sqrt(dd - 1), np.cos(alpha_c)
            ) * np.sign(phi_c)
        self._uc_sign = 1.0 if latc >= 0 else -1.0

    def _to_uv(self, lon, lat):
        e = self.ell.e
        phi = np.radians(np.asarray(lat, dtype=float))
        lam = np.radians(np.asarray(lon, dtype=float))
        sin_phi = np.sin(phi)
        t = np.tan(np.pi / 4 - phi / 2) / (
            (1 - e * sin_phi) / (1 + e * sin_phi)
        ) ** (e / 2)
        big_q = self.H / t**self.B
        big_s = (big_q - 1 / big_q) / 2
        big_t = (big_q + 1 / big_q) / 2
        dl = (lam - self.lam0 + np.pi) % (2 * np.pi) - np.pi
        big_v = np.sin(self.B * dl)
        big_u = (-big_v * np.cos(self.gamma0) + big_s * np.sin(self.gamma0)) / big_t
        v = self.A * np.log((1 - big_u) / (1 + big_u)) / (2 * self.B)
        u = (self.A / self.B) * np.arctan2(
            big_s * np.cos(self.gamma0) + big_v * np.sin(self.gamma0),
            np.cos(self.B * dl),
        )
        return u, v

    def forward(self, lon, lat):
        u, v = self._to_uv(lon, lat)
        if self.variant == "B":
            u = u - abs(self.uc) * self._uc_sign
        x = v * np.cos(self.gamma_c) + u * np.sin(self.gamma_c) + self.fe
        y = u * np.cos(self.gamma_c) - v * np.sin(self.gamma_c) + self.fn
        return x, y

    def inverse(self, x, y):
        e = self.ell.e
        dx = np.asarray(x, dtype=float) - self.fe
        dy = np.asarray(y, dtype=float) - self.fn
        v = dx * np.cos(self.gamma_c) - dy * np.sin(self.gamma_c)
        u = dy * np.cos(self.gamma_c) + dx * np.sin(self.gamma_c)
        if self.variant == "B":
            u = u + abs(self.uc) * self._uc_sign
        big_q = np.exp(-self.B * v / self.A)
        big_s = (big_q - 1 / big_q) / 2
        big_t = (big_q + 1 / big_q) / 2
        big_v = np.sin(self.B * u / self.A)
        big_u = (big_v * np.cos(self.gamma0) + big_s * np.sin(self.gamma0)) / big_t
        t = (self.H / np.sqrt((1 + big_u) / (1 - big_u))) ** (1 / self.B)
        chi = np.pi / 2 - 2 * np.arctan(t)
        phi = chi
        for _ in range(8):
            sin_phi = np.sin(phi)
            phi = np.pi / 2 - 2 * np.arctan(
                t * ((1 - e * sin_phi) / (1 + e * sin_phi)) ** (e / 2)
            )
        lam = self.lam0 - np.arctan2(
            big_s * np.cos(self.gamma0) - big_v * np.sin(self.gamma0),
            np.cos(self.B * u / self.A),
        ) / self.B
        return np.degrees(lam), np.degrees(phi)


class _Krovak:
    """Krovak oblique conformal conic (EPSG method 9819), as used by the
    Czech/Slovak S-JTSK grids.  Formulas per EPSG Guidance Note 7-2
    §3.2.7.  Coordinates follow the GDAL/PROJ "Krovak" convention
    (east/north = negated EPSG southing/westing, so values are negative
    over Czechia, matching +proj=krovak)."""

    is_geographic = False
    unit = "metre"

    def __init__(
        self,
        ell,
        lonc,
        latc,
        azimuth,
        pseudo_standard_parallel,
        k0,
        false_easting,
        false_northing,
    ):
        self.ell = ell
        self.fe = false_easting
        self.fn = false_northing
        e, e2 = ell.e, ell.e2
        phi_c = np.radians(latc)
        self.lam0 = np.radians(lonc)
        self.alpha_c = np.radians(azimuth)
        psi = np.radians(pseudo_standard_parallel)

        sin_c = np.sin(phi_c)
        self.A = ell.a * np.sqrt(1 - e2) / (1 - e2 * sin_c**2)
        self.B = np.sqrt(1 + e2 * np.cos(phi_c) ** 4 / (1 - e2))
        self.gamma0 = np.arcsin(sin_c / self.B)
        self.t0 = (
            np.tan(np.pi / 4 + self.gamma0 / 2)
            * ((1 + e * sin_c) / (1 - e * sin_c)) ** (e * self.B / 2)
            / np.tan(np.pi / 4 + phi_c / 2) ** self.B
        )
        self.n = np.sin(psi)
        self.r0 = k0 * self.A / np.tan(psi)
        self.tan_psi_half = np.tan(psi / 2 + np.pi / 4)

    def forward(self, lon, lat):
        e = self.ell.e
        phi = np.radians(np.asarray(lat, dtype=float))
        lam = np.radians(np.asarray(lon, dtype=float))
        sin_phi = np.sin(phi)
        big_u = 2 * (
            np.arctan(
                self.t0
                * np.tan(phi / 2 + np.pi / 4) ** self.B
                / ((1 + e * sin_phi) / (1 - e * sin_phi)) ** (e * self.B / 2)
            )
            - np.pi / 4
        )
        big_v = self.B * (self.lam0 - lam)
        big_t = np.arcsin(
            np.cos(self.alpha_c) * np.sin(big_u)
            + np.sin(self.alpha_c) * np.cos(big_u) * np.cos(big_v)
        )
        big_d = np.arcsin(np.cos(big_u) * np.sin(big_v) / np.cos(big_t))
        theta = self.n * big_d
        r = (
            self.r0
            * self.tan_psi_half**self.n
            / np.tan(big_t / 2 + np.pi / 4) ** self.n
        )
        southing = r * np.cos(theta)
        westing = r * np.sin(theta)
        return -westing + self.fe, -southing + self.fn

    def inverse(self, x, y):
        e = self.ell.e
        westing = -(np.asarray(x, dtype=float) - self.fe)
        southing = -(np.asarray(y, dtype=float) - self.fn)
        r = np.hypot(southing, westing)
        theta = np.arctan2(westing, southing)
        big_d = theta / self.n
        big_t = 2 * (
            np.arctan((self.r0 / r) ** (1 / self.n) * self.tan_psi_half)
            - np.pi / 4
        )
        big_u = np.arcsin(
            np.cos(self.alpha_c) * np.sin(big_t)
            - np.sin(self.alpha_c) * np.cos(big_t) * np.cos(big_d)
        )
        big_v = np.arcsin(np.cos(big_t) * np.sin(big_d) / np.cos(big_u))
        lam = self.lam0 - big_v / self.B

        # invert the conformal-sphere latitude iteratively
        phi = big_u
        for _ in range(8):
            sin_phi = np.sin(phi)
            phi = 2 * (
                np.arctan(
                    (np.tan(big_u / 2 + np.pi / 4) / self.t0) ** (1 / self.B)
                    * ((1 + e * sin_phi) / (1 - e * sin_phi)) ** (e / 2)
                )
                - np.pi / 4
            )
        return np.degrees(lam), np.degrees(phi)


class _KrovakModified(_Krovak):
    """Krovak Modified (EPSG method 1042 / 1043 north-orientated): plain
    Krovak plus the published S-JTSK/05 polynomial distortion corrections
    evaluated around a fixed point in the (southing, westing) plane.  The
    evaluation point and C1..C10 exist for exactly one real-world grid
    (S-JTSK/05, EPSG Guidance Note 7-2 §3.2.8), so they are constants —
    proj.db's conversion table cannot even carry them (7-parameter cap),
    and PROJ's ``+proj=mod_krovak`` hardcodes the same values."""

    _X0, _Y0 = 1089000.0, 654000.0
    _C = (
        2.946529277e-02, 2.515965696e-02, 1.193845912e-07,
        -4.668270147e-07, 9.233980362e-12, 1.523735715e-12,
        1.696780024e-18, 4.408314235e-18, -8.331083518e-24,
        -3.689471323e-24,
    )

    def _corrections(self, southing, westing):
        c1, c2, c3, c4, c5, c6, c7, c8, c9, c10 = self._C
        xr = southing - self._X0
        yr = westing - self._Y0
        xr2, yr2 = xr * xr, yr * yr
        dx = (
            c1 + c3 * xr - c4 * yr - 2 * c6 * xr * yr + c5 * (xr2 - yr2)
            + c7 * xr * (xr2 - 3 * yr2) - c8 * yr * (3 * xr2 - yr2)
            + 4 * c9 * xr * yr * (xr2 - yr2)
            + c10 * (xr2 * xr2 + yr2 * yr2 - 6 * xr2 * yr2)
        )
        dy = (
            c2 + c3 * yr + c4 * xr + 2 * c5 * xr * yr + c6 * (xr2 - yr2)
            + c8 * xr * (xr2 - 3 * yr2) + c7 * yr * (3 * xr2 - yr2)
            - 4 * c10 * xr * yr * (xr2 - yr2)
            + c9 * (xr2 * xr2 + yr2 * yr2 - 6 * xr2 * yr2)
        )
        return dx, dy

    def forward(self, lon, lat):
        x, y = _Krovak.forward(self, lon, lat)
        # back to raw EPSG southing/westing (the parent negates and
        # applies FE/FN), correct, then restore the convention
        southing = -(y - self.fn)
        westing = -(x - self.fe)
        dx, dy = self._corrections(southing, westing)
        return (
            -(westing - dy) + self.fe,
            -(southing - dx) + self.fn,
        )

    def inverse(self, x, y):
        southing = -(np.asarray(y, dtype=float) - self.fn)
        westing = -(np.asarray(x, dtype=float) - self.fe)
        # EPSG 1042 reverse: the corrections are evaluated at the INPUT
        # grid point and ADDED (they vary slowly enough at ~0.1 m scale)
        dx, dy = self._corrections(southing, westing)
        return _Krovak.inverse(
            self,
            -(westing + dy) + self.fe,
            -(southing + dx) + self.fn,
        )


class _ColombiaUrban:
    """Colombia Urban (EPSG method 1052): a plane at ``h0`` metres above
    the ellipsoid, tangent at the origin — the method behind Colombia's
    32 MAGNA-SIRGAS city grids (EPSG Guidance Note 7-2 §3.7.2)."""

    is_geographic = False
    unit = "metre"

    def __init__(self, ell, lon0, lat0, h0, false_easting, false_northing):
        self.ell = ell
        self.lam0 = np.radians(lon0)
        self.phi0 = np.radians(lat0)
        self.fe = false_easting
        self.fn = false_northing
        e2 = ell.e2
        sin0 = np.sin(self.phi0)
        self.h0 = h0
        self.rho0 = ell.a * (1 - e2) / (1 - e2 * sin0**2) ** 1.5
        nu0 = ell.a / np.sqrt(1 - e2 * sin0**2)
        self.A = 1 + h0 / nu0
        self.big_b = np.tan(self.phi0) / (2 * self.rho0 * nu0)

    def _g(self, phi):
        """G = 1 + h0 / rho_M, rho_M at the origin/target mid-latitude."""
        e2 = self.ell.e2
        sin_m = np.sin(0.5 * (phi + self.phi0))
        rho_m = self.ell.a * (1 - e2) / (1 - e2 * sin_m**2) ** 1.5
        return 1 + self.h0 / rho_m

    def forward(self, lon, lat):
        e2 = self.ell.e2
        phi = np.radians(np.asarray(lat, dtype=float))
        lam = np.radians(np.asarray(lon, dtype=float))
        sin_phi = np.sin(phi)
        nu = self.ell.a / np.sqrt(1 - e2 * sin_phi**2)
        dl = lam - self.lam0
        x = self.fe + self.A * nu * np.cos(phi) * dl
        y = self.fn + self._g(phi) * self.rho0 * (
            (phi - self.phi0) + self.big_b * dl**2 * nu**2 * np.cos(phi) ** 2
        )
        return x, y

    def inverse(self, x, y):
        e2 = self.ell.e2
        de = np.asarray(x, dtype=float) - self.fe
        dn = np.asarray(y, dtype=float) - self.fn
        # iterate phi from the northing equation, then lambda follows
        phi = self.phi0 + dn / self.rho0
        lam = self.lam0
        for _ in range(8):
            sin_phi = np.sin(phi)
            nu = self.ell.a / np.sqrt(1 - e2 * sin_phi**2)
            dl = de / (self.A * nu * np.cos(phi))
            phi = self.phi0 + dn / (self._g(phi) * self.rho0) - (
                self.big_b * dl**2 * nu**2 * np.cos(phi) ** 2
            )
            lam = self.lam0 + dl
        return np.degrees(lam), np.degrees(phi)


class _NewZealandMapGrid:
    """New Zealand Map Grid (EPSG method 9811, EPSG:27200).

    A sixth-order complex-polynomial conformal projection fitted to the
    shape of New Zealand (LINZ standard LINZS25000; the series
    coefficients are the published ones, as also used by PROJ's
    ``+proj=nzmg``).  The latitude series works in units of 1e5 arc
    seconds of latitude difference from the -41° origin; longitudes are
    plain radian offsets from 173°E.  Complex arithmetic is spelled out
    on (real, imag) pairs, as in the JAX package."""

    is_geographic = False
    unit = "metre"

    # psi(delta-phi) series, delta-phi in 1e5 arcsec (forward)
    _TPSI = (
        0.6399175073, -0.1358797613, 0.063294409, -0.02526853, 0.0117879,
        -0.0055161, 0.0026906, -0.001333, 0.00067, -0.00034,
    )
    # delta-phi(psi) series (inverse first estimate)
    _TPHI = (
        1.5627014243, 0.5185406398, -0.03333098, -0.1052906, -0.0368594,
        0.007317, 0.01220, 0.00394, -0.0013,
    )
    # complex series: z = psi + i*dlam -> (northing + i*easting) / a
    _BF = (
        (0.7557853228, 0.0),
        (0.249204646, 0.003371507),
        (-0.001541739, 0.041058560),
        (-0.10162907, 0.01727609),
        (-0.26623489, -0.36249218),
        (-0.6870983, -1.1651967),
    )
    # inverse first estimate: (northing + i*easting)/a -> psi + i*dlam
    _BW = (
        (1.3231270439, 0.0),
        (-0.577245789, -0.007809598),
        (0.508307513, -0.112208952),
        (-0.15094762, 0.18200602),
        (1.01418179, 1.64497696),
        (1.9660549, 2.5127645),
    )
    #: radians -> units of 1e5 arc seconds
    _RAD_TO_SEC5 = 180.0 * 3600.0 / np.pi * 1e-5

    def __init__(self, ell, lon0=173.0, lat0=-41.0,
                 false_easting=2510000.0, false_northing=6023150.0):
        self.ell = ell
        self.lam0 = np.radians(lon0)
        self.phi0 = np.radians(lat0)
        self.fe = false_easting
        self.fn = false_northing

    def forward(self, lon, lat):
        phi = np.radians(np.asarray(lat, dtype=float))
        lam = np.radians(np.asarray(lon, dtype=float))
        dphi = (phi - self.phi0) * self._RAD_TO_SEC5
        psi = 0.0
        for c in self._TPSI[::-1]:
            psi = (psi + c) * dphi
        zr, zi = psi, lam - self.lam0
        pr, pi = _complex_poly(zr, zi, self._BF)
        return pi * self.ell.a + self.fe, pr * self.ell.a + self.fn

    def inverse(self, x, y):
        zr = (np.asarray(y, dtype=float) - self.fn) / self.ell.a
        zi = (np.asarray(x, dtype=float) - self.fe) / self.ell.a
        # first estimate, then Newton against the forward series; three
        # fixed iterations reach <1e-12 over the projection's domain and
        # a fixed count (no data-dependent loop), as in the JAX package
        pr, pi = _complex_poly(zr, zi, self._BW)
        for _ in range(3):
            fr, fi, dr, di = _complex_poly_d1(pr, pi, self._BF)
            fr, fi = fr - zr, fi - zi
            den = dr * dr + di * di
            pr = pr - (fr * dr + fi * di) / den
            pi = pi - (fi * dr - fr * di) / den
        psi, dlam = pr, pi
        # latitude: tphi-series estimate refined against the tpsi series
        dphi = 0.0
        for c in self._TPHI[::-1]:
            dphi = (dphi + c) * psi
        for _ in range(2):
            f = 0.0
            fp = 0.0
            for j in range(len(self._TPSI) - 1, -1, -1):
                f = f * dphi + self._TPSI[j]
                fp = fp * dphi + (j + 1) * self._TPSI[j]
            f = f * dphi - psi
            dphi = dphi - f / fp
        phi = self.phi0 + dphi / self._RAD_TO_SEC5
        lam = self.lam0 + dlam
        return np.degrees(lam), np.degrees(phi)


def _complex_poly(zr, zi, coeffs):
    """sum coeffs[j] * z**(j+1) (zero constant term), Horner on pairs."""
    pr, pi = coeffs[-1]
    for cr, ci in coeffs[-2::-1]:
        pr, pi = cr + pr * zr - pi * zi, ci + pi * zr + pr * zi
    return pr * zr - pi * zi, pr * zi + pi * zr


def _complex_poly_d1(zr, zi, coeffs):
    """Value and derivative of sum coeffs[j] * z**(j+1)."""
    fr, fi = _complex_poly(zr, zi, coeffs)
    dr, di = len(coeffs) * coeffs[-1][0], len(coeffs) * coeffs[-1][1]
    for j in range(len(coeffs) - 2, -1, -1):
        cr, ci = coeffs[j]
        dr, di = (
            (j + 1) * cr + dr * zr - di * zi,
            (j + 1) * ci + di * zr + dr * zi,
        )
    return fr, fi, dr, di


# --- generic Newton inverse + the long-tail projection families ---
#
# The reference handles *any* CRS through OSR/PROJ (reference
# utils.py:396-473).  The families below extend the native coverage to
# the common long tail; projections without a closed-form inverse invert
# their own forward map with a damped 2-D Newton iteration, so any
# parametric definition in a known family transforms instead of raising.


def _newton_inverse(forward, x, y, lon, lat, iters=18):
    """Invert ``forward(lon, lat) -> (x, y)`` by damped 2-D Newton with a
    finite-difference Jacobian.  Fixed iteration count (the JAX
    package's, which traces it); quadratic convergence makes 18 rounds ample for any seed within
    the projection's domain.  Non-convergent points come back NaN."""
    h = 1e-7  # degrees: ~1 cm on the ground; safe for f64 differences
    for _ in range(iters):
        fx, fy = forward(lon, lat)
        fx1, fy1 = forward(lon + h, lat)
        fx2, fy2 = forward(lon, lat + h)
        j11 = (fx1 - fx) / h
        j21 = (fy1 - fy) / h
        j12 = (fx2 - fx) / h
        j22 = (fy2 - fy) / h
        det = j11 * j22 - j12 * j21
        det = np.where(det == 0.0, np.nan, det)
        rx = x - fx
        ry = y - fy
        # damp steps: a wild Jacobian at a domain edge must not fling the
        # iterate out of the hemisphere
        dlon = np.clip((j22 * rx - j12 * ry) / det, -20.0, 20.0)
        dlat = np.clip((j11 * ry - j21 * rx) / det, -20.0, 20.0)
        lon = lon + dlon
        lat = np.clip(lat + dlat, -89.999999, 89.999999)
    return lon, lat


class _NumericInverse:
    """Mixin: projections defined by their forward map only.  Subclasses
    provide ``_inverse_seed(x, y) -> (lon, lat)`` (a rough guess; the
    default assumes roughly-metric coordinates about the origin)."""

    def _inverse_seed(self, x, y):
        a = self.ell.a
        lon = self.lon0 + np.degrees((x - self.fe) / a)
        lat = np.degrees((y - self.fn) / a) + getattr(self, "lat0", 0.0)
        return np.clip(lon, self.lon0 - 179.0, self.lon0 + 179.0), np.clip(
            lat, -89.0, 89.0
        )

    def inverse(self, x, y):
        x = np.asarray(x, dtype=float)
        y = np.asarray(y, dtype=float)
        lon, lat = self._inverse_seed(x, y)
        return _newton_inverse(self.forward, x, y, lon, lat)


class _HyperbolicCassiniSoldner(_NumericInverse, _CassiniSoldner):
    """Hyperbolic Cassini-Soldner (EPSG method 9833; Vanua Levu grid,
    EPSG:3139): plain Cassini-Soldner with the hyperbolic northing
    correction N = FN + X - X^3/(6 rho nu) (EPSG GN7-2).  The inverse is
    damped Newton seeded by the plain Cassini inverse — the single CRS
    using this method spans under two degrees."""

    def forward(self, lon, lat):
        x, y = _CassiniSoldner.forward(self, lon, lat)
        ell = self.ell
        sin_phi = np.sin(np.radians(np.asarray(lat, dtype=float)))
        w = 1 - ell.e2 * sin_phi**2
        nu = ell.a / np.sqrt(w)
        rho = ell.a * (1 - ell.e2) / w**1.5
        big_x = y - self.fn
        return x, self.fn + big_x - big_x**3 / (6 * rho * nu)

    def _inverse_seed(self, x, y):
        return _CassiniSoldner.inverse(self, x, y)


class _GuamProjection:
    """Guam projection (EPSG method 9831; EPSG:3993): the simplified
    azimuthal equidistant of EPSG GN7-2, with the fixed-count inverse
    iteration on the meridional arc the guidance note prescribes."""

    is_geographic = False
    unit = "metre"

    def __init__(self, ell, lon0, lat0, false_easting, false_northing):
        self.ell = ell
        self.lon0 = lon0
        self.lat0 = lat0
        self.fe = false_easting
        self.fn = false_northing
        self.big_a, self._fwd, self._inv = _rectifying_series(ell)
        self.m0 = _meridian_arc(self.big_a, self._fwd, np.radians(lat0))

    def forward(self, lon, lat):
        ell = self.ell
        lon = np.asarray(lon, dtype=float)
        phi = np.radians(np.asarray(lat, dtype=float))
        dlam = np.radians((lon - self.lon0 + 180.0) % 360.0 - 180.0)
        w = np.sqrt(1 - ell.e2 * np.sin(phi) ** 2)
        x = ell.a * dlam * np.cos(phi) / w
        m = _meridian_arc(self.big_a, self._fwd, phi)
        y = m - self.m0 + x**2 * np.tan(phi) * w / (2 * ell.a)
        return self.fe + x, self.fn + y

    def inverse(self, x, y):
        ell = self.ell
        x = np.asarray(x, dtype=float) - self.fe
        y = np.asarray(y, dtype=float) - self.fn
        arc = self.m0 + y
        phi = _inverse_meridian_arc(self.big_a, self._inv, arc)
        for _ in range(3):  # the GN7-2 three-pass refinement
            w = np.sqrt(1 - ell.e2 * np.sin(phi) ** 2)
            arc = self.m0 + y - x**2 * np.tan(phi) * w / (2 * ell.a)
            phi = _inverse_meridian_arc(self.big_a, self._inv, arc)
        w = np.sqrt(1 - ell.e2 * np.sin(phi) ** 2)
        lam = x * w / (ell.a * np.cos(phi))
        return self.lon0 + np.degrees(lam), np.degrees(phi)


class _LambertConicNearConformal:
    """Lambert Conic Near-Conformal (EPSG method 9817; Levant zone,
    EPSG:22700).  EPSG GN7-2 series forms with the cubic arc correction
    M = k0 (m + A m^3); the inverse mirrors the guidance note's
    fixed-point iterations."""

    is_geographic = False
    unit = "metre"

    def __init__(self, ell, lon0, lat0, k0, false_easting, false_northing):
        self.ell = ell
        self.lon0 = lon0
        self.lat0 = lat0
        self.k0 = k0
        self.fe = false_easting
        self.fn = false_northing
        a, e2 = ell.a, ell.e2
        phi0 = math.radians(lat0)
        sin0 = math.sin(phi0)
        w0 = 1 - e2 * sin0 * sin0
        nu0 = a / math.sqrt(w0)
        rho0 = a * (1 - e2) / w0**1.5
        self.cube_a = 1.0 / (6.0 * rho0 * nu0)
        n = ell.f / (2.0 - ell.f)
        n2, n3, n4, n5 = n * n, n**3, n**4, n**5
        # GN7-2 meridian-arc coefficients; A' multiplies phi in DEGREES
        self.coeff_a = (
            a * (1 - n + 5 * (n2 - n3) / 4 + 81 * (n4 - n5) / 64)
            * math.pi / 180.0
        )
        self.coeff_b = 1.5 * a * (n - n2 + 7 * (n3 - n4) / 8 + 55 * n5 / 64)
        self.coeff_c = 15 * a * (n2 - n3 + 0.75 * (n4 - n5)) / 16
        self.coeff_d = 35 * a * (n3 - n4 + 11 * n5 / 16) / 48
        self.coeff_e = 315 * a * (n4 - n5) / 512
        self.s0 = float(self._meridian_s(np.asarray(lat0, float)))
        self.r0 = k0 * nu0 / math.tan(phi0)
        self.sin_phi0 = sin0

    def _meridian_s(self, lat_deg):
        phi = np.radians(lat_deg)
        return (
            self.coeff_a * lat_deg
            - self.coeff_b * np.sin(2 * phi)
            + self.coeff_c * np.sin(4 * phi)
            - self.coeff_d * np.sin(6 * phi)
            + self.coeff_e * np.sin(8 * phi)
        )

    def forward(self, lon, lat):
        lon = np.asarray(lon, dtype=float)
        lat = np.asarray(lat, dtype=float)
        m = self._meridian_s(lat) - self.s0
        big_m = self.k0 * (m + self.cube_a * m**3)
        r = self.r0 - big_m
        dlam = np.radians((lon - self.lon0 + 180.0) % 360.0 - 180.0)
        theta = dlam * self.sin_phi0
        x = r * np.sin(theta)
        return self.fe + x, self.fn + big_m + x * np.tan(theta / 2)

    def inverse(self, x, y):
        x = np.asarray(x, dtype=float) - self.fe
        y = np.asarray(y, dtype=float) - self.fn
        theta = np.arctan2(x, self.r0 - y)
        big_m = y - x * np.tan(theta / 2)
        m = big_m / self.k0
        for _ in range(4):  # invert M = k0 (m + A m^3)
            m = m - (self.k0 * (m + self.cube_a * m**3) - big_m) / (
                self.k0 * (1 + 3 * self.cube_a * m**2)
            )
        lat = (m + self.s0) / self.coeff_a
        for _ in range(4):  # invert the meridian series (phi in degrees)
            lat = lat + (m + self.s0 - self._meridian_s(lat)) / self.coeff_a
        lon = self.lon0 + np.degrees(theta / self.sin_phi0)
        return lon, lat


class _LabordeObliqueMercator(_NumericInverse):
    """Laborde oblique Mercator (EPSG method 9813; Madagascar grids
    EPSG:8441/29701).  EPSG GN7-2: Gaussian sphere, oblique rotation,
    and the cubic complex correction H + G H^3; damped-Newton inverse."""

    is_geographic = False
    unit = "metre"

    def __init__(self, ell, lonc, latc, azimuth, k0, false_easting,
                 false_northing):
        self.ell = ell
        self.lon0 = lonc
        self.lat0 = latc
        self.fe = false_easting
        self.fn = false_northing
        e, e2 = ell.e, ell.e2
        phic = math.radians(latc)
        sinc = math.sin(phic)
        self.big_b = math.sqrt(1 + e2 * math.cos(phic) ** 4 / (1 - e2))
        self.phi_s = math.asin(sinc / self.big_b)
        self.big_r = ell.a * k0 * math.sqrt(1 - e2) / (1 - e2 * sinc * sinc)
        self.big_c = math.log(math.tan(math.pi / 4 + self.phi_s / 2)) - (
            self.big_b
            * math.log(
                math.tan(math.pi / 4 + phic / 2)
                * ((1 - e * sinc) / (1 + e * sinc)) ** (e / 2)
            )
        )
        two_alpha = 2.0 * math.radians(azimuth)
        self.g_re = (1 - math.cos(two_alpha)) / 12.0
        self.g_im = math.sin(two_alpha) / 12.0

    def forward(self, lon, lat):
        ell = self.ell
        e = ell.e
        lon = np.asarray(lon, dtype=float)
        phi = np.radians(np.asarray(lat, dtype=float))
        dlam = np.radians((lon - self.lon0 + 180.0) % 360.0 - 180.0)
        big_l = self.big_b * dlam
        sin_phi = np.sin(phi)
        q = self.big_c + self.big_b * np.log(
            np.tan(np.pi / 4 + phi / 2)
            * ((1 - e * sin_phi) / (1 + e * sin_phi)) ** (e / 2)
        )
        big_p = 2 * np.arctan(np.exp(q)) - np.pi / 2
        cos_p, sin_p = np.cos(big_p), np.sin(big_p)
        cos_l, sin_l = np.cos(big_l), np.sin(big_l)
        sin_s, cos_s = np.sin(self.phi_s), np.cos(self.phi_s)
        big_u = cos_p * cos_l * cos_s + sin_p * sin_s
        big_v = cos_p * cos_l * sin_s - sin_p * cos_s
        big_w = cos_p * sin_l
        d = np.hypot(big_u, big_v)
        l1 = np.where(d > 0, 2 * np.arctan2(big_v, big_u + d), 0.0)
        p1 = np.arctan2(big_w, d)
        h_re = -l1
        h_im = np.log(np.tan(np.pi / 4 + p1 / 2))
        # H + G H^3 in complex arithmetic, split into parts
        h2_re = h_re * h_re - h_im * h_im
        h2_im = 2 * h_re * h_im
        h3_re = h2_re * h_re - h2_im * h_im
        h3_im = h2_re * h_im + h2_im * h_re
        out_re = h_re + self.g_re * h3_re - self.g_im * h3_im
        out_im = h_im + self.g_re * h3_im + self.g_im * h3_re
        return self.fe + self.big_r * out_im, self.fn + self.big_r * out_re


class _TransverseMercatorZoned:
    """Transverse Mercator Zoned Grid System (EPSG method 9824;
    EPSG:32600/32700): the zone number from longitude prefixes the
    easting in units of 10^6 m, each zone a plain UTM-style TM."""

    is_geographic = False
    unit = "metre"

    def __init__(self, ell, initial_lon, zone_width, lat0, k0,
                 false_easting, false_northing):
        self.ell = ell
        self.initial_lon = initial_lon
        self.width = float(zone_width)
        self.lon0 = initial_lon  # _NumericInverse-style attribute parity
        self._tm = _TransverseMercator(
            ell, 0.0, lat0, k0, false_easting, false_northing
        )
        self.fe = false_easting
        self.fn = false_northing

    def forward(self, lon, lat):
        lon = np.asarray(lon, dtype=float)
        rel = (lon - self.initial_lon) % 360.0
        zone = np.floor(rel / self.width) + 1
        dlon = rel - (zone - 0.5) * self.width
        x, y = self._tm.forward(dlon, lat)
        return zone * 1e6 + x, y

    def inverse(self, x, y):
        x = np.asarray(x, dtype=float)
        zone = np.floor(x / 1e6)
        lon, lat = self._tm.inverse(x - zone * 1e6, y)
        lon = lon + self.initial_lon + (zone - 0.5) * self.width
        return (lon + 180.0) % 360.0 - 180.0, lat


class _TunisiaMiningGrid:
    """Tunisia Mining Grid (EPSG method 9816; EPSG:22300).  The grid is
    an exact grads-based affine about the false origin (EPSG GN7-2:
    one grid kilometre = 0.012185 grads of longitude / 0.010015 grads
    of latitude); parameters arrive in degrees/metres from the registry
    and convert back internally.  Longitudes are relative to the CRS's
    (Paris) prime meridian like every projection here."""

    is_geographic = False
    unit = "metre"

    #: GN7-2 constants: grads per grid kilometre
    LON_GRADS_PER_KM = 0.012185
    LAT_GRADS_PER_KM = 0.010015

    def __init__(self, ell, lon0, lat0, false_easting, false_northing):
        self.ell = ell
        self.lon0 = lon0  # degrees (7.83445 grads)
        self.lat0 = lat0  # degrees (36.5964 grads)
        self.fe = false_easting  # metres (270 km)
        self.fn = false_northing  # metres (360 km)

    def forward(self, lon, lat):
        lon = np.asarray(lon, dtype=float)
        lat = np.asarray(lat, dtype=float)
        dlon_grads = ((lon - self.lon0 + 180.0) % 360.0 - 180.0) / 0.9
        dlat_grads = (lat - self.lat0) / 0.9
        x = self.fe + dlon_grads / self.LON_GRADS_PER_KM * 1000.0
        y = self.fn + dlat_grads / self.LAT_GRADS_PER_KM * 1000.0
        return x, y

    def inverse(self, x, y):
        x = np.asarray(x, dtype=float)
        y = np.asarray(y, dtype=float)
        lon = self.lon0 + (x - self.fe) / 1000.0 * self.LON_GRADS_PER_KM * 0.9
        lat = self.lat0 + (y - self.fn) / 1000.0 * self.LAT_GRADS_PER_KM * 0.9
        return lon, lat


def _authalic_coeffs(ell):
    """(qp, (c2, c4, c6)): total authalic q and the authalic->geodetic
    latitude series phi = beta + c2 sin 2b + c4 sin 4b + c6 sin 6b."""
    e2 = ell.e2
    e4 = e2 * e2
    e6 = e4 * e2
    if ell.e == 0:
        return 2.0, (0.0, 0.0, 0.0)
    qp = (1 - e2) * (
        1 / (1 - e2) - (1 / (2 * ell.e)) * np.log((1 - ell.e) / (1 + ell.e))
    )
    return qp, (
        e2 / 3 + 31 * e4 / 180 + 517 * e6 / 5040,
        23 * e4 / 360 + 251 * e6 / 3780,
        761 * e6 / 45360,
    )


def _authalic_q(ell, phi):
    """Snyder's q (3-12): the equal-area integrand at latitude phi."""
    if ell.e == 0:
        return 2.0 * np.sin(phi)
    sin_phi = np.sin(phi)
    esin = ell.e * sin_phi
    return (1 - ell.e2) * (
        sin_phi / (1 - ell.e2 * sin_phi**2)
        - (1 / (2 * ell.e)) * np.log((1 - esin) / (1 + esin))
    )


def _authalic_to_geodetic(coeffs, beta):
    c2, c4, c6 = coeffs
    return (
        beta
        + c2 * np.sin(2 * beta)
        + c4 * np.sin(4 * beta)
        + c6 * np.sin(6 * beta)
    )


class _AmericanPolyconic(_NumericInverse):
    """American polyconic, ellipsoidal (EPSG method 9818; Snyder 18-12..15)."""

    is_geographic = False
    unit = "metre"

    def __init__(self, ell, lon0, lat0, false_easting=0.0, false_northing=0.0):
        self.ell = ell
        self.lon0 = lon0
        self.lat0 = lat0
        self.fe = false_easting
        self.fn = false_northing
        self.big_a, self._fwd, self._inv = _rectifying_series(ell)
        self.m0 = _meridian_arc(self.big_a, self._fwd, np.radians(lat0))

    def forward(self, lon, lat):
        ell = self.ell
        lon = np.asarray(lon, dtype=float)
        phi = np.radians(np.asarray(lat, dtype=float))
        dlam = np.radians((lon - self.lon0 + 180.0) % 360.0 - 180.0)
        sin_phi = np.sin(phi)
        # guard the equator singularity: cot(phi) blows up, but the limit
        # is the plain equidistant cylindrical line
        tiny = np.abs(phi) < 1e-10
        phi_safe = np.where(tiny, 1e-10, phi)
        sin_safe = np.sin(phi_safe)
        nu = ell.a / np.sqrt(1 - ell.e2 * sin_safe**2)
        cot = np.cos(phi_safe) / sin_safe
        big_e = dlam * sin_safe
        m = _meridian_arc(self.big_a, self._fwd, phi)
        x = np.where(tiny, ell.a * dlam, nu * cot * np.sin(big_e))
        y = np.where(
            tiny,
            -self.m0,
            m - self.m0 + nu * cot * (1 - np.cos(big_e)),
        )
        return self.fe + x, self.fn + y


class _Bonne:
    """Bonne pseudoconic equal area, ellipsoidal (EPSG method 9827;
    Snyder p. 138-140)."""

    is_geographic = False
    unit = "metre"

    def __init__(self, ell, lon0, lat1, false_easting=0.0, false_northing=0.0):
        self.ell = ell
        self.lon0 = lon0
        self.fe = false_easting
        self.fn = false_northing
        phi1 = np.radians(lat1)
        self.sign = 1.0 if lat1 >= 0 else -1.0
        m1 = np.cos(phi1) / np.sqrt(1 - ell.e2 * np.sin(phi1) ** 2)
        self.big_a, self._fwd, self._inv = _rectifying_series(ell)
        self.m1 = _meridian_arc(self.big_a, self._fwd, phi1)
        self.rho1 = ell.a * m1 / np.sin(phi1)

    def forward(self, lon, lat):
        ell = self.ell
        lon = np.asarray(lon, dtype=float)
        phi = np.radians(np.asarray(lat, dtype=float))
        dlam = np.radians((lon - self.lon0 + 180.0) % 360.0 - 180.0)
        m = np.cos(phi) / np.sqrt(1 - ell.e2 * np.sin(phi) ** 2)
        arc = _meridian_arc(self.big_a, self._fwd, phi)
        rho = self.rho1 + self.m1 - arc
        rho_safe = np.where(rho == 0.0, 1e-12, rho)
        big_e = ell.a * m * dlam / rho_safe
        x = rho * np.sin(big_e)
        y = self.rho1 - rho * np.cos(big_e)
        return self.fe + x, self.fn + y

    def inverse(self, x, y):
        ell = self.ell
        x = np.asarray(x, dtype=float) - self.fe
        y = np.asarray(y, dtype=float) - self.fn
        rho = self.sign * np.hypot(x, self.rho1 - y)
        arc = self.rho1 + self.m1 - rho
        phi = _inverse_meridian_arc(self.big_a, self._inv, arc)
        m = np.cos(phi) / np.sqrt(1 - ell.e2 * np.sin(phi) ** 2)
        m_safe = np.where(np.abs(m) < 1e-12, 1e-12, m)
        big_e = np.arctan2(self.sign * x, self.sign * (self.rho1 - y))
        dlam = rho * big_e / (ell.a * m_safe)
        return self.lon0 + np.degrees(dlam), np.degrees(phi)


class _Sinusoidal:
    """Sinusoidal equal area, ellipsoidal (Snyder p. 243-248; the MODIS
    grid ESRI:54008 / the spherical 53008)."""

    is_geographic = False
    unit = "metre"

    def __init__(self, ell, lon0, false_easting=0.0, false_northing=0.0):
        self.ell = ell
        self.lon0 = lon0
        self.fe = false_easting
        self.fn = false_northing
        self.big_a, self._fwd, self._inv = _rectifying_series(ell)

    def forward(self, lon, lat):
        ell = self.ell
        lon = np.asarray(lon, dtype=float)
        phi = np.radians(np.asarray(lat, dtype=float))
        dlam = np.radians((lon - self.lon0 + 180.0) % 360.0 - 180.0)
        x = ell.a * dlam * np.cos(phi) / np.sqrt(1 - ell.e2 * np.sin(phi) ** 2)
        y = _meridian_arc(self.big_a, self._fwd, phi)
        return self.fe + x, self.fn + y

    def inverse(self, x, y):
        ell = self.ell
        x = np.asarray(x, dtype=float) - self.fe
        y = np.asarray(y, dtype=float) - self.fn
        phi = _inverse_meridian_arc(self.big_a, self._inv, y)
        cos_phi = np.cos(phi)
        cos_safe = np.where(np.abs(cos_phi) < 1e-12, 1e-12, cos_phi)
        dlam = x * np.sqrt(1 - ell.e2 * np.sin(phi) ** 2) / (ell.a * cos_safe)
        return self.lon0 + np.degrees(dlam), np.degrees(phi)


class _CylindricalEqualArea:
    """Lambert cylindrical equal area, normal aspect, ellipsoidal (EPSG
    method 9835; EPSG:6933 EASE-Grid 2.0; Snyder 10-1/10-2)."""

    is_geographic = False
    unit = "metre"

    def __init__(self, ell, lon0, lat_ts, false_easting=0.0, false_northing=0.0):
        self.ell = ell
        self.lon0 = lon0
        self.fe = false_easting
        self.fn = false_northing
        phi_ts = np.radians(lat_ts)
        self.k0 = np.cos(phi_ts) / np.sqrt(1 - ell.e2 * np.sin(phi_ts) ** 2)
        self.qp, self._auth = _authalic_coeffs(ell)

    def forward(self, lon, lat):
        ell = self.ell
        lon = np.asarray(lon, dtype=float)
        phi = np.radians(np.asarray(lat, dtype=float))
        dlam = np.radians((lon - self.lon0 + 180.0) % 360.0 - 180.0)
        x = ell.a * self.k0 * dlam
        y = ell.a * _authalic_q(ell, phi) / (2 * self.k0)
        return self.fe + x, self.fn + y

    def inverse(self, x, y):
        ell = self.ell
        x = np.asarray(x, dtype=float) - self.fe
        y = np.asarray(y, dtype=float) - self.fn
        dlam = x / (ell.a * self.k0)
        sin_beta = np.clip(2 * y * self.k0 / (ell.a * self.qp), -1.0, 1.0)
        beta = np.arcsin(sin_beta)
        phi = _authalic_to_geodetic(self._auth, beta)
        return self.lon0 + np.degrees(dlam), np.degrees(phi)


class _Mollweide:
    """Mollweide pseudocylindrical equal area, spherical (ESRI:54009 uses
    the semi-major axis as the radius, as PROJ does)."""

    is_geographic = False
    unit = "metre"

    def __init__(self, ell, lon0, false_easting=0.0, false_northing=0.0):
        self.ell = ell
        self.r = ell.a
        self.lon0 = lon0
        self.fe = false_easting
        self.fn = false_northing

    def forward(self, lon, lat):
        lon = np.asarray(lon, dtype=float)
        phi = np.radians(np.asarray(lat, dtype=float))
        dlam = np.radians((lon - self.lon0 + 180.0) % 360.0 - 180.0)
        target = np.pi * np.sin(phi)
        theta = phi
        for _ in range(14):  # Newton for 2t + sin 2t = pi sin phi
            f = 2 * theta + np.sin(2 * theta) - target
            theta = theta - f / (2 + 2 * np.cos(2 * theta) + 1e-15)
        # the derivative vanishes at the poles and Newton stalls there;
        # the limit is exact
        theta = np.where(
            np.abs(phi) > np.pi / 2 - 1e-7, np.sign(phi) * (np.pi / 2), theta
        )
        x = (2 * np.sqrt(2) / np.pi) * self.r * dlam * np.cos(theta)
        y = np.sqrt(2) * self.r * np.sin(theta)
        return self.fe + x, self.fn + y

    def inverse(self, x, y):
        x = np.asarray(x, dtype=float) - self.fe
        y = np.asarray(y, dtype=float) - self.fn
        theta = np.arcsin(np.clip(y / (np.sqrt(2) * self.r), -1.0, 1.0))
        phi = np.arcsin(
            np.clip((2 * theta + np.sin(2 * theta)) / np.pi, -1.0, 1.0)
        )
        cos_theta = np.cos(theta)
        cos_safe = np.where(cos_theta < 1e-12, 1e-12, cos_theta)
        dlam = np.pi * x / (2 * np.sqrt(2) * self.r * cos_safe)
        return self.lon0 + np.degrees(dlam), np.degrees(phi)


#: Robinson's table: X (length multiplier) and Y (parallel distance) at
#: every 5 degrees of latitude (Robinson 1974; the values PROJ embeds)
_ROBINSON_TABLE = np.array(
    [
        # lat, X, Y
        [0, 1.0000, 0.0000],
        [5, 0.9986, 0.0620],
        [10, 0.9954, 0.1240],
        [15, 0.9900, 0.1860],
        [20, 0.9822, 0.2480],
        [25, 0.9730, 0.3100],
        [30, 0.9600, 0.3720],
        [35, 0.9427, 0.4340],
        [40, 0.9216, 0.4958],
        [45, 0.8962, 0.5571],
        [50, 0.8679, 0.6176],
        [55, 0.8350, 0.6769],
        [60, 0.7986, 0.7346],
        [65, 0.7597, 0.7903],
        [70, 0.7186, 0.8435],
        [75, 0.6732, 0.8936],
        [80, 0.6213, 0.9394],
        [85, 0.5722, 0.9761],
        [90, 0.5322, 1.0000],
    ]
)


def _natural_spline_coeffs(xs, ys):
    """Second derivatives of the natural cubic spline through (xs, ys)."""
    n = len(xs)
    h = np.diff(xs)
    mat = np.zeros((n, n))
    rhs = np.zeros(n)
    mat[0, 0] = mat[-1, -1] = 1.0
    for i in range(1, n - 1):
        mat[i, i - 1] = h[i - 1]
        mat[i, i] = 2 * (h[i - 1] + h[i])
        mat[i, i + 1] = h[i]
        rhs[i] = 3 * ((ys[i + 1] - ys[i]) / h[i] - (ys[i] - ys[i - 1]) / h[i - 1])
    return np.linalg.solve(mat, rhs)


def _spline_eval(xs, ys, c, x):
    """Evaluate the natural cubic spline (and clamp outside the knots)."""
    x = np.clip(x, xs[0], xs[-1])
    i = np.clip(np.searchsorted(np.asarray(xs), x) - 1, 0, len(xs) - 2)
    xs_a = np.asarray(xs)
    ys_a = np.asarray(ys)
    c_a = np.asarray(c)
    x0 = xs_a[i]
    h = xs_a[i + 1] - x0
    y0 = ys_a[i]
    y1 = ys_a[i + 1]
    c0 = c_a[i]
    c1 = c_a[i + 1]
    b = (y1 - y0) / h - h * (2 * c0 + c1) / 3
    d = (c1 - c0) / (3 * h)
    t = x - x0
    return y0 + t * (b + t * (c0 + t * d))


class _Robinson(_NumericInverse):
    """Robinson pseudocylindrical (ESRI:54030), natural cubic splines
    through Robinson's 5-degree table."""

    is_geographic = False
    unit = "metre"

    def __init__(self, ell, lon0, false_easting=0.0, false_northing=0.0):
        self.ell = ell
        self.r = ell.a
        self.lon0 = lon0
        self.lat0 = 0.0
        self.fe = false_easting
        self.fn = false_northing
        lats = _ROBINSON_TABLE[:, 0]
        self._xs = lats
        self._xv = _ROBINSON_TABLE[:, 1]
        self._yv = _ROBINSON_TABLE[:, 2]
        self._xc = _natural_spline_coeffs(lats, self._xv)
        self._yc = _natural_spline_coeffs(lats, self._yv)

    def forward(self, lon, lat):
        lon = np.asarray(lon, dtype=float)
        lat = np.asarray(lat, dtype=float)
        dlam = np.radians((lon - self.lon0 + 180.0) % 360.0 - 180.0)
        alat = np.abs(lat)
        big_x = _spline_eval(self._xs, self._xv, self._xc, alat)
        big_y = _spline_eval(self._xs, self._yv, self._yc, alat)
        x = 0.8487 * self.r * big_x * dlam
        y = 1.3523 * self.r * np.sign(lat) * big_y
        return self.fe + x, self.fn + y

    def _inverse_seed(self, x, y):
        lat = np.clip(np.degrees((y - self.fn) / (1.3523 * self.r)) * 90.0 / 57.3, -89.0, 89.0)
        lon = self.lon0 + np.degrees((x - self.fe) / (0.8487 * self.r))
        return np.clip(lon, self.lon0 - 179.0, self.lon0 + 179.0), lat


class _VanDerGrinten(_NumericInverse):
    """Van der Grinten I, spherical (ESRI:54029; Snyder 33-1..33-13)."""

    is_geographic = False
    unit = "metre"

    def __init__(self, ell, lon0, false_easting=0.0, false_northing=0.0):
        self.ell = ell
        self.r = ell.a
        self.lon0 = lon0
        self.lat0 = 0.0
        self.fe = false_easting
        self.fn = false_northing

    def forward(self, lon, lat):
        lon = np.asarray(lon, dtype=float)
        lat = np.asarray(lat, dtype=float)
        dlam = np.radians((lon - self.lon0 + 180.0) % 360.0 - 180.0)
        phi = np.radians(lat)
        theta = np.arcsin(np.clip(np.abs(2 * phi / np.pi), 0.0, 1.0))
        # domain guards: the equator and the central meridian are limits
        small_phi = np.abs(phi) < 1e-10
        small_lam = np.abs(dlam) < 1e-10
        lam_safe = np.where(small_lam, 1e-10, dlam)
        big_a = 0.5 * np.abs(np.pi / lam_safe - lam_safe / np.pi)
        cos_theta = np.cos(theta)
        g_den = np.where(small_phi, 1.0, np.sin(theta))
        big_g = cos_theta / (g_den + cos_theta - 1)
        big_p = big_g * (2 / np.where(small_phi, 1.0, np.sin(theta)) - 1)
        a2 = big_a * big_a
        p2 = big_p * big_p
        q = a2 + big_g
        den = p2 + a2
        # Snyder 33-1 / 33-2
        root = np.sqrt(
            np.clip(
                a2 * (big_g - p2) ** 2 - den * (big_g * big_g - p2), 0.0, None
            )
        )
        x = (
            np.pi
            * self.r
            * np.sign(dlam)
            * (big_a * (big_g - p2) + root)
            / den
        )
        y_root = np.sqrt(np.clip((a2 + 1) * den - q * q, 0.0, None))
        y = np.pi * self.r * np.sign(lat) * (big_p * q - big_a * y_root) / den
        pole = np.abs(np.abs(lat) - 90.0) < 1e-9
        x = np.where(small_lam | pole, 0.0, x)
        y = np.where(small_phi, 0.0, y)
        x = np.where(small_phi & ~small_lam, self.r * lam_safe, x)
        y = np.where(
            (small_lam & ~small_phi) | pole,
            np.pi * self.r * np.tan(theta / 2) * np.sign(lat),
            y,
        )
        return self.fe + x, self.fn + y


class _EckertIV:
    """Eckert IV pseudocylindrical equal area, spherical (ESRI:54012)."""

    is_geographic = False
    unit = "metre"

    def __init__(self, ell, lon0, false_easting=0.0, false_northing=0.0):
        self.ell = ell
        self.r = ell.a
        self.lon0 = lon0
        self.fe = false_easting
        self.fn = false_northing

    def forward(self, lon, lat):
        lon = np.asarray(lon, dtype=float)
        phi = np.radians(np.asarray(lat, dtype=float))
        dlam = np.radians((lon - self.lon0 + 180.0) % 360.0 - 180.0)
        target = (2 + np.pi / 2) * np.sin(phi)
        theta = phi / 2
        for _ in range(16):  # Newton: t + sin t cos t + 2 sin t = target
            f = theta + np.sin(theta) * np.cos(theta) + 2 * np.sin(theta) - target
            df = 1 + np.cos(2 * theta) + 2 * np.cos(theta)
            theta = theta - f / (df + 1e-15)
        # Newton stalls where the derivative vanishes (the poles)
        theta = np.where(
            np.abs(phi) > np.pi / 2 - 1e-7, np.sign(phi) * (np.pi / 2), theta
        )
        x = (2 / np.sqrt(np.pi * (4 + np.pi))) * self.r * dlam * (
            1 + np.cos(theta)
        )
        y = 2 * np.sqrt(np.pi / (4 + np.pi)) * self.r * np.sin(theta)
        return self.fe + x, self.fn + y

    def inverse(self, x, y):
        x = np.asarray(x, dtype=float) - self.fe
        y = np.asarray(y, dtype=float) - self.fn
        theta = np.arcsin(
            np.clip(y / (2 * np.sqrt(np.pi / (4 + np.pi)) * self.r), -1.0, 1.0)
        )
        phi = np.arcsin(
            np.clip(
                (theta + np.sin(theta) * np.cos(theta) + 2 * np.sin(theta))
                / (2 + np.pi / 2),
                -1.0,
                1.0,
            )
        )
        den = (2 / np.sqrt(np.pi * (4 + np.pi))) * self.r * (1 + np.cos(theta))
        dlam = x / np.where(den < 1e-12, 1e-12, den)
        return self.lon0 + np.degrees(dlam), np.degrees(phi)


class _MillerCylindrical:
    """Miller cylindrical, spherical (ESRI:54003)."""

    is_geographic = False
    unit = "metre"

    def __init__(self, ell, lon0, false_easting=0.0, false_northing=0.0):
        self.ell = ell
        self.r = ell.a
        self.lon0 = lon0
        self.fe = false_easting
        self.fn = false_northing

    def forward(self, lon, lat):
        lon = np.asarray(lon, dtype=float)
        phi = np.radians(np.asarray(lat, dtype=float))
        dlam = np.radians((lon - self.lon0 + 180.0) % 360.0 - 180.0)
        x = self.r * dlam
        y = self.r * np.log(np.tan(np.pi / 4 + 0.4 * phi)) / 0.8
        return self.fe + x, self.fn + y

    def inverse(self, x, y):
        x = np.asarray(x, dtype=float) - self.fe
        y = np.asarray(y, dtype=float) - self.fn
        dlam = x / self.r
        phi = 2.5 * (np.arctan(np.exp(0.8 * y / self.r)) - np.pi / 4)
        return self.lon0 + np.degrees(dlam), np.degrees(phi)


class _GallStereographic:
    """Gall stereographic, spherical (ESRI:54016)."""

    is_geographic = False
    unit = "metre"

    def __init__(self, ell, lon0, false_easting=0.0, false_northing=0.0):
        self.ell = ell
        self.r = ell.a
        self.lon0 = lon0
        self.fe = false_easting
        self.fn = false_northing

    def forward(self, lon, lat):
        lon = np.asarray(lon, dtype=float)
        phi = np.radians(np.asarray(lat, dtype=float))
        dlam = np.radians((lon - self.lon0 + 180.0) % 360.0 - 180.0)
        x = self.r * dlam / np.sqrt(2)
        y = self.r * (1 + np.sqrt(2) / 2) * np.tan(phi / 2)
        return self.fe + x, self.fn + y

    def inverse(self, x, y):
        x = np.asarray(x, dtype=float) - self.fe
        y = np.asarray(y, dtype=float) - self.fn
        dlam = x * np.sqrt(2) / self.r
        phi = 2 * np.arctan(y / (self.r * (1 + np.sqrt(2) / 2)))
        return self.lon0 + np.degrees(dlam), np.degrees(phi)


class _EqualEarth:
    """Equal Earth pseudocylindrical equal area (EPSG method 1078,
    EPSG:8857; Savric, Patterson & Jenny 2018), over the authalic
    latitude so it is ellipsoid-exact like PROJ's implementation."""

    is_geographic = False
    unit = "metre"
    _A1 = 1.340264
    _A2 = -0.081106
    _A3 = 0.000893
    _A4 = 0.003796
    _M = np.sqrt(3) / 2

    def __init__(self, ell, lon0, false_easting=0.0, false_northing=0.0):
        self.ell = ell
        self.lon0 = lon0
        self.fe = false_easting
        self.fn = false_northing
        self.qp, self._auth = _authalic_coeffs(ell)
        self.rq = ell.a * np.sqrt(self.qp / 2)

    def _y_of_theta(self, theta):
        t2 = theta * theta
        t6 = t2 * t2 * t2
        return theta * (
            self._A1 + self._A2 * t2 + t6 * (self._A3 + self._A4 * t2)
        )

    def _dy_dtheta(self, theta):
        t2 = theta * theta
        t6 = t2 * t2 * t2
        return (
            self._A1
            + 3 * self._A2 * t2
            + t6 * (7 * self._A3 + 9 * self._A4 * t2)
        )

    def forward(self, lon, lat):
        ell = self.ell
        lon = np.asarray(lon, dtype=float)
        phi = np.radians(np.asarray(lat, dtype=float))
        dlam = np.radians((lon - self.lon0 + 180.0) % 360.0 - 180.0)
        beta = np.arcsin(
            np.clip(_authalic_q(ell, phi) / self.qp, -1.0, 1.0)
        )
        theta = np.arcsin(self._M * np.sin(beta))
        x = (
            2
            * np.sqrt(3)
            * self.rq
            * dlam
            * np.cos(theta)
            / (3 * self._dy_dtheta(theta))
        )
        y = self.rq * self._y_of_theta(theta)
        return self.fe + x, self.fn + y

    def inverse(self, x, y):
        x = np.asarray(x, dtype=float) - self.fe
        y = np.asarray(y, dtype=float) - self.fn
        yn = y / self.rq
        theta = yn
        for _ in range(12):  # Newton on y(theta)
            f = self._y_of_theta(theta) - yn
            theta = theta - f / self._dy_dtheta(theta)
        beta = np.arcsin(np.clip(np.sin(theta) / self._M, -1.0, 1.0))
        phi = _authalic_to_geodetic(self._auth, beta)
        dlam = (
            3
            * x
            * self._dy_dtheta(theta)
            / (2 * np.sqrt(3) * self.rq * np.cos(theta))
        )
        return self.lon0 + np.degrees(dlam), np.degrees(phi)


def _vincenty_inverse(ell, lat1, lon1, lat2, lon2, iters=20):
    """Geodesic distance and forward azimuth from point 1 to point 2
    (Vincenty, fixed iterations; nearly-antipodal pairs come back NaN-free
    but with reduced accuracy)."""
    f = ell.f
    b = ell.b
    u1 = np.arctan((1 - f) * np.tan(np.radians(lat1)))
    u2 = np.arctan((1 - f) * np.tan(np.radians(lat2)))
    ell_lam = np.radians(lon2 - lon1)
    sin_u1, cos_u1 = np.sin(u1), np.cos(u1)
    sin_u2, cos_u2 = np.sin(u2), np.cos(u2)
    lam = ell_lam
    for _ in range(iters):
        sin_lam, cos_lam = np.sin(lam), np.cos(lam)
        sin_sigma = np.sqrt(
            (cos_u2 * sin_lam) ** 2
            + (cos_u1 * sin_u2 - sin_u1 * cos_u2 * cos_lam) ** 2
        )
        cos_sigma = sin_u1 * sin_u2 + cos_u1 * cos_u2 * cos_lam
        sigma = np.arctan2(sin_sigma, cos_sigma)
        sin_safe = np.where(sin_sigma == 0.0, 1e-15, sin_sigma)
        sin_alpha = cos_u1 * cos_u2 * sin_lam / sin_safe
        cos2_alpha = 1 - sin_alpha**2
        cos2_safe = np.where(cos2_alpha == 0.0, 1e-15, cos2_alpha)
        cos_2sm = cos_sigma - 2 * sin_u1 * sin_u2 / cos2_safe
        c = f / 16 * cos2_alpha * (4 + f * (4 - 3 * cos2_alpha))
        lam = ell_lam + (1 - c) * f * sin_alpha * (
            sigma
            + c
            * sin_sigma
            * (cos_2sm + c * cos_sigma * (-1 + 2 * cos_2sm**2))
        )
    u_sq = cos2_alpha * (ell.a**2 - b**2) / b**2
    big_a = 1 + u_sq / 16384 * (4096 + u_sq * (-768 + u_sq * (320 - 175 * u_sq)))
    big_b = u_sq / 1024 * (256 + u_sq * (-128 + u_sq * (74 - 47 * u_sq)))
    delta_sigma = (
        big_b
        * sin_sigma
        * (
            cos_2sm
            + big_b
            / 4
            * (
                cos_sigma * (-1 + 2 * cos_2sm**2)
                - big_b
                / 6
                * cos_2sm
                * (-3 + 4 * sin_sigma**2)
                * (-3 + 4 * cos_2sm**2)
            )
        )
    )
    s = b * big_a * (sigma - delta_sigma)
    alpha1 = np.arctan2(
        cos_u2 * np.sin(lam), cos_u1 * sin_u2 - sin_u1 * cos_u2 * np.cos(lam)
    )
    return s, alpha1


def _vincenty_direct(ell, lat1, lon1, alpha1, s, iters=8):
    """Destination point given start, azimuth, and geodesic distance."""
    f = ell.f
    b = ell.b
    u1 = np.arctan((1 - f) * np.tan(np.radians(lat1)))
    sin_u1, cos_u1 = np.sin(u1), np.cos(u1)
    sin_a1, cos_a1 = np.sin(alpha1), np.cos(alpha1)
    sigma1 = np.arctan2(np.tan(u1), cos_a1)
    sin_alpha = cos_u1 * sin_a1
    cos2_alpha = 1 - sin_alpha**2
    u_sq = cos2_alpha * (ell.a**2 - b**2) / b**2
    big_a = 1 + u_sq / 16384 * (4096 + u_sq * (-768 + u_sq * (320 - 175 * u_sq)))
    big_b = u_sq / 1024 * (256 + u_sq * (-128 + u_sq * (74 - 47 * u_sq)))
    sigma = s / (b * big_a)
    for _ in range(iters):
        cos_2sm = np.cos(2 * sigma1 + sigma)
        sin_sigma, cos_sigma = np.sin(sigma), np.cos(sigma)
        delta = (
            big_b
            * sin_sigma
            * (
                cos_2sm
                + big_b
                / 4
                * (
                    cos_sigma * (-1 + 2 * cos_2sm**2)
                    - big_b
                    / 6
                    * cos_2sm
                    * (-3 + 4 * sin_sigma**2)
                    * (-3 + 4 * cos_2sm**2)
                )
            )
        )
        sigma = s / (b * big_a) + delta
    sin_sigma, cos_sigma = np.sin(sigma), np.cos(sigma)
    cos_2sm = np.cos(2 * sigma1 + sigma)
    lat2 = np.arctan2(
        sin_u1 * cos_sigma + cos_u1 * sin_sigma * cos_a1,
        (1 - f)
        * np.sqrt(
            sin_alpha**2 + (sin_u1 * sin_sigma - cos_u1 * cos_sigma * cos_a1) ** 2
        ),
    )
    lam = np.arctan2(
        sin_sigma * sin_a1,
        cos_u1 * cos_sigma - sin_u1 * sin_sigma * cos_a1,
    )
    c = f / 16 * cos2_alpha * (4 + f * (4 - 3 * cos2_alpha))
    dl = lam - (1 - c) * f * sin_alpha * (
        sigma
        + c * sin_sigma * (cos_2sm + c * cos_sigma * (-1 + 2 * cos_2sm**2))
    )
    return np.degrees(lat2), lon1 + np.degrees(dl)


class _AzimuthalEquidistant:
    """Azimuthal equidistant, ellipsoidal via Vincenty geodesics (the
    approach of PROJ's aeqd; EPSG method 1125 is the spherical case)."""

    is_geographic = False
    unit = "metre"

    def __init__(self, ell, lon0, lat0, false_easting=0.0, false_northing=0.0):
        self.ell = ell
        self.lon0 = lon0
        self.lat0 = lat0
        self.fe = false_easting
        self.fn = false_northing
        self.polar = abs(abs(lat0) - 90.0) < 1e-9
        self.north = lat0 > 0
        if self.polar:
            self.big_a, self._fwd, self._inv = _rectifying_series(ell)
            self.mp = _meridian_arc(self.big_a, self._fwd, np.radians(90.0))

    def forward(self, lon, lat):
        lon = np.asarray(lon, dtype=float)
        lat = np.asarray(lat, dtype=float)
        dlam = np.radians((lon - self.lon0 + 180.0) % 360.0 - 180.0)
        if self.polar:
            m = _meridian_arc(self.big_a, self._fwd, np.radians(lat))
            rho = self.mp - m if self.north else self.mp + m
            x = rho * np.sin(dlam)
            y = (-rho if self.north else rho) * np.cos(dlam)
            return self.fe + x, self.fn + y
        s, alpha = _vincenty_inverse(
            self.ell, self.lat0, self.lon0, lat, self.lon0 + np.degrees(dlam)
        )
        # the center itself: distance 0, azimuth undefined -> (0, 0)
        x = np.where(s < 1e-9, 0.0, s * np.sin(alpha))
        y = np.where(s < 1e-9, 0.0, s * np.cos(alpha))
        return self.fe + x, self.fn + y

    def inverse(self, x, y):
        x = np.asarray(x, dtype=float) - self.fe
        y = np.asarray(y, dtype=float) - self.fn
        if self.polar:
            rho = np.hypot(x, y)
            m = self.mp - rho if self.north else rho - self.mp
            lat = np.degrees(
                _inverse_meridian_arc(self.big_a, self._inv, m)
            )
            dlam = np.arctan2(x, -y if self.north else y)
            return self.lon0 + np.degrees(dlam), lat
        s = np.hypot(x, y)
        alpha = np.arctan2(x, y)
        lat, lon = _vincenty_direct(self.ell, self.lat0, self.lon0, alpha, s)
        lat = np.where(s < 1e-9, self.lat0, lat)
        lon = np.where(s < 1e-9, self.lon0, lon)
        return lon, lat


class _Orthographic(_NumericInverse):
    """Orthographic, ellipsoidal (EPSG method 9840)."""

    is_geographic = False
    unit = "metre"

    def __init__(self, ell, lon0, lat0, false_easting=0.0, false_northing=0.0):
        self.ell = ell
        self.lon0 = lon0
        self.lat0 = lat0
        self.fe = false_easting
        self.fn = false_northing
        phi0 = np.radians(lat0)
        self.sin0, self.cos0 = np.sin(phi0), np.cos(phi0)
        self.nu0 = ell.a / np.sqrt(1 - ell.e2 * self.sin0**2)

    def forward(self, lon, lat):
        ell = self.ell
        lon = np.asarray(lon, dtype=float)
        phi = np.radians(np.asarray(lat, dtype=float))
        dlam = np.radians((lon - self.lon0 + 180.0) % 360.0 - 180.0)
        sin_phi, cos_phi = np.sin(phi), np.cos(phi)
        nu = ell.a / np.sqrt(1 - ell.e2 * sin_phi**2)
        # the far hemisphere is unprojectable: NaN (as PROJ errors there)
        cos_c = self.sin0 * sin_phi + self.cos0 * cos_phi * np.cos(dlam)
        far = cos_c < -1e-10
        x = np.where(far, np.nan, nu * cos_phi * np.sin(dlam))
        y = np.where(
            far,
            np.nan,
            nu * (sin_phi * self.cos0 - cos_phi * self.sin0 * np.cos(dlam))
            + ell.e2 * (self.nu0 * self.sin0 - nu * sin_phi) * self.cos0,
        )
        return self.fe + x, self.fn + y

    def _inverse_seed(self, x, y):
        a = self.ell.a
        lon = self.lon0 + np.degrees(
            np.arcsin(np.clip((x - self.fe) / a, -0.99, 0.99))
        )
        lat = self.lat0 + np.degrees(
            np.arcsin(np.clip((y - self.fn) / a, -0.99, 0.99))
        )
        return lon, np.clip(lat, -89.0, 89.0)


class _Gnomonic:
    """Gnomonic, spherical."""

    is_geographic = False
    unit = "metre"

    def __init__(self, ell, lon0, lat0, false_easting=0.0, false_northing=0.0):
        self.ell = ell
        self.r = ell.a
        self.lon0 = lon0
        self.lat0 = lat0
        self.fe = false_easting
        self.fn = false_northing
        phi0 = np.radians(lat0)
        self.sin0, self.cos0 = np.sin(phi0), np.cos(phi0)

    def forward(self, lon, lat):
        lon = np.asarray(lon, dtype=float)
        phi = np.radians(np.asarray(lat, dtype=float))
        dlam = np.radians((lon - self.lon0 + 180.0) % 360.0 - 180.0)
        sin_phi, cos_phi = np.sin(phi), np.cos(phi)
        cos_c = self.sin0 * sin_phi + self.cos0 * cos_phi * np.cos(dlam)
        # the far hemisphere is unprojectable: NaN
        cos_c = np.where(cos_c <= 1e-10, np.nan, cos_c)
        x = self.r * cos_phi * np.sin(dlam) / cos_c
        y = (
            self.r
            * (self.cos0 * sin_phi - self.sin0 * cos_phi * np.cos(dlam))
            / cos_c
        )
        return self.fe + x, self.fn + y

    def inverse(self, x, y):
        x = np.asarray(x, dtype=float) - self.fe
        y = np.asarray(y, dtype=float) - self.fn
        rho = np.hypot(x, y)
        c = np.arctan(rho / self.r)
        sin_c, cos_c = np.sin(c), np.cos(c)
        rho_safe = np.where(rho == 0.0, 1e-15, rho)
        phi = np.arcsin(
            np.clip(
                cos_c * self.sin0 + y * sin_c * self.cos0 / rho_safe, -1.0, 1.0
            )
        )
        dlam = np.arctan2(
            x * sin_c, rho_safe * self.cos0 * cos_c - y * self.sin0 * sin_c
        )
        phi = np.where(rho == 0.0, np.radians(self.lat0), phi)
        dlam = np.where(rho == 0.0, 0.0, dlam)
        return self.lon0 + np.degrees(dlam), np.degrees(phi)


class _ScaledUnitProjection:
    """Wrap a projection whose CRS uses non-metre linear units (e.g. US
    survey foot state plane systems): grid coordinates = metres / factor."""

    is_geographic = False

    def __init__(self, inner, factor, unit_name="unknown"):
        self._inner = inner
        self.factor = factor
        self.unit = unit_name
        self.ell = inner.ell

    def forward(self, lon, lat):
        x, y = self._inner.forward(lon, lat)
        return x / self.factor, y / self.factor

    def inverse(self, x, y):
        return self._inner.inverse(
            np.asarray(x, dtype=float) * self.factor,
            np.asarray(y, dtype=float) * self.factor,
        )


class _AxisAdjustedProjection:
    """Wrap a projection whose CRS axes are non-metre and/or south/west
    orientated (EPSG axis conventions, e.g. Hartebeesthoek Lo grids or the
    west-orientated Greenland/Faroe Lamberts).  A flipped axis mirrors the
    projection displacement around the false origin, matching EPSG methods
    9808/9826: grid = (f + s*(m - f)) / factor."""

    is_geographic = False

    def __init__(self, inner, factor=1.0, sx=1, sy=1, fe=0.0, fn=0.0,
                 unit_name="unknown"):
        self._inner = inner
        self.factor = factor
        self.sx = sx
        self.sy = sy
        self.fe = fe
        self.fn = fn
        self.unit = unit_name
        self.ell = inner.ell

    def forward(self, lon, lat):
        x, y = self._inner.forward(lon, lat)
        x = (self.fe + self.sx * (x - self.fe)) / self.factor
        y = (self.fn + self.sy * (y - self.fn)) / self.factor
        return x, y

    def inverse(self, x, y):
        x = np.asarray(x, dtype=float) * self.factor
        y = np.asarray(y, dtype=float) * self.factor
        return self._inner.inverse(
            self.fe + self.sx * (x - self.fe),
            self.fn + self.sy * (y - self.fn),
        )


class _ShiftedGeographicProjection:
    """Geographic axes referenced to a non-Greenwich prime meridian and/or
    counted in non-degree units (e.g. NTF (Paris) longitudes in grads)."""

    is_geographic = True

    def __init__(self, pm=0.0, deg_factor=1.0, unit_name="degree"):
        self.pm = pm
        self.factor = deg_factor
        self.unit = unit_name

    def forward(self, lon, lat):
        lon = np.asarray(lon, dtype=float)
        lat = np.asarray(lat, dtype=float)
        return (lon - self.pm) / self.factor, lat / self.factor

    def inverse(self, x, y):
        x = np.asarray(x, dtype=float)
        y = np.asarray(y, dtype=float)
        return x * self.factor + self.pm, y * self.factor


def _capture_projection_args():
    """Record every projection's constructor arguments on the instance
    (``_ctor_args``): the WKT exporter re-serializes supported families
    structurally from them (``_make_wkt``)."""
    import inspect

    for obj in list(globals().values()):
        if not (
            inspect.isclass(obj)
            and obj.__module__ == __name__
            and hasattr(obj, "forward")
            and "__init__" in obj.__dict__
        ):
            continue
        original = obj.__init__
        signature = inspect.signature(original)

        def make_init(original=original, signature=signature):
            def __init__(self, *args, **kwargs):
                bound = signature.bind(self, *args, **kwargs)
                bound.apply_defaults()
                self._ctor_args = {
                    key: value
                    for key, value in bound.arguments.items()
                    if key not in ("self", "ell")
                }
                original(self, *args, **kwargs)

            return __init__

        obj.__init__ = make_init()


_capture_projection_args()


class SpatialReference:
    """A CRS: a datum plus a projection, identified by an EPSG code (or by
    its parameters, for CRSes parsed from WKT/proj4 without a known code)."""

    def __init__(self, code, name, datum, projection, wkt=None, key=None):
        self.code = code
        self.name = name
        self.datum = datum  # key into DATUMS
        self.projection = projection
        self._wkt = wkt
        self._key = key if key is not None else code

    @property
    def is_geographic(self):
        return self.projection.is_geographic

    @property
    def ellipsoid(self):
        return _ellipsoid(DATUMS[self.datum][0])

    @property
    def helmert_to_wgs84(self):
        return DATUMS[self.datum][1]

    # GDAL-ish introspection API kept for familiarity
    def IsGeographic(self):
        return self.is_geographic

    def GetAuthorityName(self, *_):
        return "EPSG" if self.code else None

    def GetAuthorityCode(self, *_):
        return str(self.code) if self.code else None

    def ExportToWkt(self):
        return self._wkt or _make_wkt(self)

    def __repr__(self):
        return "<SpatialReference EPSG:{} {}>".format(self.code, self.name)

    def __eq__(self, other):
        return isinstance(other, SpatialReference) and self._key == other._key

    def __hash__(self):
        return hash(self._key)


#: WKT1 serialization specs for the common projection families:
#: class name -> (PROJECTION name, [(ctor arg, WKT parameter name)]).
#: Parameter names are GDAL's canonical WKT1 spellings; the structural
#: parser here accepts the same set (see the method dispatch).
_WKT1_EXPORT = {
    "_TransverseMercator": ("Transverse_Mercator", [
        ("lat0", "latitude_of_origin"), ("lon0", "central_meridian"),
        ("k0", "scale_factor"), ("false_easting", "false_easting"),
        ("false_northing", "false_northing"),
    ]),
    "_ObliqueStereographic": ("Oblique_Stereographic", [
        ("lat0", "latitude_of_origin"), ("lon0", "central_meridian"),
        ("k0", "scale_factor"), ("false_easting", "false_easting"),
        ("false_northing", "false_northing"),
    ]),
    "_Mercator": ("Mercator_1SP", [
        ("lon0", "central_meridian"), ("k0", "scale_factor"),
        ("false_easting", "false_easting"),
        ("false_northing", "false_northing"),
    ]),
    "_LambertConformalConic": ("Lambert_Conformal_Conic_2SP", [
        ("lat1", "standard_parallel_1"), ("lat2", "standard_parallel_2"),
        ("lat0", "latitude_of_origin"), ("lon0", "central_meridian"),
        ("false_easting", "false_easting"),
        ("false_northing", "false_northing"),
    ]),
    "_LambertAzimuthalEqualArea": ("Lambert_Azimuthal_Equal_Area", [
        ("lat0", "latitude_of_center"), ("lon0", "longitude_of_center"),
        ("false_easting", "false_easting"),
        ("false_northing", "false_northing"),
    ]),
    "_AlbersEqualArea": ("Albers_Conic_Equal_Area", [
        ("sp1", "standard_parallel_1"), ("sp2", "standard_parallel_2"),
        ("lat0", "latitude_of_center"), ("lon0", "longitude_of_center"),
        ("false_easting", "false_easting"),
        ("false_northing", "false_northing"),
    ]),
    "_CassiniSoldner": ("Cassini_Soldner", [
        ("lat0", "latitude_of_origin"), ("lon0", "central_meridian"),
        ("false_easting", "false_easting"),
        ("false_northing", "false_northing"),
    ]),
    "_Sinusoidal": ("Sinusoidal", [
        ("lon0", "longitude_of_center"),
        ("false_easting", "false_easting"),
        ("false_northing", "false_northing"),
    ]),
    "_Mollweide": ("Mollweide", [
        ("lon0", "central_meridian"),
        ("false_easting", "false_easting"),
        ("false_northing", "false_northing"),
    ]),
    "_Robinson": ("Robinson", [
        ("lon0", "longitude_of_center"),
        ("false_easting", "false_easting"),
        ("false_northing", "false_northing"),
    ]),
    "_VanDerGrinten": ("VanDerGrinten", [
        ("lon0", "central_meridian"),
        ("false_easting", "false_easting"),
        ("false_northing", "false_northing"),
    ]),
    "_EckertIV": ("Eckert_IV", [
        ("lon0", "central_meridian"),
        ("false_easting", "false_easting"),
        ("false_northing", "false_northing"),
    ]),
    "_MillerCylindrical": ("Miller_Cylindrical", [
        ("lon0", "longitude_of_center"),
        ("false_easting", "false_easting"),
        ("false_northing", "false_northing"),
    ]),
    "_GallStereographic": ("Gall_Stereographic", [
        ("lon0", "central_meridian"),
        ("false_easting", "false_easting"),
        ("false_northing", "false_northing"),
    ]),
    "_EqualEarth": ("Equal_Earth", [
        ("lon0", "longitude_of_center"),
        ("false_easting", "false_easting"),
        ("false_northing", "false_northing"),
    ]),
    "_AmericanPolyconic": ("Polyconic", [
        ("lat0", "latitude_of_origin"), ("lon0", "central_meridian"),
        ("false_easting", "false_easting"),
        ("false_northing", "false_northing"),
    ]),
    "_Bonne": ("Bonne", [
        ("lat1", "standard_parallel_1"), ("lon0", "central_meridian"),
        ("false_easting", "false_easting"),
        ("false_northing", "false_northing"),
    ]),
    "_AzimuthalEquidistant": ("Azimuthal_Equidistant", [
        ("lat0", "latitude_of_center"), ("lon0", "longitude_of_center"),
        ("false_easting", "false_easting"),
        ("false_northing", "false_northing"),
    ]),
    "_Orthographic": ("Orthographic", [
        ("lat0", "latitude_of_origin"), ("lon0", "central_meridian"),
        ("false_easting", "false_easting"),
        ("false_northing", "false_northing"),
    ]),
    "_Gnomonic": ("Gnomonic", [
        ("lat0", "latitude_of_origin"), ("lon0", "central_meridian"),
        ("false_easting", "false_easting"),
        ("false_northing", "false_northing"),
    ]),
    "_CylindricalEqualArea": ("Cylindrical_Equal_Area", [
        ("lat_ts", "standard_parallel_1"), ("lon0", "central_meridian"),
        ("false_easting", "false_easting"),
        ("false_northing", "false_northing"),
    ]),
    # placeholder: serialized by the special case in
    # _wkt1_projection_nodes (variant A vs B depends on the ctor args)
    "_PolarStereographic": ("Polar_Stereographic", []),
    "_EquidistantCylindrical": ("Equirectangular", [
        ("lat1", "standard_parallel_1"), ("lat0", "latitude_of_origin"),
        ("lon0", "central_meridian"),
        ("false_easting", "false_easting"),
        ("false_northing", "false_northing"),
    ]),
}


def _wkt1_projection_nodes(projection):
    """PROJECTION/PARAMETER WKT1 text for supported families, or None."""
    spec = _WKT1_EXPORT.get(type(projection).__name__)
    ctor = getattr(projection, "_ctor_args", None)
    if spec is None or ctor is None:
        return None
    if type(projection).__name__ == "_PolarStereographic":
        sign = 1.0 if ctor.get("north", True) else -1.0
        if ctor.get("standard_parallel") is not None:
            spec = ("Polar_Stereographic", [])
            params = [
                ("latitude_of_origin", sign * float(ctor["standard_parallel"])),
                ("central_meridian", float(ctor["lon0"])),
                ("false_easting", float(ctor["false_easting"])),
                ("false_northing", float(ctor["false_northing"])),
            ]
        else:
            params = [
                ("latitude_of_origin", sign * 90.0),
                ("central_meridian", float(ctor["lon0"])),
                ("scale_factor", float(ctor.get("k0") or 1.0)),
                ("false_easting", float(ctor["false_easting"])),
                ("false_northing", float(ctor["false_northing"])),
            ]
        parts = ['PROJECTION["Polar_Stereographic"]'] + [
            'PARAMETER["%s",%.17g]' % (name, value)
            for name, value in params
        ]
        return ",".join(parts)
    if type(projection).__name__ == "_LambertConformalConic":
        if float(ctor.get("k0", 1.0)) != 1.0:
            # the registry builds 1SP cones as touching 2SP cones with a
            # scale factor; serialize those in the 1SP form
            if ctor["lat1"] != ctor["lat2"] or ctor["lat1"] != ctor["lat0"]:
                return None  # scaled secant cone: no WKT1 form
            spec = ("Lambert_Conformal_Conic_1SP", [
                ("lat0", "latitude_of_origin"), ("lon0", "central_meridian"),
                ("k0", "scale_factor"),
                ("false_easting", "false_easting"),
                ("false_northing", "false_northing"),
            ])
    method, param_map = spec
    missing = [arg for arg, _ in param_map if arg not in ctor]
    if missing:
        return None
    parts = ['PROJECTION["%s"]' % method]
    for arg, wkt_name in param_map:
        parts.append(
            'PARAMETER["%s",%.17g]' % (wkt_name, float(ctor[arg]))
        )
    return ",".join(parts)


def _make_wkt(sr):
    """Produce a WKT1 representation: structural (PROJECTION/PARAMETER/
    TOWGS84) for the common families, authority-carrying always."""
    helmert = DATUMS.get(sr.datum, (None, None))[1]
    towgs84 = (
        ",TOWGS84[%s]" % ",".join("%.10g" % v for v in helmert)
        if helmert
        else ""
    )
    geog = (
        'GEOGCS["{name}",DATUM["{datum}",SPHEROID["{datum}",{a},{invf}]'
        '{towgs84}],'
        'PRIMEM["Greenwich",0],UNIT["degree",0.0174532925199433]'.format(
            name=sr.name if sr.is_geographic else sr.datum,
            datum=sr.datum,
            a=sr.ellipsoid.a,
            invf=(1.0 / sr.ellipsoid.f) if sr.ellipsoid.f else 0,
            towgs84=towgs84,
        )
    )
    auth = ',AUTHORITY["EPSG","{}"]'.format(sr.code) if sr.code else ""
    if sr.is_geographic:
        return geog + auth + "]"
    nodes = _wkt1_projection_nodes(sr.projection)
    projection_part = ",%s" % nodes if nodes else ""
    return 'PROJCS["{name}",{geog}]{proj},UNIT["metre",1]{auth}]'.format(
        name=sr.name, geog=geog, proj=projection_part, auth=auth
    )


# --- EPSG registry ---


def _utm(zone, north):
    lon0 = -183.0 + 6.0 * zone
    return _TransverseMercator(
        _ellipsoid("WGS84"), lon0, 0.0, 0.9996, 500000.0, 0.0 if north else 10000000.0
    )


@lru_cache(maxsize=None)
def _registry_get(code):
    if code == 4326:
        return SpatialReference(4326, "WGS 84", "WGS84", _GeographicProjection())
    if code == 4258:
        return SpatialReference(4258, "ETRS89", "ETRS89", _GeographicProjection())
    if code == 4289:
        return SpatialReference(
            4289, "Amersfoort", "Amersfoort", _GeographicProjection()
        )
    if code == 4277:
        return SpatialReference(4277, "OSGB36", "OSGB36", _GeographicProjection())
    if code == 4269:
        return SpatialReference(4269, "NAD83", "ETRS89", _GeographicProjection())
    if code == 4272:
        return SpatialReference(4272, "NZGD49", "NZGD49", _GeographicProjection())
    if code == 3395:
        return SpatialReference(
            3395, "WGS 84 / World Mercator", "WGS84", _Mercator(_ellipsoid("WGS84"))
        )
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
    if code == 27700:
        return SpatialReference(
            27700,
            "OSGB36 / British National Grid",
            "OSGB36",
            _TransverseMercator(
                _ellipsoid("airy"), -2.0, 49.0, 0.9996012717, 400000.0, -100000.0
            ),
        )
    if 32601 <= code <= 32660:
        return SpatialReference(
            code, "WGS 84 / UTM zone %dN" % (code - 32600), "WGS84",
            _utm(code - 32600, True),
        )
    if 32701 <= code <= 32760:
        return SpatialReference(
            code, "WGS 84 / UTM zone %dS" % (code - 32700), "WGS84",
            _utm(code - 32700, False),
        )
    if 25828 <= code <= 25838:
        zone = code - 25800
        return SpatialReference(
            code,
            "ETRS89 / UTM zone %dN" % zone,
            "ETRS89",
            _TransverseMercator(
                _ellipsoid("GRS80"), -183.0 + 6.0 * zone, 0.0, 0.9996, 500000.0, 0.0
            ),
        )
    if code == 2154:
        return SpatialReference(
            2154,
            "RGF93 v1 / Lambert-93",
            "ETRS89",  # RGF93 is ETRS89-aligned at this accuracy level
            _LambertConformalConic(
                _ellipsoid("GRS80"), 3.0, 46.5, 49.0, 44.0, 700000.0, 6600000.0
            ),
        )
    if code == 5070:
        return SpatialReference(
            5070,
            "NAD83 / Conus Albers",
            "ETRS89",  # NAD83 treated as WGS84-coincident
            _AlbersEqualArea(
                _ellipsoid("GRS80"), -96.0, 23.0, 29.5, 45.5, 0.0, 0.0
            ),
        )
    if code == 3413:
        return SpatialReference(
            3413,
            "WGS 84 / NSIDC Sea Ice Polar Stereographic North",
            "WGS84",
            _PolarStereographic(
                _ellipsoid("WGS84"), -45.0, standard_parallel=70.0, north=True
            ),
        )
    if code == 3031:
        return SpatialReference(
            3031,
            "WGS 84 / Antarctic Polar Stereographic",
            "WGS84",
            _PolarStereographic(
                _ellipsoid("WGS84"), 0.0, standard_parallel=71.0, north=False
            ),
        )
    if code == 27200:
        return SpatialReference(
            27200,
            "NZGD49 / New Zealand Map Grid",
            "NZGD49",
            _NewZealandMapGrid(_ellipsoid("intl")),
        )
    if code == 3035:
        return SpatialReference(
            3035,
            "ETRS89-extended / LAEA Europe",
            "ETRS89",
            _LambertAzimuthalEqualArea(
                _ellipsoid("GRS80"), 10.0, 52.0, 4321000.0, 3210000.0
            ),
        )
    if code == 4267:
        return SpatialReference(4267, "NAD27", "NAD27", _GeographicProjection())
    if code == 4230:
        return SpatialReference(4230, "ED50", "ED50", _GeographicProjection())
    if code == 4284:
        return SpatialReference(
            4284, "Pulkovo 1942", "Pulkovo42", _GeographicProjection()
        )
    if code == 4167:
        return SpatialReference(
            4167, "NZGD2000", "WGS84", _GeographicProjection()
        )
    if code == 2193:
        return SpatialReference(
            2193,
            "NZGD2000 / New Zealand Transverse Mercator 2000",
            "WGS84",  # NZGD2000 is WGS84-coincident at this accuracy
            _TransverseMercator(
                _ellipsoid("GRS80"), 173.0, 0.0, 0.9996, 1600000.0, 10000000.0
            ),
        )
    if code == 31370:
        return SpatialReference(
            31370,
            "BD72 / Belgian Lambert 72",
            "BD72",
            _LambertConformalConic(
                _ellipsoid("intl"),
                4.367486666666666,
                90.0,
                51.16666723333333,
                49.8333339,
                150000.013,
                5400088.438,
            ),
        )
    if code in (21781, 2056):
        lv95 = code == 2056
        return SpatialReference(
            code,
            "CH1903+ / LV95" if lv95 else "CH1903 / LV03",
            "CH1903",
            _HotineObliqueMercator(
                _ellipsoid("bessel"),
                7.439583333333333,
                46.952405555555565,
                90.0,
                90.0,
                1.0,
                2600000.0 if lv95 else 600000.0,
                1200000.0 if lv95 else 200000.0,
                variant="B",
            ),
        )
    if code == 3112:
        return SpatialReference(
            3112,
            "GDA94 / Geoscience Australia Lambert",
            "WGS84",  # GDA94 treated as WGS84-coincident
            _LambertConformalConic(
                _ellipsoid("GRS80"), 134.0, 0.0, -18.0, -36.0, 0.0, 0.0
            ),
        )
    if code == 3577:
        return SpatialReference(
            3577,
            "GDA94 / Australian Albers",
            "WGS84",
            _AlbersEqualArea(
                _ellipsoid("GRS80"), 132.0, 0.0, -18.0, -36.0, 0.0, 0.0
            ),
        )
    if 28348 <= code <= 28358:
        zone = code - 28300
        return SpatialReference(
            code,
            "GDA94 / MGA zone %d" % zone,
            "WGS84",
            _TransverseMercator(
                _ellipsoid("GRS80"),
                -183.0 + 6.0 * zone,
                0.0,
                0.9996,
                500000.0,
                10000000.0,
            ),
        )
    if 26901 <= code <= 26923:
        zone = code - 26900
        return SpatialReference(
            code,
            "NAD83 / UTM zone %dN" % zone,
            "ETRS89",  # NAD83 treated as WGS84-coincident
            _TransverseMercator(
                _ellipsoid("GRS80"), -183.0 + 6.0 * zone, 0.0, 0.9996,
                500000.0, 0.0,
            ),
        )
    if 23028 <= code <= 23038:
        zone = code - 23000
        return SpatialReference(
            code,
            "ED50 / UTM zone %dN" % zone,
            "ED50",
            _TransverseMercator(
                _ellipsoid("intl"), -183.0 + 6.0 * zone, 0.0, 0.9996,
                500000.0, 0.0,
            ),
        )
    if code in (32661, 32761):
        north = code == 32661
        return SpatialReference(
            code,
            "WGS 84 / UPS %s" % ("North" if north else "South"),
            "WGS84",
            _PolarStereographic(
                _ellipsoid("WGS84"), 0.0, k0=0.994, false_easting=2000000.0,
                false_northing=2000000.0, north=north,
            ),
        )
    if code == 5514:
        return SpatialReference(
            5514,
            "S-JTSK / Krovak East North",
            "S-JTSK",
            _Krovak(
                _ellipsoid("bessel"),
                24.833333333333332,
                49.5,
                30.28813975277778,
                78.5,
                0.9999,
                0.0,
                0.0,
            ),
        )
    if code == 6933:
        return SpatialReference(
            6933,
            "WGS 84 / NSIDC EASE-Grid 2.0 Global",
            "WGS84",
            _CylindricalEqualArea(_ellipsoid("WGS84"), 0.0, 30.0),
        )
    if code == 8857:
        return SpatialReference(
            8857,
            "WGS 84 / Equal Earth Greenwich",
            "WGS84",
            _EqualEarth(_ellipsoid("WGS84"), 0.0),
        )
    if code == 2163:
        return SpatialReference(
            2163,
            "US National Atlas Equal Area",
            "WGS84",  # the sphere is its own "datum"; treated as WGS84
            _LambertAzimuthalEqualArea(
                _Ellipsoid(6370997.0, float("inf")), -100.0, 45.0, 0.0, 0.0
            ),
        )
    if code == 3067:
        return SpatialReference(
            3067,
            "ETRS89 / TM35FIN(E,N)",
            "ETRS89",
            _TransverseMercator(
                _ellipsoid("GRS80"), 27.0, 0.0, 0.9996, 500000.0, 0.0
            ),
        )
    if code == 2180:
        return SpatialReference(
            2180,
            "ETRS89 / Poland CS92",
            "ETRS89",
            _TransverseMercator(
                _ellipsoid("GRS80"), 19.0, 0.0, 0.9993, 500000.0, -5300000.0
            ),
        )
    if code == 23700:
        return SpatialReference(
            23700,
            "HD72 / EOV",
            "HD72",
            _HotineObliqueMercator(
                _ellipsoid("GRS67"),
                19.04857177777778,
                47.14439372222222,
                90.0,
                90.0,
                0.99993,
                650000.0,
                200000.0,
                variant="B",
            ),
        )
    if 31466 <= code <= 31469:
        zone = code - 31464  # 31466 = 3-degree Gauss-Krueger zone 2
        return SpatialReference(
            code,
            "DHDN / 3-degree Gauss-Kruger zone %d" % zone,
            "DHDN",
            _TransverseMercator(
                _ellipsoid("bessel"),
                3.0 * zone,
                0.0,
                1.0,
                zone * 1000000.0 + 500000.0,
                0.0,
            ),
        )
    if code == 4283:
        # GDA94 is WGS84-coincident at this accuracy level
        return SpatialReference(4283, "GDA94", "ETRS89", _GeographicProjection())
    if code == 4312:
        return SpatialReference(4312, "MGI", "MGI", _GeographicProjection())
    if code == 31287:
        return SpatialReference(
            31287,
            "MGI / Austria Lambert",
            "MGI",
            _LambertConformalConic(
                _ellipsoid("bessel"),
                13.0 + 20.0 / 60.0,
                47.5,
                49.0,
                46.0,
                400000.0,
                400000.0,
            ),
        )
    if code == 4121:
        return SpatialReference(4121, "GGRS87", "GGRS87", _GeographicProjection())
    if code == 2100:
        return SpatialReference(
            2100,
            "GGRS87 / Greek Grid",
            "GGRS87",
            _TransverseMercator(
                _ellipsoid("GRS80"), 24.0, 0.0, 0.9996, 500000.0, 0.0
            ),
        )
    if code == 3347:
        return SpatialReference(
            3347,
            "NAD83 / Statistics Canada Lambert",
            "ETRS89",  # NAD83 treated as WGS84-coincident
            _LambertConformalConic(
                _ellipsoid("GRS80"),
                -(91.0 + 52.0 / 60.0),
                63.390675,
                49.0,
                77.0,
                6200000.0,
                3000000.0,
            ),
        )
    if code == 3978:
        return SpatialReference(
            3978,
            "NAD83 / Canada Atlas Lambert",
            "ETRS89",
            _LambertConformalConic(
                _ellipsoid("GRS80"), -95.0, 49.0, 49.0, 77.0, 0.0, 0.0
            ),
        )
    if code == 2263:
        # the representative US state plane ftUS definition
        return SpatialReference(
            2263,
            "NAD83 / New York Long Island (ftUS)",
            "ETRS89",
            _ScaledUnitProjection(
                _LambertConformalConic(
                    _ellipsoid("GRS80"),
                    -74.0,
                    40.0 + 10.0 / 60.0,
                    41.0 + 2.0 / 60.0,
                    40.0 + 40.0 / 60.0,
                    300000.0,
                    0.0,
                ),
                1200.0 / 3937.0,
                "US survey foot",
            ),
        )
    if code in (102100, 102113):
        # ArcGIS WKIDs for Web Mercator, widely written with an EPSG
        # authority tag in the wild
        return _registry_get(3857)
    if code // 1000 in (53, 54):
        # ESRI world-series codes are often cited as EPSG:54xxx
        return _esri_registry_get(code)
    if code in _GEOGRAPHIC:
        name, datum = _GEOGRAPHIC[code]
        return SpatialReference(code, name, datum, _GeographicProjection())
    if 26703 <= code <= 26722:
        zone = code - 26700
        return SpatialReference(
            code, "NAD27 / UTM zone %dN" % zone, "NAD27",
            _TransverseMercator(
                _ellipsoid("clrk66"), -183.0 + 6.0 * zone, 0.0, 0.9996,
                500000.0, 0.0,
            ),
        )
    if 32201 <= code <= 32260 or 32301 <= code <= 32360:
        north = code <= 32260
        zone = code - (32200 if north else 32300)
        return SpatialReference(
            code,
            "WGS 72 / UTM zone %d%s" % (zone, "N" if north else "S"),
            "WGS72",
            _TransverseMercator(
                _ellipsoid("WGS72"), -183.0 + 6.0 * zone, 0.0, 0.9996,
                500000.0, 0.0 if north else 10000000.0,
            ),
        )
    if 28402 <= code <= 28432:
        zone = code - 28400
        return SpatialReference(
            code, "Pulkovo 1942 / Gauss-Kruger zone %d" % zone, "Pulkovo42",
            _TransverseMercator(
                _ellipsoid("krass"), -3.0 + 6.0 * zone, 0.0, 1.0,
                zone * 1000000.0 + 500000.0, 0.0,
            ),
        )
    if 28462 <= code <= 28492:
        zone = code - 28460
        return SpatialReference(
            code,
            "Pulkovo 1942 / Gauss-Kruger CM %dE" % (6 * zone - 3),
            "Pulkovo42",
            _TransverseMercator(
                _ellipsoid("krass"), -3.0 + 6.0 * zone, 0.0, 1.0,
                500000.0, 0.0,
            ),
        )
    if 7846 <= code <= 7859:
        zone = code - 7800
        return SpatialReference(
            code,
            "GDA2020 / MGA zone %d" % zone,
            "WGS84",  # GDA2020 treated as WGS84-coincident
            _TransverseMercator(
                _ellipsoid("GRS80"), -183.0 + 6.0 * zone, 0.0, 0.9996,
                500000.0, 10000000.0,
            ),
        )
    if 31965 <= code <= 31985:
        north = code <= 31976
        zone = code - (31954 if north else 31960)
        return SpatialReference(
            code,
            "SIRGAS 2000 / UTM zone %d%s" % (zone, "N" if north else "S"),
            "WGS84",  # SIRGAS 2000 treated as WGS84-coincident
            _TransverseMercator(
                _ellipsoid("GRS80"), -183.0 + 6.0 * zone, 0.0, 0.9996,
                500000.0, 0.0 if north else 10000000.0,
            ),
        )
    if 3097 <= code <= 3101 or 6688 <= code <= 6692:
        jgd2000 = code <= 3101
        zone = code - (3046 if jgd2000 else 6637)
        return SpatialReference(
            code,
            "%s / UTM zone %dN" % ("JGD2000" if jgd2000 else "JGD2011", zone),
            "WGS84",  # both JGD realizations are WGS84-coincident here
            _TransverseMercator(
                _ellipsoid("GRS80"), -183.0 + 6.0 * zone, 0.0, 0.9996,
                500000.0, 0.0,
            ),
        )
    if code in _TM_REGISTRY:
        name, datum, ell, lon0, lat0, k0, fe, fn = _TM_REGISTRY[code]
        return SpatialReference(
            code, name, datum,
            _TransverseMercator(_ellipsoid(ell), lon0, lat0, k0, fe, fn),
        )
    if code in _LCC_REGISTRY:
        name, datum, ell, lon0, lat0, sp1, sp2, fe, fn, k0 = _LCC_REGISTRY[
            code
        ]
        return SpatialReference(
            code, name, datum,
            _LambertConformalConic(
                _ellipsoid(ell), lon0, lat0, sp1, sp2, fe, fn, k0=k0
            ),
        )
    if code in (29101, 5880):
        sad69 = code == 29101
        return SpatialReference(
            code,
            "SAD69 / Brazil Polyconic" if sad69 else
            "SIRGAS 2000 / Brazil Polyconic",
            "SAD69" if sad69 else "WGS84",
            _AmericanPolyconic(
                _ellipsoid("aust_SA" if sad69 else "GRS80"), -54.0, 0.0,
                5000000.0, 10000000.0,
            ),
        )
    # the hand registry misses: fall back to the generated EPSG parameter
    # table (geo/epsg.json.gz, full projected+geographic EPSG coverage)
    from . import _epsg_registry

    sr = _epsg_registry.resolve(code)
    if sr is not None:
        return sr
    raise TransformException(
        "Unsupported EPSG code: %d (not in the EPSG registry table; pass "
        "the CRS as WKT instead)" % code
    )


#: geographic (2-D lat/lon) CRSes: code -> (name, DATUMS key)
_GEOGRAPHIC = {
    4322: ("WGS 72", "WGS72"),
    4618: ("SAD69", "SAD69"),
    4674: ("SIRGAS 2000", "WGS84"),
    4612: ("JGD2000", "WGS84"),
    6668: ("JGD2011", "WGS84"),
    7844: ("GDA2020", "WGS84"),
    4619: ("SWEREF99", "ETRS89"),
    4299: ("TM65", "TM65"),
    4300: ("TM75", "TM65"),
    4173: ("IRENET95", "ETRS89"),
    4171: ("RGF93 v1", "ETRS89"),
    4275: ("NTF", "NTF"),
    4181: ("Luxembourg 1930", "LUREF"),
    4314: ("DHDN", "DHDN"),
}

#: the Paris-meridian NTF Lambert longitude of origin, in Greenwich degrees
_PARIS_LON = 2.0 + 20.0 / 60.0 + 14.025 / 3600.0

#: transverse-Mercator singletons:
#: code -> (name, datum, ellipsoid, lon0, lat0, k0, fe, fn)
_TM_REGISTRY = {
    2157: (
        "IRENET95 / Irish Transverse Mercator", "ETRS89", "GRS80",
        -8.0, 53.5, 0.99982, 600000.0, 750000.0,
    ),
    29902: (
        "TM65 / Irish Grid", "TM65", "mod_airy",
        -8.0, 53.5, 1.000035, 200000.0, 250000.0,
    ),
    29903: (
        "TM75 / Irish Grid", "TM65", "mod_airy",
        -8.0, 53.5, 1.000035, 200000.0, 250000.0,
    ),
    2169: (
        "Luxembourg 1930 / Gauss", "LUREF", "intl",
        6.166666666666667, 49.833333333333336, 1.0, 80000.0, 100000.0,
    ),
    3006: (
        "SWEREF99 TM", "ETRS89", "GRS80",
        15.0, 0.0, 0.9996, 500000.0, 0.0,
    ),
    3763: (
        "ETRS89 / Portugal TM06", "ETRS89", "GRS80",
        -8.133108333333334, 39.66825833333333, 1.0, 0.0, 0.0,
    ),
    31254: (
        "MGI / Austria GK West", "MGI", "bessel",
        10.333333333333334, 0.0, 1.0, 0.0, -5000000.0,
    ),
    31255: (
        "MGI / Austria GK Central", "MGI", "bessel",
        13.333333333333334, 0.0, 1.0, 0.0, -5000000.0,
    ),
    31256: (
        "MGI / Austria GK East", "MGI", "bessel",
        16.333333333333332, 0.0, 1.0, 0.0, -5000000.0,
    ),
    31257: (
        "MGI / Austria GK M28", "MGI", "bessel",
        10.333333333333334, 0.0, 1.0, 150000.0, -5000000.0,
    ),
    31258: (
        "MGI / Austria GK M31", "MGI", "bessel",
        13.333333333333334, 0.0, 1.0, 450000.0, -5000000.0,
    ),
    31259: (
        "MGI / Austria GK M34", "MGI", "bessel",
        16.333333333333332, 0.0, 1.0, 750000.0, -5000000.0,
    ),
}

#: Lambert-conformal-conic singletons:
#: code -> (name, datum, ellipsoid, lon0, lat0, sp1, sp2, fe, fn, k0).
#: sp1 == sp2 == lat0 selects the 1SP form with its k0 (NTF Lambert zones).
_LCC_REGISTRY = {
    3301: (
        "ETRS89 / Estonian Coordinate System of 1997", "ETRS89", "GRS80",
        24.0, 57.517553930555555, 59.33333333333334, 58.0,
        500000.0, 6375000.0, 1.0,
    ),
    32139: (
        "NAD83 / Texas Central", "ETRS89", "GRS80",
        -100.33333333333333, 29.66666666666667,
        31.883333333333333, 30.116666666666667,
        700000.0, 3000000.0, 1.0,
    ),
}

# NAD83 / California Albers-free state plane zones 1-6 (EPSG 26941-26946):
# (lon0, lat0, sp1, sp2); FE 2,000,000 / FN 500,000 for every zone
_CALIFORNIA_ZONES = (
    (-122.0, 39.33333333333334, 41.66666666666666, 40.0),
    (-122.0, 37.66666666666666, 39.83333333333334, 38.33333333333334),
    (-120.5, 36.5, 38.43333333333333, 37.06666666666667),
    (-119.0, 35.33333333333334, 37.25, 36.0),
    (-118.0, 33.5, 35.46666666666667, 34.03333333333333),
    (-116.25, 32.16666666666666, 33.88333333333333, 32.78333333333333),
)
for _i, (_lon0, _lat0, _sp1, _sp2) in enumerate(_CALIFORNIA_ZONES):
    _LCC_REGISTRY[26941 + _i] = (
        "NAD83 / California zone %d" % (_i + 1), "ETRS89", "GRS80",
        _lon0, _lat0, _sp1, _sp2, 2000000.0, 500000.0, 1.0,
    )

# NTF (Paris) Lambert zones I-IV (EPSG 27561-27564 "Nord/Centre/Sud/Corse"
# and the carto variants 27571-27574 whose northing carries the zone
# number): 1SP definitions at the Paris meridian, expressed in Greenwich
# longitudes
_NTF_LAMBERT = (
    ("I", 49.5, 0.999877340, 600000.0, 200000.0),
    ("II", 46.8, 0.99987742, 600000.0, 200000.0),
    ("III", 44.1, 0.999877499, 600000.0, 200000.0),
    # zone IV (Corse) has its own false origin, not the mainland 600 km
    ("IV", 42.165, 0.99994471, 234.358, 185861.369),
)
for _i, (_num, _lat0, _k0, _fe, _fn) in enumerate(_NTF_LAMBERT):
    _LCC_REGISTRY[27561 + _i] = (
        "NTF (Paris) / Lambert %s"
        % ("Nord", "Centre", "Sud", "Corse")[_i],
        "NTF", "clrk80ign", _PARIS_LON, _lat0, _lat0, _lat0,
        _fe, _fn, _k0,
    )
    _LCC_REGISTRY[27571 + _i] = (
        "NTF (Paris) / Lambert zone %s" % _num,
        "NTF", "clrk80ign", _PARIS_LON, _lat0, _lat0, _lat0,
        _fe, _fn + (_i + 1) * 1000000.0, _k0,
    )


#: the commonly-encountered ESRI :54xxx "World" series (WGS84 ellipsoid)
#: and :53xxx sphere series; method + ellipsoid name per code suffix
_ESRI_WORLD = {
    3: ("miller_cylindrical", {}),
    8: ("sinusoidal", {}),
    9: ("mollweide", {}),
    12: ("eckert_iv", {}),
    16: ("gall_stereographic", {}),
    # 54017 World Behrmann: cylindrical equal area, standard parallel 30
    17: ("cylindrical_equal_area", {"standard_parallel_1": 30.0}),
    21: ("polyconic", {}),
    24: ("bonne", {"standard_parallel_1": 60.0}),
    29: ("van_der_grinten", {}),
    30: ("robinson", {}),
    32: ("azimuthal_equidistant", {}),
    34: ("cylindrical_equal_area", {}),
}


@lru_cache(maxsize=None)
def _esri_registry_get(code):
    if code in (102100, 102113):  # ArcGIS Web Mercator WKIDs
        return _registry_get(3857)
    series = code // 1000
    suffix = code % 1000
    if series in (53, 54) and suffix in _ESRI_WORLD:
        method, extra = _ESRI_WORLD[suffix]
        ell = _ellipsoid("WGS84" if series == 54 else "authalic")
        datum = "WGS84"
        projection = _build_projection(method, ell, dict(extra))
        return SpatialReference(
            None,
            "ESRI:%d" % code,
            datum,
            projection,
            key=("esri", code),
        )
    raise TransformException("Unsupported ESRI code: %d" % code)


_EPSG_RE = re.compile(r"^(?:EPSG|epsg):(\d+)$")
_ESRI_RE = re.compile(r"^(?:ESRI|esri):(\d+)$")
_OGC_URN_RE = re.compile(
    r"^urn:ogc:def:crs:EPSG:[\d.]*:(\d+)$", re.IGNORECASE
)
_OGC_URL_RE = re.compile(
    r"^https?://www\.opengis\.net/def/crs/EPSG/[\d.]+/(\d+)$",
    re.IGNORECASE,
)
_GML2_SRS_RE = re.compile(
    r"^https?://www\.opengis\.net/gml/srs/epsg\.xml#(\d+)$",
    re.IGNORECASE,
)
_CRS84_RE = re.compile(
    r"^(urn:ogc:def:crs:OGC:[\d.]*:|OGC:)?CRS:?84$", re.IGNORECASE
)
_EPSG_COMPOUND_RE = re.compile(r"^(?:EPSG|epsg):(\d+)\+\d+$")
_PROJ4_INIT_RE = re.compile(
    r"^\+init=epsg:(\d+)(?:\s+\+(?:no_defs|wktext|type=crs))*\s*$",
    re.IGNORECASE,
)
_WKT_AUTH_RE = re.compile(r'AUTHORITY\[\"EPSG\",\s*\"?(\d+)\"?\]\s*\]\s*$')
_WKT_ID_RE = re.compile(r'ID\[\"EPSG\",\s*(\d+)\]\s*\]\s*$')


# --- parametric CRS parsing (WKT1 / proj4) for CRSes outside the registry ---


_WKT_TOKEN_RE = re.compile(
    r'"([^"]*)"|([A-Za-z_][A-Za-z0-9_]*)|([-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?)'
    r"|([\[\]\(\),])"
)


def _parse_wkt(text):
    """Parse a WKT1 string into a ('NAME', [args]) tree; args are strings,
    floats, or nested nodes."""
    tokens = []
    for m in _WKT_TOKEN_RE.finditer(text):
        if m.group(1) is not None:
            tokens.append(("str", m.group(1)))
        elif m.group(2) is not None:
            tokens.append(("word", m.group(2)))
        elif m.group(3) is not None:
            tokens.append(("num", float(m.group(3))))
        else:
            tokens.append(("punct", m.group(4)))
    pos = [0]

    def node():
        kind, word = tokens[pos[0]]
        if kind != "word":
            raise TransformException("Malformed WKT near token %r" % (word,))
        pos[0] += 1
        args = []
        if pos[0] < len(tokens) and tokens[pos[0]][1] in "[(":
            pos[0] += 1
            while pos[0] < len(tokens):
                kind, val = tokens[pos[0]]
                if kind == "punct":
                    pos[0] += 1
                    if val in "])":
                        break
                    continue  # comma
                if kind == "word":
                    args.append(node())
                else:
                    args.append(val)
                    pos[0] += 1
        return (word.upper(), args)

    return node()


def _wkt_find(node, *names):
    for arg in node[1]:
        if isinstance(arg, tuple) and arg[0] in names:
            return arg
    return None


def _intern_datum(name, a, inv_f, helmert):
    """Return a DATUMS key for (ellipsoid, helmert), matching known datums
    (so WKT-parsed CRSes compare equal-datum with registry ones) or
    registering a synthetic entry."""
    if helmert is not None:
        helmert = tuple(float(v) for v in helmert)
        if len(helmert) == 3:
            helmert = helmert + (0.0, 0.0, 0.0, 0.0)
        if not any(helmert):
            helmert = None
    for key, (ell_name, known_helmert) in DATUMS.items():
        ka, kinvf = ELLIPSOIDS[ell_name]
        if abs(ka - a) < 1e-3 and (
            (np.isinf(kinvf) and not inv_f) or abs(kinvf - inv_f) < 1e-6
        ):
            if helmert is None and known_helmert is None:
                return key
            if helmert is not None and known_helmert is not None and all(
                abs(x - y) < 1e-9 for x, y in zip(helmert, known_helmert)
            ):
                return key
    ell_key = "custom:%.3f:%.9f" % (a, inv_f)
    ELLIPSOIDS.setdefault(ell_key, (a, inv_f if inv_f else float("inf")))
    key = "%s|%s|%s" % (name, ell_key, helmert)
    DATUMS.setdefault(key, (ell_key, helmert))
    return key


def _build_projection(method, ell, p):
    """Build a projection object from an EPSG/OGC method name and a
    {parameter_name: value} dict (WKT1 and proj4 share these)."""
    cm = p.get("central_meridian", p.get("longitude_of_center", 0.0))
    lat0 = p.get("latitude_of_origin", p.get("latitude_of_center", 0.0))
    k0 = p.get("scale_factor", 1.0)
    fe = p.get("false_easting", 0.0)
    fn = p.get("false_northing", 0.0)
    # normalize both WKT1 identifiers and WKT2 human-readable names
    method = method.lower().replace(" ", "_").replace("-", "_")
    method = {
        "lambert_conic_conformal_(2sp)": "lambert_conformal_conic_2sp",
        "lambert_conic_conformal_2sp": "lambert_conformal_conic_2sp",
        "lambert_conic_conformal_(1sp)": "lambert_conformal_conic_1sp",
        "lambert_conic_conformal_1sp": "lambert_conformal_conic_1sp",
        "albers_equal_area": "albers_conic_equal_area",
        "mercator_variant_a": "mercator_1sp",
        "mercator_variant_b": "mercator_2sp",
        "mercator_(variant_a)": "mercator_1sp",
        "mercator_(variant_b)": "mercator_2sp",
        "polar_stereographic_(variant_a)": "polar_stereographic",
        "polar_stereographic_variant_a": "polar_stereographic",
        "polar_stereographic_(variant_b)": "polar_stereographic_variant_b",
        "hotine_oblique_mercator_(variant_a)": "hotine_oblique_mercator_variant_a",
        "hotine_oblique_mercator_(variant_b)": "hotine_oblique_mercator_variant_b",
    }.get(method, method)
    if method in ("transverse_mercator", "gauss_kruger"):
        return _TransverseMercator(ell, cm, lat0, k0, fe, fn)
    if method in ("oblique_stereographic", "double_stereographic"):
        return _ObliqueStereographic(
            ell, lon0=cm, lat0=lat0, k0=k0, false_easting=fe, false_northing=fn
        )
    if method == "lambert_conformal_conic_1sp":
        # EPSG 9801: the cone touches at the latitude of origin with k0
        return _LambertConformalConic(ell, cm, lat0, lat0, lat0, fe, fn, k0=k0)
    if method in ("lambert_conformal_conic_2sp", "lambert_conformal_conic"):
        sp1 = p.get("standard_parallel_1", lat0)
        sp2 = p.get("standard_parallel_2", sp1)
        return _LambertConformalConic(ell, cm, lat0, sp1, sp2, fe, fn)
    if method == "lambert_azimuthal_equal_area":
        return _LambertAzimuthalEqualArea(ell, cm, lat0, fe, fn)
    if method == "albers_conic_equal_area":
        sp1 = p.get("standard_parallel_1", lat0)
        sp2 = p.get("standard_parallel_2", sp1)
        return _AlbersEqualArea(ell, cm, lat0, sp1, sp2, fe, fn)
    if method in ("polar_stereographic", "polar_stereographic_variant_b"):
        # GDAL WKT1: latitude_of_origin is the standard parallel unless it
        # is exactly +/-90, in which case scale_factor applies (variant A)
        north = lat0 >= 0
        if abs(abs(lat0) - 90.0) < 1e-9:
            return _PolarStereographic(
                ell, cm, k0=k0, false_easting=fe, false_northing=fn,
                north=north,
            )
        return _PolarStereographic(
            ell, cm, standard_parallel=abs(lat0), false_easting=fe,
            false_northing=fn, north=north,
        )
    if method in ("mercator_1sp", "mercator_2sp"):
        if method == "mercator_2sp":
            # EPSG 9805: the standard parallel fixes the scale (the
            # spherical case degenerates to k0 = cos(sp1))
            sp1 = np.radians(p.get("standard_parallel_1", 0.0))
            k0 = np.cos(sp1) / np.sqrt(1 - ell.e2 * np.sin(sp1) ** 2)
        if ell.e == 0 and (
            abs(ell.a - 6378137.0) < 1e-6
            and k0 == 1.0 and cm == 0.0 and fe == 0.0 and fn == 0.0
        ):
            return _WebMercator()  # the canonical web-mercator grid
        return _Mercator(ell, lon0=cm, k0=k0, false_easting=fe, false_northing=fn)
    if method in (
        "mercator_auxiliary_sphere",
        "popular_visualisation_pseudo_mercator",
        "pseudo_mercator",
    ):
        return _WebMercator()
    if method in (
        "equirectangular",
        "equidistant_cylindrical",
        "equidistant_cylindrical_spherical",
        "plate_carree",
    ):
        # EPSG 1028/9823: standard parallel from either parameter name
        lat1 = p.get("standard_parallel_1", p.get("latitude_of_origin", 0.0))
        lat_origin = p.get("latitude_of_origin", 0.0) if "standard_parallel_1" in p else 0.0
        return _EquidistantCylindrical(ell, cm, lat1, lat_origin, fe, fn)
    if method == "cassini_soldner":
        return _CassiniSoldner(ell, cm, lat0, fe, fn)
    if method in (
        "hotine_oblique_mercator",
        "hotine_oblique_mercator_variant_a",
        "hotine_oblique_mercator_azimuth_natural_origin",
        "oblique_mercator",
        "hotine_oblique_mercator_azimuth_center",
        "hotine_oblique_mercator_variant_b",
    ):
        azimuth = p.get("azimuth", 90.0)
        gamma = p.get("rectified_grid_angle", azimuth)
        variant = (
            "A"
            if method
            in (
                "hotine_oblique_mercator",
                "hotine_oblique_mercator_variant_a",
                "hotine_oblique_mercator_azimuth_natural_origin",
            )
            else "B"
        )
        return _HotineObliqueMercator(
            ell, cm, lat0, azimuth, gamma, k0, fe, fn, variant=variant
        )
    if method in ("krovak", "krovak_east_north", "krovak_modified",
                  "krovak_modified_north"):
        cls = _KrovakModified if method.startswith("krovak_modified") else _Krovak
        return cls(
            ell,
            cm,
            lat0,
            p.get("azimuth", 30.28813975277778),
            p.get("pseudo_standard_parallel_1", 78.5),
            k0,
            fe,
            fn,
        )
    if method == "colombia_urban":
        return _ColombiaUrban(
            ell, cm, lat0,
            p.get("projection_plane_origin_height", 0.0), fe, fn,
        )
    if method == "lambert_conformal_conic_2sp_michigan":
        sp1 = p.get("standard_parallel_1", lat0)
        sp2 = p.get("standard_parallel_2", sp1)
        return _LambertConformalConic(
            ell, cm, lat0, sp1, sp2, fe, fn,
            ell_k=p.get("ellipsoid_scaling_factor", 1.0),
        )
    if method == "lambert_conformal_conic_2sp_belgium":
        # EPSG 9803 adds a fixed 29.2985" cone-angle subtraction on paper,
        # but PROJ (the reference's engine) maps the method to plain LCC
        # 2SP - cs2cs EPSG:31300 confirms; parity follows PROJ
        sp1 = p.get("standard_parallel_1", lat0)
        sp2 = p.get("standard_parallel_2", sp1)
        return _LambertConformalConic(ell, cm, lat0, sp1, sp2, fe, fn)
    if method == "polar_stereographic_variant_c":
        lat_ts = p.get("standard_parallel_1", lat0)
        return _PolarStereographic(
            ell, cm, standard_parallel=abs(lat_ts), false_easting=fe,
            false_northing=fn, north=lat_ts >= 0, variant_c=True,
        )
    if method == "new_zealand_map_grid":
        # presence-based defaults: an explicit zero parameter is honored
        return _NewZealandMapGrid(
            ell,
            lon0=p.get("central_meridian", 173.0),
            lat0=p.get("latitude_of_origin", -41.0),
            false_easting=p.get("false_easting", 2510000.0),
            false_northing=p.get("false_northing", 6023150.0),
        )
    if method in ("polyconic", "american_polyconic"):
        return _AmericanPolyconic(ell, cm, lat0, fe, fn)
    if method == "bonne":
        return _Bonne(ell, cm, p.get("standard_parallel_1", lat0), fe, fn)
    if method == "sinusoidal":
        return _Sinusoidal(ell, cm, fe, fn)
    if method in (
        "cylindrical_equal_area",
        "lambert_cylindrical_equal_area",
        "lambert_cylindrical_equal_area_spherical",
    ):
        return _CylindricalEqualArea(
            ell, cm, p.get("standard_parallel_1", lat0), fe, fn
        )
    if method == "mollweide":
        return _Mollweide(ell, cm, fe, fn)
    if method == "robinson":
        return _Robinson(ell, cm, fe, fn)
    if method in ("vandergrinten", "van_der_grinten_i", "van_der_grinten"):
        return _VanDerGrinten(ell, cm, fe, fn)
    if method == "eckert_iv":
        return _EckertIV(ell, cm, fe, fn)
    if method == "miller_cylindrical":
        return _MillerCylindrical(ell, cm, fe, fn)
    if method == "gall_stereographic":
        return _GallStereographic(ell, cm, fe, fn)
    if method == "equal_earth":
        return _EqualEarth(ell, cm, fe, fn)
    if method in (
        "azimuthal_equidistant",
        "modified_azimuthal_equidistant",
        "azimuthal_equidistant_spherical",
    ):
        return _AzimuthalEquidistant(ell, cm, lat0, fe, fn)
    if method == "orthographic":
        return _Orthographic(ell, cm, lat0, fe, fn)
    if method == "gnomonic":
        return _Gnomonic(ell, cm, lat0, fe, fn)
    if method == "hyperbolic_cassini_soldner":
        return _HyperbolicCassiniSoldner(ell, cm, lat0, fe, fn)
    if method == "guam_projection":
        return _GuamProjection(ell, cm, lat0, fe, fn)
    if method == "lambert_conic_near_conformal":
        return _LambertConicNearConformal(ell, cm, lat0, k0, fe, fn)
    if method == "laborde_oblique_mercator":
        return _LabordeObliqueMercator(
            ell, cm, lat0, p.get("azimuth", 0.0), k0, fe, fn
        )
    if method == "transverse_mercator_zoned_grid_system":
        return _TransverseMercatorZoned(
            ell, cm, p.get("zone_width", 6.0), lat0, k0, fe, fn
        )
    if method == "tunisia_mining_grid":
        return _TunisiaMiningGrid(ell, cm, lat0, fe, fn)
    raise TransformException("Unsupported projection method: %s" % method)


# WKT2 parameter names (EPSG registry wording) -> the WKT1 snake names
# the projection builder consumes
_WKT2_PARAMS = {
    "latitude_of_natural_origin": "latitude_of_origin",
    "longitude_of_natural_origin": "central_meridian",
    "scale_factor_at_natural_origin": "scale_factor",
    "latitude_of_1st_standard_parallel": "standard_parallel_1",
    "latitude_of_2nd_standard_parallel": "standard_parallel_2",
    "latitude_of_false_origin": "latitude_of_origin",
    "longitude_of_false_origin": "central_meridian",
    "easting_at_false_origin": "false_easting",
    "northing_at_false_origin": "false_northing",
    "latitude_of_projection_centre": "latitude_of_center",
    "longitude_of_projection_centre": "longitude_of_center",
    "azimuth_at_projection_centre": "azimuth",
    "azimuth_of_initial_line": "azimuth",
    "angle_from_rectified_to_skew_grid": "rectified_grid_angle",
    "scale_factor_at_projection_centre": "scale_factor",
    "scale_factor_on_initial_line": "scale_factor",
    "latitude_of_pseudo_standard_parallel": "pseudo_standard_parallel_1",
    "scale_factor_on_pseudo_standard_parallel": "scale_factor",
    "latitude_of_standard_parallel": "standard_parallel_1",
    "easting_at_projection_centre": "false_easting",
    "northing_at_projection_centre": "false_northing",
}


def _wkt_param_name(name):
    key = name.lower().replace(" ", "_")
    return _WKT2_PARAMS.get(key, key)


def _sr_from_wkt(text):
    root = _parse_wkt(text)
    if root[0] in ("COMPD_CS", "COMPOUNDCRS"):
        # compound (horizontal + vertical) CRS: raster geometry uses the
        # horizontal member, like GDAL's 2-D handling of COMPD_CS
        horizontal = _wkt_find(
            root, "PROJCS", "PROJCRS", "PROJECTEDCRS",
            "GEOGCS", "GEOGCRS", "GEOGRAPHICCRS",
        )
        if horizontal is None:
            raise TransformException(
                "Compound CRS without a horizontal member"
            )
        root = horizontal
        # the member's own EPSG authority beats structural re-parsing
        # (matching the whole-text AUTHORITY shortcut in get_sr); code
        # extraction mirrors the main parse below: EPSG namespace only,
        # positional code field
        auth = _wkt_find(root, "AUTHORITY", "ID")
        if auth and len(auth[1]) > 1 and str(auth[1][0]).upper() == "EPSG":
            try:
                return _registry_get(int(float(auth[1][1])))
            except (TransformException, ValueError):
                pass
    if root[0] in ("GEOGCS", "GEOGCRS", "GEOGRAPHICCRS"):
        projected, geog = False, root
    elif root[0] in ("PROJCS", "PROJCRS", "PROJECTEDCRS"):
        projected, geog = True, _wkt_find(root, "GEOGCS", "GEOGCRS", "BASEGEOGCRS")
    else:
        raise TransformException("Cannot parse WKT root: %s" % root[0])
    if geog is None:
        raise TransformException("WKT PROJCS without a GEOGCS")
    datum_node = _wkt_find(geog, "DATUM", "TRF", "ENSEMBLE")
    spheroid = _wkt_find(datum_node, "SPHEROID", "ELLIPSOID")
    a, inv_f = float(spheroid[1][1]), float(spheroid[1][2])
    towgs84 = _wkt_find(datum_node, "TOWGS84")
    helmert = [float(v) for v in towgs84[1]] if towgs84 else None
    datum_key = _intern_datum(str(datum_node[1][0]), a, inv_f, helmert)
    ell = _ellipsoid(DATUMS[datum_key][0])

    name = str(root[1][0]) if root[1] else "unnamed"
    auth = _wkt_find(root, "AUTHORITY", "ID")
    code = None
    if auth and str(auth[1][0]).upper() == "EPSG":
        code = int(float(auth[1][1]))

    if not projected:
        projection = _GeographicProjection()
        key = code or ("geog", datum_key)
        return SpatialReference(code, name, datum_key, projection, wkt=text, key=key)

    # WKT1 keeps PROJECTION/PARAMETER at the root; WKT2 nests METHOD and
    # PARAMETER inside a CONVERSION node and uses human-readable names
    conversion = _wkt_find(root, "CONVERSION", "DERIVINGCONVERSION")
    param_scope = conversion if conversion is not None else root
    method_node = _wkt_find(param_scope, "PROJECTION", "METHOD")
    if method_node is None:
        raise TransformException(
            "WKT projected CRS without a PROJECTION/METHOD node"
        )
    method = str(method_node[1][0])
    params = {
        _wkt_param_name(str(arg[1][0])): float(arg[1][1])
        for arg in param_scope[1]
        if isinstance(arg, tuple) and arg[0] == "PARAMETER"
    }
    unit = _wkt_find(root, "UNIT", "LENGTHUNIT")
    factor = float(unit[1][1]) if unit is not None else 1.0
    if abs(factor - 1.0) > 1e-12:
        # WKT expresses false easting/northing in the CRS's linear unit
        # (e.g. US survey foot state plane); the projection math runs in
        # metres, so convert the offsets in and scale the grid out
        for param in ("false_easting", "false_northing"):
            if param in params:
                params[param] = params[param] * factor
        projection = _ScaledUnitProjection(
            _build_projection(method, ell, params),
            factor,
            str(unit[1][0]),
        )
    else:
        projection = _build_projection(method, ell, params)
    key = code or (
        method.lower(), datum_key, tuple(sorted(params.items())), factor
    )
    return SpatialReference(code, name, datum_key, projection, wkt=text, key=key)


_PROJ4_ELLPS = {
    "WGS84": "WGS84",
    "GRS80": "GRS80",
    "bessel": "bessel",
    "airy": "airy",
    "intl": "intl",
    "sphere": "sphere",
    "clrk66": "clrk66",
    "krass": "krass",
    "GRS67": "GRS67",
}

#: proj4 +datum= names -> DATUMS keys (ellipsoid + towgs84 implied)
_PROJ4_DATUMS = {
    "WGS84": "WGS84",
    "NAD83": "ETRS89",
    "NAD27": "NAD27",
    "OSGB36": "OSGB36",
    "nzgd49": "NZGD49",
    "ED50": "ED50",
}

_PROJ4_METHODS = {
    "aea": "albers_conic_equal_area",
    "tmerc": "transverse_mercator",
    "sterea": "oblique_stereographic",
    "lcc": "lambert_conformal_conic_2sp",
    "laea": "lambert_azimuthal_equal_area",
    "merc": "mercator_1sp",
    "webmerc": "popular_visualisation_pseudo_mercator",
    "eqc": "equidistant_cylindrical",
    "cass": "cassini_soldner",
    "omerc": "hotine_oblique_mercator_azimuth_center",
    "somerc": "hotine_oblique_mercator_azimuth_center",
    "krovak": "krovak",
    "nzmg": "new_zealand_map_grid",
    "poly": "polyconic",
    "bonne": "bonne",
    "sinu": "sinusoidal",
    "cea": "cylindrical_equal_area",
    "moll": "mollweide",
    "robin": "robinson",
    "vandg": "van_der_grinten",
    "eck4": "eckert_iv",
    "mill": "miller_cylindrical",
    "gall": "gall_stereographic",
    "eqearth": "equal_earth",
    "aeqd": "azimuthal_equidistant",
    "ortho": "orthographic",
    "gnom": "gnomonic",
}

#: proj4 +units values -> metres per unit (subset; +to_meter overrides)
_PROJ4_UNITS = {
    "m": 1.0,
    "ft": 0.3048,
    "us-ft": 1200.0 / 3937.0,
    "km": 1000.0,
}


def _sr_from_proj4(text):
    parts = {}
    for item in text.split():
        if not item.startswith("+"):
            continue
        key, _, value = item[1:].partition("=")
        parts[key] = value if value else True

    if "datum" in parts and str(parts["datum"]) in _PROJ4_DATUMS:
        # a named datum implies the ellipsoid AND the WGS84 shift
        datum_key = _PROJ4_DATUMS[str(parts["datum"])]
        ell_name, known_helmert = DATUMS[datum_key]
        a, inv_f = ELLIPSOIDS[ell_name]
        if "towgs84" not in parts and known_helmert is not None:
            parts = dict(parts)
            parts["towgs84"] = ",".join(str(v) for v in known_helmert)
    elif "ellps" in parts and parts["ellps"] in _PROJ4_ELLPS:
        a, inv_f = ELLIPSOIDS[_PROJ4_ELLPS[parts["ellps"]]]
    elif "a" in parts:
        a = float(parts["a"])
        if "rf" in parts:
            inv_f = float(parts["rf"])
        elif "b" in parts:
            b = float(parts["b"])
            inv_f = a / (a - b) if a != b else float("inf")
        else:
            inv_f = float("inf")
    else:
        a, inv_f = ELLIPSOIDS["WGS84"]
    if np.isinf(inv_f):
        inv_f = 0.0
    helmert = None
    if "towgs84" in parts:
        helmert = [float(v) for v in str(parts["towgs84"]).split(",")]
    datum_key = _intern_datum(
        str(parts.get("datum", "proj4")), a, inv_f, helmert
    )
    ell = _ellipsoid(DATUMS[datum_key][0])

    # +units / +to_meter apply to EVERY projected early return below;
    # proj4 keeps x_0/y_0 in metres, only grid coordinates scale
    factor = None
    if "to_meter" in parts:
        factor = float(parts["to_meter"])
    elif "units" in parts and parts["units"] != "m":
        try:
            factor = _PROJ4_UNITS[str(parts["units"])]
        except KeyError:
            raise TransformException(
                "Unsupported proj4 unit: %r" % parts["units"]
            )
    if factor is not None and abs(factor - 1.0) <= 1e-12:
        factor = None

    def scaled(projection):
        if factor is None:
            return projection
        return _ScaledUnitProjection(
            projection, factor, str(parts.get("units", "unit"))
        )

    proj = parts.get("proj")
    if proj in ("longlat", "latlong", "latlon", "lonlat"):
        projection = _GeographicProjection()
        return SpatialReference(
            None, text, datum_key, projection, key=("geog", datum_key)
        )
    if proj == "utm":
        zone = int(parts["zone"])
        projection = scaled(
            _TransverseMercator(
                ell, -183.0 + 6.0 * zone, 0.0, 0.9996, 500000.0,
                10000000.0 if "south" in parts else 0.0,
            )
        )
        key = ("utm", datum_key, zone, "south" in parts, factor)
        return SpatialReference(None, text, datum_key, projection, key=key)
    if proj == "stere":
        lat_0 = float(parts.get("lat_0", 0))
        if abs(abs(lat_0) - 90.0) > 1e-9:
            raise TransformException(
                "Only polar +proj=stere is supported (+proj=sterea for oblique)"
            )
        north = lat_0 > 0
        fe = float(parts.get("x_0", 0))
        fn = float(parts.get("y_0", 0))
        lon_0 = float(parts.get("lon_0", 0))
        if "lat_ts" in parts:
            projection = _PolarStereographic(
                ell, lon_0, standard_parallel=abs(float(parts["lat_ts"])),
                false_easting=fe, false_northing=fn, north=north,
            )
        else:
            projection = _PolarStereographic(
                ell, lon_0, k0=float(parts.get("k", parts.get("k_0", 1))),
                false_easting=fe, false_northing=fn, north=north,
            )
        key = (
            "stere", datum_key, lon_0, parts.get("lat_ts"),
            parts.get("k", parts.get("k_0")), fe, fn, north, factor,
        )
        return SpatialReference(
            None, text, datum_key, scaled(projection), key=key
        )
    if proj not in _PROJ4_METHODS:
        raise TransformException("Unsupported proj4 projection: %r" % proj)
    params = {
        "central_meridian": float(parts.get("lon_0", 0)),
        "latitude_of_origin": float(parts.get("lat_0", 0)),
        "scale_factor": float(parts.get("k", parts.get("k_0", 1))),
        "false_easting": float(parts.get("x_0", 0)),
        "false_northing": float(parts.get("y_0", 0)),
    }
    if "lat_ts" in parts:
        params["standard_parallel_1"] = float(parts["lat_ts"])
    if "lat_1" in parts:
        params["standard_parallel_1"] = float(parts["lat_1"])
    if "lat_2" in parts:
        params["standard_parallel_2"] = float(parts["lat_2"])
    method = _PROJ4_METHODS[proj]
    if proj == "merc":
        if a == ELLIPSOIDS["sphere"][0] and not inv_f:
            method = "popular_visualisation_pseudo_mercator"
        elif "lat_ts" in parts:
            method = "mercator_2sp"
    elif proj == "lcc" and "lat_1" not in parts and "lat_2" not in parts:
        method = "lambert_conformal_conic_1sp"
    elif proj == "eqc" and "lat_ts" in parts:
        # +lat_ts is the standard parallel; +lat_0 offsets the y origin
        params["standard_parallel_1"] = float(parts["lat_ts"])
    elif proj in ("omerc", "somerc"):
        # somerc (Swiss oblique Mercator) = variant B with azimuth 90 and
        # rectified grid angle 90 (EPSG method 9815, e.g. EPSG:21781)
        params["central_meridian"] = float(parts.get("lonc", parts.get("lon_0", 0)))
        params["azimuth"] = float(parts.get("alpha", 90))
        if "gamma" in parts:
            params["rectified_grid_angle"] = float(parts["gamma"])
        if proj == "omerc" and ("no_uoff" in parts or "no_off" in parts):
            method = "hotine_oblique_mercator"
    elif proj == "nzmg":
        # PROJ's built-in New Zealand Map Grid defaults
        params["central_meridian"] = float(parts.get("lon_0", 173.0))
        params["latitude_of_origin"] = float(parts.get("lat_0", -41.0))
        params["false_easting"] = float(parts.get("x_0", 2510000.0))
        params["false_northing"] = float(parts.get("y_0", 6023150.0))
    elif proj == "krovak":
        # PROJ's built-in S-JTSK defaults
        params["latitude_of_origin"] = float(parts.get("lat_0", 49.5))
        params["central_meridian"] = float(
            parts.get("lon_0", 24.833333333333332)
        )
        params["azimuth"] = float(parts.get("alpha", 30.28813975277778))
        if "k" not in parts and "k_0" not in parts:
            params["scale_factor"] = 0.9999
    projection = scaled(_build_projection(method, ell, params))
    key = (method, datum_key, tuple(sorted(params.items())), factor)
    return SpatialReference(None, text, datum_key, projection, key=key)


@lru_cache(maxsize=32)
def get_sr(user_input):
    """Return a SpatialReference for an 'EPSG:xxxx' string, an EPSG integer,
    or a WKT string carrying an EPSG authority.  Axis order is always
    traditional GIS (x=lon first), as the reference enforces
    (utils.py:396-406)."""
    if isinstance(user_input, SpatialReference):
        return user_input
    if isinstance(user_input, int):
        return _registry_get(user_input)
    text = str(user_input).strip()
    match = _EPSG_RE.match(text)
    if match:
        return _registry_get(int(match.group(1)))
    match = _ESRI_RE.match(text)
    if match:
        return _esri_registry_get(int(match.group(1)))
    if text.isdigit():
        return _registry_get(int(text))
    # OGC URN/URL identifiers (GML/WFS/GeoJSON interchange) and other
    # common aliases, all resolving to registry codes:
    #   urn:ogc:def:crs:EPSG::4326   urn:ogc:def:crs:EPSG:9.9.1:4326
    #   http://www.opengis.net/def/crs/EPSG/0/4326
    #   urn:ogc:def:crs:OGC:1.3:CRS84 (GeoJSON's lon/lat WGS84)
    #   EPSG:4326+5709 (compound: the horizontal member drives 2-D)
    #   +init=epsg:4326 (legacy proj4)
    match = (
        _OGC_URN_RE.match(text)
        or _OGC_URL_RE.match(text)
        or _GML2_SRS_RE.match(text)
    )
    if match:
        return _registry_get(int(match.group(1)))
    if _CRS84_RE.match(text):
        return _registry_get(4326)
    match = _EPSG_COMPOUND_RE.match(text)
    if match:
        return _registry_get(int(match.group(1)))
    match = _PROJ4_INIT_RE.match(text)
    if match:
        return _registry_get(int(match.group(1)))
    if text.lower().startswith("+init=epsg:"):
        # proj4 semantics let trailing parameters OVERRIDE the init
        # definition; silently dropping them would transform with the
        # wrong datum, so fail loudly instead
        raise TransformException(
            "+init=epsg: with parameter overrides is not supported: %r"
            % text[:80]
        )
    # WKT with an EPSG authority: prefer the registry entry for its datum
    # metadata, falling back to a parametric parse for unknown codes
    for regex in (_WKT_AUTH_RE, _WKT_ID_RE):
        match = regex.search(text)
        if match:
            try:
                return _registry_get(int(match.group(1)))
            except TransformException:
                break
    if text.startswith("+"):
        return _sr_from_proj4(text)
    if "[" in text:
        return _sr_from_wkt(text)
    # common names
    upper = text.upper()
    if "WGS" in upper and "84" in upper and "MERCATOR" not in upper:
        return _registry_get(4326)
    raise TransformException("Cannot parse spatial reference: %r" % text[:80])


def get_crs(user_input):
    """Alias of :func:`get_sr` (the reference distinguishes osr/pyproj)."""
    return get_sr(user_input)


def crs_to_srs(crs):
    """Canonical string for a CRS-like object (or None)."""
    if crs is None:
        return None
    return get_projection(crs)


def get_projection(sr):
    """Return the canonical user string ('EPSG:xxxx' or WKT) for ``sr``."""
    if isinstance(sr, str):
        return sr
    sr = get_sr(sr) if not isinstance(sr, SpatialReference) else sr
    if sr.code:
        return "EPSG:{}".format(sr.code)
    return sr.ExportToWkt()


def get_epsg_or_wkt(text):
    """Return 'EPSG:<code>' where possible, WKT otherwise."""
    sr = get_sr(text)
    if sr.code:
        return "EPSG:{}".format(sr.code)
    return sr.ExportToWkt()


def _same_datum(a, b):
    return a.datum == b.datum or (
        a.helmert_to_wgs84 is None and b.helmert_to_wgs84 is None
    )


def _datum_shift(src, dst, lon, lat):
    """Geographic coordinates src datum -> dst datum.

    A registered NTv2 grid (``geomodeling.ntv2-grids``) upgrades a
    datum's WGS84 leg from the 7-parameter Helmert (~0.5 m) to grid
    interpolation (cm-level); without grids the legs fuse into one
    geocentric chain exactly as before.
    """
    from dask_geomodeling_tpu_torch.geo import ntv2

    src_grid = ntv2.grid_for_datum(src.datum)
    dst_grid = ntv2.grid_for_datum(dst.datum)
    if src_grid is None and dst_grid is None:
        gx, gy, gz = _geodetic_to_geocentric(src.ellipsoid, lon, lat)
        if src.helmert_to_wgs84 is not None:
            gx, gy, gz = _helmert(src.helmert_to_wgs84, gx, gy, gz)
        if dst.helmert_to_wgs84 is not None:
            gx, gy, gz = _helmert(
                dst.helmert_to_wgs84, gx, gy, gz, inverse=True
            )
        return _geocentric_to_geodetic(dst.ellipsoid, gx, gy, gz)
    # grid legs run through explicit WGS84 geographic coordinates;
    # points OUTSIDE a grid's coverage take the datum's Helmert leg
    # instead of extrapolated edge shifts (PROJ leaves them unshifted)
    def helmert_leg(sr, lon, lat, inverse):
        if sr.helmert_to_wgs84 is None:
            return lon, lat
        source_ell = _ellipsoid("WGS84") if inverse else sr.ellipsoid
        target_ell = sr.ellipsoid if inverse else _ellipsoid("WGS84")
        gx, gy, gz = _geodetic_to_geocentric(source_ell, lon, lat)
        gx, gy, gz = _helmert(
            sr.helmert_to_wgs84, gx, gy, gz, inverse=inverse
        )
        return _geocentric_to_geodetic(target_ell, gx, gy, gz)

    def grid_leg(grid, sr, lon, lat, inverse):
        covered = grid.coverage(lon, lat)
        grid_lon, grid_lat = (
            grid.inverse(lon, lat) if inverse else grid.forward(lon, lat)
        )
        fallback_lon, fallback_lat = helmert_leg(sr, lon, lat, inverse)
        return (
            np.where(covered, grid_lon, fallback_lon),
            np.where(covered, grid_lat, fallback_lat),
        )

    if src_grid is not None:
        lon, lat = grid_leg(src_grid, src, lon, lat, inverse=False)
    else:
        lon, lat = helmert_leg(src, lon, lat, inverse=False)
    if dst_grid is not None:
        lon, lat = grid_leg(dst_grid, dst, lon, lat, inverse=True)
    else:
        lon, lat = helmert_leg(dst, lon, lat, inverse=True)
    return lon, lat


def transform_points(x, y, src_srs, dst_srs):
    """Transform coordinate arrays from src to dst; returns (x, y) arrays."""
    src = get_sr(src_srs)
    dst = get_sr(dst_srs)
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    if src == dst:
        return x, y
    try:
        # out-of-domain points compute silently to NaN (the warp fills
        # them)
        with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
            lon, lat = src.projection.inverse(x, y)
            if not _same_datum(src, dst):
                lon, lat = _datum_shift(src, dst, lon, lat)
            return dst.projection.forward(lon, lat)
    except TransformException:
        raise
    except Exception as e:
        raise TransformException(
            "An error occurred while transforming from {} to {}: {}".format(
                get_projection(src), get_projection(dst), e
            )
        )


@lru_cache(maxsize=100)
def get_transform_func(src_srs, dst_srs):
    """Cached point-transform callable ``f(x, y) -> (x, y)``.

    Mirrors the reference's cached pyproj Transformer
    (utils.py:444-449)."""
    src = get_sr(src_srs)
    dst = get_sr(dst_srs)

    def func(x, y):
        return transform_points(x, y, src, dst)

    return func


def transform_extent(bbox, src_srs, dst_srs):
    """Transform a bbox by transforming its corner points (matching the
    reference's shapely box transform, utils.py:183-188)."""
    x1, y1, x2, y2 = bbox
    xs = np.array([x1, x2, x2, x1])
    ys = np.array([y1, y1, y2, y2])
    tx, ty = transform_points(xs, ys, src_srs, dst_srs)
    return float(tx.min()), float(ty.min()), float(tx.max()), float(ty.max())


def transform_min_size(min_size, geometry, src_srs, dst_srs):
    """Convert a minimum size (diameter) between CRSes at the location of
    ``geometry`` (reference utils.py:488-505)."""
    cx, cy = geometry.centroid.coords0
    r = min_size / 2.0
    xs = np.array([cx - r, cx + r, cx, cx])
    ys = np.array([cy, cy, cy - r, cy + r])
    tx, ty = transform_points(xs, ys, src_srs, dst_srs)
    return max(float(tx.max() - tx.min()), float(ty.max() - ty.min()))
