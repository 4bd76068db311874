"""The port's CRS layer (geo/crs.py, geo/_epsg_registry.py) against the
JAX package's, on the CPU.

- ``transform_points`` forward (from WGS 84 geographic) and inverse (back
  from the JAX package's forward answer) is bitwise the JAX package's,
  NaN equal to NaN, for every code of the EPSG table: one case per
  projection method of the table (33) and one for its geographic CRSes.
  The points are a world grid and a grid of +-2 degrees about the
  projection's origin.  The same holds for every code the hand registry
  answers (the literal codes and code ranges of its source) and every
  ESRI code;
- ``ExportToWkt``, ``get_projection``, ``get_epsg_or_wkt``, the name and
  datum agree code by code, and ``__eq__`` agrees on each code against
  itself, its neighbour and the CRS its WKT parses to;
- every string literal of the JAX package's CRS tests
  (tests/test_crs_universal.py, test_crs_extended.py,
  test_crs_registry_families.py, test_crs_exotic_methods.py and
  test_epsg_registry.py) that the JAX ``get_sr`` parses is parsed alike
  (the same WKT, projection string and transforms), and every one it
  refuses is refused with the same error and message;
- the port reads its own copy of ``epsg.json.gz``, equal to the JAX
  package's.

Run with ``python -m pytest tests/test_torch_crs.py -q``.
"""
import ast
import gzip
import json
import os
import re

import numpy as np
import pytest

from dask_geomodeling_tpu.geo import _epsg_registry as jax_registry
from dask_geomodeling_tpu.geo import crs as J
from dask_geomodeling_tpu_torch.geo import _epsg_registry as port_registry
from dask_geomodeling_tpu_torch.geo import crs as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TABLE = os.path.join(REPO, "dask_geomodeling_tpu", "geo", "epsg.json.gz")
PORT_TABLE = os.path.join(REPO, "dask_geomodeling_tpu_torch", "geo", "epsg.json.gz")

with gzip.open(JAX_TABLE, "rb") as _f:
    TABLE = json.load(_f)

#: table codes by projection method; the geographic CRSes as one group
BY_METHOD = {"geographic": sorted(int(c) for c in TABLE["geographic"])}
for _code, _entry in TABLE["projected"].items():
    BY_METHOD.setdefault(_entry[2], []).append(int(_code))

WORLD_LON, WORLD_LAT = (a.ravel() for a in np.meshgrid(
    np.array([-179.0, -150.0, -60.0, 0.0, 30.0, 95.0, 170.0]),
    np.array([-89.0, -70.0, -33.0, 0.0, 18.0, 52.0, 78.0, 89.5])))
_ORIGIN_KEYS = (("central_meridian", "longitude_of_center", "longitude_of_origin"),
                ("latitude_of_origin", "latitude_of_center", "standard_parallel_1"))


def _points(params):
    """The world grid and a +-2 degree grid about the projection's origin
    (lon, lat)."""
    lon0 = next((params[k] for k in _ORIGIN_KEYS[0] if k in params), 0.0)
    lat0 = next((params[k] for k in _ORIGIN_KEYS[1] if k in params), 0.0)
    offsets = np.array([-2.0, -0.5, 0.0, 0.3, 2.0])
    lon, lat = np.meshgrid(lon0 + offsets, np.clip(lat0 + offsets, -89.9, 89.9))
    return (np.concatenate([WORLD_LON, lon.ravel()]),
            np.concatenate([WORLD_LAT, lat.ravel()]))


def _same(actual, expected, what):
    for a, e in zip(actual, expected):
        assert a.dtype == e.dtype, what
        np.testing.assert_array_equal(a, e, err_msg=what)  # NaN in the same places


def _hold(jax_sr, port_sr, params, what):
    """Forward and inverse transforms, WKT and projection string alike."""
    lon, lat = _points(params)
    with np.errstate(all="ignore"):
        expected = J.transform_points(lon, lat, "EPSG:4326", jax_sr)
        _same(P.transform_points(lon, lat, "EPSG:4326", port_sr), expected, what + " forward")
        x, y = expected
        _same(P.transform_points(x, y, port_sr, "EPSG:4326"),
              J.transform_points(x, y, jax_sr, "EPSG:4326"), what + " inverse")
    assert port_sr.ExportToWkt() == jax_sr.ExportToWkt(), what
    assert P.get_projection(port_sr) == J.get_projection(jax_sr), what
    assert (port_sr.code, port_sr.name, port_sr.datum) == (jax_sr.code, jax_sr.name,
                                                           jax_sr.datum), what


def test_the_port_reads_its_own_table():
    assert os.path.dirname(port_registry.__file__) == os.path.dirname(PORT_TABLE)
    with open(PORT_TABLE, "rb") as port, open(JAX_TABLE, "rb") as jax:
        assert port.read() == jax.read()
    assert port_registry._table() == TABLE
    assert port_registry._table() is not jax_registry._table()


def test_the_table_has_33_methods():
    assert len(BY_METHOD) == 34
    assert sum(len(codes) for codes in BY_METHOD.values()) == 6276


@pytest.mark.parametrize("method", sorted(BY_METHOD))
def test_every_table_code_bitwise(method):
    codes = BY_METHOD[method]
    previous = None
    for code in codes:
        entry = TABLE["projected"].get(str(code))
        params = entry[3] if entry else {}
        jax_sr, port_sr = J.get_sr(code), P.get_sr(code)
        _hold(jax_sr, port_sr, params, "EPSG:%d" % code)
        assert P.get_epsg_or_wkt("EPSG:%d" % code) == J.get_epsg_or_wkt("EPSG:%d" % code)
        if previous is not None:
            assert (port_sr == P.get_sr(previous)) == (jax_sr == J.get_sr(previous))
        assert port_sr == P.get_sr(code) and hash(port_sr) == hash(P.get_sr(code))
        previous = code
    # a WKT round trip per method: the parsed CRS equals the code's where
    # the JAX package's does, and transforms alike
    for code in codes[:: max(1, len(codes) // 8)]:
        jax_sr, port_sr = J.get_sr(code), P.get_sr(code)
        jax_back, port_back = J.get_sr(jax_sr.ExportToWkt()), P.get_sr(port_sr.ExportToWkt())
        assert (port_back == port_sr) == (jax_back == jax_sr)
        _hold(jax_back, port_back, {}, "WKT of EPSG:%d" % code)


def _hand_registry_codes():
    """The codes the JAX package's hand registry names: its literals and
    the ranges it tests, in ``_registry_get``'s source."""
    with open(J.__file__) as f:
        source = f.read()
    body = source[source.index("def _registry_get"):source.index("_EPSG_RE = ")]
    codes = set()
    for lo, hi in re.findall(r"(\d{4,6}) <= code <= (\d{4,6})", body):
        codes.update(range(int(lo), int(hi) + 1))
    codes.update(int(n) for n in re.findall(r"\b\d{4,6}\b", body))
    resolved = []
    for code in sorted(codes):
        try:
            J.get_sr(code)
        except J.TransformException:
            continue
        resolved.append(code)
    return resolved


HAND_CODES = _hand_registry_codes()
ESRI_CODES = [102100, 102113] + [series * 1000 + suffix for series in (53, 54)
                                 for suffix in sorted(J._ESRI_WORLD)]


def test_hand_registry_and_esri_codes_bitwise():
    assert len(HAND_CODES) > 300
    for code in HAND_CODES:
        _hold(J.get_sr(code), P.get_sr(code), {}, "EPSG:%d" % code)
    for code in ESRI_CODES:
        text = "ESRI:%d" % code
        _hold(J.get_sr(text), P.get_sr(text), {}, text)
        assert P.get_sr(text) == P.get_sr(text)


def test_unknown_codes_raise_alike():
    for text in ("EPSG:999999", "ESRI:54999", "EPSG:1", "not a crs"):
        with pytest.raises(J.TransformException) as expected:
            J.get_sr(text)
        with pytest.raises(P.TransformException) as actual:
            P.get_sr(text)
        assert str(actual.value) == str(expected.value)


CRS_TEST_FILES = ("test_crs_universal.py", "test_crs_extended.py",
                  "test_crs_registry_families.py", "test_crs_exotic_methods.py",
                  "test_epsg_registry.py")


def _identifier_cases():
    """Every distinct string literal of the JAX package's CRS tests that
    could name a CRS, as (file, text)."""
    cases = []
    seen = set()
    for name in CRS_TEST_FILES:
        with open(os.path.join(REPO, "tests", name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                text = node.value
                if text in seen or len(text) < 4 or "\n" in text.strip():
                    continue
                if not re.search(r"EPSG|ESRI|epsg|esri|CRS|crs|\+proj|\+init|PROJCS|GEOGCS|"
                                 r"PROJCRS|GEOGCRS|GEODCRS|BASEGEOGCRS|urn:|opengis|WGS", text):
                    continue
                seen.add(text)
                cases.append((name, text))
    return cases


IDENTIFIERS = _identifier_cases()


def test_identifier_cases_are_many():
    assert len(IDENTIFIERS) > 100


@pytest.mark.parametrize("case", range(len(IDENTIFIERS)),
                         ids=["%s-%d" % (IDENTIFIERS[i][0][5:-3], i) for i in range(len(IDENTIFIERS))])
def test_identifier_parses_alike(case):
    _, text = IDENTIFIERS[case]
    try:
        jax_sr = J.get_sr(text)
    except Exception as error:
        with pytest.raises(Exception) as raised:
            P.get_sr(text)
        assert type(raised.value).__name__ == type(error).__name__
        assert str(raised.value) == str(error)
        return
    port_sr = P.get_sr(text)
    _hold(jax_sr, port_sr, {}, text[:60])
    assert P.get_epsg_or_wkt(text) == J.get_epsg_or_wkt(text)
    assert P.crs_to_srs(text) == J.crs_to_srs(text)
    assert (port_sr == P.get_sr(4326)) == (jax_sr == J.get_sr(4326))
