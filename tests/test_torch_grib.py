"""The port's GRIB reader (io/grib.py), its dispatch in the read cache and
``RasterFileSource``, and chip_smoke's GRIB writers and grib-forecast view,
held on the CPU to the JAX package's.

Every case of tests/test_grib.py runs once in each package (``run_both``
of tests/test_torch_raster_formats.py), the test itself with its own
message builders and assertions, its ``read_grib`` the package's: the
files are byte-identical, and every payload ``read_grib`` returns and
every error it raises the same (arrays bitwise with their dtypes, the
projection, geotransform, nodata and metadata equal; errors by type and
message, paths made relative).  ``test_jpeg2000_packing`` has its own
case: the JAX package decodes the codestream with Pillow, the port raises
NotImplementedError naming io/grib.py.  The complex-packing decode
(``_complex_groups``, ``_decode_complex``, ``_decode_complex_diff``) and
``_unpack_bits`` give the JAX loop's integers and missing flags, or its
error, over random group layouts under hypothesis.  The truncations and
byte corruptions of tests/test_format_robustness.py, for both editions and
for a message in complex packing with spatial differencing: the port
gives the JAX payload where the JAX reader decodes, and an error of the
same type where it raises, with the same message where that message is
the format's own (not a wrapped low-level error).  Every GRIB suffix
reaches the reader through ``info`` and the read cache and is never read
by window.  A ``RasterFileSource`` over chip_smoke's GRIB2 forecast and
its GRIB1 archive comes across with ``from_reference`` and answers the
JAX numpy executor; chip_smoke's writer and the grib-forecast view at 320
x 75 points and six hourly fields (both packings) answer as the JAX
package's, and the phase's checks hold on the CPU.

Tolerance: none but one.  Payloads, ``compute_host`` and get_data at the
file's grid are held bitwise; get_data in RD New within chip_smoke's
HEADLINE_SHARE (at most 5e-4 of the cells differing), the port's rule for
a cross-CRS nearest warp on the device path.
"""
import os
import struct
import zlib
from datetime import timedelta
from unittest import mock

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
import tests.test_grib as grib_tests
from dask_geomodeling_tpu import raster as jax_raster
from dask_geomodeling_tpu.io import grib as jax_grib
from dask_geomodeling_tpu.runtime import pipeline as jax_pipeline
from dask_geomodeling_tpu_torch import compute_host, evaluate_tiled, from_reference
from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.io import grib
from dask_geomodeling_tpu_torch.raster import RasterFileSource
from dask_geomodeling_tpu_torch.runtime import pipeline
from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests
from tests.test_format_robustness import _grib1_bytes, _grib2_bytes
from tests.test_grib import _pack_bits, _section, _sm
from tests.test_torch_file_sources import assert_agrees, both_configs, jax_numpy
from tests.test_torch_hdf4 import outcome, within_share
from tests.test_torch_raster_formats import assert_same, run_both
from tests.test_torch_zarr import info_fields

#: the JAX package's reader, before any case replaces it
JAX_READ_GRIB = jax_grib.read_grib
GRIB_SUFFIXES = (".grib", ".grib2", ".grb", ".grb2", ".gb2")
#: chip_smoke's grib-forecast phase at a small size: 320 x 75 points of
#: 0.02 degree from 1.00 W (stored as 359.00 E) and 53.50 N, six hourly
#: fields, (b) over a 51.2 km box of RD New inside them at 1 km
GRIB_SMALL = dict(ni=320, nj=75, hours=6, origin=(53500000, 359000000),
                  rd_bbox=(20000.0, 520000.0, 71200.0, 571200.0), rd_cell=1000.0,
                  cog_cell=2000.0, rd_hours=6, sampled_tiles=1)


# --- tests/test_grib.py, every case, in each package ---


def _parametrized(function):
    """The keyword sets of ``function``'s parametrize marks."""
    combos = [{}]
    for mark in getattr(function, "pytestmark", []):
        if mark.name == "parametrize":
            name, values = mark.args
            combos = [dict(combo, **{name: value}) for combo in combos for value in values]
    return combos


#: cases with their own version below: the JPEG 2000 field, and the
#: RasterFileSource test, which builds the JAX package's blocks
OWN_CASES = ("test_jpeg2000_packing", "test_raster_file_source_integration")
JAX_CASES = {
    name[len("test_"):] + "".join("[%s=%r]" % kv for kv in combo.items()): (function, combo)
    for name, function in vars(grib_tests).items()
    if name.startswith("test_") and callable(function) and name not in OWN_CASES
    for combo in _parametrized(function)
}


def _reading(read, root, results):
    """``read`` recording what it returns or raises in ``results``."""
    def reading(path):
        kind, value = outcome(lambda: read(path), root)
        results.append((kind, value))
        if kind == "error":
            return read(path)  # raise the error itself, for pytest.raises
        return value
    return reading


def run_case(test, combo):
    """The case ``test(**combo)`` of tests/test_grib.py in one package:
    its ``read_grib`` (and the JAX module's, which two cases import inside)
    the package's, recorded."""
    def case(k, root):
        results = []
        reading = _reading(grib.read_grib if k.port else JAX_READ_GRIB, root, results)
        with mock.patch.object(grib_tests, "read_grib", reading), \
                mock.patch.object(jax_grib, "read_grib", reading):
            test(root, **combo)
        return results
    return case


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_jax_case(tmp_path, name):
    """One case of tests/test_grib.py, in each package."""
    results = run_both(tmp_path, run_case(*JAX_CASES[name]))
    assert results


def test_jpeg2000_packing(tmp_path):
    """tests/test_grib.py's JPEG 2000 field: the JAX package decodes it
    (with Pillow's OpenJPEG binding); the port raises NotImplementedError
    naming io/grib.py, as for its other unported variants; a constant field
    (0 bits a value) needs no decoder, and reads alike."""
    jax_results = []
    with mock.patch.object(grib_tests, "read_grib",
                           _reading(JAX_READ_GRIB, tmp_path, jax_results)):
        grib_tests.test_jpeg2000_packing(tmp_path)
    assert jax_results and jax_results[0][0] == "result"
    (path,) = [str(p) for p in tmp_path.iterdir()]
    with pytest.raises(NotImplementedError, match="io/grib.py") as raised:
        grib.read_grib(path)
    assert "5.40" in str(raised.value)
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    # the section 5's bits per value (octet 20) to 0: a constant field
    sec5 = raw.index(struct.pack(">IB", 21, 5))
    raw[sec5 + 19] = 0
    with open(path, "wb") as f:
        f.write(raw)
    assert_same(grib.read_grib(path), JAX_READ_GRIB(path))


def _raster_file_source_integration(k, root):
    """tests/test_grib.py's RasterFileSource case, with the package's
    blocks and get_data (the JAX package's on its numpy executor)."""
    values = np.arange(100, dtype=np.int64).reshape(10, 10)
    grib_tests._write(root, grib_tests._simple_message(values, la1=55.0, lo1=4.0, di=0.1,
                                                       dj=0.1))
    source = k.R.RasterFileSource("test.grib2")
    assert source.projection == "EPSG:4326"
    assert len(source) == 1
    data = k.get_data(source, mode="vals", bbox=(3.95, 54.15, 4.95, 55.05),
                      projection="EPSG:4326", width=10, height=9)
    assert data["values"].shape == (1, 9, 10)
    np.testing.assert_array_equal(data["values"][0], values[:9].astype("f8"))
    meta = k.get_data(source, mode="meta", start=None, stop=None)
    assert "GRIB discipline=0" in meta["meta"][0]
    return data, meta


def test_raster_file_source_integration(tmp_path):
    run_both(tmp_path, _raster_file_source_integration)


# --- the branches tests/test_grib.py leaves out ---


def _lambert(shape=6, radius=(0, 0), major=(0, 0), minor=(0, 0)):
    """tests/test_grib.py's Lambert grid section on shape of earth
    ``shape`` with (scale, value) of the radius and the axes."""
    sec3 = bytearray(grib_tests._sec3_lambert(4, 3, la1=46.0, lo1=5.0, lad=52.0, lov=10.0,
                                              dx=3000.0, dy=3000.0, latin1=48.0,
                                              latin2=56.0, scan=0x40))
    sec3[14] = shape
    for at, (scale, value) in ((15, radius), (20, major), (25, minor)):
        sec3[at] = scale
        sec3[at + 1 : at + 5] = value.to_bytes(4, "big")
    return bytes(sec3)


def _grib2(sec3=None, sec5=None, sec6=None, sec7=None, values=None):
    """A one-message GRIB2 file of tests/test_grib.py's sections, the
    given ones in place of the defaults (simple packing of ``values`` on a
    4 x 3 lat-lon grid)."""
    values = np.arange(12).reshape(3, 4) if values is None else values
    nbits = max(int(values.max()).bit_length(), 1)
    return grib_tests._message([
        grib_tests._sec1(),
        sec3 or grib_tests._sec3_latlon(4, 3, 55.0, 4.0, 54.0, 5.5, 0.5, 0.5, 0),
        grib_tests._sec4(),
        sec5 or grib_tests._sec5_simple(values.size, 0.0, 0, 0, nbits),
        sec6 or grib_tests._sec6(),
        sec7 or grib_tests._sec7_simple(values.ravel(), nbits)])


def _g1_gds(rep, tail, ni=5, nj=4, la1=60.0, lo1=-10.0, flags=0):
    """An edition-1 GDS of representation ``rep``: the common head, then
    ``tail`` (octets 18 on), padded to 32 octets."""
    body = (bytes([0, 255, rep]) + struct.pack(">HH", ni, nj) + _sm(round(la1 * 1e3), 3)
            + _sm(round(lo1 * 1e3), 3) + bytes([flags]) + tail)
    body += bytes(max(29 - len(body), 0))
    return (len(body) + 3).to_bytes(3, "big") + body


def _grib1(gds, values=None, bms=b"", **pds):
    values = np.arange(20.0) if values is None else values
    return grib_tests._g1_message(grib_tests._g1_pds(**pds), gds, bms,
                                  grib_tests._g1_bds(values, 0.0, 0, 0, 8))


def _png_rgb():
    """Template 5.41 with 24-bit samples: an RGB PNG, recombined."""
    from dask_geomodeling_tpu_torch.io.png import write_png_bytes

    planes = (np.arange(36, dtype=np.uint8).reshape(3, 3, 4) * 7) % 251
    sec5 = _section(5, struct.pack(">IH", 12, 41) + struct.pack(">f", 0.0) + _sm(0, 2)
                    + _sm(0, 2) + bytes([24, 0]))
    return _grib2(sec5=sec5, sec7=_section(7, write_png_bytes(planes)))


def _ccsds(nbits, flags, cells):
    """Template 5.42 of ``nbits`` samples in ``cells``-byte cells, flags
    ``flags`` (MSB 4, 3BYTE 2): the stream from libaec's own encoder."""
    from dask_geomodeling_tpu_torch.io import ccsds

    if not ccsds.aec_available():
        pytest.skip("libaec not loadable")
    packed = (np.arange(12, dtype=np.int64) * 977) % (1 << nbits)
    order = ">" if flags & 4 else "<"
    raw = (packed.astype(order + {1: "u1", 2: "u2", 4: "u4"}[cells]).tobytes() if cells != 3
           else np.stack([(packed >> 16) & 255, (packed >> 8) & 255, packed & 255], 1)
           .astype(np.uint8)[:, :: 1 if flags & 4 else -1].tobytes())
    stream = ccsds.aec_encode(raw, bits_per_sample=nbits, block_size=16, rsi=64,
                              flags=flags | 8)
    return _grib2(sec5=grib_tests._sec5_ccsds(12, 0.0, 0, 0, nbits, flags | 8, 16, 64),
                  sec7=_section(7, bytes(stream)))


def _two(first, second):
    return first + second


BRANCHES = {
    # the earth (code table 3.2) in the proj4 string: +a and +b
    **{"earth-shape-%d" % shape: (lambda shape: lambda: _grib2(sec3=_lambert(shape)))(shape)
       for shape in (0, 2, 4, 5, 6, 8, 9, 10)},
    "earth-radius": lambda: _grib2(sec3=_lambert(1, radius=(1, 63712290))),
    "earth-axes-km": lambda: _grib2(sec3=_lambert(3, major=(3, 6378137), minor=(4, 63567523))),
    "earth-axes-m": lambda: _grib2(sec3=_lambert(7, major=(0, 6378137), minor=(0, 6356752))),
    "grid-source-1": lambda: _grib2(sec3=(lambda b: bytes(b[:5]) + b"\x01" + bytes(b[6:]))(
        grib_tests._sec3_latlon(4, 3, 55.0, 4.0, 54.0, 5.5, 0.5, 0.5, 0))),
    "grid-template-40": lambda: _grib2(sec3=(lambda b: bytes(b[:12]) + b"\x00\x28" + bytes(b[14:]))(
        grib_tests._sec3_latlon(4, 3, 55.0, 4.0, 54.0, 5.5, 0.5, 0.5, 0))),
    "thinned-consecutive-j": lambda: _grib2(
        sec3=grib_tests._sec3_latlon_thinned([4, 4, 4], 55.0, 4.0, 54.0, 5.5, 0.5, scan=0x20)),
    "thinned-interpretation-2": lambda: _grib2(sec3=(lambda b: bytes(b[:11]) + b"\x02" + bytes(
        b[12:]))(grib_tests._sec3_latlon_thinned([4, 4, 4], 55.0, 4.0, 54.0, 5.5, 0.5))),
    "thinned-list-short": lambda: _grib2(sec3=(lambda b: struct.pack(">I", len(b) - 4) + bytes(
        b[4:-4]))(grib_tests._sec3_latlon_thinned([4, 4, 4], 55.0, 4.0, 54.0, 5.5, 0.5))),
    "thinned-missing-list": lambda: _grib2(sec3=(lambda b: bytes(b[:30]) + b"\xff" * 4 + bytes(
        b[34:]))(grib_tests._sec3_latlon(4, 3, 55.0, 4.0, 54.0, 5.5, 0.5, 0.5, 0))),
    "data-template-99": lambda: _grib2(sec5=_section(5, struct.pack(">IH", 12, 99)
                                                     + bytes(11))),
    "bitmap-indicator-7": lambda: _grib2(sec6=_section(6, bytes([7]))),
    "bitmap-reused": lambda: grib_tests._message([
        grib_tests._sec1(), grib_tests._sec3_latlon(4, 3, 55.0, 4.0, 54.0, 5.5, 0.5, 0.5, 0),
        grib_tests._sec4(), grib_tests._sec5_simple(8, 0.0, 0, 0, 3),
        grib_tests._sec6(np.arange(12) % 3 > 0), grib_tests._sec7_simple(np.arange(8), 3),
        grib_tests._sec4(forecast=6), grib_tests._sec5_simple(8, 0.0, 0, 0, 3),
        _section(6, bytes([254])), grib_tests._sec7_simple(np.arange(8) % 5, 3)]),
    "bitmap-254-in-a-new-message": lambda: _two(
        _grib2(sec6=grib_tests._sec6(np.arange(12) % 3 > 0), values=np.arange(8).reshape(2, 4),
               sec5=grib_tests._sec5_simple(8, 0.0, 0, 0, 3),
               sec7=grib_tests._sec7_simple(np.arange(8), 3)),
        _grib2(sec6=_section(6, bytes([254])), values=np.arange(8).reshape(2, 4),
               sec5=grib_tests._sec5_simple(8, 0.0, 0, 0, 3),
               sec7=grib_tests._sec7_simple(np.arange(8) % 5, 3))),
    "grids-differ": lambda: _two(_grib2(), _grib2(
        sec3=grib_tests._sec3_latlon(4, 3, 56.0, 4.0, 55.0, 5.5, 0.5, 0.5, 0))),
    "data-before-grid": lambda: grib_tests._message([
        grib_tests._sec1(), grib_tests._sec4(), grib_tests._sec5_simple(12, 0.0, 0, 0, 4),
        grib_tests._sec7_simple(np.arange(12), 4)]),
    "no-end-marker": lambda: _grib2()[:-4] + b"7778",
    "no-fields": lambda: grib_tests._message([grib_tests._sec1()]),
    "png-24-bit": _png_rgb,
    "ccsds-16-bit-lsb": lambda: _ccsds(16, 0, 2),
    "ccsds-20-bit-4-byte-cells": lambda: _ccsds(20, 4, 4),
    "ccsds-20-bit-3-byte-lsb": lambda: _ccsds(20, 2, 3),
    "grib1-mercator": lambda: _grib1(_g1_gds(1, _sm(50000, 3) + _sm(20000, 3) + _sm(20000, 3)
                                             + bytes([0, 0]) + (10000).to_bytes(3, "big") * 2)),
    "grib1-polar-north": lambda: _grib1(_g1_gds(5, _sm(350000, 3) + (25000).to_bytes(3, "big")
                                                * 2 + bytes([0, 0x40]))),
    "grib1-polar-south-oblate": lambda: _grib1(_g1_gds(
        5, _sm(10000, 3) + (25000).to_bytes(3, "big") * 2 + bytes([0x80, 0]), la1=-60.0,
        flags=0x40)),
    "grib1-lambert-oblate": lambda: _grib1(_g1_gds(
        3, _sm(9000, 3) + (2500).to_bytes(3, "big") * 2 + bytes([0, 0x40]) + _sm(46000, 3)
        + _sm(49000, 3), la1=46.0, lo1=8.0, flags=0x40)),
    "grib1-gaussian-thinned": lambda: _grib1(
        (lambda gds: gds[:5] + b"\x04" + gds[6:])(
            grib_tests._g1_gds_latlon_thinned([2, 4, 4, 2], 55.0, 4.0, 53.5, 5.5)),
        values=np.arange(12.0)),
    "grib1-representation-2": lambda: _grib1(_g1_gds(2, bytes(20))),
    "grib1-predefined-bitmap": lambda: _grib1(
        grib_tests._g1_gds_latlon(5, 4, 55.0, 4.0, 53.5, 6.0, 0.5, 0.5),
        bms=(6).to_bytes(3, "big") + bytes([0, 0, 9]), has_bms=True),
    "grib1-spherical-harmonics": lambda: grib_tests._g1_message(
        grib_tests._g1_pds(), grib_tests._g1_gds_latlon(5, 4, 55.0, 4.0, 53.5, 6.0, 0.5, 0.5),
        b"", grib_tests._g1_bds(np.arange(20.0), 0.0, 0, 0, 8, flags=0x8)),
    "grib1-decade-units-isobaric": lambda: _grib1(
        grib_tests._g1_gds_latlon(5, 4, 55.0, 4.0, 53.5, 6.0, 0.5, 0.5), time_unit=10, p1=2,
        trange=10, level_type=100, level=500),
    "edition-3": lambda: (lambda raw: raw[:7] + b"\x03" + raw[8:])(_grib2()),
}


@pytest.mark.parametrize("name", list(BRANCHES))
def test_branch(tmp_path, name):
    """A message through a branch of the reader that tests/test_grib.py
    does not reach (the earth's shapes and radii, the projected GRIB1
    grids and the oblate earth, thinned Gaussian rows, a reused bitmap,
    24-bit PNG samples, CCSDS cells of 2, 3 and 4 bytes in either byte
    order, and the refusals), in each package: the same payload or error."""
    def case(k, root):
        path = str(root / "branch.grib2")
        with open(path, "wb") as f:
            f.write(BRANCHES[name]())
        return outcome(lambda: k.grib.read_grib(path), root)

    run_both(tmp_path, lambda k, root: case(_gkit(k), root))


def _gkit(kit):
    """``_kit`` with the package's GRIB module."""
    kit.grib = grib if kit.port else jax_grib
    return kit


# --- the complex-packing decode against the JAX loop ---


@st.composite
def complex_layouts(draw):
    """(section 5, section 7, npts, template) of a random complex-packed
    field: 0-40 groups of widths 0-32 and lengths that a reference, an
    increment and a scaled list give, missing-value management 0 or 1
    (values and references of all ones), template 5.2 or 5.3 of order 1 or
    2; at times a declared point count one off, a missing-value
    management or order the decoders refuse, or a stream cut short or
    padded."""
    template = draw(st.sampled_from([2, 3]))
    ng = draw(st.integers(0, 40))
    nbits = draw(st.integers(0, 32))
    mgmt = draw(st.sampled_from([0, 1, 1, 2] if template == 2 else [0, 0, 0, 1]))
    widths = draw(st.lists(st.integers(0, 32), min_size=ng, max_size=ng))
    width_ref = draw(st.integers(0, min(widths, default=0)))
    width_bits = max([w - width_ref for w in widths], default=0).bit_length()
    width_bits += draw(st.integers(0, 2))
    len_ref, len_inc = draw(st.integers(0, 5)), draw(st.integers(1, 3))
    scaled = draw(st.lists(st.integers(0, 6), min_size=ng, max_size=ng))
    len_bits = max(scaled, default=0).bit_length() + draw(st.integers(0, 1))
    last_len = draw(st.integers(0, 12))
    lengths = [s * len_inc + len_ref for s in scaled[:-1]] + ([last_len] if ng else [])
    npts = sum(lengths) + draw(st.sampled_from([0, 0, 0, 0, 1, -1]))
    ones = (1 << nbits) - 1
    refs = [draw(st.sampled_from([0, ones, ones]) | st.integers(0, ones)) for _ in range(ng)]
    values = []
    for width, length in zip(widths, lengths):
        top = (1 << width) - 1
        values += [(draw(st.sampled_from([0, top]) | st.integers(0, top)), width)
                   for _ in range(length if width else 0)]
    order = draw(st.sampled_from([1, 2, 2, 3])) if template == 3 else 0
    nb = draw(st.integers(1, 4)) if template == 3 else 0
    descriptors = b"".join(_sm(draw(st.integers(-(1 << (8 * nb - 1)) + 1, (1 << (8 * nb - 1)) - 1)),
                               nb) for _ in range(max(order, 1) + 1)) if template == 3 else b""
    stream = (descriptors + _pack_bits(refs, nbits) + _pack_bits(widths, width_bits)
              + _pack_bits([(length - len_ref) // len_inc for length in lengths], len_bits))
    bits = "".join(format(v, "0%db" % w) for v, w in values)
    bits += "0" * (-len(bits) % 8)
    stream += bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
    cut = draw(st.sampled_from([0, 0, 0, 1, 2, 5]))
    stream = stream[: max(len(stream) - cut, 0)] + bytes(draw(st.sampled_from([0, 0, 3])))
    sec5 = (struct.pack(">IH", max(npts, 0), template) + struct.pack(">f", 0.5) + _sm(-1, 2)
            + _sm(1, 2) + bytes([nbits, 0, 1, mgmt]) + bytes(8)
            + struct.pack(">IBBIBIB", ng, width_ref, width_bits, len_ref, len_inc, last_len,
                          len_bits)
            + (bytes([order, nb]) if template == 3 else b""))
    return _section(5, sec5), _section(7, stream), max(npts, 0), template


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(complex_layouts())
def test_complex_decode_equals_the_jax_loop(layout):
    """_complex_groups' integers and missing flags, and the decoded values
    of templates 5.2 and 5.3, or the error, are the JAX loop's."""
    sec5, sec7, npts, template = layout
    offset = (sec5[47] + 1) * sec5[48] * 8 if template == 3 else 0
    assert_same(outcome(lambda: grib._complex_groups(sec5, sec7, npts, offset)),
                outcome(lambda: jax_grib._complex_groups(sec5, sec7, npts, offset)))
    decode = "_decode_complex" if template == 2 else "_decode_complex_diff"
    assert_same(outcome(lambda: getattr(grib, decode)(sec5, sec7, npts)),
                outcome(lambda: getattr(jax_grib, decode)(sec5, sec7, npts)))


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.binary(max_size=80), st.integers(0, 80), st.integers(0, 70), st.integers(0, 20))
def test_unpack_bits_equals_jax(data, count, nbits, offset):
    """_unpack_bits over arbitrary bytes, widths up to 70 bits (the last 64
    of a wider field, in two's complement, as the JAX matrix product keeps
    them) and bit offsets: the JAX package's integers or error."""
    assert_same(outcome(lambda: grib._unpack_bits(data, nbits, count, offset)),
                outcome(lambda: jax_grib._unpack_bits(data, nbits, count, offset)))


def test_complex_groups_at_a_field_size():
    """chip_smoke's second-order differenced field at 1215 x 746 points,
    in about 26,000 groups, decodes to the JAX loop's values."""
    rain = chip_smoke.forecast_rain(1, seed=5)[0]
    sec5, sec7, groups = chip_smoke.grib_c3_field(rain, np.random.default_rng(5))
    assert groups > 20000
    ours, _ = grib._decode_complex_diff(sec5, sec7, rain.size)
    theirs, _ = jax_grib._decode_complex_diff(sec5, sec7, rain.size)
    assert_same(ours, theirs)
    np.testing.assert_array_equal(ours, chip_smoke.grib_values(rain.ravel()))


# --- tests/test_format_robustness.py's damage, for both editions ---


def _c3_bytes():
    """A one-message file of chip_smoke's writer in complex packing with
    second-order spatial differencing."""
    rain = chip_smoke.forecast_rain(1, 24, 16, seed=3)[0]
    sec5, sec7, _ = chip_smoke.grib_c3_field(rain, np.random.default_rng(3))
    return chip_smoke.grib2_message([
        chip_smoke.grib_identification(chip_smoke.GRIB_RUN), chip_smoke.grib_latlon_grid(24, 16),
        chip_smoke.grib_apcp_product(0, chip_smoke.GRIB_RUN), sec5,
        _section(6, bytes([255])), sec7])


PAYLOADS = {"grib2": (_grib2_bytes, "x.grib2"), "grib1": (_grib1_bytes, "x.grb"),
            "grib2-complex": (_c3_bytes, "x.grib2")}


def assert_same_outcome(path, root):
    """The port's read_grib gives the JAX package's payload, or an error of
    the same type, with the same message where it is the format's own."""
    theirs = outcome(lambda: JAX_READ_GRIB(path), root)
    ours = outcome(lambda: grib.read_grib(path), root)
    assert ours[0] == theirs[0], (ours, theirs)
    if theirs[0] == "result":
        assert_same(ours[1], theirs[1])
        return
    assert ours[1][0] == theirs[1][0], (ours, theirs)
    if not theirs[1][1].startswith("Corrupt or truncated GRIB file"):
        assert ours[1][1] == theirs[1][1]


@pytest.mark.parametrize("which", list(PAYLOADS))
def test_truncations(tmp_path, which):
    """Every truncation point of tests/test_format_robustness.py."""
    build, name = PAYLOADS[which]
    payload = build()
    path = str(tmp_path / name)
    for cut in range(4, len(payload), max(len(payload) // 24, 1)):
        with open(path, "wb") as f:
            f.write(payload[:cut])
        assert_same_outcome(path, tmp_path)


@pytest.mark.parametrize("which", list(PAYLOADS))
def test_byte_corruptions(tmp_path, which):
    """tests/test_format_robustness.py's 60 corruptions of 1-3 bytes, and
    60 more of the same kind."""
    build, name = PAYLOADS[which]
    payload = build()
    path = str(tmp_path / name)
    for seed in (zlib.crc32(which.encode()), 7):
        rng = np.random.RandomState(seed)
        for _ in range(60):
            corrupt = bytearray(payload)
            for _ in range(rng.randint(1, 4)):
                corrupt[rng.randint(4, len(corrupt))] = rng.randint(256)
            with open(path, "wb") as f:
                f.write(bytes(corrupt))
            assert_same_outcome(path, tmp_path)


# --- the dispatch ---


@pytest.mark.parametrize("suffix", GRIB_SUFFIXES)
def test_every_suffix_reads_whole(tmp_path, suffix):
    """A GRIB file under each suffix: not refused, ``info`` equal to the
    JAX package's, the read cache's payload the reader's, and no window
    read even under a windowed-read limit of one cell."""
    name = "a" + suffix
    grib_tests._write(tmp_path, grib_tests._simple_message(np.arange(35).reshape(5, 7)), name)
    path = str(tmp_path / name)
    pipeline.check_ported_format(path)
    assert pipeline.whole_file_reader(path) is grib.read_grib
    pipeline.clear_read_cache()
    jax_pipeline.clear_read_cache()
    with both_configs({"geomodeling.root": str(tmp_path),
                       "geomodeling.windowed-read-limit": 1}):
        source = RasterFileSource(name)
        assert info_fields(source.info) == info_fields(jax_raster.RasterFileSource(name).info)
        assert_same(pipeline.read_geotiff_cached(path), JAX_READ_GRIB(path))
        request = dict(mode="vals", bbox=(3.75, 53.25, 7.25, 55.25), projection="EPSG:4326",
                       width=7, height=4)
        assert source._file_read_plan(request) is None
        with mock.patch.object(pipeline, "read_geotiff_window_cached",
                               side_effect=AssertionError("a window read")):
            assert_agrees(jax_raster.RasterFileSource(name), request)
    pipeline.clear_read_cache()


# --- RasterFileSource through from_reference, and the grib-forecast view ---


def _forecast(tmp_path, hours=6):
    path, rain, _ = chip_smoke.write_forecast_grib(
        str(tmp_path), GRIB_SMALL["ni"], GRIB_SMALL["nj"], hours, origin=GRIB_SMALL["origin"])
    return path, rain


def _jax_forecast_source(path):
    return jax_raster.RasterFileSource(os.path.basename(path), time_first=chip_smoke.GRIB_RUN,
                                       time_delta=timedelta(hours=1))


def agrees_within_share(ours, theirs):
    """Two answers of the same dtype, shape and nodata, at most
    HEADLINE_SHARE of their cells differing."""
    return (ours["no_data_value"] == theirs["no_data_value"]
            and within_share(ours["values"], theirs["values"]))


def assert_agrees_in(jax_view, request):
    """``assert_agrees`` at a geographic request; in RD New compute_host
    bitwise and get_data on the CPU within HEADLINE_SHARE."""
    if request["projection"] == "EPSG:4326":
        return assert_agrees(jax_view, request)
    expected = jax_numpy(jax_view, request)
    view = from_reference(jax_view.serialize())
    assert_same(compute_host(*view.get_compute_graph(**request)), expected)
    assert agrees_within_share(view.get_data(device="cpu", **request), expected)
    return view, expected


@pytest.mark.parametrize("projection", ["EPSG:4326", "EPSG:28992"])
@pytest.mark.parametrize("edition", [2, 1])
def test_file_source_from_reference(tmp_path, edition, projection):
    """chip_smoke's GRIB2 forecast (both packings) and its GRIB1 archive
    under a RasterFileSource of the JAX package's classes come across with
    from_reference and answer its numpy executor at the file's grid
    (bitwise) and in RD New; info, meta and time are the same."""
    pipeline.clear_read_cache()
    jax_pipeline.clear_read_cache()
    if edition == 2:
        path, _ = _forecast(tmp_path)
        times = dict(start=chip_smoke.GRIB_RUN, stop=chip_smoke.GRIB_RUN + timedelta(hours=5))
    else:
        path, _ = chip_smoke.write_grib1_archive(str(tmp_path))
        times = dict(start=None, stop=None)
    with both_configs({"geomodeling.root": str(tmp_path)}):
        jax_source = (_jax_forecast_source(path) if edition == 2
                      else jax_raster.RasterFileSource(os.path.basename(path)))
        info = jax_source.info
        if projection == "EPSG:4326":
            request = chip_smoke.grib_request(info.geo_transform, info.width, info.height,
                                              info.bands)
        else:
            request = chip_smoke.grib_rd_request(GRIB_SMALL["rd_bbox"], 1000.0, info.bands)
        request.update(times)
        view, expected = assert_agrees_in(jax_source, request)
        assert expected["values"].shape[0] == info.bands
        assert info_fields(view.info) == info_fields(info)
        for mode in ("meta", "time"):
            assert (view.get_data(device="cpu", mode=mode, **times)
                    == jax_source.get_data(mode=mode, **times))
    pipeline.clear_read_cache()


@pytest.mark.parametrize("projection", ["EPSG:4326", "EPSG:28992"])
def test_forecast_view_against_jax_numpy(tmp_path, projection):
    """chip_smoke's writer and the grib-forecast view at 320 x 75 points
    and six hourly fields (three in each packing): the view built with the
    JAX package's classes comes across with from_reference and answers its
    numpy executor (compute_host bitwise; get_data and 64^2 tiles through
    evaluate_tiled bitwise at the file's grid, within HEADLINE_SHARE in RD
    New), and chip_smoke's own build answers the same; the whole read is
    the values written, in both packages."""
    pipeline.clear_read_cache()
    jax_pipeline.clear_read_cache()
    path, rain = _forecast(tmp_path)
    expected_read = np.stack([chip_smoke.grib_values(frame) for frame in rain])
    np.testing.assert_array_equal(grib.read_grib(path).array, expected_read)
    np.testing.assert_array_equal(JAX_READ_GRIB(path).array, expected_read)
    with both_configs({"geomodeling.root": str(tmp_path)}):
        jax_source = _jax_forecast_source(path)
        jax_view = jax_raster.Classify(jax_raster.Smooth(jax_raster.TemporalAggregate(
            jax_source, chip_smoke.GRIB_AGGREGATE, statistic="sum"), chip_smoke.GRIB_SMOOTH_M),
            chip_smoke.GRIB_BINS)
        if projection == "EPSG:4326":
            info = jax_source.info
            request = chip_smoke.grib_request(info.geo_transform, info.width, info.height, 6)
        else:
            request = chip_smoke.grib_rd_request(GRIB_SMALL["rd_bbox"], 1000.0, 6)
        _, expected = assert_agrees_in(jax_view, request)
        assert expected["values"].shape[0] == 2
        assert len(np.unique(expected["values"])) >= 2
        view = chip_smoke.build_grib_view(path)
        assert_same(compute_host(*view.get_compute_graph(**request)), expected)
        tiled = evaluate_tiled(view, request, tile_size=64, batch=8, device="cpu")
        tiles, nx = tile_requests(request, 64)
        for index in range(0, len(tiles), 3):
            (rows, cols), (tile_rows, tile_cols) = chip_smoke.tile_cells(
                index, nx, request["width"], request["height"], 64)
            want = jax_numpy(jax_view, tiles[index])
            got = dict(want, values=tiled["values"][:, rows, cols])
            want = dict(want, values=want["values"][:, tile_rows, tile_cols])
            if projection == "EPSG:4326":
                assert_same(got, want)
            else:
                assert agrees_within_share(got, want)
    pipeline.clear_read_cache()


def test_the_phase_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke's check_grib_forecast on CPU tensors at GRIB_SMALL, 64^2
    tiles in batches of 8: its checks hold (the Gaussian's launches counted
    where the card would launch it), and it removes its files."""
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.raster import spatial

    def launching(*args, **kwargs):
        cuda_stencils.launches += 1
        return cuda_stencils.gaussian_blur_reference(*args, **kwargs)

    monkeypatch.setattr(spatial, "gaussian_blur", launching)
    monkeypatch.setattr(chip_smoke, "TILE", 64)
    monkeypatch.setattr(chip_smoke, "BATCH", 8)
    launches, numbers, kernels = chip_smoke.check_grib_forecast("cpu", "cpu", str(tmp_path),
                                                                **GRIB_SMALL)
    assert launches["gaussian_blur"] >= 3 and launches["moving_max"] == 0
    assert numbers["batches_a"] >= 2 and kernels == []
    assert numbers["groups"][0] > 600 and not list(tmp_path.iterdir())


def test_writers():
    """chip_smoke's bit packer writes tests/test_grib.py's bitstreams; its
    IBM float is the JAX reader's value; its GRIB1 archive is recipe 8's
    grid."""
    rng = np.random.default_rng(2)
    for nbits in (1, 3, 8, 12, 17, 32):
        values = rng.integers(0, 1 << nbits, 101)
        assert chip_smoke.pack_bits(values, nbits) == _pack_bits(values, nbits)
    widths = rng.integers(0, 20, 300)
    values = np.array([rng.integers(0, 1 << w) if w else 0 for w in widths])
    bits = "".join(format(int(v), "0%db" % w) if w else "" for v, w in zip(values, widths))
    bits += "0" * (-len(bits) % 8)
    expected = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
    assert chip_smoke.pack_bits(values, widths) == expected
    for value in (3.75, -0.1, 1e-3, 250.0):
        raw = int.from_bytes(chip_smoke.ibm_float(value), "big")
        assert grib._ibm_float(raw) == jax_grib._ibm_float(raw)
        assert abs(grib._ibm_float(raw) - value) <= abs(value) * 2 ** -20
