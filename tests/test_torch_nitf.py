"""The port's NITF reader (io/nitf.py), its dispatch in the read cache and
``RasterFileSource``, and chip_smoke's NITF writer and parcel-imagery
view, held on the CPU to the JAX package's.

Every case of tests/test_nitf.py runs once in each package (``run_both``
of tests/test_torch_raster_formats.py), the test itself with its own
encoder and assertions, its ``read_nitf`` and ``read_nitf_info`` the
package's: the files are byte-identical, and every payload, header info
and error the same (arrays bitwise with their dtypes, geotransforms
exactly; errors by type and message).  ``test_masked_jpeg_blocks`` has
its own case, run once per package too: the JAX package decodes the JPEG
blocks with Pillow, the port with its native codec, to the same arrays.
A JPEG 2000 segment (C8, M8) raises NotImplementedError naming
dask_geomodeling_tpu/io/nitf.py; a C3 or M3 segment whose codestream is
no JPEG raises OSError in both packages.  The branches that file
leaves out are written with chip_smoke's encoder (NITF 2.0 with and
without a downgrade event, every pixel type, IMODE B, S and P with
padded edge blocks, ABPP masking, ICORDS G, D, N and U and rotated
corners, NM with and without a block mask and with pad-pixel mask
records, two segments, LUT bands, a bad IC) and read alike, under
hypothesis too; a file cut at every 24th of its length, or under a bad
magic, raises the same error in both.  ``.ntf`` and ``.nitf`` reach the
reader through ``info`` and the read cache and never by window; a
``RasterFileSource`` over chip_smoke's scene and the parcel-imagery
view built with the JAX package's classes come across with
``from_reference`` and answer its numpy executor, and the phase's checks
hold on the CPU.

Tolerance: none.  Payloads, info, compute_host and get_data at the
scene's grid are held bitwise; in RD New get_data within chip_smoke's
HEADLINE_SHARE, the port's rule for a cross-CRS nearest warp on the
device path.
"""
import dataclasses
import os
import struct
from unittest import mock

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
import tests.test_nitf as nitf_tests
from dask_geomodeling_tpu import raster as jax_raster
from dask_geomodeling_tpu.io import nitf as jax_nitf
from dask_geomodeling_tpu.runtime import pipeline as jax_pipeline
from dask_geomodeling_tpu_torch import compute_host, evaluate_tiled, from_reference
from dask_geomodeling_tpu_torch.io import nitf
from dask_geomodeling_tpu_torch.raster import RasterFileSource
from dask_geomodeling_tpu_torch.runtime import pipeline
from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests
from tests.test_torch_file_sources import assert_agrees, both_configs, jax_numpy
from tests.test_torch_grib import agrees_within_share
from tests.test_torch_hdf4 import outcome
from tests.test_torch_raster_formats import assert_same, run_both
from tests.test_torch_zarr import info_fields

#: the JAX package's reader, before any case replaces it
JAX_READ_NITF = jax_nitf.read_nitf
JAX_READ_NITF_INFO = jax_nitf.read_nitf_info
COMPRESSED = ("C3", "C8", "M3", "M8")
#: chip_smoke's parcel-imagery phase at a small size: a 512^2 scene in
#: 128^2 blocks (20 m pixels over the same 10 km), 16 x 16 parcels of
#: 600 m, the sub-area and sampled tiles at the same places
PARCELS_SMALL = dict(px=512, block=128, sampled=((0, 5), (0, 6), (2, 6), (6, 0), (7, 2), (4, 4)),
                     grid=16, cell=600.0, sub=((42, 349), (162, 469)))


def _kind(result):
    """A header info as a dict, to compare across packages."""
    if dataclasses.is_dataclass(result) and not hasattr(result, "array"):
        return info_fields(result)
    return result


def _reading(read, root, results):
    """``read`` recording what it returns or raises in ``results``."""
    def reading(path):
        kind, value = outcome(lambda: read(path), root)
        results.append((kind, _kind(value)))
        if kind == "error":
            return read(path)  # raise the error itself, for pytest.raises
        return value
    return reading


# --- tests/test_nitf.py, every case, in each package ---


def _parametrized(function):
    combos = [{}]
    for mark in getattr(function, "pytestmark", []):
        if mark.name == "parametrize":
            name, values = mark.args
            combos = [dict(combo, **{name: value}) for combo in combos for value in values]
    return combos


#: cases with their own version below: the JPEG blocks, and the
#: RasterFileSource test, which builds the JAX package's blocks
OWN_CASES = ("test_masked_jpeg_blocks", "test_raster_file_source_serves_nitf")
JAX_CASES = {
    name[len("test_"):] + "".join("[%s=%r]" % kv for kv in combo.items()): (function, combo)
    for name, function in vars(nitf_tests).items()
    if name.startswith("test_") and callable(function) and name not in OWN_CASES
    for combo in _parametrized(function)
}


def run_case(test, combo):
    """The case ``test(**combo)`` of tests/test_nitf.py in one package,
    its readers the package's, recorded."""
    def case(k, root):
        results = []
        read = _reading(nitf.read_nitf if k.port else JAX_READ_NITF, root, results)
        info = _reading(nitf.read_nitf_info if k.port else JAX_READ_NITF_INFO, root, results)
        with mock.patch.object(nitf_tests, "read_nitf", read), \
                mock.patch.object(nitf_tests, "read_nitf_info", info):
            test(root, **combo)
        return results
    return case


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_jax_case(tmp_path, name):
    """One case of tests/test_nitf.py, in each package."""
    assert run_both(tmp_path, run_case(*JAX_CASES[name]))


def test_masked_jpeg_blocks(tmp_path):
    """tests/test_nitf.py's M3 segment in each package: the JAX package
    decodes its JPEG blocks with Pillow, the port with its native codec;
    the payloads and the header info are the same."""
    assert run_both(tmp_path, run_case(nitf_tests.test_masked_jpeg_blocks, {}))


def _raster_file_source_serves_nitf(k, root):
    """tests/test_nitf.py's RasterFileSource case, with the package's blocks
    and get_data (the JAX package's on its numpy executor)."""
    from datetime import datetime

    values = np.arange(64, dtype=np.uint8).reshape(1, 8, 8)
    path = nitf_tests._make_nitf(root, values)
    source = k.R.RasterFileSource(path, time_first=datetime(2000, 1, 1))
    assert source.dtype == np.uint8
    data = k.get_data(source, mode="vals", bbox=source._get_extent().bbox,
                      projection="EPSG:4326", width=8, height=8, start=datetime(2000, 1, 1))
    np.testing.assert_array_equal(data["values"], values)
    return data


def test_raster_file_source_serves_nitf(tmp_path):
    run_both(tmp_path, _raster_file_source_serves_nitf)


# --- the branches tests/test_nitf.py leaves out, with chip_smoke's encoder ---


def _igeolo(corners, icords="D"):
    """IGEOLO of (lat, lon) corners UL, UR, LR, LL: decimal degrees, or
    DMS from whole arcseconds."""
    if icords == "D":
        return "".join("%+07.3f%+08.3f" % corner for corner in corners)

    def dms(value, width, hemispheres):
        seconds = int(round(abs(value) * 3600))
        d, rest = divmod(seconds, 3600)
        return "%0*d%02d%02d%s" % (width - 4, d, *divmod(rest, 60),
                                   hemispheres[value < 0])
    return "".join(dms(lat, 6, "NS") + dms(lon, 7, "EW") for lat, lon in corners)


CORNERS = [(52.0, 4.0), (52.0, 4.07), (51.95, 4.07), (51.95, 4.0)]
#: rotated: the image's top edge runs south-east
ROTATED = [(52.0, 4.0), (51.98, 4.07), (51.93, 4.05), (51.95, 3.98)]


def _mask(present, record, pad=b"\x00", pad_records=False):
    """An NM mask: chip_smoke's, or with pad-pixel mask records after the
    block offsets (TMRLNTH = 4)."""
    if not pad_records:
        return chip_smoke.nitf_block_mask(present, record, pad)
    offsets, at = [], 0
    for kept in present:
        offsets.append(at if kept else 0xFFFFFFFF)
        at += record if kept else 0
    head = 10 + len(pad) + 8 * len(offsets)
    return (struct.pack(">IHHH", head, 4, 4, 8 * len(pad)) + pad
            + struct.pack(">%dI" % len(offsets), *offsets)
            + struct.pack(">%dI" % len(offsets), *([0xFFFFFFFF] * len(offsets))))


def nitf_bytes(values, version="2.1", imode="B", nbpr=1, nbpc=1, nppbh=None, nppbv=None,
               pvtype="INT", nbpp=None, abpp=None, icords="D", corners=CORNERS, ic="NC",
               absent=(), pad=b"\x00", pad_records=False, dense_mask=False, downgrade=False,
               comments=0, xbands=False, segments=1):
    """A NITF file of ``values`` (bands, rows, columns) in ``segments``
    identical segments, written with chip_smoke's encoder; ``absent``
    records left out of an NM segment's payload."""
    values = np.asarray(values)
    bands, nrows, ncols = values.shape
    nppbh, nppbv = nppbh or ncols, nppbv or nrows
    payload = nitf_tests._blocked_payload(values, imode if imode in "BSP" else "B", nbpr, nbpc,
                                          nppbh, nppbv, values.dtype)
    if ic in ("NM", "M3", "M8"):
        records = nbpr * nbpc * (bands if imode == "S" else 1)
        record = len(payload) // records
        if dense_mask:
            payload = struct.pack(">IHHH", 10 + len(pad), 0, 0, 8 * len(pad)) + pad + payload
        else:
            present = [k not in absent for k in range(records)]
            payload = _mask(present, record, pad, pad_records) + b"".join(
                payload[k * record:(k + 1) * record] for k in range(records) if present[k])
    igeolo = _igeolo(corners, icords) if icords in ("G", "D") else "32631" + "0" * 55
    subheader = chip_smoke.nitf_image_subheader(
        bands, nrows, ncols, version=version, pvtype=pvtype,
        nbpp=nbpp or values.dtype.itemsize * 8, abpp=abpp, irep="MULTI" if bands > 1 else "MONO",
        icords=icords, igeolo=igeolo, ic=ic, imode=imode, nbpr=nbpr, nbpc=nbpc, nppbh=nppbh,
        nppbv=nppbv, comments=comments, xbands=xbands)
    header = chip_smoke.nitf_file_header([(len(subheader), len(payload))] * segments, version,
                                         downgrade)
    return header + (subheader + payload) * segments


GRID = np.random.RandomState(7).randint(0, 200, (3, 10, 13)).astype(np.uint8)


def _typed(dtype):
    """2 x 9 x 11 values over ``dtype``'s range (a float's: normal, x 1000),
    the same at every call."""
    rng = np.random.RandomState(11)
    if np.dtype(dtype).kind == "f":
        return (rng.standard_normal((2, 9, 11)) * 1e3).astype(dtype)
    info = np.iinfo(dtype)
    return rng.randint(max(info.min, -2**31), min(info.max, 2**31 - 1), (2, 9, 11)).astype(dtype)


def _lut(raw):
    """A file whose first band declares a LUT (NLUTS 1)."""
    at = raw.index(b"  " + b" " * 6 + b"N   0")
    return raw[:at + 12] + b"1" + raw[at + 13:]


def _segments(raw):
    """The (subheader, data) pairs of a NITF file."""
    _, at, segments = nitf._parse_header(raw)
    out = []
    for lish, li in segments:
        out.append((raw[at:at + lish], raw[at + lish:at + lish + li]))
        at += lish + li
    return out


def join_segments(*raws):
    """One NITF file of the image segments of ``raws``, in order."""
    parts = [part for raw in raws for part in _segments(raw)]
    return (chip_smoke.nitf_file_header([(len(sub), len(data)) for sub, data in parts])
            + b"".join(sub + data for sub, data in parts))


BRANCHES = {
    "nitf-2.0": lambda: nitf_bytes(GRID, version="2.0"),
    "nitf-2.0-downgrade-event": lambda: nitf_bytes(GRID, version="2.0", downgrade=True),
    "nitf-2.0-icords-n-no-igeolo": lambda: nitf_bytes(GRID, version="2.0", icords="N"),
    **{"pixel-%s-%s" % (pv, np.dtype(dt).name): (lambda pv, dt: lambda: nitf_bytes(
        _typed(dt), pvtype=pv))(pv, dt)
       for pv, dt in [("INT", np.uint8), ("INT", np.uint16), ("INT", np.uint32),
                      ("SI", np.int8), ("SI", np.int16), ("SI", np.int32),
                      ("R", np.float32), ("R", np.float64)]},
    "pixel-si-64-refused": lambda: nitf_bytes(_typed(np.int32), pvtype="SI", nbpp=64),
    **{"imode-%s-padded" % mode: (lambda mode: lambda: nitf_bytes(
        GRID, imode=mode, nbpr=4, nbpc=3, nppbh=4, nppbv=4))(mode) for mode in "BSP"},
    "imode-x": lambda: nitf_bytes(GRID, imode="X"),
    "abpp-11-of-16": lambda: nitf_bytes((_typed(np.uint16) | 0xF800).astype(np.uint16),
                                        abpp=11),
    "abpp-11-signed-not-masked": lambda: nitf_bytes(_typed(np.int16), pvtype="SI", abpp=11),
    "icords-g": lambda: nitf_bytes(GRID, icords="G", corners=[(52.0, 4.0), (52.0, 4.0 + 12 / 3600),
                                                             (52.0 - 9 / 3600, 4.0 + 12 / 3600),
                                                             (52.0 - 9 / 3600, 4.0)]),
    "icords-g-south-west": lambda: nitf_bytes(GRID, icords="G", corners=[
        (-33.0, -70.0), (-33.0, -70.0 + 12 / 3600), (-33.0 - 9 / 3600, -70.0 + 12 / 3600),
        (-33.0 - 9 / 3600, -70.0)]),
    "icords-d-rotated": lambda: nitf_bytes(GRID, corners=ROTATED),
    "icords-n": lambda: nitf_bytes(GRID, icords="N"),
    "icords-u": lambda: nitf_bytes(GRID, icords="U"),
    "icords-none": lambda: nitf_bytes(GRID, icords=" "),
    "comments-and-xbands": lambda: nitf_bytes(GRID, comments=2, xbands=True),
    "nm-block-mask-b": lambda: nitf_bytes(GRID, ic="NM", nbpr=4, nbpc=3, nppbh=4, nppbv=4,
                                          absent=(0, 5, 11), pad=b"\x63"),
    "nm-block-mask-p": lambda: nitf_bytes(GRID, ic="NM", imode="P", nbpr=4, nbpc=3, nppbh=4,
                                          nppbv=4, absent=(3,), pad=b""),
    "nm-block-mask-s-per-band": lambda: nitf_bytes(GRID, ic="NM", imode="S", nbpr=4, nbpc=3,
                                                   nppbh=4, nppbv=4, absent=(0, 13, 35)),
    "nm-pad-records": lambda: nitf_bytes(GRID, ic="NM", nbpr=4, nbpc=3, nppbh=4, nppbv=4,
                                         absent=(2,), pad_records=True),
    "nm-16-bit-pad": lambda: nitf_bytes(_typed(np.uint16), ic="NM", nbpr=3, nbpc=3, nppbh=4,
                                        nppbv=3, absent=(4,), pad=b"\x01\x02"),
    "nm-no-block-mask": lambda: nitf_bytes(GRID, ic="NM", nbpr=4, nbpc=3, nppbh=4, nppbv=4,
                                           dense_mask=True),
    "nm-offset-out-of-range": lambda: (lambda raw: raw[:-10])(
        nitf_bytes(GRID, ic="NM", nbpr=4, nbpc=3, nppbh=4, nppbv=4, absent=(1,))),
    "nm-mask-truncated": lambda: (lambda raw: raw[:raw.index(b"IM") + 600])(
        nitf_bytes(GRID[:1], ic="NM", nbpr=2, nbpc=2, nppbh=8, nppbv=5)),
    "two-segments": lambda: nitf_bytes(GRID, segments=2),
    "two-segments-mismatched": lambda: join_segments(nitf_bytes(GRID[:1]),
                                                     nitf_bytes(GRID[:1, :8])),
    "two-segments-of-two-types": lambda: join_segments(nitf_bytes(GRID[:2]),
                                                       nitf_bytes(_typed(np.uint16)[:1, :10, :13])),
    "lut-band": lambda: _lut(nitf_bytes(GRID)),
    "bad-ic": lambda: nitf_bytes(GRID, ic="XX"),
    "bad-magic": lambda: b"NOTNITF!!" + nitf_bytes(GRID)[9:],
    "no-segments": lambda: chip_smoke.nitf_file_header([]),
    "bad-number": lambda: (lambda raw: raw.replace(b"00000010", b"0000001x", 1))(
        nitf_bytes(GRID)),
    "header-truncated": lambda: nitf_bytes(GRID)[:200],
}


def _read_both(k, root, name, body):
    path = str(root / name)
    with open(path, "wb") as f:
        f.write(body)
    module = nitf if k.port else jax_nitf
    return [outcome(lambda: _kind(read(path)), root)
            for read in (module.read_nitf, module.read_nitf_info)]


@pytest.mark.parametrize("name", list(BRANCHES))
def test_branch(tmp_path, name):
    """A file through a branch of the reader that tests/test_nitf.py does
    not reach, in each package: the same payload and info, or the same
    error."""
    run_both(tmp_path, lambda k, root: _read_both(k, root, "branch.ntf", BRANCHES[name]()))


def test_branches_decode(tmp_path):
    """The branches' payloads are the values written, so that equal
    answers are right ones: IMODE S and P, NITF 2.0, comments and XBANDS,
    two segments, absent NM blocks filled with the pad code, and 11 of 16
    bits kept."""
    path = tmp_path / "a.ntf"
    for name, expected in [("imode-S-padded", GRID), ("imode-P-padded", GRID),
                           ("nitf-2.0-downgrade-event", GRID), ("comments-and-xbands", GRID),
                           ("two-segments", np.concatenate([GRID, GRID]))]:
        path.write_bytes(BRANCHES[name]())
        np.testing.assert_array_equal(nitf.read_nitf(str(path)).array, expected)
    path.write_bytes(BRANCHES["nm-block-mask-b"]())
    expected = GRID.copy()
    for record in (0, 5, 11):
        row, col = divmod(record, 4)
        expected[:, row * 4:(row + 1) * 4, col * 4:(col + 1) * 4] = 0x63
    np.testing.assert_array_equal(nitf.read_nitf(str(path)).array, expected)
    path.write_bytes(BRANCHES["abpp-11-of-16"]())
    assert int(nitf.read_nitf(str(path)).array.max()) < 2048


@pytest.mark.parametrize("ic", COMPRESSED)
def test_compressed_segments_name_the_jax_module(tmp_path, ic):
    """A C3, C8, M3 or M8 segment, alone or behind an NC segment.  JPEG 2000
    (C8, M8): NotImplementedError naming dask_geomodeling_tpu/io/nitf.py
    from read_nitf, read_nitf_info and RasterFileSource.info, where the JAX
    package's info reads the headers.  JPEG (C3, M3), here blocks that are
    no JPEG codestream: the port's payload or error and its header info
    are the JAX package's (OSError from both decoders)."""
    single = nitf_bytes(GRID[:1], ic=ic, nbpr=2, nbpc=2, nppbh=8, nppbv=5)
    (tmp_path / "a.ntf").write_bytes(single)
    (tmp_path / "b.nitf").write_bytes(join_segments(nitf_bytes(GRID[:1]), single))
    for name, bands in (("a.ntf", 1), ("b.nitf", 2)):
        path = str(tmp_path / name)
        if ic in ("C3", "M3"):
            for ours, theirs in ((nitf.read_nitf, JAX_READ_NITF),
                                 (nitf.read_nitf_info, JAX_READ_NITF_INFO)):
                got = outcome(lambda: _kind(ours(path)), tmp_path)
                want = outcome(lambda: _kind(theirs(path)), tmp_path)
                if want[0] == "error":
                    assert got[0] == "error" and want[1][0] in ("OSError",
                                                                 "UnidentifiedImageError")
                    assert got[1][0] == "OSError", got
                else:
                    assert_same(got, want)
            assert nitf.read_nitf_info(path).bands == bands
            continue
        for read in (nitf.read_nitf, nitf.read_nitf_info):
            with pytest.raises(NotImplementedError, match="dask_geomodeling_tpu/io/nitf.py"):
                read(path)
        with both_configs({"geomodeling.root": str(tmp_path)}):
            with pytest.raises(NotImplementedError, match=ic):
                RasterFileSource(name).info
        assert JAX_READ_NITF_INFO(path).bands == bands


def test_truncations(tmp_path):
    """A masked file cut at every 24th of its length, and a plain one:
    the port's payload or error is the JAX package's."""
    for body in (BRANCHES["nm-block-mask-b"](), nitf_bytes(GRID)):
        path = str(tmp_path / "cut.ntf")
        for cut in range(4, len(body), max(len(body) // 24, 1)):
            with open(path, "wb") as f:
                f.write(body[:cut])
            for ours, theirs in ((nitf.read_nitf, JAX_READ_NITF),
                                 (nitf.read_nitf_info, JAX_READ_NITF_INFO)):
                got = outcome(lambda: _kind(ours(path)), tmp_path)
                want = outcome(lambda: _kind(theirs(path)), tmp_path)
                assert_same(got, want, "cut at %d" % cut)


@st.composite
def layouts(draw):
    """A random blocked image: dtype, bands, size, blocking, IMODE, and
    for NM the absent records and pad code."""
    pvtype, dtype = draw(st.sampled_from([("INT", np.uint8), ("INT", np.uint16),
                                          ("SI", np.int16), ("R", np.float32)]))
    bands = draw(st.integers(1, 3))
    nrows, ncols = draw(st.integers(1, 9)), draw(st.integers(1, 9))
    nppbv, nppbh = draw(st.integers(1, nrows)), draw(st.integers(1, ncols))
    nbpc, nbpr = -(-nrows // nppbv), -(-ncols // nppbh)
    imode = draw(st.sampled_from("BSP"))
    ic = draw(st.sampled_from(["NC", "NM"]))
    records = nbpr * nbpc * (bands if imode == "S" else 1)
    absent = draw(st.sets(st.integers(0, records - 1), max_size=records)) if ic == "NM" else ()
    seed = draw(st.integers(0, 2**16))
    values = np.random.RandomState(seed).randint(0, 100, (bands, nrows, ncols)).astype(dtype)
    itemsize = np.dtype(dtype).itemsize
    pad = bytes(draw(st.lists(st.integers(0, 255), min_size=itemsize, max_size=itemsize)))
    return nitf_bytes(values, imode=imode, nbpr=nbpr, nbpc=nbpc, nppbh=nppbh, nppbv=nppbv,
                      pvtype=pvtype, ic=ic, absent=tuple(absent), pad=pad)


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow,
                                                                 HealthCheck.function_scoped_fixture])
@given(body=layouts())
def test_layouts_read_alike(tmp_path, body):
    """Random blocked images, NC and NM: the same payload and info."""
    path = str(tmp_path / "h.ntf")
    with open(path, "wb") as f:
        f.write(body)
    for ours, theirs in ((nitf.read_nitf, JAX_READ_NITF), (nitf.read_nitf_info, JAX_READ_NITF_INFO)):
        assert_same(outcome(lambda: _kind(ours(path))), outcome(lambda: _kind(theirs(path))))


# --- the dispatch ---


@pytest.mark.parametrize("suffix", [".ntf", ".nitf", ".NTF"])
def test_every_suffix_reads_whole(tmp_path, suffix):
    """A NITF file under each suffix: not refused, ``info`` equal to the
    JAX package's (from the headers: no segment decoded), the read
    cache's payload the reader's, and no window read even under a
    windowed-read limit of one cell."""
    name = "a" + suffix
    (tmp_path / name).write_bytes(BRANCHES["nm-block-mask-b"]())
    path = str(tmp_path / name)
    pipeline.check_ported_format(path)
    assert pipeline.whole_file_reader(path) is nitf.read_nitf
    pipeline.clear_read_cache()
    jax_pipeline.clear_read_cache()
    with both_configs({"geomodeling.root": str(tmp_path),
                       "geomodeling.windowed-read-limit": 1}):
        with mock.patch.object(nitf, "_decode_blocks", side_effect=AssertionError("decoded")):
            info = RasterFileSource(name).info
        assert info_fields(info) == info_fields(jax_raster.RasterFileSource(name).info)
        assert_same(pipeline.read_geotiff_cached(path), JAX_READ_NITF(path))
        source = jax_raster.RasterFileSource(name)
        x0, dx, _, y0, _, dy = info.geo_transform
        request = dict(mode="vals", bbox=(x0, y0 + 10 * dy, x0 + 13 * dx, y0),
                       projection="EPSG:4326", width=13, height=10)
        assert RasterFileSource(name)._file_read_plan(request) is None
        with mock.patch.object(pipeline, "read_geotiff_window_cached",
                               side_effect=AssertionError("a window read")):
            assert_agrees(source, request)
    pipeline.clear_read_cache()


# --- chip_smoke's scene and view, against the JAX package ---


def _jax_scene_view(path):
    """build_scene_view with the JAX package's classes."""
    R = jax_raster
    source = R.RasterFileSource(os.path.basename(path), time_first=chip_smoke.SCENE_TIME,
                                time_delta=chip_smoke.SCENE_BAND_STEP)
    nir = R.Shift(source, -chip_smoke.SCENE_BAND_STEP)
    total = R.MaskBelow(R.Add(nir, source), 1)
    smooth = R.Clip(R.Smooth(R.Divide(R.Subtract(nir, source), total), chip_smoke.SCENE_SMOOTH_M),
                    total)
    return R.Classify(smooth, chip_smoke.SCENE_BINS), smooth, source


def test_scene_writer(tmp_path):
    """chip_smoke's scene: both readers give the values written (the absent
    blocks the pad code 0), the corners' geotransform, uint16 and 4 bands
    in the info; its blocks are those tests/test_nitf.py's encoder lays
    out."""
    path, values = chip_smoke.write_scene_nitf(str(tmp_path), 256, 64)
    assert values[:, :64, -64:].max() == 0 and values[:, -64:, :64].max() == 0
    assert values[:, 64:192].min() > 0
    ours, theirs = nitf.read_nitf(path), JAX_READ_NITF(path)
    assert_same(ours, theirs)
    np.testing.assert_array_equal(ours.array, values)
    np.testing.assert_allclose(ours.geo_transform, chip_smoke.scene_geo_transform(256), rtol=0,
                               atol=1e-12)
    info = nitf.read_nitf_info(path)
    assert (info.dtype, info.bands, info.width) == ("uint16", 4, 256)
    assert info_fields(info) == info_fields(JAX_READ_NITF_INFO(path))
    x0, dx, _, y0, _, dy = info.geo_transform
    assert abs(dx * 255 * 3600 - 530) < 1e-9 and abs(dy * 255 * 3600 + 330) < 1e-9
    blocks = nitf_tests._blocked_payload(chip_smoke.scene_bands(256), "B", 4, 4, 64, 64,
                                         np.uint16)
    with open(path, "rb") as f:
        raw = f.read()
    record = 4 * 64 * 64 * 2
    kept = [k for k in range(16) if k not in (3, 12)]
    assert raw.endswith(b"".join(blocks[k * record:(k + 1) * record] for k in kept))


@pytest.mark.parametrize("projection", ["EPSG:4326", "EPSG:28992"])
def test_scene_view_against_jax_numpy(tmp_path, projection):
    """The parcel-imagery view at 512^2 built with the JAX package's
    classes comes across with from_reference and answers its numpy
    executor (compute_host bitwise; get_data bitwise at the scene's grid,
    within HEADLINE_SHARE in RD New); chip_smoke's own build and its 64^2
    tiles through evaluate_tiled answer the same; the RasterFileSource's
    info, time and meta are the JAX package's."""
    pipeline.clear_read_cache()
    jax_pipeline.clear_read_cache()
    path, _ = chip_smoke.write_scene_nitf(str(tmp_path), 512, 128)
    with both_configs({"geomodeling.root": str(tmp_path)}):
        jax_view, jax_smooth, jax_source = _jax_scene_view(path)
        if projection == "EPSG:4326":
            request = chip_smoke.scene_request(512)
            view, expected = assert_agrees(jax_view, request)
        else:
            red = chip_smoke.SCENE_TIME + 2 * chip_smoke.SCENE_BAND_STEP
            request = dict(mode="vals", projection=projection, width=200, height=200,
                           bbox=(158000.0, 496500.0, 167000.0, 505500.0), start=red, stop=red)
            expected = jax_numpy(jax_view, request)
            view = from_reference(jax_view.serialize())
            assert_same(compute_host(*view.get_compute_graph(**request)), expected)
            assert agrees_within_share(view.get_data(device="cpu", **request), expected)
        assert np.count_nonzero(expected["values"] == expected["no_data_value"]) > 0
        source = from_reference(jax_source.serialize())
        assert info_fields(source.info) == info_fields(jax_source.info)
        for mode in ("time", "meta"):
            times = dict(start=chip_smoke.SCENE_TIME, stop=chip_smoke.SCENE_TIME
                         + 3 * chip_smoke.SCENE_BAND_STEP)
            assert (source.get_data(device="cpu", mode=mode, **times)
                    == jax_source.get_data(mode=mode, **times))
        ours, _ = chip_smoke.build_scene_view(path)
        assert_same(compute_host(*ours.get_compute_graph(**request)), expected)
        if projection == "EPSG:4326":
            tiled = evaluate_tiled(ours, request, tile_size=64, batch=8, device="cpu")
            tiles, nx = tile_requests(request, 64)
            for index in range(0, len(tiles), 7):
                (rows, cols), (tile_rows, tile_cols) = chip_smoke.tile_cells(
                    index, nx, 512, 512, 64)
                want = jax_numpy(jax_view, tiles[index])["values"][:, tile_rows, tile_cols]
                np.testing.assert_array_equal(tiled["values"][:, rows, cols], want)
    pipeline.clear_read_cache()


def test_the_phase_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke's check_parcel_imagery on CPU tensors at PARCELS_SMALL,
    64^2 tiles in batches of 8: its checks hold (the Gaussian's launches
    counted where the card would launch it), and it removes its files."""
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.raster import spatial

    def launching(*args, **kwargs):
        cuda_stencils.launches += 1
        return cuda_stencils.gaussian_blur_reference(*args, **kwargs)

    monkeypatch.setattr(spatial, "gaussian_blur", launching)
    monkeypatch.setattr(chip_smoke, "TILE", 64)
    monkeypatch.setattr(chip_smoke, "BATCH", 8)
    launches, numbers, kernels = chip_smoke.check_parcel_imagery("cpu", "cpu", str(tmp_path),
                                                                 **PARCELS_SMALL)
    assert launches["gaussian_blur"] >= 8 and launches["moving_max"] == 0
    assert kernels == [] and numbers["features_decoded"]["mean"] >= 256
    assert not list(tmp_path.iterdir())
