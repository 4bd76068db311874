"""The port's native host layer (native/): the LZW and PackBits decoders,
the scanline rasterizer, their g++ build, and chip_smoke's lzw-sheet
phase on the CPU.

- ``tiff_decode_native`` against the port's pure-Python ``_lzw_decode`` and
  ``_packbits_decode`` (the plain versions) and the JAX package's native
  library, byte for byte: the streams of tests/test_geotiff_foreign.py and
  Pillow (libtiff) written files read through both packages, chip_smoke's
  fixture encoder, the 9 to 12-bit width changes and clear codes, truncated
  streams and random bytes under hypothesis; the JAX error texts on corrupt
  input; a small capacity grows;
- the native burn (``burn_mask``, ``burn_values``) against the numpy
  scanline (the native library bypassed) and the JAX package's native
  burn, under hypothesis: vertices on pixel centres, holes, multipolygons,
  int32, float64 and uint8 outputs; the one place the two scanlines part;
- the build: hash-named in ``_build/``, rebuilt after an edit, a failing
  or missing compiler raises (and so do the decoders and the burn: no
  fallback);
- chip_smoke's fixture files decode under Pillow to the values written,
  and its lzw-sheet phase runs on CPU tensors at a small size.
"""
import ctypes
import hashlib
import os
import shutil
import zlib

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
from dask_geomodeling_tpu import native as jax_native
from dask_geomodeling_tpu.geo import geometry as jax_geometry
from dask_geomodeling_tpu.geo import rasterize as jax_rasterize
from dask_geomodeling_tpu.io import geotiff as J
from dask_geomodeling_tpu_torch import evaluate_tiled, native
from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.geo import geometry
from dask_geomodeling_tpu_torch.geo import rasterize
from dask_geomodeling_tpu_torch.io import geotiff as P
from dask_geomodeling_tpu_torch.ops import _build
from tests.test_geotiff_foreign import lzw_encode, packbits_encode, write_minimal_tiff

KINDS = {"lzw": P._lzw_decode, "packbits": P._packbits_decode}


def outcome(func):
    """("ok", value) or ("raised", exception type, message)."""
    try:
        return ("ok", func())
    except Exception as exc:  # compared, not swallowed
        return ("raised", type(exc).__name__, str(exc))


def decode_all(kind, data, expected_size):
    """The port's native decode, the JAX package's native decode and the
    port's plain decode of one chunk."""
    ours = outcome(lambda: native.tiff_decode_native(kind, data, expected_size))
    theirs = outcome(lambda: jax_native.tiff_decode_native(kind, data, expected_size))
    plain = outcome(lambda: KINDS[kind](data))
    return ours, theirs, plain


def assert_same_bytes(kind, data, expected_size=None):
    expected_size = len(data) * 4 if expected_size is None else expected_size
    ours, theirs, plain = decode_all(kind, data, expected_size)
    assert ours[0] == "ok", ours
    assert ours == theirs == plain
    return ours[1]


# --- the decoders on the streams of tests/test_geotiff_foreign.py ---


@pytest.mark.parametrize("seed", range(4))
def test_lzw_roundtrip_random(seed):
    rng = np.random.RandomState(seed)
    data = rng.randint(0, 8, 5000).astype(np.uint8).tobytes()
    assert assert_same_bytes("lzw", lzw_encode(data)) == data


def test_lzw_hand_vector():
    assert assert_same_bytes("lzw", bytes([0x80, 0x11, 0x60, 0x20])) == b"\x45"


def test_packbits_spec_vector():
    packed = bytes.fromhex("FE AA 02 80 00 2A FD AA 03 80 00 2A 22 F7 AA".replace(" ", ""))
    unpacked = bytes.fromhex(
        "AA AA AA 80 00 2A AA AA AA AA 80 00 2A 22 AA AA AA AA AA AA AA AA AA AA".replace(" ", "")
    )
    assert assert_same_bytes("packbits", packed) == unpacked


def test_packbits_roundtrip_random():
    rng = np.random.RandomState(9)
    data = np.repeat(rng.randint(0, 255, 300), rng.randint(1, 9, 300))
    data = data.astype(np.uint8).tobytes()
    assert assert_same_bytes("packbits", packbits_encode(data)) == data


@pytest.mark.parametrize("length", [300, 3000, 30000, 60000])
def test_lzw_width_changes_and_clear_codes(length):
    """Streams long enough to pass 9, 10, 11 and 12-bit codes and to fill
    the table (a ClearCode at 4094 entries), from both encoders."""
    rng = np.random.RandomState(length)
    data = rng.randint(0, 40, length).astype(np.uint8)
    for stream in (lzw_encode(data.tobytes()), chip_smoke.lzw_encode(data)):
        assert assert_same_bytes("lzw", stream) == data.tobytes()
    codes = _codes(chip_smoke.lzw_encode(data))
    widths = {w for _, w in codes}
    if length >= 30000:
        assert widths == {9, 10, 11, 12}
        assert sum(1 for code, _ in codes if code == 256) > 1  # a clear after the first
    assert codes[0] == (256, 9) and codes[-1][0] == 257


def _codes(stream):
    """(code, width) of a TIFF LZW stream, read as the decoders read it."""
    acc = nbits = pos = 0
    width, next_code, prev, out = 9, 258, None, []
    while True:
        while nbits < width:
            if pos >= len(stream):
                return out
            acc = ((acc << 8) | stream[pos]) & 0xFFFFFFFF
            pos += 1
            nbits += 8
        nbits -= width
        code = (acc >> nbits) & ((1 << width) - 1)
        out.append((code, width))
        if code == 256:
            width, next_code, prev = 9, 258, None
            continue
        if code == 257:
            return out
        if prev is not None:
            next_code += 1
            if next_code == (1 << width) - 1 and width < 12:
                width += 1
        prev = code


@pytest.mark.parametrize("kind", ["lzw", "packbits"])
def test_truncated_streams(kind):
    """A stream cut anywhere decodes to a prefix of the whole, alike in
    every decoder."""
    rng = np.random.RandomState(3)
    data = np.repeat(rng.randint(0, 9, 2000), rng.randint(1, 5, 2000)).astype(np.uint8)
    stream = (chip_smoke.lzw_encode(data) if kind == "lzw"
              else chip_smoke.packbits_encode(data[None]))
    for cut in sorted({0, 1, 2, 3, 7, len(stream) // 3, len(stream) // 2, len(stream) - 1}):
        decoded = assert_same_bytes(kind, stream[:cut], len(data))
        assert data.tobytes().startswith(decoded)


def test_fixture_encoders_against_the_test_encoders():
    """chip_smoke's C++ encoders write streams the test encoders' decoders
    read, on data of every kind of run."""
    rng = np.random.RandomState(4)
    for data in (np.zeros(70000, np.uint8), rng.randint(0, 256, 20000).astype(np.uint8),
                 np.repeat(rng.randint(0, 5, 3000), rng.randint(1, 300, 3000)).astype(np.uint8),
                 np.frombuffer(np.linspace(0, 50, 20000, dtype=np.float32).tobytes(), np.uint8),
                 np.array([], np.uint8), np.array([7], np.uint8)):
        assert assert_same_bytes("lzw", chip_smoke.lzw_encode(data), max(len(data), 1)) \
            == data.tobytes()
        rows = data[: len(data) // 100 * 100].reshape(-1, 100) if len(data) >= 100 else data[None]
        assert assert_same_bytes("packbits", chip_smoke.packbits_encode(rows),
                                 max(rows.size, 1)) == rows.tobytes()


# --- corrupt input, capacity ---


def _pack(codes, width=9):
    """9-bit codes packed MSB first, zero-padded to a byte."""
    acc = int("".join(format(code, "0%db" % width) for code in codes), 2)
    nbits = width * len(codes)
    pad = -nbits % 8
    return (acc << pad).to_bytes((nbits + pad) // 8, "big")


@pytest.mark.parametrize("codes", [
    [256, 300, 257],  # a first code past the byte values after a clear
    [256, 65, 400, 257],  # a code beyond the next entry
    [256, 65, 66, 260, 257],  # the same, one entry later
])
def test_corrupt_lzw_raises_the_jax_text(codes):
    ours, theirs, plain = decode_all("lzw", _pack(codes), 100)
    assert ours == theirs == ("raised", "ValueError", "Corrupt lzw stream")
    assert plain[0] == "raised"


@pytest.mark.parametrize("kind", ["lzw", "packbits"])
def test_small_capacity_grows_and_overflow_raises(kind):
    data = np.tile(np.arange(200, dtype=np.uint8), 300)  # 60,000 bytes
    stream = (chip_smoke.lzw_encode(data) if kind == "lzw"
              else chip_smoke.packbits_encode(data.reshape(300, 200)))
    # 4096 bytes first, then 16384, then 65536: the third attempt holds it
    assert assert_same_bytes(kind, stream, 0) == data.tobytes()
    big = np.tile(data, 2)
    stream = (chip_smoke.lzw_encode(big) if kind == "lzw"
              else chip_smoke.packbits_encode(big.reshape(600, 200)))
    ours, theirs, _ = decode_all(kind, stream, 0)
    assert ours == theirs == ("raised", "ValueError", "%s output exceeded expected size" % kind)


@settings(max_examples=200, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.binary(max_size=600), st.sampled_from(["lzw", "packbits"]))
def test_random_bytes_decode_alike(data, kind):
    """Any bytes: the port's native decode is the JAX package's, errors
    included; where it succeeds, the plain decoder gives the same bytes."""
    ours, theirs, plain = decode_all(kind, data, 64)
    assert ours == theirs
    if ours[0] == "ok":
        assert plain == ours


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.tuples(st.integers(0, 255), st.integers(1, 400)), max_size=60),
       st.integers(0, 2**31 - 1))
def test_encoded_runs_decode_alike(runs, cut_seed):
    """Runs of bytes through both fixture encoders, whole and cut at a
    drawn point: the same bytes from every decoder."""
    data = np.repeat(np.array([v for v, _ in runs], np.uint8),
                     [n for _, n in runs]).astype(np.uint8)
    for kind, stream in (("lzw", chip_smoke.lzw_encode(data)), ("lzw", lzw_encode(data.tobytes())),
                         ("packbits", chip_smoke.packbits_encode(data[None]))):
        assert assert_same_bytes(kind, stream, max(len(data), 1)) == data.tobytes()
        cut = cut_seed % (len(stream) + 1)
        assert data.tobytes().startswith(assert_same_bytes(kind, stream[:cut], len(data)))


# --- files read through both packages ---


@pytest.mark.parametrize("compression", ["tiff_lzw", "packbits"])
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "float32"])
def test_pillow_written_files(tmp_path, compression, dtype):
    """libtiff's streams, through Pillow: both packages read the same
    values, and every strip decodes alike natively and in Python."""
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.RandomState(5)
    array = (rng.rand(120, 170) * 250).astype(dtype)
    if dtype == "uint8":
        array[:, 40:90] = 7  # runs
    path = str(tmp_path / "pil.tif")
    PIL.fromarray(array).save(path, compression=compression)
    ours = P.read_geotiff(path).array
    np.testing.assert_array_equal(ours, J.read_geotiff(path).array)
    np.testing.assert_array_equal(ours[0], array)
    kind = "lzw" if compression == "tiff_lzw" else "packbits"
    for chunk in _chunks(path):
        assert_same_bytes(kind, chunk, array.nbytes)


def _chunks(path):
    f, _, tags = P._open_tiff(path)
    try:
        offsets = tags.get(273) or tags[324]
        counts = tags.get(279) or tags[325]
        out = []
        for offset, count in zip(offsets, counts):
            f.seek(offset)
            out.append(f.read(count))
        return out
    finally:
        f.close()


@pytest.mark.parametrize("compression_id,encoder,predictor", [
    (5, lzw_encode, 1), (5, lzw_encode, 2), (32773, packbits_encode, 1),
    (32773, packbits_encode, 2),
])
@pytest.mark.parametrize("byte_order", ["<", ">"])
def test_minimal_tiffs_through_both_packages(tmp_path, compression_id, encoder, predictor,
                                             byte_order):
    rng = np.random.RandomState(0)
    array = (rng.rand(40, 50) * 60000).astype(np.uint16)
    path = str(tmp_path / "foreign.tif")
    write_minimal_tiff(path, array, compression_id, encoder, predictor, byte_order=byte_order,
                       epsg=28992)
    ours = P.read_geotiff(path)
    np.testing.assert_array_equal(ours.array[0], array)
    np.testing.assert_array_equal(ours.array, J.read_geotiff(path).array)
    with config.set({"geomodeling.windowed-read-limit": 100}):
        np.testing.assert_array_equal(P.read_geotiff_window(path, 5, 33, 7, 41).array,
                                      J.read_geotiff_window(path, 5, 33, 7, 41).array)


@pytest.mark.parametrize("tiled", [True, False])
def test_chip_smoke_fixture_files_under_pillow(tmp_path, tiled):
    """write_coded_tiff's files (LZW tiles of float32 as write_lzw_sheet
    writes them; PackBits strips of uint8 as write_lgn_packbits writes
    them) decode under Pillow to the values written, and through both
    packages."""
    PIL = pytest.importorskip("PIL.Image")
    if tiled:
        sheet = chip_smoke.write_sheet(str(tmp_path), width=700, height=600, block=50)
        path, size = chip_smoke.write_lzw_sheet(str(tmp_path), sheet)
        values = P.read_geotiff(sheet).array[0]
        assert size < values.nbytes
    else:
        values = chip_smoke.lgn_classes(500, 300)
        path, size = chip_smoke.write_lgn_packbits(str(tmp_path), values)
    with PIL.open(path) as image:
        np.testing.assert_array_equal(np.asarray(image), values)
    ours, theirs = P.read_geotiff(path), J.read_geotiff(path)
    np.testing.assert_array_equal(ours.array[0], values)
    np.testing.assert_array_equal(ours.array, theirs.array)
    assert (ours.geo_transform, ours.projection, ours.no_data_value) == (
        theirs.geo_transform, theirs.projection, theirs.no_data_value)
    if tiled:
        deflate = P.read_geotiff(sheet)
        assert (ours.geo_transform, ours.projection, ours.no_data_value) == (
            deflate.geo_transform, deflate.projection, deflate.no_data_value)
    else:
        assert ours.no_data_value == 0 and ours.projection == "EPSG:28992"
        assert tuple(ours.geo_transform) == chip_smoke.LGN_GEO_TRANSFORM


@pytest.mark.parametrize("read_libtiff", [False, True])
def test_packbits_with_a_predictor_reads_otherwise_than_libtiff(tmp_path, monkeypatch,
                                                                read_libtiff):
    """libtiff's PackBits codec applies no predictor (only LZW, deflate,
    LZMA and ZSTD register one), so Pillow, through libtiff or its own
    decoder, reads a PackBits file tagged Predictor 2 as the stored
    differences; both packages undo the differencing, alike (a fault of the
    reference kept by the port, ROADMAP Queue 3)."""
    PIL = pytest.importorskip("PIL.Image")
    from PIL import TiffImagePlugin

    monkeypatch.setattr(TiffImagePlugin, "READ_LIBTIFF", read_libtiff)
    classes = chip_smoke.lgn_classes(300, 200)
    path = str(tmp_path / "packbits2.tif")
    chip_smoke.write_coded_tiff(path, classes, chip_smoke.LGN_GEO_TRANSFORM, "EPSG:28992", 0,
                                32773, predictor=2, rows_per_strip=8)
    differences = classes.copy()
    np.subtract(classes[:, 1:], classes[:, :-1], out=differences[:, 1:])
    with PIL.open(path) as image:
        np.testing.assert_array_equal(np.asarray(image), differences)
    ours = P.read_geotiff(path).array
    np.testing.assert_array_equal(ours[0], classes)
    np.testing.assert_array_equal(ours, J.read_geotiff(path).array)


def test_windows_decode_on_the_pool_in_parallel(tmp_path):
    """A window over several LZW tiles decodes them on the codec's pool,
    more than one at once (ctypes releases the GIL)."""
    sheet = chip_smoke.write_sheet(str(tmp_path), width=2048, height=2048, block=50)
    path, _ = chip_smoke.write_lzw_sheet(str(tmp_path), sheet)
    native.reset_counts()
    with chip_smoke.native_spy() as spy:
        window = P.read_geotiff_window(path, 0, 2048, 0, 2048)
    np.testing.assert_array_equal(window.array, P.read_geotiff(sheet).array)
    assert native.counts["tiff_decodes"] == spy.calls["tiff_decode_native"] == 16
    assert native.counts["tiff_bytes"] == 16 * 512 * 512 * 4
    assert spy.calls["_lzw_decode"] == 0
    if (os.cpu_count() or 1) > 1:
        assert spy.most["tiff_decode_native"] > 1


# --- the native burn ---


def numpy_burn(func, *args):
    """``func`` with the native rasterizer bypassed: the numpy scanline."""
    with chip_smoke.numpy_scanline():
        return func(*args)


def burn_all(shapes, gt, height, width, dtype, values=None):
    """(port native, port numpy scanline, JAX native) burns of the WKT
    ``shapes``: a mask when ``values`` is None, else values into zeros."""
    ours = [geometry.from_wkt(w) for w in shapes]
    theirs = [jax_geometry.from_wkt(w) for w in shapes]
    if values is None:
        return (rasterize.burn_mask(ours, gt, height, width),
                numpy_burn(rasterize.burn_mask, ours, gt, height, width),
                jax_rasterize.burn_mask(theirs, gt, height, width))
    out = [np.zeros((height, width), dtype) for _ in range(3)]
    rasterize.burn_values(ours, values, out[0], gt)
    numpy_burn(rasterize.burn_values, ours, values, out[1], gt)
    jax_rasterize.burn_values(theirs, values, out[2], gt)
    return out


def ring_wkt(points):
    return "(%s)" % ", ".join("%r %r" % p for p in list(points) + [points[0]])


@st.composite
def polygon_cases(draw):
    """A grid of cells of 2**-k m from an integer origin (every centre and
    crossing exact in float64) and polygons whose vertices lie on cell
    centres or corners: plain, with a hole, and multipolygons."""
    k = draw(st.integers(0, 2))
    cell = 2.0 ** -k
    height, width = draw(st.integers(4, 24)), draw(st.integers(4, 24))
    x0, y0 = draw(st.integers(-50, 50)), draw(st.integers(-50, 50))
    gt = (float(x0), cell, 0.0, float(y0 + height * cell), 0.0, -cell)

    def vertex():
        col = draw(st.integers(-2, 2 * width + 2)) / 2.0
        row = draw(st.integers(-2, 2 * height + 2)) / 2.0
        return (x0 + col * cell, y0 + row * cell)

    shapes = []
    for _ in range(draw(st.integers(1, 4))):
        kind = draw(st.sampled_from(["polygon", "holed", "multi"]))
        if kind == "holed":
            c0 = draw(st.integers(0, width - 4))
            r0 = draw(st.integers(0, height - 4))
            c1 = draw(st.integers(c0 + 3, width))
            r1 = draw(st.integers(r0 + 3, height))
            outer = [(x0 + c * cell, y0 + r * cell) for c, r in
                     ((c0, r0), (c1, r0), (c1, r1), (c0, r1))]
            inner = [(x0 + c * cell, y0 + r * cell) for c, r in
                     ((c0 + 1.5, r0 + 1.5), (c1 - 1, r0 + 1.5), (c1 - 1, r1 - 1))]
            shapes.append("POLYGON (%s, %s)" % (ring_wkt(outer), ring_wkt(inner)))
        else:
            rings = [[vertex() for _ in range(draw(st.integers(3, 7)))]
                     for _ in range(2 if kind == "multi" else 1)]
            if kind == "multi":
                shapes.append("MULTIPOLYGON (%s)" % ", ".join("(%s)" % ring_wkt(r)
                                                              for r in rings))
            else:
                shapes.append("POLYGON (%s)" % ring_wkt(rings[0]))
    return shapes, gt, height, width


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(polygon_cases(), st.sampled_from(["mask", "int32", "float64", "uint8"]))
def test_native_burn_is_the_numpy_scanline(case, dtype):
    shapes, gt, height, width = case
    values = None
    if dtype != "mask":
        values = np.arange(3, 3 + len(shapes)).astype(dtype) * (1 if dtype != "float64" else 1.5)
    ours, plain, theirs = burn_all(shapes, gt, height, width, dtype, values)
    np.testing.assert_array_equal(ours, plain)
    np.testing.assert_array_equal(ours, theirs)
    assert ours.dtype == plain.dtype == theirs.dtype


def test_native_burn_counts_and_skips_the_scanline():
    shapes = ["POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0), (3 3, 6 3, 6 6, 3 6, 3 3))",
              "MULTIPOLYGON (((12 0, 16 0, 16 4, 12 4, 12 0)), ((12 6, 16 6, 14 9, 12 6)))"]
    gt = (0.0, 1.0, 0.0, 16.0, 0.0, -1.0)
    native.reset_counts()
    with chip_smoke.native_spy() as spy:
        ours, plain, theirs = burn_all(shapes, gt, 16, 16, "int32", np.array([5, 9], np.int32))
    assert native.counts["burns"] == 1 and spy.calls["rasterize_native"] == 1
    assert spy.calls["_burn_polygon_rows"] == 2  # the numpy burn's only: one a feature
    np.testing.assert_array_equal(ours, plain)
    np.testing.assert_array_equal(ours, theirs)
    assert (ours == 5).sum() == 100 - 9 and (ours == 9).sum() > 0


def test_lines_and_points_burn_with_numpy_as_in_the_jax_package():
    """A feature without rings sends the whole call to the numpy path."""
    shapes = ["POLYGON ((0 0, 5 0, 5 5, 0 5, 0 0))", "LINESTRING (0 9, 9 0)", "POINT (7.5 7.5)"]
    gt = (0.0, 1.0, 0.0, 10.0, 0.0, -1.0)
    native.reset_counts()
    ours, plain, theirs = burn_all(shapes, gt, 10, 10, "float64", np.array([1.0, 2.0, 3.0]))
    assert native.counts["burns"] == 0
    np.testing.assert_array_equal(ours, plain)
    np.testing.assert_array_equal(ours, theirs)


def test_where_the_two_scanlines_part():
    """A vertical edge whose x is a pixel centre's float64 value, on cells
    of 0.1 m: the native scanline places the crossing with
    ceil((x - x0) / a - 0.5), which rounds past the centre, the numpy
    scanline with searchsorted against the centres, which counts it in.
    The port burns natively, as the JAX package does with its library
    built: its answer is the JAX native one (ROADMAP Queue 3)."""
    a = 0.1
    x_centre = 0.0 + a * (1 + 0.5)  # 0.15000000000000002, pixel 1's centre
    shape = "POLYGON ((%r 0, 1 0, 1 1, %r 1, %r 0))" % (x_centre, x_centre, x_centre)
    gt = (0.0, a, 0.0, 1.0, 0.0, -a)
    ours, plain, theirs = burn_all([shape], gt, 10, 10, "mask")
    np.testing.assert_array_equal(ours, theirs)
    assert plain[:, 1].all() and not ours[:, 1].any()
    np.testing.assert_array_equal(ours[:, 2:], plain[:, 2:])


# --- the build ---


@pytest.fixture
def private_build(tmp_path, monkeypatch):
    """A private _build/ and library cache: nothing built here is reused."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_build, "_LIBRARIES", {})
    monkeypatch.setattr(_build, "_NAME_LOCKS", {})
    return tmp_path


def test_host_library_hash_named_and_rebuilt_after_an_edit(private_build):
    source = private_build / "tiffcodec.cpp"
    shutil.copy(native._TIFF_SOURCE, source)
    first = _build.host_library_path(str(source))
    digest = hashlib.sha256(source.read_bytes() + repr(_build.GXX_FLAGS).encode()).hexdigest()
    assert os.path.basename(first) == "libtiffcodec-%s.so" % digest[:16]
    assert os.path.dirname(first) == _build.BUILD_DIR
    assert _build.build_log["tiffcodec"]["seconds"] > 0
    assert _build.host_library_path(str(source)) == first  # reused
    assert not [name for name in os.listdir(private_build) if name.endswith((".so", ".bin"))]
    source.write_text(source.read_text() + "\n// edited\n")
    second = _build.host_library_path(str(source))
    assert second != first and os.path.exists(second) and os.path.exists(first)
    lib = ctypes.CDLL(second)
    assert hasattr(lib, "lzw_decode") and hasattr(lib, "packbits_decode")


def test_the_package_builds_outside_its_sources():
    """The libraries land in _build/, which git ignores, never beside the
    sources."""
    native.load_tiffcodec()
    native.load_rasterizer()
    here = os.path.dirname(native.__file__)
    assert not [name for name in os.listdir(here) if name.endswith((".so", ".bin"))]
    built = os.listdir(_build.BUILD_DIR)
    assert any(name.startswith("libtiffcodec-") for name in built)
    assert any(name.startswith("librasterize-") for name in built)
    root = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    with open(os.path.join(root, ".gitignore")) as f:
        assert "dask_geomodeling_tpu_torch/_build/" in f.read().split()


@pytest.mark.parametrize("failure", ["fails", "missing"])
def test_a_failing_compiler_raises_and_nothing_falls_back(private_build, monkeypatch, tmp_path,
                                                          failure):
    if failure == "fails":
        monkeypatch.setattr(_build, "gxx_path", lambda: shutil.which("false"))
        message = "g\\+\\+ failed on .*tiffcodec.cpp"
    else:
        monkeypatch.setattr(_build, "gxx_path", lambda: str(tmp_path / "no-such-g++"))
        message = "g\\+\\+ could not run on .*tiffcodec.cpp"
    with pytest.raises(RuntimeError, match=message):
        native.load_tiffcodec()
    with pytest.raises(RuntimeError, match=message):
        native.tiff_decode_native("lzw", bytes([0x80, 0x11, 0x60, 0x20]), 1)
    path = str(tmp_path / "foreign.tif")
    write_minimal_tiff(path, np.zeros((4, 5), np.uint8), 5, lzw_encode)
    with pytest.raises(RuntimeError, match=message):
        P.read_geotiff(path)
    with pytest.raises(RuntimeError, match=message.replace("tiffcodec", "rasterize")):
        rasterize.burn_mask([geometry.from_wkt("POLYGON ((0 0, 1 0, 1 1, 0 0))")],
                            (0.0, 1.0, 0.0, 1.0, 0.0, -1.0), 1, 1)


def test_no_compiler_on_path_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.gxx_path()


# --- chip_smoke's lzw-sheet phase on the CPU ---


def test_the_phase_on_the_cpu(tmp_path, monkeypatch):
    """check_lzw_sheet on CPU tensors over a 1024^2 sheet and a 512 x 384
    land use, 256^2 tiles in batches of 8, the windowed-read limit
    lowered: every check of the full run (file-read's and hfa-roughness'
    answers from this run's own evaluate_tiled), two pool workers, the
    files removed."""
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.raster import spatial

    def launching(*args, **kwargs):
        cuda_stencils.launches += 1
        return cuda_stencils.gaussian_blur_reference(*args, **kwargs)

    monkeypatch.setattr(spatial, "gaussian_blur", launching)
    monkeypatch.setattr(chip_smoke, "TILE", 256)
    monkeypatch.setattr(chip_smoke, "BATCH", 8)
    folder = str(tmp_path)
    sheet = chip_smoke.write_sheet(folder, width=1024, height=1024, block=120)
    paths = chip_smoke.build_file_paths(sheet, reproject_px=512)
    view, request, _, _ = paths["file-read"]
    with config.set({"geomodeling.windowed-read-limit": 100_000}):
        read_values = evaluate_tiled(view, request, tile_size=256, batch=8,
                                     device="cpu")["values"]
        lgn_path, classes, _ = chip_smoke.write_lgn(folder, 512, 384)
        lgn_values = evaluate_tiled(chip_smoke.build_lgn_view(lgn_path),
                                    chip_smoke.lgn_request(512, 384), tile_size=256, batch=8,
                                    device="cpu")["values"]
        lgn = {"classes": classes, "values": lgn_values}
        launches, numbers, kernels = chip_smoke.check_lzw_sheet(
            "cpu", "cpu", folder, sheet, paths["file-read"], read_values, lgn, sampled_tiles=4)
    assert launches["gaussian_blur"] >= 3 and launches["moving_max"] == 0
    assert kernels == [] and lgn == {}
    assert numbers["native_decodes"] >= 16 and numbers["packbits_decodes"] >= 48
    assert numbers["pool_status"]["completed"] > 0 and numbers["python_band_bytes"] == 65536
    assert sorted(os.listdir(folder)) == ["lgn.img", "lgn.img.aux.xml", "sheet.tif"]


def test_the_decoded_sheet_equals_the_deflate_sheet_by_window(tmp_path):
    """Windows of the LZW sheet equal the deflate sheet's, in both packages."""
    sheet = chip_smoke.write_sheet(str(tmp_path), width=1100, height=900, block=100)
    path, _ = chip_smoke.write_lzw_sheet(str(tmp_path), sheet)
    rng = np.random.RandomState(2)
    for _ in range(6):
        r0, c0 = rng.randint(0, 800), rng.randint(0, 1000)
        r1, c1 = r0 + rng.randint(1, 600), c0 + rng.randint(1, 700)
        ours = P.read_geotiff_window(path, r0, r1, c0, c1)
        np.testing.assert_array_equal(ours.array, P.read_geotiff_window(sheet, r0, r1, c0, c1).array)
        np.testing.assert_array_equal(ours.array, J.read_geotiff_window(path, r0, r1, c0, c1).array)


def test_zlib_chunks_untouched():
    """Deflate chunks still inflate with zlib, whatever the capacity."""
    data = np.arange(1000, dtype=np.uint16).tobytes()
    assert P._decode(zlib.compress(data), 8, 0) == data
    assert P._decode(data, 1, 0) == data
