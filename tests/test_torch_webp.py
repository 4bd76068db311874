"""The port's WebP codec (native/webpcodec.cpp) and every WebP call site,
held on the CPU to the JAX package, which reads and writes WebP with
Pillow (libwebp 1.6.0 in this environment); the lossy decoder's corpora
are tests/test_torch_webp_lossy.py's.

- The decoder is bitwise to Pillow (pixels, mode and shape) over a matrix
  of Pillow's lossless files: gray, RGB and RGBA; methods 0-6; qualities 0,
  50 and 100; ``exact`` on and off; palettes of 2, 4, 16 and 256 colours;
  sizes from 1 x 1 to 1031 x 517; VP8X files with metadata and unknown
  chunks; and random planes under hypothesis.  A truncated or corrupted
  file, lossless, lossy or lossy with ALPH, raises where Pillow raises,
  with Pillow's class (OSError), and decodes to Pillow's array where
  Pillow decodes it; the lossy and lossy-with-ALPH fixtures decode to
  Pillow's arrays, and an animated file raises NotImplementedError naming
  the JAX modules.
- The encoder is lossless: Pillow decodes its bytes to exactly the input,
  and so does the port, for random, smooth and few-colour planes (its
  bytes are its own, not libwebp's).
- WebP GeoTIFFs: each package reads the other's (the JAX writer's Pillow
  chunks, the port's own), whole and by window, to equal payloads; GDAL's
  contiguous RGB layout; the JAX tests' WebP cases run once per package;
  WebP tiles of GeoPackage and MBTiles give the JAX package's payload.
- chip_smoke's fixtures (tests/data/torch_webp) are Pillow's files, and
  their hashes.json Pillow's arrays; the ortho-webp phase runs on CPU
  tensors at a small size.
- A failing g++ raises, naming the compiler and the source.

Tolerance: none.  Every array is compared bitwise.
"""
import hashlib
import io
import json
import os
import sqlite3
import struct
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

import chip_smoke
from dask_geomodeling_tpu.io import geotiff as jax_geotiff
from dask_geomodeling_tpu.io import gpkg_raster as jax_gpkg
from dask_geomodeling_tpu.io import mbtiles as jax_mbtiles
from dask_geomodeling_tpu_torch import native
from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.io import geotiff as port_geotiff
from dask_geomodeling_tpu_torch.io import gpkg_raster as port_gpkg
from dask_geomodeling_tpu_torch.io import mbtiles as port_mbtiles
from dask_geomodeling_tpu_torch.ops import _build
from dask_geomodeling_tpu_torch.runtime import pipeline
from tests.test_torch_raster_formats import assert_same
from tests.test_torch_tile_pyramids import _grid_aligned_gt

MODES = {"L": (), "RGB": (3,), "RGBA": (4,)}
SIZES = [(1, 1), (1, 17), (7, 1), (17, 33), (65, 129)]
QUALITIES = (0, 50, 100)
GT = (0.0, 1.0, 0.0, 300.0, 0.0, -1.0)


def pixels_of(mode, shape, seed, kind="noise"):
    """Seeded uint8 pixels: noise, a random walk along the rows (smooth),
    or few distinct values."""
    rng = np.random.default_rng(seed)
    full = tuple(shape) + MODES[mode]
    if kind == "smooth":
        return np.clip(np.cumsum(rng.integers(-6, 7, full), axis=1) + 128, 0, 255).astype(np.uint8)
    if kind == "few":
        return (rng.integers(0, 3, full) * 100).astype(np.uint8)
    return rng.integers(0, 256, full).astype(np.uint8)


def pillow_webp(pixels, mode=None, **options):
    buf = io.BytesIO()
    Image.fromarray(pixels, mode).save(buf, format="WEBP", **dict({"lossless": True}, **options))
    return buf.getvalue()


def pillow_read(blob):
    with Image.open(io.BytesIO(blob)) as image:
        return np.asarray(image), image.mode


def assert_decodes_as_pillow(blob):
    theirs, mode = pillow_read(blob)
    ours = native.webp_decode_native(blob)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    assert {3: "RGB", 4: "RGBA"}[ours.shape[2]] == mode
    assert np.array_equal(ours, theirs)


def _raises(call):
    try:
        call()
    except Exception as error:  # the verdict is the exception
        return error
    return None


# --- the decoder ---


@pytest.mark.parametrize("method", range(7))
@pytest.mark.parametrize("mode", list(MODES))
def test_decoder_bitwise_over_the_grid(mode, method):
    for shape in SIZES:
        for quality in QUALITIES:
            for kind in ("noise", "smooth"):
                pixels = pixels_of(mode, shape, shape[0] * 31 + quality, kind)
                assert_decodes_as_pillow(pillow_webp(pixels, mode, method=method,
                                                     quality=quality))


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("method", [0, 4, 6])
def test_exact_and_transparent_pixels(exact, method):
    """RGBA with fully transparent areas, whose colour libwebp rewrites
    unless ``exact``: the decoder gives what Pillow decodes either way."""
    pixels = pixels_of("RGBA", (45, 70), 5, "smooth")
    pixels[::3, :, 3] = 0
    pixels[:, ::5, 3] = 255
    assert_decodes_as_pillow(pillow_webp(pixels, "RGBA", method=method, exact=exact))


@pytest.mark.parametrize("colours", [2, 3, 4, 5, 16, 17, 256])
@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_palettes(colours, mode):
    """Colour-indexed images: 2, 4 and 16 colours bundle 8, 4 and 2
    pixels a byte, up to 256 one a pixel; odd widths leave a partial
    byte at each row's end."""
    rng = np.random.default_rng(colours)
    palette = rng.integers(0, 256, (colours, 4 if mode == "RGBA" else 3)).astype(np.uint8)
    for shape in [(1, 1), (7, 13), (33, 1), (64, 257)]:
        pixels = palette[rng.integers(0, colours, shape)]
        for method in (0, 6):
            assert_decodes_as_pillow(pillow_webp(pixels, mode, method=method))


@pytest.mark.parametrize("mode", list(MODES))
def test_the_largest_size(mode):
    pixels = pixels_of(mode, (517, 1031), 3, "smooth")
    assert_decodes_as_pillow(pillow_webp(pixels, mode, method=4))


def _chunks(blob):
    """(tag, payload) of a RIFF/WEBP file's chunks."""
    chunks, pos = [], 12
    while pos < len(blob):
        tag, size = blob[pos:pos + 4], struct.unpack("<I", blob[pos + 4:pos + 8])[0]
        chunks.append((tag, blob[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return chunks


def _riff(chunks):
    body = b"".join(tag + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)
                    for tag, data in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def test_vp8x_with_metadata_and_unknown_chunks():
    """Pillow's VP8X file with ICC, EXIF and XMP, and the same with
    unknown chunks of odd lengths (padded to even) before and after the
    image: both decoders give the same array; the alpha flag of VP8X
    decides RGB or RGBA."""
    pixels = pixels_of("RGB", (20, 30), 1)
    blob = pillow_webp(pixels, exif=chip_smoke.WEBP_EXIF, icc_profile=chip_smoke.WEBP_ICC,
                       xmp=b"<x:xmpmeta/>")
    chunks = _chunks(blob)
    assert [tag for tag, _ in chunks] == [b"VP8X", b"ICCP", b"VP8L", b"EXIF", b"XMP "]
    assert_decodes_as_pillow(blob)
    extra = chunks[:2] + [(b"ABCD", b"xyz")] + chunks[2:3] + [(b"WXYZ", b"12345")] + chunks[3:]
    assert_decodes_as_pillow(_riff(extra))
    rgba = pillow_webp(pixels_of("RGBA", (20, 30), 2), "RGBA", exif=chip_smoke.WEBP_EXIF)
    assert native.webp_decode_native(rgba).shape == (20, 30, 4)
    assert_decodes_as_pillow(rgba)


def test_the_simple_files_alpha_hint():
    """A simple VP8L file's alpha hint makes RGBA; Pillow writes it only
    where some alpha is below 255, and so does the port's encoder."""
    opaque = pixels_of("RGBA", (9, 11), 4)
    opaque[..., 3] = 255
    assert native.webp_decode_native(pillow_webp(opaque, "RGBA")).shape == (9, 11, 3)
    translucent = pixels_of("RGBA", (9, 11), 4)
    assert native.webp_decode_native(pillow_webp(translucent, "RGBA")).shape == (9, 11, 4)
    assert native.webp_decode_native(native.webp_encode_native(opaque)).shape == (9, 11, 3)
    assert native.webp_decode_native(native.webp_encode_native(translucent)).shape == (9, 11, 4)


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(height=st.integers(1, 70), width=st.integers(1, 70), seed=st.integers(0, 2**16),
       mode=st.sampled_from(list(MODES)), method=st.integers(0, 6),
       quality=st.integers(0, 100), kind=st.sampled_from(["noise", "smooth", "few"]),
       exact=st.booleans())
def test_decoder_under_hypothesis(height, width, seed, mode, method, quality, kind, exact):
    pixels = pixels_of(mode, (height, width), seed, kind)
    assert_decodes_as_pillow(pillow_webp(pixels, mode, method=method, quality=quality,
                                         exact=exact))


def lossy_webp(alpha, shape=(40, 56), quality=60):
    """Pillow's lossy WebP of a smooth RGB, or RGBA (an ALPH chunk), plane."""
    pixels = pixels_of("RGBA" if alpha else "RGB", shape, 3, "smooth")
    if alpha:
        pixels[::4, :, 3] = 0
    return pillow_webp(pixels, "RGBA" if alpha else "RGB", lossless=False, quality=quality)


def _verdicts_agree(blob):
    """Pillow and the port on the same bytes: both raise, the port with
    Pillow's class (OSError; Pillow's UnidentifiedImageError is one), or
    both decode to the same array.  Returns whether Pillow raised."""
    theirs = _raises(lambda: pillow_read(blob))
    ours = _raises(lambda: native.webp_decode_native(blob))
    if theirs is not None:
        assert isinstance(theirs, OSError)
        assert type(ours) is OSError, (ours, theirs)
        return True
    assert ours is None, ours
    assert np.array_equal(native.webp_decode_native(blob), pillow_read(blob)[0])
    return False


@pytest.mark.parametrize("source", ["pillow-rgb", "pillow-gray-vp8x", "port-rgba", "pillow-lossy",
                                    "pillow-lossy-alpha"])
def test_truncated_files_raise_as_pillow(source):
    pixels = pixels_of("RGBA" if source == "port-rgba" else "RGB", (40, 56), 3, "smooth")
    if source == "pillow-rgb":
        blob = pillow_webp(pixels)
    elif source == "pillow-gray-vp8x":
        blob = pillow_webp(pixels[..., 0], "L", exif=chip_smoke.WEBP_EXIF)
    elif source.startswith("pillow-lossy"):
        blob = lossy_webp(source.endswith("alpha"))
    else:
        blob = native.webp_encode_native(pixels)
    for cut in range(len(blob)):
        assert _verdicts_agree(blob[:cut]), cut


@pytest.mark.parametrize("source", ["pillow-rgb", "pillow-palette", "port-rgb", "pillow-lossy",
                                    "pillow-lossy-alpha"])
def test_corrupted_files_decode_or_raise_as_pillow(source):
    """One or two bytes anywhere overwritten: where Pillow raises the port
    raises OSError, and where Pillow decodes the port gives its array
    (libwebp's checks of the container, the prefix codes, the transforms
    and the copies; of a lossy frame its headers, its partitions' ends and
    the ALPH chunk's)."""
    rng = np.random.default_rng(11)
    pixels = pixels_of("RGB", (24, 33), 9, "smooth")
    if source == "pillow-rgb":
        blob = pillow_webp(pixels)
    elif source == "pillow-palette":
        blob = pillow_webp(pixels // 64 * 64)
    elif source.startswith("pillow-lossy"):
        blob = lossy_webp(source.endswith("alpha"), shape=(24, 33))
    else:
        blob = native.webp_encode_native(pixels)
    raised = 0
    for _ in range(600):
        broken = bytearray(blob)
        for _ in range(int(rng.integers(1, 3))):
            broken[int(rng.integers(0, len(broken)))] = int(rng.integers(0, 256))
        raised += _verdicts_agree(bytes(broken))
    assert raised >= 10


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(alpha=st.booleans(), quality=st.integers(0, 100), cut=st.floats(0.0, 1.0),
       edits=st.lists(st.tuples(st.floats(0.0, 1.0), st.integers(0, 255)), max_size=3))
def test_lossy_mutations_under_hypothesis(alpha, quality, cut, edits):
    """A lossy file, with an ALPH chunk or without, some bytes overwritten
    and maybe cut short: the port raises OSError exactly where Pillow
    raises, and else gives Pillow's array."""
    blob = bytearray(lossy_webp(alpha, shape=(19, 37), quality=quality))
    for where, value in edits:
        blob[min(int(where * len(blob)), len(blob) - 1)] = value
    if cut < 0.3:
        blob = blob[: int(len(blob) * (0.7 + cut))]
    _verdicts_agree(bytes(blob))


def test_coefficients_past_their_range_wrap_as_libwebps():
    """A byte of the token partition overwritten so that a chroma block's
    coefficients leave the normal range: libwebp's x86-64 inverse
    transform (Transform_SSE2) wraps in 16 bits there where its C version
    would not, and the port gives Pillow's array."""
    blob = bytearray(lossy_webp(False, shape=(70, 90), quality=90))
    assert len(blob) == 1844 and blob[436] == 74
    blob[436] = 220
    assert not _verdicts_agree(bytes(blob))


def test_alpha_read_past_its_end_wraps_as_libwebps():
    """A byte of a colour-indexed ALPH stream overwritten so that its last
    pixels are read past the stream's end: libwebp's DecodeAlphaData keeps
    them, read from its bit reader's window wrapped onto the last bytes
    (not zeros), and the port gives Pillow's array."""
    rng = np.random.default_rng(7)
    pixels = rng.integers(0, 256, (48, 64, 4)).astype(np.uint8)
    pixels[..., 3] = np.where(rng.random((48, 64)) < 0.3, 0, 255)
    blob = bytearray(pillow_webp(pixels, "RGBA", lossless=False, quality=90,
                                 method=int(rng.integers(0, 7))))
    assert blob[308] == 134
    blob[308] = 54
    assert not _verdicts_agree(bytes(blob))


@pytest.mark.parametrize("name", sorted(list(chip_smoke.WEBP_REFUSED)
                                        + list(chip_smoke.WEBP_LOSSY_FIXTURES)))
def test_unported_webp_names_the_jax_modules(name):
    """The lossy (VP8) fixture and the lossy one with an ALPH chunk decode
    to Pillow's arrays; the animated one, which Pillow decodes too, raises
    NotImplementedError naming the JAX modules that do."""
    blob = fixture_bytes(name)
    assert pillow_read(blob)[0].size
    if name in chip_smoke.WEBP_LOSSY_FIXTURES:
        assert_decodes_as_pillow(blob)
        assert (b"ALPH" in blob) == (chip_smoke.WEBP_LOSSY_FIXTURES[name] == "ALPH")
        return
    with pytest.raises(NotImplementedError, match="dask_geomodeling_tpu/io/gpkg_raster.py"):
        native.webp_decode_native(blob)


# --- the encoder ---


@pytest.mark.parametrize("kind", ["noise", "smooth", "few"])
@pytest.mark.parametrize("mode", list(MODES))
def test_encoder_is_lossless(mode, kind):
    for shape in [(1, 1), (1, 9), (9, 1), (64, 64), (300, 301)]:
        pixels = pixels_of(mode, shape, shape[1], kind)
        blob = native.webp_encode_native(pixels)
        theirs, pillow_mode = pillow_read(blob)
        want = np.stack([pixels] * 3, axis=-1) if mode == "L" else pixels
        if mode == "RGBA" and (pixels[..., 3] == 255).all():
            want = pixels[..., :3]
        assert pillow_mode == {3: "RGB", 4: "RGBA"}[want.shape[2]]
        assert np.array_equal(theirs, want)
        assert np.array_equal(native.webp_decode_native(blob), want)


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(height=st.integers(1, 90), width=st.integers(1, 90), seed=st.integers(0, 2**16),
       mode=st.sampled_from(list(MODES)), kind=st.sampled_from(["noise", "smooth", "few"]))
def test_encoder_under_hypothesis(height, width, seed, mode, kind):
    pixels = pixels_of(mode, (height, width), seed, kind)
    theirs, _ = pillow_read(native.webp_encode_native(pixels))
    assert np.array_equal(theirs[..., 0] if mode == "L" else theirs[..., :MODES[mode][0]],
                          pixels)


def test_encoder_beats_deflate_on_an_orthophoto_tile():
    """The predictor, the LZ77 and the prefix-code groups: a band tile of
    chip_smoke's orthophoto as lossless WebP is smaller than zlib's."""
    import zlib

    tile = np.ascontiguousarray(chip_smoke.ortho_pixels(512, 512)[..., 1])
    assert len(native.webp_encode_native(tile)) < len(zlib.compress(tile.tobytes(), 6))


def test_encoder_refuses_what_it_cannot_write():
    for pixels in (np.zeros((4, 4), np.uint16), np.zeros((4, 4, 2), np.uint8),
                   np.zeros((0, 4), np.uint8), np.zeros((1, 16385), np.uint8)):
        with pytest.raises(ValueError):
            native.webp_encode_native(pixels)


# --- WebP GeoTIFFs and tiles in both packages ---


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("bands", [1, 3])
def test_each_package_reads_the_others_webp_geotiffs(tmp_path, tiled, bands):
    """The JAX writer's Pillow chunks read by the port, and the port's own
    chunks read by the JAX package, whole and by window: equal payloads,
    the pixels written."""
    array = pixels_of("RGB", (300, 280), 8, "smooth").transpose(2, 0, 1)[:bands]
    for writer in (jax_geotiff, port_geotiff):
        path = str(tmp_path / ("%s.tif" % writer.__name__.split(".")[0]))
        writer.write_geotiff(path, np.ascontiguousarray(array), GT, "EPSG:28992", 255.0,
                             compress="webp", tiled=tiled, tile_size=128)
        ours, theirs = port_geotiff.read_geotiff(path), jax_geotiff.read_geotiff(path)
        assert_same(ours, theirs)
        assert np.array_equal(ours.array, array)
        for window in [(0, 128, 0, 128), (17, 290, 33, 271), (299, 300, 279, 280)]:
            assert_same(port_geotiff.read_geotiff_window(path, *window),
                        jax_geotiff.read_geotiff_window(path, *window))


def test_gdal_contiguous_rgb_layout(tmp_path):
    """chip_smoke.write_webp_layout: contiguous RGB WebP tiles, as GDAL
    writes COMPRESS=WEBP; both packages read the pixels, whole and by
    window."""
    pixels = chip_smoke.ortho_pixels(700, 600)
    path = str(tmp_path / "rgb.tif")
    chip_smoke.write_webp_layout(path, pixels, chip_smoke.ortho_geo_transform(), tile=256)
    ours = port_geotiff.read_geotiff(path)
    assert_same(ours, jax_geotiff.read_geotiff(path))
    assert np.array_equal(ours.array, pixels.transpose(2, 0, 1))
    for window in [(0, 1, 0, 1), (100, 513, 250, 699), (599, 600, 0, 700)]:
        assert_same(port_geotiff.read_geotiff_window(path, *window),
                    jax_geotiff.read_geotiff_window(path, *window))


def _modern_codecs_roundtrip(tiled):
    def case(k, root):
        """tests/test_geotiff_foreign.py:test_write_modern_codecs_roundtrip[webp-*]."""
        rng = np.random.RandomState(8)
        array = (rng.rand(2, 300, 280) * 250).astype(np.uint8)
        path = str(root / "out.tif")
        k.geotiff.write_geotiff(path, array, geo_transform=(0, 1, 0, 300, 0, -1),
                                projection="EPSG:28992", no_data_value=255.0, compress="webp",
                                tiled=tiled, tile_size=128)
        data = k.geotiff.read_geotiff(path)
        np.testing.assert_array_equal(data.array, array)
        assert data.projection == "EPSG:28992"
        return data
    return case


def _webp_requires_uint8(k, root):
    """tests/test_geotiff_foreign.py:test_write_webp_requires_uint8."""
    with pytest.raises(ValueError, match="uint8") as raised:
        k.geotiff.write_geotiff(str(root / "x.tif"), np.zeros((1, 8, 8), dtype=np.uint16),
                                geo_transform=(0, 1, 0, 8, 0, -1), projection="EPSG:28992",
                                no_data_value=0.0, compress="webp")
    return str(raised.value)


def _webp_mbtiles_tiles_decode(k, root):
    """tests/test_png_netcdf.py:test_webp_mbtiles_tiles_decode."""
    values = np.full((1, 256, 256), 123, dtype=np.uint8)
    gt = _grid_aligned_gt(col=7, row_xyz=7)
    path = str(root / "webp.mbtiles")
    k.mbtiles.write_mbtiles(path, values, gt)
    con = sqlite3.connect(path)
    con.execute("UPDATE tiles SET tile_data = ?", (pillow_webp(values[0], "L"),))
    con.execute("UPDATE metadata SET value='webp' WHERE name='format'")
    con.commit()
    con.close()
    data = k.mbtiles.read_mbtiles(path)
    assert (data.array[:, :256, :256] == 123).all()
    return data


JAX_CASES = {
    "modern-codecs-roundtrip[webp-False]": _modern_codecs_roundtrip(False),
    "modern-codecs-roundtrip[webp-True]": _modern_codecs_roundtrip(True),
    "write-webp-requires-uint8": _webp_requires_uint8,
    "webp-mbtiles-tiles-decode": _webp_mbtiles_tiles_decode,
}


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_jax_case(tmp_path, name):
    """Each JAX test once per package: the same payload or message (the
    WebP chunks' bytes differ, by design, so files are not compared)."""
    results = {}
    for side, kit in (("jax", SimpleNamespace(geotiff=jax_geotiff, mbtiles=jax_mbtiles)),
                      ("port", SimpleNamespace(geotiff=port_geotiff, mbtiles=port_mbtiles))):
        root = tmp_path / side
        root.mkdir()
        pipeline.clear_read_cache()
        results[side] = JAX_CASES[name](kit, root)
    assert_same(results["port"], results["jax"])


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_webp_gpkg_tiles_as_the_jax_package(tmp_path, mode):
    """A GeoPackage whose tiles are WebP (Pillow's, and the port's): the
    JAX package's payload, an RGBA tile converted to RGB as Pillow's
    ``convert`` does."""
    path = str(tmp_path / "w.gpkg")
    values = pixels_of("RGB", (512, 512), 2, "smooth").transpose(2, 0, 1)
    jax_gpkg.write_gpkg_raster(path, values, (0.0, 1.0, 0.0, 512.0, 0.0, -1.0),
                               projection="EPSG:28992")
    con = sqlite3.connect(path)
    rows = con.execute("SELECT rowid FROM tiles ORDER BY rowid").fetchall()
    for k, (rowid,) in enumerate(rows):
        pixels = pixels_of(mode, (256, 256), k, "smooth")
        blob = pillow_webp(pixels, mode) if k % 2 else native.webp_encode_native(pixels)
        con.execute("UPDATE tiles SET tile_data = ? WHERE rowid = ?", (blob, rowid))
    con.commit()
    con.close()
    pipeline.clear_read_cache()
    assert_same(port_gpkg.read_gpkg_raster(path), jax_gpkg.read_gpkg_raster(path))


# --- the build, the counts ---


@pytest.fixture
def private_build(tmp_path, monkeypatch):
    """A private _build/ and library cache: nothing built here is reused."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_build, "_LIBRARIES", {})
    monkeypatch.setattr(_build, "_NAME_LOCKS", {})
    return tmp_path


@pytest.mark.parametrize("failure", ["fails", "missing"])
def test_a_failing_compiler_raises_and_nothing_falls_back(private_build, monkeypatch, tmp_path,
                                                          failure):
    import shutil

    if failure == "fails":
        monkeypatch.setattr(_build, "gxx_path", lambda: shutil.which("false"))
        message = "g\\+\\+ failed on .*webpcodec.cpp"
    else:
        monkeypatch.setattr(_build, "gxx_path", lambda: str(tmp_path / "no-such-g++"))
        message = "g\\+\\+ could not run on .*webpcodec.cpp"
    pixels = pixels_of("RGB", (8, 8), 0)
    with pytest.raises(RuntimeError, match=message):
        native.load_webpcodec()
    with pytest.raises(RuntimeError, match=message):
        native.webp_decode_native(pillow_webp(pixels))
    with pytest.raises(RuntimeError, match=message):
        native.webp_encode_native(pixels)
    # one band, one strip: a single chunk, decoded and encoded inline, so
    # that no task of the codec's pool outlives the patched compiler
    band = np.ascontiguousarray(pixels[None, :, :, 0])
    tif = str(tmp_path / "webp.tif")
    jax_geotiff.write_geotiff(tif, band, GT, "EPSG:28992", None, compress="webp")
    with pytest.raises(RuntimeError, match=message):
        port_geotiff.read_geotiff(tif)
    with pytest.raises(RuntimeError, match=message):
        port_geotiff.write_geotiff(str(tmp_path / "ours.tif"), band, GT, "EPSG:28992", None,
                                   compress="webp")


def test_the_codec_builds_outside_its_sources():
    native.load_webpcodec()
    here = os.path.dirname(native.__file__)
    assert not [name for name in os.listdir(here) if name.endswith((".so", ".bin"))]
    assert any(name.startswith("libwebpcodec-") for name in os.listdir(_build.BUILD_DIR))


def test_native_counts():
    native.reset_counts()
    pixels = pixels_of("RGB", (20, 30), 0)
    blob = native.webp_encode_native(pixels)
    native.webp_decode_native(blob)
    assert native.counts["webp_encodes"] == 1 and native.counts["webp_encoded_bytes"] == len(blob)
    assert native.counts["webp_decodes"] == 1 and native.counts["webp_bytes"] == 20 * 30 * 3


# --- chip_smoke's fixtures and phase ---


def fixture_bytes(name):
    """What Pillow writes for a fixture of chip_smoke.WEBP_FIXTURES,
    WEBP_LOSSY_FIXTURES or WEBP_REFUSED."""
    if name in chip_smoke.WEBP_FIXTURES:
        mode, shape, colours, options = chip_smoke.WEBP_FIXTURES[name]
        return pillow_webp(chip_smoke.webp_fixture_array(mode, shape, colours), mode, **options)
    holds = chip_smoke.WEBP_LOSSY_FIXTURES.get(name) or chip_smoke.WEBP_REFUSED[name]
    if holds == "VP8":
        return pillow_webp(chip_smoke.webp_fixture_array("RGB", (32, 48)), lossless=False,
                           quality=60)
    if holds == "ALPH":
        return pillow_webp(chip_smoke.webp_fixture_array("RGBA", (32, 48)), "RGBA",
                           lossless=False, quality=60)
    frames = [Image.fromarray(chip_smoke.webp_fixture_array("RGB", (16, 16), colours))
              for colours in (3, 5)]
    buf = io.BytesIO()
    frames[0].save(buf, format="WEBP", save_all=True, append_images=frames[1:], duration=100,
                   lossless=True)
    return buf.getvalue()


ALL_FIXTURES = (list(chip_smoke.WEBP_FIXTURES) + list(chip_smoke.WEBP_LOSSY_FIXTURES)
                + list(chip_smoke.WEBP_REFUSED))


def write_fixtures(folder):
    """Rewrite tests/data/torch_webp from Pillow: the files and
    hashes.json (the SHA-256 of Pillow's decoded arrays; the lossy ones'
    with ortho-lossy's chunks by tests/test_torch_webp_lossy.py)."""
    from tests.test_torch_webp_lossy import write_ortho_lossy

    os.makedirs(folder, exist_ok=True)
    decoded = {}
    for name in ALL_FIXTURES:
        blob = fixture_bytes(name)
        with open(os.path.join(folder, name), "wb") as f:
            f.write(blob)
        if name in chip_smoke.WEBP_FIXTURES:
            array = pillow_read(blob)[0]
            decoded[name] = {"shape": list(array.shape), "sha256": chip_smoke.array_sha256(array)}
    with open(os.path.join(folder, "hashes.json"), "w") as f:
        json.dump({"decoded": decoded}, f, indent=1, sort_keys=True)
        f.write("\n")
    write_ortho_lossy(folder)


def test_chip_smoke_fixtures_are_pillows():
    """Each file of tests/data/torch_webp is what Pillow writes for its
    entry, hashes.json holds Pillow's decoded arrays, the files cover gray,
    RGB and RGBA, methods 0 and 6, palettes of 2, 4, 16 and 200 colours,
    widths 1, 7 and 257 and a VP8X file, under 200 KB together (ortho-lossy's
    chunks apart), and check_webp_fixtures holds the port to them."""
    folder, recorded = chip_smoke.webp_fixture_hashes()
    total = 0
    for name in ALL_FIXTURES:
        blob = fixture_bytes(name)
        with open(os.path.join(folder, name), "rb") as f:
            assert f.read() == blob, name
        total += len(blob)
        if name in chip_smoke.WEBP_FIXTURES:
            array = pillow_read(blob)[0]
            assert recorded["decoded"][name] == {"shape": list(array.shape),
                                                 "sha256": chip_smoke.array_sha256(array)}
    assert total < 200_000
    specs = chip_smoke.WEBP_FIXTURES.values()
    assert {mode for mode, _, _, _ in specs} == set(MODES)
    assert {0, 6} <= {options.get("method", 4) for _, _, _, options in specs}
    assert {2, 4, 16, 200} <= {colours for _, _, colours, _ in specs}
    assert {1, 7, 257} <= {shape[1] for _, shape, _, _ in specs}
    assert any(_chunks(fixture_bytes(name))[0][0] == b"VP8X" for name in chip_smoke.WEBP_FIXTURES)
    assert sorted(os.listdir(folder)) == sorted(
        ALL_FIXTURES + ["hashes.json", chip_smoke.ORTHO_LOSSY_DIR])
    held, refusals, chunks = chip_smoke.check_webp_fixtures("cpu")
    assert held == len(chip_smoke.WEBP_FIXTURES) + len(chip_smoke.webp_lossy_fixture_names())
    assert sorted(refusals) == sorted(list(chip_smoke.WEBP_REFUSED)
                                      + ["truncated", "truncated lossy"])
    assert sorted(chunks) == sorted(chip_smoke.ORTHO_LOSSY_CHUNKS)
    with open(os.path.join(folder, "hashes.json")) as f:
        assert json.load(f) == recorded


def test_pyramid_refusals_tile_is_lossy():
    """pyramid_refusals' WebP tile, once the lossy fixture, is the animated
    one now that the port decodes lossy WebP: Pillow decodes it, so the
    JAX package reads the file, and the port refuses it."""
    blob = fixture_bytes("animated-2x16x16.webp")
    assert [tag for tag, _ in _chunks(blob)][:2] == [b"VP8X", b"ANIM"]
    assert pillow_read(blob)[1] == "RGBA"  # an animation's canvas
    with pytest.raises(NotImplementedError, match="dask_geomodeling_tpu/io/gpkg_raster.py"):
        native.webp_decode_native(blob)


def test_the_phase_on_the_cpu(tmp_path, monkeypatch):
    """check_ortho_webp on CPU tensors over a 1024^2 orthophoto, a 512^2
    sub-area, 256^2 tiles in batches of 8, the windowed-read limit
    lowered: every check of the full run, (g)'s lossy file of the committed
    chunks among them, the files removed."""
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.raster import spatial

    def launching(*args, **kwargs):
        cuda_stencils.launches += 1
        return cuda_stencils.gaussian_blur_reference(*args, **kwargs)

    monkeypatch.setattr(spatial, "gaussian_blur", launching)
    monkeypatch.setattr(chip_smoke, "TILE", 256)
    monkeypatch.setattr(chip_smoke, "BATCH", 8)
    with config.set({"geomodeling.torch-device": "cpu",
                     "geomodeling.windowed-read-limit": 100_000}):
        launches, numbers, kernels = chip_smoke.check_ortho_webp(
            "cpu", "cpu", str(tmp_path), px=1024, sub_px=512, sampled_tiles=2)
    assert launches["gaussian_blur"] >= 7 and launches["moving_max"] == 0
    assert kernels == [] and numbers["native_decodes"] >= 4 * 3
    assert numbers["tiles_encoded"] == 12 and numbers["windows_checked"] >= 16
    assert numbers["sampled_webp_share"] < numbers["sampled_deflate_share"]
    assert numbers["gaussian_dtype"] == "float64"
    assert set(numbers["pyramids"]) == {"gpkg", "mbtiles"}
    lossy = numbers["lossy"]
    assert lossy["chunks"] == 4 and lossy["native_decodes"] >= 4
    assert lossy["windows_checked"] >= 4 and lossy["gaussian_launches"] >= 1
    assert not list(tmp_path.iterdir())


def test_webp_fixture_hash_helper_is_sha256_of_the_bytes():
    array = chip_smoke.webp_fixture_array("RGB", (3, 4), 2)
    assert chip_smoke.array_sha256(array) == hashlib.sha256(array.tobytes()).hexdigest()
