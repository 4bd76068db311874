"""The port's HDF4 reader (io/hdf4.py), its dispatch in the read caches
and ``RasterFileSource``, and chip_smoke's MODIS writer and modis-ndvi
view, held on the CPU to the JAX package's.

Every case of tests/test_hdf4.py runs once in each package (``run_both``
of tests/test_torch_raster_formats.py, with the test's own independent
writer): the files are byte-identical, and the payloads, infos and
errors the same (arrays bitwise with their dtypes; paths in messages made
relative).  Its chunked cases write the JAX reader's special element kind
6, as that test does.  The same chunked layouts written as the HDF4
library writes them, kind 5 with the description record's length, read
in the port as the values written, where the JAX reader refuses the kind
(its fault, not copied); so does a chunked file written by the system
HDF4 SD library, whole and by window (skipped where the library cannot
be loaded, as the JAX test skips).  The run-length, n-bit and
skip-huffman decoders give the JAX decoders' values or errors on
arbitrary bytes under hypothesis.  A ``RasterFileSource`` over an HDF4
file comes across with ``from_reference`` and answers the JAX numpy
executor bitwise, whole and by window, at the file's grid and in RD New;
its ``info`` decodes no chunk; every HDF suffix with HDF4's magic goes to
the HDF4 reader.  chip_smoke's ``write_modis_hdf4`` and the modis-ndvi
view at 480 x 480 in 48^2 chunks: the kind-6 file answers as the JAX
package's, and the kind-5 file (deflate, or szip in its reliability set
where libsz loads) answers the same in the port.  Tolerance: none but
one; compute_host is held bitwise everywhere, and get_data in RD New to
chip_smoke's HEADLINE_SHARE (at most 5e-4 of the cells differing), the
port's rule for a cross-CRS nearest warp on the device path.
"""
import struct
import zlib

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
from dask_geomodeling_tpu import raster as jax_raster
from dask_geomodeling_tpu.io import ccsds as jax_ccsds
from dask_geomodeling_tpu.io import hdf4 as jax_hdf4
from dask_geomodeling_tpu.runtime import pipeline as jax_pipeline
from dask_geomodeling_tpu_torch import compute_host, evaluate_tiled, from_reference
from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.io import ccsds, hdf4
from dask_geomodeling_tpu_torch.raster import RasterFileSource
from dask_geomodeling_tpu_torch.runtime import pipeline
from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests
from tests.test_hdf4 import (
    _GEO_META,
    _SINU_META,
    SPECIAL,
    TAG_CAL,
    TAG_CHUNK,
    TAG_COMPRESSED,
    TAG_FV,
    TAG_LINKED,
    TAG_NDG,
    TAG_SD,
    TAG_SDD,
    TAG_VH,
    Writer,
    _chunk_table,
    _hdf4_sd,
    _nt,
    _sdd,
    _simple_sds,
    _vdata,
    _vgroup,
    _write_skphuff,
)
from tests.test_torch_file_sources import assert_agrees, both_configs, jax_numpy
from tests.test_torch_raster_formats import _kit, assert_same, run_both
from tests.test_torch_zarr import error, info_fields



def _h4kit(port):
    """``_kit`` with the package's HDF4 and CCSDS modules and read cache."""
    kit = _kit(port)
    kit.hdf4 = hdf4 if port else jax_hdf4
    kit.ccsds = ccsds if port else jax_ccsds
    kit.pipeline = pipeline if port else jax_pipeline
    return kit


def run_hdf4(tmp_path, case):
    """``run_both`` with the HDF4 kits."""
    return run_both(tmp_path, lambda k, root: case(_h4kit(k.port), root))


def outcome(call, root=None):
    """What ``call()`` gives: its result, or its error's type and message
    (``root`` taken out of it)."""
    try:
        return "result", call()
    except Exception as raised:  # the same error in both packages
        message = str(raised)
        return "error", (type(raised).__name__, message.replace(str(root), "") if root else message)


def _library():
    lib = _hdf4_sd()
    if lib is None:
        pytest.skip("system HDF4 library not loadable")
    return lib


def _shared(root, name, write):
    """A file the system library writes once for both packages, beside
    their roots (it records its own path, so the two roots' copies would
    differ)."""
    folder = root.parent / "library"
    folder.mkdir(exist_ok=True)
    path = folder / name
    if not path.exists():
        write(str(path))
    return str(path)


def _chunk_record(kind, body):
    """A chunked element's description record: kind 6 as the JAX reader
    reads it, kind 5 as the HDF4 library writes it (the length of the rest
    before the version byte)."""
    if kind == 6:
        return struct.pack(">H", 6) + body
    return struct.pack(">Hi", 5, len(body)) + body


# --- tests/test_hdf4.py ---


def _magic_detection(k, root):
    writer = Writer()
    _simple_sds(writer, np.arange(6, dtype=np.int16).reshape(2, 3))
    path = writer.write(root)
    assert k.hdf4.is_hdf4(path)
    assert not k.hdf4.is_hdf4(__file__)
    with pytest.raises(IOError, match="Not an HDF4") as raised:
        k.hdf4.read_hdf4(__file__)
    return error(raised, root)


def _simple_int16_roundtrip(k, root):
    values = np.arange(24, dtype=np.int16).reshape(4, 6)
    writer = Writer()
    _simple_sds(writer, values)
    data = k.hdf4.read_hdf4(writer.write(root))
    assert data.array.shape == (1, 4, 6)
    np.testing.assert_array_equal(data.array[0], values)
    assert data.geo_transform == (0.0, 1.0, 0.0, 0.0, 0.0, -1.0)
    assert data.projection is None
    return data


def _rank3_multiband(k, root):
    values = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    writer = Writer()
    _simple_sds(writer, values, kind="f4")
    data = k.hdf4.read_hdf4(writer.write(root))
    np.testing.assert_array_equal(data.array, values)
    return data


def _fill_value_and_calibration(k, root):
    values = np.array([[1, 2], [3, -99]], np.int16)
    writer = Writer()
    fv_ref = writer.add(TAG_FV, 2, np.array(-99, ">i2").tobytes())
    cal = struct.pack(">dddd", 0.5, 0.0, 10.0, 0.0) + struct.pack(">i", 1)
    cal_ref = writer.add(TAG_CAL, 2, cal)
    _simple_sds(writer, values, extra_ndg=[(TAG_FV, fv_ref), (TAG_CAL, cal_ref)])
    data = k.hdf4.read_hdf4(writer.write(root))
    mask = values == -99
    np.testing.assert_allclose(data.array[0][~mask], 0.5 * (values[~mask] - 10.0))
    assert np.all(data.array[0][mask] == np.float32(data.no_data_value))
    return data


def _sd_api_attributes(k, root):
    values = np.array([[100, 200], [300, 999]], np.int32)
    writer = Writer()
    _simple_sds(writer, values, ref=2)
    _vdata(writer, 11, "_FillValue", "Attr0.0", "i4", [999])
    _vdata(writer, 12, "scale_factor", "Attr0.0", "f8", [0.01])
    _vdata(writer, 13, "long_name", "Attr0.0", "c", ["ignored"])
    _vgroup(writer, 20, "ndvi", "Var0.0", [(TAG_NDG, 2), (TAG_VH, 11), (TAG_VH, 12), (TAG_VH, 13)])
    data = k.hdf4.read_hdf4(writer.write(root))
    assert data.metadata[0] == "ndvi"
    return data


def _deflate_compressed_element(k, root):
    values = np.arange(64, dtype=np.uint8).reshape(8, 8)
    raw = values.tobytes()
    writer = Writer()
    nt_ref = _nt(writer, 2, "u1")
    _sdd(writer, 2, values.shape, nt_ref)
    writer.add(TAG_SD | SPECIAL, 2, struct.pack(">HHiHHH", 3, 0, len(raw), 7, 0, 4)
               + struct.pack(">H", 6))
    writer.add(TAG_COMPRESSED, 7, zlib.compress(raw, 6))
    _ndg_sd(writer)
    data = k.hdf4.read_hdf4(writer.write(root))
    np.testing.assert_array_equal(data.array[0], values)
    return data


def _ndg_sd(writer):
    writer.add(TAG_NDG, 2, struct.pack(">HHHH", TAG_SDD, 2, TAG_SD, 2))


def _rle_compressed_element(k, root):
    values = np.zeros((4, 8), np.uint8)
    values[1] = 7
    writer = Writer()
    nt_ref = _nt(writer, 2, "u1")
    _sdd(writer, 2, values.shape, nt_ref)
    writer.add(TAG_SD | SPECIAL, 2, struct.pack(">HHiHHH", 3, 0, values.size, 7, 0, 1))
    writer.add(TAG_COMPRESSED, 7, bytes([127 + 8, 0, 127 + 8, 7, 127 + 16, 0]))
    _ndg_sd(writer)
    data = k.hdf4.read_hdf4(writer.write(root))
    np.testing.assert_array_equal(data.array[0], values)
    return data


def _linked_blocks_element(k, root):
    values = np.arange(40, dtype=np.uint8).reshape(5, 8)
    raw = values.tobytes()
    writer = Writer()
    nt_ref = _nt(writer, 2, "u1")
    _sdd(writer, 2, values.shape, nt_ref)
    writer.add(TAG_SD | SPECIAL, 2, struct.pack(">HiiiH", 1, len(raw), 16, 3, 30))
    writer.add(TAG_LINKED, 30, struct.pack(">HHHH", 0, 31, 32, 33))
    writer.add(TAG_LINKED, 31, raw[:16])
    writer.add(TAG_LINKED, 32, raw[16:32])
    writer.add(TAG_LINKED, 33, raw[32:])
    _ndg_sd(writer)
    data = k.hdf4.read_hdf4(writer.write(root))
    np.testing.assert_array_equal(data.array[0], values)
    return data


def _dfsd_standalone_pair(k, root):
    values = np.arange(12, dtype=np.float32).reshape(3, 4)
    writer = Writer()
    nt_ref = _nt(writer, 2, "f4")
    _sdd(writer, 2, values.shape, nt_ref)
    writer.add(TAG_SD, 2, values.astype(">f4").tobytes())
    data = k.hdf4.read_hdf4(writer.write(root))
    np.testing.assert_array_equal(data.array[0], values)
    return data


def _hdfeos_grid(meta):
    def case(k, root):
        writer = Writer()
        _simple_sds(writer, np.arange(12, dtype=np.int16).reshape(3, 4))
        _vdata(writer, 60, "StructMetadata.0", "Attr0.0", "c", [meta])
        return k.hdf4.read_hdf4(writer.write(root))
    return case


def _raster_file_source_integration(k, root):
    values = np.arange(12, dtype=np.int16).reshape(3, 4)
    writer = Writer()
    _simple_sds(writer, values)
    _vdata(writer, 60, "StructMetadata.0", "Attr0.0", "c", [_GEO_META])
    writer.write(root)
    data = k.get_data(k.R.RasterFileSource("test.hdf"), mode="vals",
                      bbox=(4.0, 52.0, 6.0, 55.0), projection="EPSG:4326", width=4, height=3,
                      start=None, stop=None)
    np.testing.assert_array_equal(data["values"][0], values)
    return data


def _unsupported_coder_message(k, root):
    writer = Writer()
    nt_ref = _nt(writer, 2, "u1")
    _sdd(writer, 2, (2, 2), nt_ref)
    writer.add(TAG_SD | SPECIAL, 2, struct.pack(">HHiHHH", 3, 0, 4, 7, 0, 5))  # szip
    writer.add(TAG_COMPRESSED, 7, b"\x00\x00\x00\x00")
    _ndg_sd(writer)
    with pytest.raises(ValueError, match="szip") as raised:
        k.hdf4.read_hdf4(writer.write(root))
    return error(raised, root)


def _external_element(k, root):
    values = np.arange(48, dtype=np.uint8).reshape(6, 8)
    (root / "payload.dat").write_bytes(b"xx" + values.tobytes())
    writer = Writer()
    nt_ref = _nt(writer, 2, "u1")
    _sdd(writer, 2, values.shape, nt_ref)
    name = b"payload.dat"
    writer.add(TAG_SD | SPECIAL, 2, struct.pack(">Hiii", 2, values.size, 2, len(name)) + name)
    _ndg_sd(writer)
    data = k.hdf4.read_hdf4(writer.write(root))
    np.testing.assert_array_equal(data.array[0], values)
    return data


def _external_element_missing_file(k, root):
    writer = Writer()
    nt_ref = _nt(writer, 2, "u1")
    _sdd(writer, 2, (2, 2), nt_ref)
    name = b"gone.dat"
    writer.add(TAG_SD | SPECIAL, 2, struct.pack(">Hiii", 2, 4, 0, len(name)) + name)
    _ndg_sd(writer)
    with pytest.raises(ValueError, match="not found") as raised:
        k.hdf4.read_hdf4(writer.write(root))
    return error(raised, root)


def _external_element_escaping_path_confined(k, root):
    values = np.zeros((2, 2), np.uint8)
    (root / "safe.dat").write_bytes(values.tobytes())
    writer = Writer()
    nt_ref = _nt(writer, 2, "u1")
    _sdd(writer, 2, values.shape, nt_ref)
    name = b"../../../../etc/safe.dat"
    writer.add(TAG_SD | SPECIAL, 2, struct.pack(">Hiii", 2, 4, 0, len(name)) + name)
    _ndg_sd(writer)
    data = k.hdf4.read_hdf4(writer.write(root))
    np.testing.assert_array_equal(data.array[0], values)
    return data


def _szip_element(dtype, kind, options, bits, block, scanline, shape):
    def case(k, root):
        if not k.ccsds.szip_available():
            pytest.skip("libsz not loadable")
        values = ((np.arange(np.prod(shape)) * 13) % 4099 % (2**bits)).astype(
            ">" + dtype).reshape(shape)
        raw = values.tobytes()
        coded = k.ccsds.szip_compress(raw, options, bits_per_pixel=bits, pixels_per_block=block,
                                      pixels_per_scanline=scanline)
        writer = Writer()
        nt_ref = _nt(writer, 2, kind)
        _sdd(writer, 2, values.shape, nt_ref)
        writer.add(TAG_SD | SPECIAL, 2, struct.pack(">HHiHHH", 3, 0, len(raw), 7, 0, 5)
                   + struct.pack(">iiiii", values.size, scanline, options, bits, block))
        writer.add(TAG_COMPRESSED, 7, coded)
        _ndg_sd(writer)
        data = k.hdf4.read_hdf4(writer.write(root))
        np.testing.assert_array_equal(data.array[0], values.astype(dtype))
        return data
    return case


def _pack_fields(fields, bit_len):
    bits = []
    for value in fields:
        bits += [(value >> b) & 1 for b in range(bit_len - 1, -1, -1)]
    while len(bits) % 8:
        bits.append(0)
    return np.packbits(np.array(bits, np.uint8)).tobytes()


def _nbit(fields, bit_len, expected_len, shape, kind, nt_code, sign_ext, fill_one, start_bit,
          expected):
    def case(k, root):
        writer = Writer()
        nt_ref = _nt(writer, 2, kind)
        _sdd(writer, 2, shape, nt_ref)
        writer.add(TAG_SD | SPECIAL, 2, struct.pack(">HHiHHH", 3, 0, expected_len, 7, 0, 2)
                   + struct.pack(">iiiii", nt_code, sign_ext, fill_one, start_bit, bit_len))
        writer.add(TAG_COMPRESSED, 7, _pack_fields(fields, bit_len))
        _ndg_sd(writer)
        data = k.hdf4.read_hdf4(writer.write(root))
        np.testing.assert_array_equal(data.array[0], np.array(expected).reshape(shape))
        return data
    return case


def _skphuff_uint8(k, root):
    lib = _library()
    values = ((np.arange(21 * 17) * 7) % 40).astype(np.uint8).reshape(21, 17)
    path = _shared(root, "skp.hdf", lambda p: _write_skphuff(lib, p, values, 21, 1))
    data = k.hdf4.read_hdf4(path)
    np.testing.assert_array_equal(data.array[0], values)
    return data


def _skphuff_multibyte_skip_trees(k, root):
    lib = _library()
    rng = np.random.RandomState(42)
    i16 = rng.randint(-900, 900, size=(13, 19)).astype(np.int16)
    f32 = (rng.randint(0, 50, size=(9, 11)) * 0.25).astype(np.float32)
    found = []
    for name, values, nt, skip in (("skp16.hdf", i16, 22, 2), ("skp32.hdf", f32, 5, 4),
                                   ("skple.hdf", i16, 22 | 0x4000, 2)):
        path = _shared(root, name, lambda p: _write_skphuff(lib, p, values, nt, skip))
        found.append(k.hdf4.read_hdf4(path))
        np.testing.assert_array_equal(found[-1].array[0], values)
    return found


def _skphuff_raises(skip_size, stream, match):
    def case(k, root):
        writer = Writer()
        nt_ref = _nt(writer, 2, "u1")
        _sdd(writer, 2, (8, 8), nt_ref)
        writer.add(TAG_SD | SPECIAL, 2, struct.pack(">HHiHHH", 3, 0, 64, 7, 0, 3)
                   + struct.pack(">i", skip_size))
        writer.add(TAG_COMPRESSED, 7, stream)
        _ndg_sd(writer)
        with pytest.raises(ValueError, match=match) as raised:
            k.hdf4.read_hdf4(writer.write(root))
        return error(raised, root)
    return case


# --- the chunked cases: kind 6 as tests/test_hdf4.py writes them, kind 5 ---


def _chunked_element(k, root, kind):
    values = np.arange(30, dtype=np.int16).reshape(5, 6)
    writer = Writer()
    nt_ref = _nt(writer, 2, "i2")
    _sdd(writer, 2, values.shape, nt_ref)
    entries, ref = [], 40
    for ci in range(2):
        for cj in range(2):
            block = np.zeros((3, 4), np.int16)
            part = values[ci * 3:ci * 3 + 3, cj * 4:cj * 4 + 4]
            block[:part.shape[0], :part.shape[1]] = part
            writer.add(TAG_CHUNK, ref, block.astype(">i2").tobytes())
            entries.append(((ci, cj), TAG_CHUNK, ref))
            ref += 1
    _chunk_table(writer, 50, entries, 2)
    fill = np.array(-1, ">i2").tobytes()
    body = struct.pack(">BiiiiHHHHi", 1, 0, values.size * 2, 24, 2, TAG_VH, 50, 0, 0, 2)
    body += struct.pack(">iii", 0, 5, 3) + struct.pack(">iii", 0, 6, 4)
    body += struct.pack(">i", len(fill)) + fill
    writer.add(TAG_SD | SPECIAL, 2, _chunk_record(kind, body))
    _ndg_sd(writer)
    data = k.hdf4.read_hdf4(writer.write(root))
    np.testing.assert_array_equal(data.array[0], values)
    return "test.hdf", data


def _chunked_compressed_chunks(k, root, kind):
    values = np.arange(16, dtype=np.uint8).reshape(4, 4)
    writer = Writer()
    nt_ref = _nt(writer, 2, "u1")
    _sdd(writer, 2, values.shape, nt_ref)
    entries, ref = [], 40
    for ci in range(2):
        raw = values[ci * 2:ci * 2 + 2, :].tobytes()
        writer.add(TAG_CHUNK | SPECIAL, ref,
                   struct.pack(">HHiHHH", 3, 0, len(raw), ref + 100, 0, 4))
        writer.add(TAG_COMPRESSED, ref + 100, zlib.compress(raw))
        entries.append(((ci, 0), TAG_CHUNK, ref))
        ref += 1
    _chunk_table(writer, 50, entries, 2)
    body = struct.pack(">BiiiiHHHHi", 1, 1, values.size, 21, 1, TAG_VH, 50, 0, 0, 2)
    body += struct.pack(">iii", 0, 4, 2) + struct.pack(">iii", 0, 4, 4) + struct.pack(">i", 0)
    writer.add(TAG_SD | SPECIAL, 2, _chunk_record(kind, body))
    _ndg_sd(writer)
    data = k.hdf4.read_hdf4(writer.write(root))
    np.testing.assert_array_equal(data.array[0], values)
    return "test.hdf", data


def _chunked_szip_elements(k, root, kind):
    if not k.ccsds.szip_available():
        pytest.skip("libsz not loadable")
    values = ((np.arange(64) * 11) % 199).astype(np.uint8).reshape(8, 8)
    options = 32 | 4 | 1
    writer = Writer()
    nt_ref = _nt(writer, 2, "u1")
    _sdd(writer, 2, values.shape, nt_ref)
    entries, ref = [], 40
    for ci in range(2):
        raw = values[ci * 4:ci * 4 + 4, :].tobytes()
        coded = k.ccsds.szip_compress(raw, options, bits_per_pixel=8, pixels_per_block=8,
                                      pixels_per_scanline=8)
        writer.add(TAG_CHUNK | SPECIAL, ref, struct.pack(">HHiHHH", 3, 0, len(raw), ref + 100, 0, 5)
                   + struct.pack(">iiiii", 32, 8, options, 8, 8))
        writer.add(TAG_COMPRESSED, ref + 100, coded)
        entries.append(((ci, 0), TAG_CHUNK, ref))
        ref += 1
    _chunk_table(writer, 50, entries, 2)
    body = struct.pack(">BiiiiHHHHi", 1, 1, values.size, 21, 1, TAG_VH, 50, 0, 0, 2)
    body += struct.pack(">iii", 0, 8, 4) + struct.pack(">iii", 0, 8, 8) + struct.pack(">i", 0)
    writer.add(TAG_SD | SPECIAL, 2, _chunk_record(kind, body))
    _ndg_sd(writer)
    data = k.hdf4.read_hdf4(writer.write(root))
    np.testing.assert_array_equal(data.array[0], values)
    return "test.hdf", data


def _chunked_skphuff_chunks(k, root, kind):
    lib = _library()
    values = ((np.arange(64) * 11) % 29).astype(np.uint8).reshape(8, 8)

    def payload(block, name):
        # the library's stream for one block, lifted out of its own file
        path = _shared(root, name, lambda p: _write_skphuff(lib, p, block, 21, 1))
        with open(path, "rb") as f:
            parsed = k.hdf4._File(f.read(), path)
        for (tag, ref) in parsed.dds:
            if tag == (TAG_SD | SPECIAL):
                (_, n, data_ref, _, coder) = struct.unpack_from(">HiHHH", parsed.raw(tag, ref), 2)
                assert coder == 3
                return parsed.element(TAG_COMPRESSED, data_ref), n

    writer = Writer()
    nt_ref = _nt(writer, 2, "u1")
    _sdd(writer, 2, values.shape, nt_ref)
    entries, ref = [], 40
    for ci in range(2):
        stream, n = payload(values[ci * 4:ci * 4 + 4, :], "chunk%d.hdf" % ci)
        writer.add(TAG_CHUNK | SPECIAL, ref, struct.pack(">HHiHHH", 3, 0, n, ref + 100, 0, 3)
                   + struct.pack(">i", 1))
        writer.add(TAG_COMPRESSED, ref + 100, stream)
        entries.append(((ci, 0), TAG_CHUNK, ref))
        ref += 1
    _chunk_table(writer, 50, entries, 2)
    body = struct.pack(">BiiiiHHHHi", 1, 1, values.size, 21, 1, TAG_VH, 50, 0, 0, 2)
    body += struct.pack(">iii", 0, 8, 4) + struct.pack(">iii", 0, 8, 8) + struct.pack(">i", 0)
    writer.add(TAG_SD | SPECIAL, 2, _chunk_record(kind, body))
    _ndg_sd(writer)
    data = k.hdf4.read_hdf4(writer.write(root))
    np.testing.assert_array_equal(data.array[0], values)
    return "test.hdf", data


def _windowed_file(root, kind, name="chunked.hdf"):
    """TestWindowedReads' file: 30 x 28 uint8 in 10 x 7 deflate chunks."""
    values = (np.arange(30 * 28) % 251).astype(np.uint8).reshape(30, 28)
    writer = Writer()
    nt_ref = _nt(writer, 2, "u1")
    _sdd(writer, 2, values.shape, nt_ref)
    entries, ref = [], 40
    for ci in range(3):
        for cj in range(4):
            block = np.zeros((10, 7), np.uint8)
            part = values[ci * 10:ci * 10 + 10, cj * 7:cj * 7 + 7]
            block[:part.shape[0], :part.shape[1]] = part
            raw = block.tobytes()
            writer.add(TAG_CHUNK | SPECIAL, ref,
                       struct.pack(">HHiHHH", 3, 0, len(raw), ref + 100, 0, 4))
            writer.add(TAG_COMPRESSED, ref + 100, zlib.compress(raw))
            entries.append(((ci, cj), TAG_CHUNK, ref))
            ref += 1
    _chunk_table(writer, 50, entries, 2)
    body = struct.pack(">BiiiiHHHHi", 1, 1, values.size, 21, 70, TAG_VH, 50, 0, 0, 2)
    body += struct.pack(">iii", 0, 30, 10) + struct.pack(">iii", 0, 28, 7) + struct.pack(">i", 0)
    writer.add(TAG_SD | SPECIAL, 2, _chunk_record(kind, body))
    _ndg_sd(writer)
    _vdata(writer, 60, "StructMetadata.0", "Attr0.0", "c", [
        _GEO_META.replace("XDim=4", "XDim=28").replace("YDim=3", "YDim=30")])
    return writer.write(root, name), values


def _chunked_window_bit_exact(k, root, kind):
    path, values = _windowed_file(root, kind)
    whole = k.hdf4.read_hdf4(path)
    np.testing.assert_array_equal(whole.array[0], values)
    parts = []
    for window in [(0, 30, 0, 28), (5, 17, 3, 22), (9, 11, 6, 8), (0, 1, 0, 28),
                   (29, 30, 27, 28), (-4, 50, 20, 90)]:
        r0, r1, c0, c1 = window
        parts.append(k.hdf4.read_hdf4_window(path, *window))
        np.testing.assert_array_equal(parts[-1].array,
                                      whole.array[:, max(r0, 0):r1, max(c0, 0):c1])
    return "chunked.hdf", [whole] + parts


def _info_is_metadata_only(k, root, kind):
    path, _ = _windowed_file(root, kind)
    info = k.hdf4.read_hdf4_info(path)
    assert (info.width, info.height, info.bands) == (28, 30, 1)
    return "chunked.hdf", info_fields(info)


def _source_windowed_requests(k, root, kind):
    _windowed_file(root, kind)
    source = k.R.RasterFileSource("chunked.hdf")
    request = dict(mode="vals", bbox=(4.25, 52.5, 4.75, 53.5), projection="EPSG:4326",
                   width=4, height=4, start=None, stop=None)
    whole = k.get_data(source, **request)
    with k.config.set({"geomodeling.windowed-read-limit": 16}):
        windowed = k.get_data(k.R.RasterFileSource("chunked.hdf"), **request)
    np.testing.assert_array_equal(whole["values"], windowed["values"])
    return "chunked.hdf", [whole, windowed]


CHUNKED_CASES = {
    "chunked-element": _chunked_element,
    "chunked-compressed-chunks": _chunked_compressed_chunks,
    "chunked-szip-elements": _chunked_szip_elements,
    "chunked-skphuff-chunks": _chunked_skphuff_chunks,
    "chunked-window-bit-exact": _chunked_window_bit_exact,
    "info-is-metadata-only": _info_is_metadata_only,
    "source-windowed-requests": _source_windowed_requests,
}


def _contiguous_window_bit_exact(k, root):
    values = (np.arange(20 * 16) % 200).astype(np.int16).reshape(20, 16)
    writer = Writer()
    _simple_sds(writer, values)
    path = writer.write(root)
    whole = k.hdf4.read_hdf4(path)
    part = k.hdf4.read_hdf4_window(path, 3, 12, 5, 14)
    np.testing.assert_array_equal(part.array, whole.array[:, 3:12, 5:14])
    return part


JAX_CASES = {
    "magic-detection": _magic_detection,
    "simple-int16-roundtrip": _simple_int16_roundtrip,
    "rank3-multiband": _rank3_multiband,
    "fill-value-and-calibration": _fill_value_and_calibration,
    "sd-api-attributes": _sd_api_attributes,
    "deflate-compressed-element": _deflate_compressed_element,
    "rle-compressed-element": _rle_compressed_element,
    "linked-blocks-element": _linked_blocks_element,
    "dfsd-standalone-pair": _dfsd_standalone_pair,
    "hdfeos-sinusoidal-grid": _hdfeos_grid(_SINU_META),
    "hdfeos-geo-grid-packed-dms": _hdfeos_grid(_GEO_META),
    "raster-file-source-integration": _raster_file_source_integration,
    "unsupported-coder-message": _unsupported_coder_message,
    "contiguous-window-bit-exact": _contiguous_window_bit_exact,
    "external-element": _external_element,
    "external-element-missing-file": _external_element_missing_file,
    "external-element-escaping-path-confined": _external_element_escaping_path_confined,
    "szip-compressed-element": _szip_element("u1", "u1", 32 | 4 | 1, 8, 8, 16, (16, 16)),
    "szip-16bit-element": _szip_element("u2", "u2", 32 | 4 | 16 | 1, 16, 16, 32, (16, 32)),
    "nbit-unsigned-fields": _nbit([0, 1, 17, 63, 32, 5, 63, 2], 6, 8, (2, 4), "u1", 21, 0, 0, 5,
                                  [0, 1, 17, 63, 32, 5, 63, 2]),
    "nbit-shifted-field-with-fill-one": _nbit([0b1010, 0b0001], 4, 2, (1, 2), "u1", 21, 0, 1, 5,
                                              [0b11101011, 0b11000111]),
    "nbit-signed-extension-int16": _nbit([0b11111, 0b00001, 0b10000, 0b01111], 5, 8, (1, 4),
                                         "i2", 22, 1, 0, 4, [-1, 1, -16, 15]),
    "skphuff-uint8": _skphuff_uint8,
    "skphuff-multibyte-skip-trees": _skphuff_multibyte_skip_trees,
    "skphuff-truncated-stream-raises": _skphuff_raises(1, b"\xff\x00", "truncated"),
    "skphuff-implausible-skip-size-raises": _skphuff_raises(1 << 20, b"\x00" * 64, "skip size"),
    **{name + "-kind6": (lambda case: lambda k, root: case(k, root, 6))(case)
       for name, case in CHUNKED_CASES.items()},
}


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_jax_case(tmp_path, name):
    """One case of tests/test_hdf4.py, in each package."""
    run_hdf4(tmp_path, JAX_CASES[name])


@pytest.mark.parametrize("name", list(CHUNKED_CASES))
def test_kind5_chunked_case(tmp_path, name):
    """The chunked layouts as the HDF4 library writes them (kind 5, the
    description record's length before its version byte): the port reads
    the values written, by window too; the JAX reader refuses the kind."""
    pipeline.clear_read_cache()
    with config.set({"geomodeling.root": str(tmp_path)}):
        file_name, _ = CHUNKED_CASES[name](_h4kit(True), tmp_path, 5)
    refused = outcome(lambda: jax_hdf4.read_hdf4(str(tmp_path / file_name)))
    assert refused == ("error", ("_Hdf4Error", "Unsupported HDF4 special element kind 5"))


def test_skphuff_message_keeps_the_double_prefix(tmp_path):
    """The skip-huffman errors carry the JAX reader's double prefix, so
    that the packages agree."""
    raised = JAX_CASES["skphuff-truncated-stream-raises"](_h4kit(True), tmp_path)
    assert raised == ("_Hdf4Error", "HDF4 skip-huffman element: HDF4 skip-huffman stream "
                                    "is truncated")


# --- a chunked file from the system HDF4 library ---


def _library_chunked(path, values, nt, chunks, comp_type):
    """``values`` written whole by the system HDF4 SD library as one
    chunked data set (SDsetchunk: HDF_CHUNK, with deflate at level 6 when
    ``comp_type`` is 4), as tests/test_hdf4.py's library test writes it."""
    import ctypes

    lib = _library()

    class ChunkDef(ctypes.Structure):
        _fields_ = [("chunk_lengths", ctypes.c_int32 * 32), ("comp_type", ctypes.c_int32),
                    ("cinfo", ctypes.c_int * 14)]

    lib.SDsetchunk.argtypes = [ctypes.c_int32, ChunkDef, ctypes.c_int32]
    lib.SDsetchunk.restype = ctypes.c_int
    values = np.ascontiguousarray(values)
    fid = lib.SDstart(path.encode(), 4)
    sds = lib.SDcreate(fid, b"data", nt, 2, (ctypes.c_int32 * 2)(*values.shape))
    definition = ChunkDef()
    definition.chunk_lengths[0], definition.chunk_lengths[1] = chunks
    definition.comp_type = comp_type
    definition.cinfo[0] = 6
    assert lib.SDsetchunk(sds, definition, 3 if comp_type else 1) == 0
    assert lib.SDwritedata(sds, (ctypes.c_int32 * 2)(0, 0), None,
                           (ctypes.c_int32 * 2)(*values.shape),
                           values.ctypes.data_as(ctypes.c_void_p)) == 0
    assert lib.SDendaccess(sds) == 0
    assert lib.SDend(fid) == 0


@pytest.mark.parametrize("dtype, nt, shape, chunks, comp_type", [
    ("u1", 21, (40, 50), (16, 16), 4),
    ("i2", 22, (37, 61), (10, 24), 4),
    ("f4", 5, (30, 20), (30, 7), 4),
    ("i2", 22, (33, 29), (8, 8), 0),
])
def test_chunked_file_from_the_library(tmp_path, dtype, nt, shape, chunks, comp_type):
    """A chunked data set written by the system HDF4 library (kind 5, the
    real chunk table and records): the port reads it whole and by window
    as the values written, in info and through the read caches."""
    rng = np.random.RandomState(sum(shape))
    values = (rng.rand(*shape) * 120 - 20).astype(dtype)
    path = str(tmp_path / "library.hdf")
    _library_chunked(path, values, nt, chunks, comp_type)
    data = hdf4.read_hdf4(path)
    assert data.metadata == ["data"] and data.array.shape == (1,) + shape
    np.testing.assert_array_equal(data.array[0], values)
    for window in [(5, 33, 7, 49), (0, 1, 0, shape[1]), (shape[0] - 3, shape[0], 2, 9)]:
        r0, r1, c0, c1 = window
        part = hdf4.read_hdf4_window(path, *window)
        np.testing.assert_array_equal(part.array[0], values[r0:r1, c0:c1])
    info = hdf4.read_hdf4_info(path)
    assert (info.width, info.height, info.bands, info.metadata) == (shape[1], shape[0], 1,
                                                                   ["data"])
    pipeline.clear_read_cache()
    np.testing.assert_array_equal(pipeline.read_geotiff_window_cached(path, 2, 9, 3, 11).array[0],
                                  values[2:9, 3:11])
    pipeline.clear_read_cache()


# --- the decoders under hypothesis ---


@settings(max_examples=200, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.binary(max_size=120), st.integers(0, 300))
def test_rle_decode_equals_jax(data, expected):
    """Any bytes and length: the JAX decoder's bytes or error."""
    ours = outcome(lambda: hdf4._rle_decode(data, expected))
    assert ours == outcome(lambda: jax_hdf4._rle_decode(data, expected))


@settings(max_examples=200, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.binary(max_size=64), st.integers(0, 80),
       st.sampled_from([3, 4, 5, 6, 20, 21, 22, 23, 24, 25, 26, 27, 22 | 0x4000, 2, 99]),
       st.booleans(), st.booleans(), st.integers(-2, 66), st.integers(-2, 66))
def test_nbit_decode_equals_jax(data, expected, nt_code, sign_ext, fill_one, start_bit, bit_len):
    """Any fields, number type and bit layout: the JAX decoder's bytes or
    error."""
    args = (data, expected, nt_code, int(sign_ext), int(fill_one), start_bit, bit_len)
    ours = outcome(lambda: hdf4._nbit_decode(*args))
    assert ours == outcome(lambda: jax_hdf4._nbit_decode(*args))


@settings(max_examples=200, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.binary(max_size=96), st.integers(0, 120), st.integers(-1, 70))
def test_skphuff_decode_equals_jax(data, expected, skip_size):
    """Any stream, length and skip size: the JAX decoder's bytes or
    error."""
    ours = outcome(lambda: hdf4._skphuff_decode(data, expected, skip_size))
    assert ours == outcome(lambda: jax_hdf4._skphuff_decode(data, expected, skip_size))


@pytest.mark.parametrize("skip_size, dtype", [(1, "u1"), (2, ">i2"), (4, ">f4")])
def test_skphuff_decode_library_streams(tmp_path, skip_size, dtype):
    """Streams from the system library's coder decode alike in both
    packages to the values written."""
    lib = _library()
    rng = np.random.RandomState(skip_size)
    values = (rng.randint(0, 60, (17, 23)) * (0.5 if dtype == ">f4" else 3)).astype(
        dtype.lstrip(">"))
    nt = {"u1": 21, ">i2": 22, ">f4": 5}[dtype]
    path = str(tmp_path / "skp.hdf")
    _write_skphuff(lib, path, values, nt, skip_size)
    with open(path, "rb") as f:
        parsed = hdf4._File(f.read(), path)
    (desc,) = [parsed.raw(tag, ref) for tag, ref in parsed.dds if tag == TAG_SD | SPECIAL]
    _, n, data_ref, _, coder = struct.unpack_from(">HiHHH", desc, 2)
    stream = parsed.element(TAG_COMPRESSED, data_ref)
    ours = hdf4._skphuff_decode(stream, n, skip_size)
    assert ours == jax_hdf4._skphuff_decode(stream, n, skip_size)
    np.testing.assert_array_equal(np.frombuffer(ours, dtype).reshape(values.shape), values)


# --- the dispatch, info and RasterFileSource ---


@pytest.mark.parametrize("suffix", [".hdf", ".h4", ".hdf4"])
def test_hdf4_by_its_magic_reads_through_the_caches(tmp_path, suffix):
    """An HDF4 file under each HDF suffix goes to the HDF4 reader in both
    read caches and ``info``, as in the JAX package; an info decodes no
    chunk."""
    path, _ = _windowed_file(tmp_path, 6, "a" + suffix)
    assert pipeline.is_hdf4(path) and not pipeline.is_netcdf(path)
    pipeline.clear_read_cache()
    jax_pipeline.clear_read_cache()
    assert_same(pipeline.read_geotiff_cached(path), jax_pipeline.read_geotiff_cached(path))
    assert_same(pipeline.read_geotiff_window_cached(path, 3, 17, 2, 25),
                jax_pipeline.read_geotiff_window_cached(path, 3, 17, 2, 25))
    original = hdf4._File._compressed
    hdf4._File._compressed = None  # info must decode no chunk
    try:
        with both_configs({"geomodeling.root": str(tmp_path)}):
            source = RasterFileSource("a" + suffix)
            assert info_fields(source.info) == info_fields(
                jax_raster.RasterFileSource("a" + suffix).info)
    finally:
        hdf4._File._compressed = original
    pipeline.clear_read_cache()


def _modis_file(tmp_path, kind, szip=False, name=None):
    path, sets = chip_smoke.write_modis_hdf4(str(tmp_path), 480, 48, kind=kind, szip=szip,
                                             name=name or "modis%d.hdf" % kind)
    return path, sets


def assert_agrees_across(jax_view, request, projection):
    """``assert_agrees``, but in RD New get_data on the CPU within
    chip_smoke's HEADLINE_SHARE of the cells (the port's rule for a
    cross-CRS nearest warp); compute_host bitwise either way."""
    if projection == "sinusoidal":
        return assert_agrees(jax_view, request)
    expected = jax_numpy(jax_view, request)
    view = from_reference(jax_view.serialize())
    assert_same(compute_host(*view.get_compute_graph(**request)), expected)
    got = view.get_data(device="cpu", **request)
    assert within_share(got["values"], expected["values"])
    return view, expected


def within_share(ours, theirs):
    return (ours.dtype == theirs.dtype and ours.shape == theirs.shape
            and np.count_nonzero(ours != theirs) <= chip_smoke.HEADLINE_SHARE * ours.size)


@pytest.mark.parametrize("limit", [None, 20000])
@pytest.mark.parametrize("projection", ["sinusoidal", "EPSG:28992"])
def test_file_source_from_reference(tmp_path, limit, projection):
    """chip_smoke's MODIS file (kind 6, which both packages read) under a
    RasterFileSource built with the JAX package's classes comes across
    with from_reference: compute_host answers the JAX numpy executor
    bitwise, whole and by window, at the tile's grid (every frame) and in
    RD New, and get_data too (in RD New within HEADLINE_SHARE); its info
    is the JAX package's."""
    pipeline.clear_read_cache()
    jax_pipeline.clear_read_cache()
    _modis_file(tmp_path, 6)
    if projection == "sinusoidal":
        request = dict(chip_smoke.modis_request(480), stop=chip_smoke.MODIS_COMPOSITE
                       + 2 * chip_smoke.timedelta(minutes=5))
    else:
        request = chip_smoke.modis_rd_request(cell=1000.0)
    with both_configs({"geomodeling.root": str(tmp_path),
                       "geomodeling.windowed-read-limit": limit}):
        jax_source = jax_raster.RasterFileSource("modis6.hdf",
                                                 time_first=chip_smoke.MODIS_COMPOSITE)
        view, expected = assert_agrees_across(jax_source, request, projection)
        assert info_fields(view.info) == info_fields(jax_source.info)
        assert (view._file_read_plan(request) is None) == (limit is None)
        if projection == "sinusoidal":
            assert expected["values"].shape == (3, 480, 480)
    pipeline.clear_read_cache()


def _modis_request(projection):
    if projection == "sinusoidal":
        return chip_smoke.modis_request(480)
    return chip_smoke.modis_rd_request(cell=1000.0)


@pytest.mark.parametrize("projection", ["sinusoidal", "EPSG:28992"])
def test_modis_view_against_jax_numpy(tmp_path, monkeypatch, projection):
    """chip_smoke's modis-ndvi file and view at 480 x 480 in 48^2 chunks,
    the Smooth scaled with the cell (5000 m over 2317 m cells, the card's
    500 m over 232 m), read by window: the view over the kind-6 file,
    built with the JAX package's classes, comes across with from_reference
    and answers its numpy executor (compute_host bitwise; get_data and
    64^2 tiles through evaluate_tiled bitwise at the tile's grid, within
    HEADLINE_SHARE in RD New), and chip_smoke's own build answers the same;
    over the kind-5 file (the library's kind; the JAX reader refuses it),
    with deflate or with szip reliability chunks, the port answers bitwise
    what it answers over the kind-6 file."""
    monkeypatch.setattr(chip_smoke, "MODIS_SMOOTH_M", 5000.0)
    pipeline.clear_read_cache()
    jax_pipeline.clear_read_cache()
    path6, _ = _modis_file(tmp_path, 6)
    path5, _ = _modis_file(tmp_path, 5)
    request = _modis_request(projection)
    exact = projection == "sinusoidal"
    with both_configs({"geomodeling.root": str(tmp_path),
                       "geomodeling.windowed-read-limit": 10000}):
        jax_view = jax_raster.Classify(jax_raster.Smooth(jax_raster.RasterFileSource(
            "modis6.hdf", time_first=chip_smoke.MODIS_COMPOSITE), 5000.0), chip_smoke.MODIS_BINS)
        _, expected = assert_agrees_across(jax_view, request, projection)
        assert len(np.unique(expected["values"])) == len(chip_smoke.MODIS_BINS) + 1
        port6 = chip_smoke.build_modis_view(path6)
        assert_same(compute_host(*port6.get_compute_graph(**request)), expected)
        answer = port6.get_data(device="cpu", **request)
        assert within_share(answer["values"], expected["values"])
        for path in [path5] + ([_modis_file(tmp_path, 5, True, "szip.hdf")[0]]
                               if ccsds.szip_available() else []):
            view = chip_smoke.build_modis_view(path)
            assert_same(compute_host(*view.get_compute_graph(**request)), expected)
            assert_same(view.get_data(device="cpu", **request), answer)
            tiled = evaluate_tiled(view, request, tile_size=64, batch=8, device="cpu")
            tiles, nx = tile_requests(request, 64)
            for index in range(0, len(tiles), 7):
                (rows, cols), (tile_rows, tile_cols) = chip_smoke.tile_cells(
                    index, nx, request["width"], request["height"], 64)
                want = jax_numpy(jax_view, tiles[index])["values"][:, tile_rows, tile_cols]
                got = tiled["values"][:, rows, cols]
                assert np.array_equal(got, want) if exact else within_share(got, want)
    pipeline.clear_read_cache()


@pytest.mark.parametrize("kind, szip", [(5, False), (6, False), (5, True), (6, True)])
def test_write_modis_hdf4(tmp_path, kind, szip):
    """chip_smoke's writer: each package's reader (the port's only, for
    kind 5) gives the values written, scaled, the fill at the float32
    maximum, the sets' names and the sinusoidal grid of the tile; windows
    equal the whole read's slices."""
    if szip and not ccsds.szip_available():
        pytest.skip("libsz not loadable")
    path, sets = _modis_file(tmp_path, kind, szip)
    data = hdf4.read_hdf4(path)
    for band, stored in enumerate(sets):
        assert stored.dtype == np.int16 and (stored == chip_smoke.MODIS_FILL).any()
        expected = np.where(stored == chip_smoke.MODIS_FILL, np.finfo(np.float32).max,
                            chip_smoke.MODIS_SCALE * (stored - 0.0))
        np.testing.assert_array_equal(data.array[band], expected)
    assert data.metadata == list(chip_smoke.MODIS_SETS)
    assert data.projection == chip_smoke.MODIS_PROJECTION
    assert data.geo_transform == chip_smoke.modis_geo_transform(480)
    assert chip_smoke.modis_geo_transform()[1] == pytest.approx(231.656358, abs=1e-6)
    if kind == 6:
        assert_same(data, jax_hdf4.read_hdf4(path))
    for window in [(0, 480, 0, 480), (47, 49, 95, 97), (100, 333, 7, 480)]:
        r0, r1, c0, c1 = window
        np.testing.assert_array_equal(hdf4.read_hdf4_window(path, *window).array,
                                      data.array[:, r0:r1, c0:c1])
    assert chip_smoke.chunks_touched((47, 49, 95, 97), 48) == 4


def test_the_phase_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke's check_modis_ndvi on CPU tensors over a 960^2 tile in
    96^2 chunks, 256^2 tiles in batches of 8, (b) over a 512^2 box of RD
    New: its checks hold (the Gaussian's launches counted where the card
    would launch it), each tile reading only the chunks of its window."""
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.raster import spatial

    def launching(*args, **kwargs):
        cuda_stencils.launches += 1
        return cuda_stencils.gaussian_blur_reference(*args, **kwargs)

    monkeypatch.setattr(spatial, "gaussian_blur", launching)
    monkeypatch.setattr(chip_smoke, "TILE", 256)
    monkeypatch.setattr(chip_smoke, "BATCH", 8)
    launches, numbers = chip_smoke.check_modis_ndvi(
        "cpu", "cpu", str(tmp_path), size=960, chunk=96, window_limit=10000,
        rd_bbox=(100000.0, 400000.0, 151200.0, 451200.0), sampled_tiles=4)
    assert launches["gaussian_blur"] >= 3 and launches["moving_max"] == 0
    assert numbers["file_mb"] > 0 and not list(tmp_path.iterdir())
