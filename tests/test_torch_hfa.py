"""The port's ERDAS Imagine (HFA) reader and writer (io/hfa.py), its
dispatch in the read cache and ``RasterFileSource``, held on the CPU to the
JAX package's.

Every case of tests/test_hfa.py runs once in each package (``run_both`` of
tests/test_torch_raster_formats.py): the files written are byte-identical,
and the payloads, answers and errors the same (arrays bitwise with their
dtypes).  ``_rle_decode`` gives the JAX decoder's values and errors on
blocks that chip_smoke's encoder (``rle_blocks``) writes and on arbitrary
bytes, and ``write_hfa`` the JAX writer's bytes, under hypothesis;
chip_smoke's RLE splice (``splice_rle``) is read back alike by both
packages; ``RasterFileSource`` over a spliced ``.img`` comes across with
``from_reference`` and answers the JAX numpy executor bitwise; chip_smoke's
hfa-roughness file and view at 256 x 192 answer as the JAX package's.
"""
import struct
from datetime import datetime

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu import raster as jax_raster
from dask_geomodeling_tpu.io import hfa as jax_hfa
from dask_geomodeling_tpu.io import pam as jax_pam
from dask_geomodeling_tpu.runtime import pipeline as jax_pipeline
from dask_geomodeling_tpu_torch.io import hfa
from dask_geomodeling_tpu_torch.runtime import pipeline
from tests.test_torch_file_sources import assert_agrees, both_configs
from tests.test_torch_raster_formats import _kit, assert_same, run_both
from tests.test_torch_zarr import error, info_fields

GT = (5000.0, 10.0, 0.0, 8000.0, 0.0, -10.0)


def _hkit(port):
    """``_kit`` with the package's HFA module and read cache."""
    kit = _kit(port)
    kit.hfa = hfa if port else jax_hfa
    kit.pipeline = pipeline if port else jax_pipeline
    return kit


def run_hfa(tmp_path, case):
    """``run_both`` with the HFA kits."""
    return run_both(tmp_path, lambda k, root: case(_hkit(k.port), root))


def outcome(call):
    """What ``call()`` gives: its result, or its error's type and message."""
    try:
        return "result", call()
    except Exception as raised:  # the same error in both packages
        return "error", (type(raised).__name__, str(raised))


# --- tests/test_hfa.py: TestRoundtrip ---


def _dtypes(dtype):
    def case(k, root):
        rng = np.random.RandomState(0)
        info = np.iinfo(dtype) if np.dtype(dtype).kind in "ui" else None
        if info is not None:
            values = rng.randint(max(info.min, -1000), min(info.max, 1000),
                                 (2, 50, 70)).astype(dtype)
        else:
            values = rng.rand(2, 50, 70).astype(dtype) * 100
        path = str(root / "a.img")
        k.hfa.write_hfa(path, values, geo_transform=GT, projection="EPSG:32633")
        data = k.hfa.read_hfa(path)
        np.testing.assert_array_equal(data.array, values)
        np.testing.assert_allclose(data.geo_transform, GT)
        assert data.projection == "EPSG:32633"
        return data
    return case


def _multiblock_ragged(k, root):
    rng = np.random.RandomState(1)
    values = rng.randint(0, 255, (1, 150, 170)).astype(np.uint8)
    path = str(root / "big.img")
    k.hfa.write_hfa(path, values, geo_transform=GT)
    data = k.hfa.read_hfa(path)
    np.testing.assert_array_equal(data.array, values)
    return data


def _nodata(k, root):
    path = str(root / "nd.img")
    k.hfa.write_hfa(path, np.zeros((1, 10, 10), np.int16), geo_transform=GT,
                    no_data_value=-9999.0)
    data = k.hfa.read_hfa(path)
    assert data.no_data_value == -9999.0
    return data


def _projections(k, root):
    found = []
    for projection in ("EPSG:4326", "EPSG:32718", "EPSG:26710"):
        path = str(root / "p.img")
        k.hfa.write_hfa(path, np.zeros((1, 4, 4), np.uint8), geo_transform=GT,
                        projection=projection)
        found.append(k.hfa.read_hfa(path).projection)
        assert found[-1] == projection
    return found


def _not_hfa(k, root):
    path = root / "x.img"
    path.write_bytes(b"not an imagine file at all")
    with pytest.raises(ValueError, match="ERDAS Imagine") as raised:
        k.hfa.read_hfa(str(path))
    return error(raised, root)


# --- TestDictionary ---


def _file_dictionary_parses_and_sizes(k, root):
    path = str(root / "a.img")
    k.hfa.write_hfa(path, np.zeros((1, 4, 4), np.uint8), geo_transform=GT)
    dic = k.hfa._HFAFile(path).dictionary
    sizes = [dic.type_size(name) for name in
             ("Eprj_Coordinate", "Edms_VirtualBlockInfo", "Eimg_Layer", "Eprj_MapInfo")]
    assert sizes == [16, 14, 20, 40]  # Eprj_MapInfo: five 8-byte pointers
    return sizes, sorted(dic.types)


def _inline_x_type_definitions_parse(k, root):
    dic = k.hfa._Dictionary(
        "{1:lnumnames,0:pcalgorithm,0:x{0:pcstring,}string,nameList,}"
        "Eimg_RRDNamesList,{1:dx,1:dy,}Eprj_Coordinate,.")
    fields = dic.types["Eimg_RRDNamesList"]
    assert [f.name for f in fields] == ["numnames", "algorithm", "nameList"]
    assert fields[2].item == "x" and fields[2].obj_type[0].name == "string"
    assert dic.type_size("Eprj_Coordinate") == 16
    return ([(f.count, f.item, f.inner, f.name) for f in fields],
            [(f.count, f.item, f.inner, f.name) for f in fields[2].obj_type])


def _tree_structure(k, root):
    path = str(root / "a.img")
    k.hfa.write_hfa(path, np.zeros((2, 4, 4), np.uint8), geo_transform=GT,
                    projection="EPSG:4326")
    handle = k.hfa._HFAFile(path)
    names = [node.name for node in handle.root.children()]
    assert names == ["Layer_1", "Layer_2"]
    child_types = [node.type for node in handle.root.find(name="Layer_1").children()]
    for type_ in ("Edms_State", "Eprj_MapInfo", "Eprj_ProParameters"):
        assert type_ in child_types
    return names, child_types


# --- TestRLE ---


def _rle(minimum, runs, n_bits, counts_bytes, values_bytes):
    head = struct.pack("<ii", minimum, runs)
    head += struct.pack("<I", 13 + len(counts_bytes)) + bytes([n_bits])
    return head + counts_bytes + values_bytes


def _simple_runs_8bit(k, root):
    out = k.hfa._rle_decode(_rle(5, 3, 8, bytes([4, 2, 3]), bytes([2, 4, 2])), 0, 9)
    np.testing.assert_array_equal(out, [7, 7, 7, 7, 9, 9, 7, 7, 7])
    return out


def _multibyte_count_and_16bit_values(k, root):
    block = _rle(100, 1, 16, bytes([0x40 | 0x01, 0x2C]), struct.pack(">H", 600))
    out = k.hfa._rle_decode(block, 0, 300)
    assert out.shape == (300,) and (out == 700).all()
    return out


def _two_bit_values_lsb_first(k, root):
    out = k.hfa._rle_decode(_rle(10, 4, 2, bytes([1, 1, 1, 1]), bytes([0b01100011])), 0, 4)
    np.testing.assert_array_equal(out, [13, 10, 12, 11])
    return out


def _uncompressed_marker(k, root):
    block = struct.pack("<ii", 50, -1) + struct.pack("<I", 0) + bytes([8]) + bytes([1, 2, 3, 4])
    out = k.hfa._rle_decode(block, 0, 4)
    np.testing.assert_array_equal(out, [51, 52, 53, 54])
    return out


def _compressed_block_in_file(k, root):
    values = np.full((1, 8, 8), 7, np.uint8)
    values[0, 0, :4] = 9
    path = str(root / "rle.img")
    k.hfa.write_hfa(path, values, geo_transform=GT)
    raw = bytearray(open(path, "rb").read())
    dms = k.hfa._HFAFile(path).root.find(name="Layer_1").find(name="RasterDMS")
    info_ptr = dms.get("blockinfo")
    (block_offset,) = struct.unpack_from("<i", bytes(raw), info_ptr + 2)
    # runs [4 x 9, 60 x 7]: minimum 7, values 2 and 0 in 8 bits
    payload = struct.pack("<iiI", 7, 2, 15) + bytes([8]) + bytes([4, 60]) + bytes([2, 0])
    raw[block_offset : block_offset + len(payload)] = payload
    struct.pack_into("<H", raw, info_ptr + 12, 1)  # compressed flag
    open(path, "wb").write(bytes(raw))
    data = k.hfa.read_hfa(path)
    np.testing.assert_array_equal(data.array, values)
    return data


# --- TestSource ---


def _raster_file_source(k, root):
    rng = np.random.RandomState(2)
    values = rng.randint(0, 1000, (3, 40, 50)).astype(np.int32)
    k.hfa.write_hfa(str(root / "src.img"), values, geo_transform=GT, projection="EPSG:28992",
                    no_data_value=-1.0)
    source = k.R.RasterFileSource("src.img", time_first=datetime(2000, 1, 1), time_delta=300000)
    assert source.projection == "EPSG:28992" and source.dtype == np.int32
    assert source.fillvalue == -1.0 and len(source) == 3
    result = k.get_data(source, mode="vals", bbox=(5000.0, 8000.0 - 400.0, 5500.0, 8000.0),
                        projection="EPSG:28992", width=50, height=40,
                        start=datetime(2000, 1, 1), stop=datetime(2000, 1, 2))
    np.testing.assert_array_equal(result["values"], values)
    return result


JAX_CASES = {
    **{"dtypes-%s" % dtype: _dtypes(dtype)
       for dtype in ("u1", "i1", "u2", "i2", "u4", "i4", "f4", "f8")},
    "multiblock-ragged": _multiblock_ragged,
    "nodata": _nodata,
    "projections": _projections,
    "not-hfa": _not_hfa,
    "file-dictionary-parses-and-sizes": _file_dictionary_parses_and_sizes,
    "inline-x-type-definitions-parse": _inline_x_type_definitions_parse,
    "tree-structure": _tree_structure,
    "simple-runs-8bit": _simple_runs_8bit,
    "multibyte-count-and-16bit-values": _multibyte_count_and_16bit_values,
    "two-bit-values-lsb-first": _two_bit_values_lsb_first,
    "uncompressed-marker": _uncompressed_marker,
    "compressed-block-in-file": _compressed_block_in_file,
    "raster-file-source": _raster_file_source,
}


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_jax_case(tmp_path, name):
    """One case of tests/test_hfa.py, in each package."""
    run_hfa(tmp_path, JAX_CASES[name])


# --- the decoder and the writer under hypothesis ---


@st.composite
def rle_runs(draw):
    """(values, width): runs of up to 300 cells, values within a width of
    0 to 32 bits above a minimum that may be negative."""
    bits = draw(st.sampled_from([0, 1, 2, 4, 8, 16, 32]))
    minimum = draw(st.integers(-2**31, 2**31 - 1 - (2**bits - 1)))
    runs = draw(st.lists(st.tuples(st.integers(1, 300), st.integers(0, 2**bits - 1)),
                         min_size=1, max_size=40))
    counts, values = zip(*runs)
    return np.repeat(np.array(values, np.int64) + minimum, counts), bits


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(rle_runs(), st.integers(-3, 3))
def test_rle_decode_equals_jax_on_encoded_blocks(runs, short):
    """A block chip_smoke's encoder writes decodes to its values in both
    packages, and asking for more values than its runs hold raises the
    same underflow."""
    values, _ = runs
    (payload,) = chip_smoke.rle_blocks(values[np.newaxis])
    n_values = len(values) + short
    ours = outcome(lambda: hfa._rle_decode(payload, 0, n_values))
    theirs = outcome(lambda: jax_hfa._rle_decode(payload, 0, n_values))
    assert ours[0] == theirs[0]
    assert_same(ours[1], theirs[1])
    if short <= 0:
        np.testing.assert_array_equal(ours[1], values[:n_values])


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.integers(-2**31, 2**31 - 1), st.integers(-2, 64), st.integers(0, 120),
       st.sampled_from([0, 1, 2, 3, 4, 8, 16, 32]), st.binary(max_size=160),
       st.integers(0, 400), st.integers(0, 3))
def test_rle_decode_equals_jax_on_any_bytes(minimum, n_runs, data_offset, bits, body,
                                            n_values, lead):
    """Any header and body (the counts' top bit clear, so no run passes
    16,383 cells): the same values, or the same error, in both packages."""
    body = bytes(b & 0x7F for b in body)
    raw = bytes(lead) + struct.pack("<iiIB", minimum, n_runs, data_offset, bits) + body
    ours = outcome(lambda: hfa._rle_decode(raw, lead, n_values))
    theirs = outcome(lambda: jax_hfa._rle_decode(raw, lead, n_values))
    assert ours[0] == theirs[0], (ours, theirs)
    assert_same(ours[1], theirs[1])


@pytest.mark.parametrize("count", [63, 64, 16383, 16384, 2**22 - 1, 2**22 + 5])
def test_rle_decode_long_runs(count):
    """Run lengths at each byte width's edge: one to four count bytes."""
    values = np.concatenate([np.full(count, 3), [5, 4]]).astype(np.int64)
    (payload,) = chip_smoke.rle_blocks(values[np.newaxis])
    ours = hfa._rle_decode(payload, 0, len(values))
    assert_same(ours, jax_hfa._rle_decode(payload, 0, len(values)))
    np.testing.assert_array_equal(ours, values)


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.function_scoped_fixture])
@given(st.sampled_from(["u1", "i1", "u2", "i2", "u4", "i4", "f4", "f8", "bool"]),
       st.integers(1, 3), st.integers(1, 140), st.integers(1, 140),
       st.sampled_from([None, "EPSG:4326", "EPSG:32631", "EPSG:32718", "EPSG:26712",
                        "EPSG:28992"]),
       st.sampled_from([None, 0.0, -9999.0, 255.0]), st.booleans(), st.integers(0, 2**32 - 1))
def test_write_hfa_equals_jax(tmp_path_factory, dtype, bands, height, width, projection,
                              no_data_value, georeferenced, seed):
    """The port's writer writes the JAX writer's bytes; each package reads
    them alike."""
    folder = tmp_path_factory.mktemp("hfa")
    rng = np.random.RandomState(seed)
    values = (rng.rand(bands, height, width) * 200 - 50).astype(dtype)
    gt = (123456.5, 2.5, 0.0, 456789.25, 0.0, -2.5) if georeferenced else None
    for name, module in (("port.img", hfa), ("jax.img", jax_hfa)):
        module.write_hfa(str(folder / name), values, geo_transform=gt, projection=projection,
                         no_data_value=no_data_value)
    assert (folder / "port.img").read_bytes() == (folder / "jax.img").read_bytes()
    assert_same(hfa.read_hfa(str(folder / "port.img")), jax_hfa.read_hfa(str(folder / "port.img")))


# --- chip_smoke's RLE splice ---


@pytest.mark.parametrize("dtype", ["u1", "i1", "u2", "i2", "u4", "i4"])
def test_splice_rle_read_back_by_both(tmp_path, dtype):
    """Blocks of long runs, noise and constants, in each integer width:
    splice_rle compresses the blocks whose RLE form is shorter, and both
    packages read the file back as the values written, bitwise; the same
    splice of the JAX writer's file gives the same bytes."""
    rng = np.random.RandomState(7)
    info = np.iinfo(dtype)
    values = np.repeat(rng.randint(max(info.min, -3000), min(info.max, 3000), (150, 6)), 30,
                       axis=1)[np.newaxis].astype(dtype)
    # noise whose RLE form is longer than the block: values of the
    # pixels' own width
    noise = {1: 14, 2: 30000, 4: 2**20}[info.bits // 8]
    values[0, 70:140, 10:120] = rng.randint(0, noise, (70, 110)).astype(dtype)
    values[0, :64, :64] = values[0, 0, 0]  # a constant block: zero bits
    for name, module in (("port.img", hfa), ("jax.img", jax_hfa)):
        module.write_hfa(str(tmp_path / name), values, geo_transform=GT, no_data_value=0)
        spliced, blocks = chip_smoke.splice_rle(str(tmp_path / name))
        assert 0 < spliced < blocks == 9
    assert (tmp_path / "port.img").read_bytes() == (tmp_path / "jax.img").read_bytes()
    ours = hfa.read_hfa(str(tmp_path / "port.img"))
    assert_same(ours, jax_hfa.read_hfa(str(tmp_path / "port.img")))
    np.testing.assert_array_equal(ours.array, values)


# --- RasterFileSource over a spliced file, from_reference ---


def _lgn(folder):
    """chip_smoke's hfa-roughness file at 256 x 192."""
    path, classes, (spliced, blocks) = chip_smoke.write_lgn(str(folder), 256, 192)
    assert 0 < spliced < blocks
    return path, classes


@pytest.mark.parametrize("projection", ["EPSG:28992", "EPSG:3857"])
def test_file_source_from_reference(tmp_path, projection):
    """An RLE .img under a RasterFileSource built with the JAX package's
    classes comes across with from_reference: the port's compute_host and
    get_data answer its numpy executor bitwise, at the file's grid and
    warped, and its info is the JAX package's."""
    pipeline.clear_read_cache()
    jax_pipeline.clear_read_cache()
    path, classes = _lgn(tmp_path)
    request = chip_smoke.lgn_request(256, 192)
    if projection != "EPSG:28992":
        from dask_geomodeling_tpu_torch.geo.crs import transform_extent

        request = dict(request, projection=projection, width=200, height=150,
                       bbox=transform_extent(request["bbox"], "EPSG:28992", projection))
    with both_configs({"geomodeling.root": str(tmp_path)}):
        jax_source = jax_raster.RasterFileSource("lgn.img")
        view, expected = assert_agrees(jax_source, request)
        assert info_fields(view.info) == info_fields(jax_source.info)
        assert view.fillvalue == jax_source.fillvalue == 0
        if projection == "EPSG:28992":
            np.testing.assert_array_equal(expected["values"][0], classes)
    pipeline.clear_read_cache()


# --- the dispatch ---


def test_hfa_reads_whole_through_the_read_cache(tmp_path):
    """An HFA .img goes to read_hfa, in the read cache and in info alike,
    even with an ENVI header beside it; its reads are never windowed."""
    pipeline.clear_read_cache()
    path, _ = _lgn(tmp_path)
    (tmp_path / "lgn.hdr").write_text("ENVI\nsamples = 1\nlines = 1\nbands = 1\n"
                                      "data type = 1\ninterleave = bsq\nheader offset = 0\n")
    assert pipeline.whole_file_reader(path) is hfa.read_hfa
    first = pipeline.read_geotiff_cached(path)
    assert pipeline.read_geotiff_cached(path) is first
    assert_same(first, jax_pipeline.read_geotiff_cached(path))
    from dask_geomodeling_tpu_torch.config import config
    from dask_geomodeling_tpu_torch.raster import RasterFileSource

    with config.set({"geomodeling.windowed-read-limit": 10}):
        source = RasterFileSource(path)
        assert source._file_read_plan(chip_smoke.lgn_request(256, 192)) is None
        assert (source.info.width, source.info.height, source.dtype) == (256, 192, np.uint8)
    pipeline.clear_read_cache()


# --- chip_smoke's hfa-roughness view, small ---


def test_hfa_roughness_view_against_jax_numpy(tmp_path):
    """chip_smoke's hfa-roughness file and view at 256 x 192: the same view
    built with the JAX package's classes and its PAM reader comes across
    with from_reference and answers its numpy executor bitwise, whole and
    in 64^2 tiles through evaluate_tiled, and equals chip_smoke's own
    build; the friction below the Smooth is nodata exactly at class 0 and
    the classes the table leaves out."""
    from dask_geomodeling_tpu_torch import evaluate_tiled
    from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests

    pipeline.clear_read_cache()
    jax_pipeline.clear_read_cache()
    path, classes = _lgn(tmp_path)
    rat = jax_pam.read_raster_attribute_table(path)
    assert rat == chip_smoke.lgn_rat(classes)
    request = chip_smoke.lgn_request(256, 192)
    with both_configs({"geomodeling.root": str(tmp_path)}):
        friction = jax_raster.Reclassify(
            jax_raster.RasterFileSource("lgn.img"),
            jax_pam.rat_as_reclassify_data(rat, "MANNING"), select=True)
        jax_view = jax_raster.Smooth(friction, chip_smoke.LGN_SMOOTH_M)
        view, expected = assert_agrees(jax_view, request)
        _, cells = assert_agrees(friction, request)
        missing = np.isin(classes, (0,) + chip_smoke.LGN_UNLISTED)
        assert missing.any() and not missing.all()
        np.testing.assert_array_equal(cells["values"][0] == cells["no_data_value"], missing)
        assert_same(chip_smoke.build_lgn_view(path).get_data(device="cpu", **request), expected)
        tiled = evaluate_tiled(view, request, tile_size=64, batch=4, device="cpu")
        tiles, nx = tile_requests(request, 64)
        for index, tile in enumerate(tiles):
            (rows, cols), (tile_rows, tile_cols) = chip_smoke.tile_cells(index, nx, 256, 192, 64)
            with jax_config.set({"geomodeling.executor": "numpy"}):
                want = jax_view.get_data(**tile)["values"]
            np.testing.assert_array_equal(tiled["values"][:, rows, cols],
                                          want[:, tile_rows, tile_cols])
    pipeline.clear_read_cache()
