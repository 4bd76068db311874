"""The port's FlatGeobuf module (io/flatgeobuf.py) and its FlatBuffers
subset (io/_flatbuffers.py), held on the CPU to the JAX package's module
and the ``flatbuffers`` runtime it uses.

The port's ``write_flatgeobuf`` writes the JAX writer's bytes for every
geometry type (holes and multi-parts, mixed types, a null geometry),
every column type the JAX writer emits (bool, int, long, ulong, double,
string, JSON, binary; bools and strings with nulls), empty, missing and
Unicode strings, index node sizes 0, 2 and 16, an EPSG CRS, a CRS with
no EPSG code, and none; each package reads the other's files into equal
frames (``assert_same_read`` of tests/test_torch_vectorfile.py), whole
and by bbox, with and without ``bbox_projection``, with the same fids in
the same order; ``_search_packed_rtree`` finds the JAX search's hits;
hypothesis draws frames, node sizes and boxes, and drives the port's
``Builder`` and ``flatbuffers.Builder`` with the same calls to the same
bytes.  ``GeometryFileSource`` over a FlatGeobuf answers as the JAX
package's above and below ``geomodeling.vector-windowed-read-limit``
(above it through the R-tree, with the bbox in the file's CRS); a tiled
``to_file`` to ``.fgb`` merges its partials into the JAX package's file;
a bad magic raises the JAX package's error.  tests/
test_torch_geometry_sources_sinks.py runs its source, sink, merge and
export cases on ``.fgb`` too.

Tolerance: none; files byte for byte, frames bitwise.
"""
import os
import struct
from unittest import mock

import flatbuffers
import numpy as np
import pandas as pd
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu import geometry as jax_blocks
from dask_geomodeling_tpu.geo import geometry as jax_geometry
from dask_geomodeling_tpu.geo.features import GeoDataFrame as JaxGeoDataFrame
from dask_geomodeling_tpu.io import flatgeobuf as jax_fgb
from dask_geomodeling_tpu.runtime import pipeline as jax_pipeline
from dask_geomodeling_tpu_torch import from_reference
from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.geo import geometry
from dask_geomodeling_tpu_torch.geo.features import GeoDataFrame
from dask_geomodeling_tpu_torch.geometry.sinks import to_file
from dask_geomodeling_tpu_torch.io import _flatbuffers, flatgeobuf
from dask_geomodeling_tpu_torch.runtime import pipeline
from tests.test_torch_field_ops import assert_same_frame
from tests.test_torch_vectorfile import assert_same_read

GEOMETRIES = {
    "point": ["POINT (135010.5 455990.25)", "POINT (1 2)"],
    "linestring": ["LINESTRING (0 0, 10 0, 10 10, 3.3 7.1)", "LINESTRING (1 1, 2 2)"],
    "polygon-with-holes": [
        "POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0), (2 2, 4 2, 4 4, 2 4, 2 2), "
        "(6 6, 8 6, 8 8, 6 6))",
        "POLYGON ((135000 456000, 135010.5 456000, 135010.5 456012.25, 135000 456000))"],
    "multipoint": ["MULTIPOINT ((0 0), (1 1), (2 3))", "MULTIPOINT ((5 5))"],
    "multilinestring": ["MULTILINESTRING ((0 0, 1 1), (2 2, 3 3, 4 2))",
                        "MULTILINESTRING ((5 5, 6 6))"],
    "multipolygon": [
        "MULTIPOLYGON (((0 0, 4 0, 4 4, 0 4, 0 0), (1 1, 2 1, 2 2, 1 1)), "
        "((6 6, 9 6, 9 9, 6 9, 6 6)))",
        "MULTIPOLYGON (((20 20, 21 20, 21 21, 20 20)))"],
    "mixed": ["POINT (1 2)", "POLYGON ((0 0, 1 0, 1 1, 0 0))", "LINESTRING (0 0, 5 5)"],
}
NODE_SIZES = [16, 0, 2]
CRSES = ["EPSG:28992", None, "+proj=sinu +R=6371007.18 +lon_0=0 +x_0=0 +y_0=0 +units=m +no_defs"]


def frames(columns, wkts, crs="EPSG:28992"):
    """(port frame, JAX frame) of the same columns (numpy arrays keep their
    dtypes in both; lists are typed by each package's inference) and
    geometries (None for a null one)."""
    ref = JaxGeoDataFrame(pd.DataFrame(columns) if columns else None,
                          geometry=[w and jax_geometry.from_wkt(w) for w in wkts], crs=crs)
    port = GeoDataFrame({k: v if isinstance(v, np.ndarray) else list(v)
                         for k, v in columns.items()} if columns else None,
                        geometry=[w and geometry.from_wkt(w) for w in wkts], crs=crs)
    return port, ref


def written(tmp_path, port, ref, **kwargs):
    """(the port's file, the JAX package's file) of one frame each."""
    ours, theirs = str(tmp_path / "port.fgb"), str(tmp_path / "jax.fgb")
    flatgeobuf.write_flatgeobuf(port, ours, **kwargs)
    jax_fgb.write_flatgeobuf(ref, theirs, **kwargs)
    return ours, theirs


def assert_same_files(tmp_path, port, ref, **kwargs):
    """The port writes the JAX writer's bytes, and each package reads both
    files into equal frames."""
    ours, theirs = written(tmp_path, port, ref, **kwargs)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    for path in (ours, theirs):
        assert_same_read(flatgeobuf.read_flatgeobuf(path), jax_fgb.read_flatgeobuf(path))
    return ours


COLUMNS = {
    "flag": np.array([True, False, True]),
    "maybe": [True, None, False],
    "int32": np.array([3, -7, 2**31 - 1], dtype=np.int32),
    "int64": np.array([3, -7, 2**40]),
    "uint64": np.array([0, 7, 2**64 - 1], dtype=np.uint64),
    "float32": np.array([1.5, np.nan, -0.0], dtype=np.float32),
    "float64": np.array([1e300, np.inf, np.nan]),
    "label": ["café", None, "中文"],
    "empty": ["", "x", ""],
    "json": [[1, 2], {"a": None}, None],
    "blob": [b"\x00\x01", b"", None],
}


@pytest.mark.parametrize("crs", CRSES)
@pytest.mark.parametrize("node_size", NODE_SIZES)
@pytest.mark.parametrize("kind", list(GEOMETRIES))
def test_geometry_types(tmp_path, kind, node_size, crs):
    """Every geometry type, holes and multi-parts, under each node size and
    CRS: the same bytes, frames read alike."""
    wkts = GEOMETRIES[kind]
    port, ref = frames({"n": np.arange(len(wkts))}, wkts, crs)
    assert_same_files(tmp_path, port, ref, index_node_size=node_size)


@pytest.mark.parametrize("node_size", NODE_SIZES)
@pytest.mark.parametrize("column", list(COLUMNS))
def test_column_types(tmp_path, column, node_size):
    """Every column type the JAX writer emits, with nulls, empty and
    Unicode strings: the same column type, bytes and frames."""
    wkts = GEOMETRIES["polygon-with-holes"] + ["POINT (3 3)"]
    port, ref = frames({column: COLUMNS[column]}, wkts)
    assert flatgeobuf._column_type_of(port[column].values) == jax_fgb._column_type_of(ref[column])
    assert_same_files(tmp_path, port, ref, index_node_size=node_size)


def test_all_columns_and_no_columns(tmp_path):
    """Every column at once, and a frame of geometries alone."""
    wkts = GEOMETRIES["polygon-with-holes"] + ["POINT (3 3)"]
    assert_same_files(tmp_path, *frames(COLUMNS, wkts))
    assert_same_files(tmp_path, *frames({}, wkts))


def test_null_geometry_writes_unindexed(tmp_path):
    """A null geometry: both writers fall back to an unindexed file in frame
    order."""
    port, ref = frames({"n": np.arange(3)}, ["POINT (1 1)", None, "POINT (2 2)"])
    path = assert_same_files(tmp_path, port, ref)
    with open(path, "rb") as f:
        assert flatgeobuf.header_index_node_size(f.read()) == 0


def _grid(n=12, crs="EPSG:28992"):
    """n^2 squares of 10 m from (135000, 456000), an id and a value."""
    wkts = ["POLYGON ((%g %g, %g %g, %g %g, %g %g))" % (
        x, y, x + 9, y, x + 9, y + 9, x, y)
        for x, y in ((135000 + 10 * i, 456000 + 10 * j) for j in range(n) for i in range(n))]
    return frames({"id": np.arange(n * n), "value": np.arange(n * n) * 0.5}, wkts, crs)


BOXES = [(135000, 456000, 135035, 456025), (135055.5, 456050, 135055.5, 456050),
         (0, 0, 1, 1), (135000, 456000, 136000, 457000)]


@pytest.mark.parametrize("node_size", [16, 4, 2])
def test_bbox_reads(tmp_path, node_size):
    """A bbox read through the R-tree, in the file's CRS and in EPSG:4326:
    the JAX reader's features, fids and order; the search's hits the JAX
    search's."""
    ours, theirs = written(tmp_path, *_grid(), index_node_size=node_size)
    from dask_geomodeling_tpu_torch.geo.crs import transform_extent

    for box in BOXES:
        for path in (ours, theirs):
            got = flatgeobuf.read_flatgeobuf(path, bbox=box)
            assert_same_read(got, jax_fgb.read_flatgeobuf(path, bbox=box))
            wgs = transform_extent(box, "EPSG:28992", "EPSG:4326")
            assert_same_read(flatgeobuf.read_flatgeobuf(path, bbox=wgs, bbox_projection="EPSG:4326"),
                             jax_fgb.read_flatgeobuf(path, bbox=wgs, bbox_projection="EPSG:4326"))
        with open(ours, "rb") as f:
            raw = f.read()
        (header_size,) = struct.unpack_from("<I", raw, 8)
        tree = 12 + header_size
        assert (flatgeobuf._search_packed_rtree(raw, tree, 144, node_size, box)
                == jax_fgb._search_packed_rtree(raw, tree, 144, node_size, box))


def test_bad_magic(tmp_path):
    """The JAX reader's error and message."""
    path = str(tmp_path / "bad.fgb")
    with open(path, "wb") as f:
        f.write(b"fgb\x02fgb\x00" + bytes(32))
    for read in (flatgeobuf.read_flatgeobuf, jax_fgb.read_flatgeobuf):
        with pytest.raises(IOError, match="Not a FlatGeobuf file: '%s'" % path):
            read(path)
    assert flatgeobuf.header_index_node_size(open(path, "rb").read()) is None


def test_helpers_equal_the_jax_package():
    """The R-tree's level sizes, its byte size and the Hilbert codes."""
    for n in (1, 2, 15, 16, 17, 255, 256, 257, 5000):
        for node in (2, 4, 16):
            assert flatgeobuf._rtree_level_sizes(n, node) == jax_fgb._rtree_level_sizes(n, node)
            assert flatgeobuf._packed_rtree_size(n, node) == jax_fgb._packed_rtree_size(n, node)
    xs, ys = np.meshgrid(np.arange(0, 65536, 257), np.arange(0, 65536, 263))
    np.testing.assert_array_equal(flatgeobuf._hilbert_codes(xs.ravel(), ys.ravel()),
                                  jax_fgb._hilbert_codes(xs.ravel(), ys.ravel()))


# --- GeometryFileSource and to_file ---


@pytest.fixture
def root(tmp_path):
    pipeline.clear_read_cache()
    jax_pipeline.clear_read_cache()
    with jax_config.set({"geomodeling.root": str(tmp_path), "geomodeling.executor": "numpy"}), \
            config.set({"geomodeling.root": str(tmp_path)}):
        yield tmp_path
    pipeline.clear_read_cache()
    jax_pipeline.clear_read_cache()


@pytest.mark.parametrize("limit", [16 * 1024 * 1024, 1024])
@pytest.mark.parametrize("projection", ["EPSG:28992", "EPSG:4326"])
def test_geometry_file_source_above_the_limit(root, limit, projection):
    """Above ``geomodeling.vector-windowed-read-limit`` bytes an indexed
    FlatGeobuf answers the bbox through its R-tree (transformed into the
    file's CRS first); below it, through the read cache; the features are
    the JAX package's in every mode."""
    from dask_geomodeling_tpu.geo import Extent

    _, ref = _grid(20)
    jax_fgb.write_flatgeobuf(ref, str(root / "grid.fgb"))
    assert os.path.getsize(root / "grid.fgb") > 1024
    bbox = Extent((135020, 456030, 135115, 456120), "EPSG:28992").transformed(projection).bbox
    jax_source = jax_blocks.GeometryFileSource("grid.fgb", id_field="id")
    source = from_reference(jax_source.serialize())
    searched = []
    real = flatgeobuf._search_packed_rtree
    for mode in ("intersects", "centroid", "extent"):
        with jax_config.set({"geomodeling.vector-windowed-read-limit": limit}), \
                config.set({"geomodeling.vector-windowed-read-limit": limit}), \
                mock.patch.object(flatgeobuf, "_search_packed_rtree",
                                  lambda *a: searched.append(a[-1]) or real(*a)):
            ref_answer = jax_source.get_data(mode=mode, projection=projection,
                                             geometry=jax_geometry.box(*bbox))
            answer = source.get_data(device="cpu", mode=mode, projection=projection,
                                     geometry=geometry.box(*bbox))
        if mode == "extent":
            assert answer["extent"] == ref_answer["extent"]
        else:
            assert_same_frame(answer["features"], ref_answer["features"])
            assert len(answer["features"]) > 10
    assert bool(searched) == (limit == 1024)
    if projection == "EPSG:4326" and searched:
        assert searched[0][0] > 100000  # the box in RD New


def test_to_file_with_a_merge(root):
    """chip_smoke's parcels (8 x 8 of 150 m) as FlatGeobuf, a view adding a
    field exported by to_file in 4 tiles of .fgb partials merged into one:
    the JAX package's file, byte for byte."""
    fields = chip_smoke.field_frame(grid=8)
    ref = JaxGeoDataFrame(pd.DataFrame({k: fields[k].values for k in ("id", "crop", "area")}),
                          geometry=[jax_geometry.from_wkb(g.wkb) for g in fields.geometry],
                          crs="EPSG:28992")
    flatgeobuf.write_flatgeobuf(fields, str(root / "ours.fgb"))
    jax_fgb.write_flatgeobuf(ref, str(root / "fields.fgb"))
    assert (root / "ours.fgb").read_bytes() == (root / "fields.fgb").read_bytes()
    jax_source = jax_blocks.GeometryFileSource("fields.fgb", id_field="id")
    jax_view = jax_source.set("double", jax_source["area"] * 2)
    for side in ("port", "jax"):
        (root / side).mkdir()
    extent = (157900.0, 505000.0, 159100.0, 506200.0)
    jax_view.to_file(str(root / "jax" / "out.fgb"), tile_size=600.0, projection="EPSG:28992",
                     geometry=jax_geometry.box(*extent))
    to_file(from_reference(jax_view.serialize()), str(root / "port" / "out.fgb"),
            tile_size=600.0, projection="EPSG:28992", geometry=geometry.box(*extent),
            device="cpu")
    ours, theirs = str(root / "port" / "out.fgb"), str(root / "jax" / "out.fgb")
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    back = flatgeobuf.read_flatgeobuf(ours)
    assert len(back) == 64 and sorted(back.columns) == ["area", "crop", "double", "geometry", "id"]


# --- hypothesis ---


@st.composite
def frames_and_boxes(draw):
    """A frame of points and boxes with an int, a float and a string
    column (with nulls), a node size and a query box."""
    n = draw(st.integers(1, 40))
    rng = np.random.RandomState(draw(st.integers(0, 2**16)))
    xy = rng.uniform(0, 100, (n, 2)).round(draw(st.sampled_from([0, 3, 9]))).tolist()
    wkts = [("POINT (%r %r)" % (x, y)) if rng.rand() < 0.5 else
            "POLYGON ((%r %r, %r %r, %r %r, %r %r))" % (x, y, x + 3, y, x + 3, y + 2, x, y)
            for x, y in xy]
    columns = {"i": rng.randint(-5, 5, n), "f": rng.choice([np.nan, 0.5, -1e9], n),
               "s": [None if rng.rand() < 0.3 else "s%d" % k for k in range(n)]}
    (x1, x2), (y1, y2) = sorted(rng.uniform(-10, 110, 2)), sorted(rng.uniform(-10, 110, 2))
    box = (float(x1), float(y1), float(x2), float(y2))
    return columns, wkts, draw(st.sampled_from([0, 2, 3, 16])), box


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.function_scoped_fixture])
@given(case=frames_and_boxes())
def test_random_frames(tmp_path, case):
    """Random frames: the same bytes, frames and bbox reads."""
    columns, wkts, node_size, box = case
    port, ref = frames(columns, wkts)
    path = assert_same_files(tmp_path, port, ref, index_node_size=node_size)
    assert_same_read(flatgeobuf.read_flatgeobuf(path, bbox=box),
                     jax_fgb.read_flatgeobuf(path, bbox=box))


@st.composite
def builder_calls(draw):
    """A random sequence of tables: strings, byte and number vectors,
    vectors of offsets and of float64, and slots of each scalar type
    (some at their defaults)."""
    tables = []
    for _ in range(draw(st.integers(1, 6))):
        fields = draw(st.integers(1, 14))
        table = {"fields": fields, "slots": [], "vectors": []}
        for _ in range(draw(st.integers(0, 4))):
            kind = draw(st.sampled_from(["string", "bytes", "f8", "u4", "offsets", "float64s"]))
            size = draw(st.integers(0, 9))
            table["vectors"].append((kind, size, draw(st.text(max_size=6))))
        for slot in draw(st.sets(st.integers(0, fields - 1), max_size=fields)):
            kind = draw(st.sampled_from(["Uint8", "Uint16", "Int32", "Uint64"]))
            value = draw(st.integers(0, 3))
            table["slots"].append((slot, kind, value, draw(st.sampled_from([0, value, 16]))))
        tables.append(table)
    return tables, draw(st.integers(1, 64))


def _build(builder, tables):
    """The same calls on either builder; returns the finished bytes."""
    done = []
    for table in tables:
        offsets = []
        for kind, size, text in table["vectors"]:
            if kind == "string":
                offsets.append(builder.CreateString(text))
            elif kind == "bytes":
                offsets.append(builder.CreateByteVector(bytes(range(size))))
            elif kind in ("f8", "u4"):
                offsets.append(builder.CreateNumpyVector(np.arange(size, dtype="<" + kind)))
            elif kind == "offsets":
                builder.StartVector(4, len(done), 4)
                for off in reversed(done):
                    builder.PrependUOffsetTRelative(off)
                offsets.append(builder.EndVector())
            else:
                builder.StartVector(8, size, 8)
                for k in range(size):
                    builder.PrependFloat64(k * 0.25)
                offsets.append(builder.EndVector())
        builder.StartObject(table["fields"])
        for slot, kind, value, default in table["slots"]:
            getattr(builder, "Prepend%sSlot" % kind)(slot, value, default)
        for k, off in enumerate(offsets[: table["fields"]]):
            if all(s != k for s, *_ in table["slots"]):
                builder.PrependUOffsetTRelativeSlot(k, off, 0)
        done.append(builder.EndObject())
    builder.Finish(done[-1])
    return bytes(builder.Output())


@settings(max_examples=150, deadline=None)
@given(calls=builder_calls())
def test_builder_writes_the_runtimes_bytes(calls):
    """The port's Builder and flatbuffers.Builder, given the same calls
    (any initial size: the buffer grows alike), finish the same bytes:
    alignment, defaults left out and vtables shared as the runtime shares
    them; the port's Table reads the root's slots as the runtime does."""
    tables, size = calls
    ours = _build(_flatbuffers.Builder(size), tables)
    assert ours == _build(flatbuffers.Builder(size), tables)
    top = _flatbuffers.root(ours)
    runtime = flatbuffers.table.Table(bytearray(ours), struct.unpack_from("<I", ours, 0)[0])
    for slot in range(tables[-1]["fields"] + 2):
        assert top.field(slot) == runtime.Offset(4 + 2 * slot)
