"""The port stands on its own and agrees with the JAX package.

- no module of the port, and not chip_smoke.py, imports the JAX package,
  jax, pandas, bench, benchmarks, matplotlib or Pillow (an AST scan), and
  running the port's paths, a WMS GetMap and a legend, routed requests
  under the profiler, the pooled scheduler with its spill, and the
  building-rings view included, loads none of them (a subprocess);
- the port's CRS subset gives the JAX package's float64 bits;
- a JAX-package view carried across by ``from_reference`` plans the same
  graph: the same process functions (by name) with equal literals;
- each copied numpy process gives the JAX package's result bit for bit on
  the inputs the JAX package's own executor hands it;
- ``compute_host`` equals the JAX package's numpy executor bitwise.

The views are the headline view (bench.py), the stencils view
(benchmarks/run.py), a view holding every other ported pixel-wise block,
three views holding the temporal blocks (chip_smoke.py's temporal
paths), RasterizeWKT below a Clip and Rasterize of a GeometryWKTSource,
at small sizes; AggregateRaster over a GeometryWKTSource is held to the
same plan, processes and numpy executor on a zonal request.
"""
import ast
import dataclasses
import datetime
import os
import subprocess
import sys

import numpy as np
import pytest

import bench
import chip_smoke
from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu.geo.crs import transform_points as jax_transform_points
from dask_geomodeling_tpu.geometry import GeometryWKTSource as JaxGeometryWKTSource
from dask_geomodeling_tpu import geometry as jax_blocks
from dask_geomodeling_tpu.geometry.merge import MergeGeometryBlocks
from dask_geomodeling_tpu.geometry.constructive import Buffer
from dask_geomodeling_tpu.geometry.text import ParseTextColumn
from dask_geomodeling_tpu.raster import HillShade as JaxHillShade
from dask_geomodeling_tpu.raster import MemorySource as JaxMemorySource
from dask_geomodeling_tpu.raster import MovingMax as JaxMovingMax
from dask_geomodeling_tpu.raster import Smooth as JaxSmooth
from dask_geomodeling_tpu.runtime.executor import _reachable as jax_reachable
from dask_geomodeling_tpu.runtime.executor import _toposort as jax_toposort
from dask_geomodeling_tpu_torch import compute_host, from_reference
from dask_geomodeling_tpu_torch.geo.crs import transform_points
from dask_geomodeling_tpu_torch.runtime.executor import _reachable, _toposort
from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("dask_geomodeling_tpu", "jax", "pandas", "bench", "benchmarks", "matplotlib", "PIL")


def _port_files():
    root = os.path.join(REPO, "dask_geomodeling_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for folder, _, names in os.walk(root):
        files += [os.path.join(folder, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _forbidden(module):
    return any(module == name or module.startswith(name + ".") for name in FORBIDDEN)


def test_no_module_of_the_port_imports_the_jax_package():
    found = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                modules = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                modules = [node.module]
            else:
                continue
            found += [
                "%s:%d %s" % (os.path.relpath(path, REPO), node.lineno, m)
                for m in modules
                if _forbidden(m)
            ]
    assert len(_port_files()) > 20
    assert not found, found


def test_port_never_imports_jax():
    """Both paths at a small size, on the CPU, through the port alone."""
    script = "\n".join(
        [
            "import os, sys",
            "import chip_smoke as cs",
            "from dask_geomodeling_tpu_torch import evaluate_tiled, get_data",
            "source, view = cs.build_headline_view(128)",
            "request = cs.headline_request(source, 256)",
            "out = evaluate_tiled(view, request, tile_size=128, batch=2, device='cpu')",
            "assert out['values'].shape == (1, 256, 256)",
            "request.update(width=64, height=64)",
            "get_data(view, device='cpu', **request)",
            "_, view = cs.build_stencils_view(256)",
            "out = evaluate_tiled(view, cs.vals_request(256), tile_size=128, batch=4, device='cpu')",
            "assert out['values'].shape == (1, 256, 256)",
            "view.get_data(device='cpu', **cs.vals_request(64))",
            "paths = cs.build_algebra_paths(512)",
            "from dask_geomodeling_tpu_torch.config import config",
            "for view, request, interpolation, _ in paths.values():",
            "    with config.set({'geomodeling.warp-interpolation': interpolation}):",
            "        evaluate_tiled(view, request, tile_size=256, batch=2, device='cpu')",
            "sources = cs.fuzz_sources()",
            "for seed in (0, 45):",
            "    view, request = cs.fuzz_view(seed, sources)",
            "    view.get_data(device='cpu', **request)",
            "paths, _ = cs.build_temporal_paths(mean_px=256, px=256)",
            "for view, request, _, _ in paths.values():",
            "    evaluate_tiled(view, request, tile_size=128, batch=2, device='cpu')",
            "mean = paths['temporal-mean'][0]",
            "geometry = cs.build_geometry_paths(px=256, rasterize_px=256, parcels_grid=2)",
            "for view, request, _, _ in geometry.values():",
            "    evaluate_tiled(view, request, tile_size=128, batch=2, device='cpu')",
            "cs.PARCEL_ORIGIN = (135010.0, 455990.0)",
            "for view, request in cs.build_zonal_views(mean, grid=3, small=1).values():",
            "    assert len(view.get_data(device='cpu', **request)['features']) == 10",
            "import tempfile",
            "folder = tempfile.mkdtemp()",
            "sheet = cs.write_sheet(folder, width=300, height=200, block=40)",
            "paths = cs.build_file_paths(sheet, reproject_px=128)",
            "view, request, _, _ = paths['file-read']",
            "evaluate_tiled(view, request, tile_size=128, batch=2, device='cpu')",
            "view.to_file(folder + '/out.vrt', tile_size=128, device='cpu')",
            "assert len(os.listdir(folder + '/tiles')) == 6",
            "from dask_geomodeling_tpu_torch.geometry.sinks import to_file",
            "from dask_geomodeling_tpu_torch.io.vectorfile import read_vector",
            "from dask_geomodeling_tpu_torch.raster import RasterFileSource",
            "bbox = RasterFileSource(sheet).footprint.bbox",
            "buildings = cs.write_buildings(folder, bbox, 24)",
            "view = cs.build_buildings_view(buildings, sheet)",
            "from dask_geomodeling_tpu_torch.geo import Extent",
            "bbox_3857 = Extent(bbox, 'EPSG:28992').transformed('EPSG:3857').bbox",
            "for ext, tile in (('gpkg', 60.0), ('geojson', None), ('shp', 60.0)):",
            "    to_file(view, folder + '/heights.' + ext, tile_size=tile,",
            "            projection='EPSG:28992', mode='centroid', device='cpu')",
            "    assert len(read_vector(folder + '/heights.' + ext)) > 15",
            "from urllib.parse import urlencode",
            "from dask_geomodeling_tpu_torch.ipyleaflet_plugin import register_layer, wms_app",
            "register_layer('ahn', paths['file-read'][0])",
            "status = []",
            "query = urlencode(dict(request='GetMap', layers='ahn', styles='terrain', vmin=0,",
            "                       vmax=10, srs='EPSG:3857', bbox='%r,%r,%r,%r' % bbox_3857,",
            "                       width=64, height=64))",
            "config.set({'geomodeling.torch-device': 'cpu'})",
            "body = b''.join(wms_app({'QUERY_STRING': query}, lambda s, h: status.append(s)))",
            "assert status == ['200 OK'] and body[:4] == b'\\x89PNG', (status, body[:200])",
            "query = urlencode(dict(request='GetLegendGraphic', styles='gray'))",
            "body = b''.join(wms_app({'QUERY_STRING': query}, lambda s, h: status.append(s)))",
            "assert status[-1] == '200 OK' and body[:4] == b'\\x89PNG', status",
            "import json",
            "from dask_geomodeling_tpu_torch.core import compute",
            "from dask_geomodeling_tpu_torch.geo.geometry import box",
            "from dask_geomodeling_tpu_torch.runtime import router, status",
            "from dask_geomodeling_tpu_torch.runtime.profile import Profiler",
            "view, request, _, _ = paths['file-read']",
            "config.set({'geomodeling.router-state': None, 'geomodeling.executor': 'auto',",
            "            'geomodeling.auto-min-device-px': 0})",
            "with Profiler() as prof:",
            "    for _ in range(4):",
            "        view.get_data(**request)",
            "assert prof.events and json.dumps(status.snapshot())",
            "config.set({'geomodeling.executor': 'numpy', 'scheduler': 'threads',",
            "            'geomodeling.scheduler-memory-limit': 1024})",
            "compute(*view.get_compute_graph(**request))",
            "config.set({'geomodeling.executor': 'torch'})",
            "area = cs.rings_area(bbox, 60.0)",
            "rings, n = cs.write_rings_buildings(folder, bbox, area, 24)",
            "fields = {name: name for name in cs.RINGS_FIELDS}",
            "to_file(cs.build_rings_view(rings, sheet), folder + '/rings.geojson', fields=fields,",
            "        geometry=box(*area), mode='centroid', projection='EPSG:28992', device='cpu')",
            "assert len(read_vector(folder + '/rings.geojson')) == n > 0",
            "bad = [m for m in sys.modules if m.split('.')[0] in %r]" % (FORBIDDEN,),
            "assert not bad, bad",
            "print('standalone')",
        ]
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", script],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "standalone"


# --- the CRS subset ---

CRSES = ["EPSG:28992", "EPSG:3857", "EPSG:4326"]


def _points_in(srs):
    """A grid over the Netherlands in ``srs`` plus out-of-domain points."""
    x, y = np.meshgrid(np.linspace(0, 300000, 41), np.linspace(290000, 630000, 37))
    x, y = jax_transform_points(x.ravel(), y.ravel(), "EPSG:28992", srs)
    if srs == "EPSG:4326":
        far = ([0.0, 179.9, -180.0, 5.0, 5.0, np.nan], [89.99, -89.0, 0.0, 90.0, -90.0, 1.0])
    else:
        far = ([1e12, -1e12, 0.0, 3e7, np.nan, 5e6], [1e12, 0.0, -1e12, 3e7, 0.0, np.nan])
    return np.concatenate([x, far[0]]), np.concatenate([y, far[1]])


@pytest.mark.parametrize("src", CRSES)
@pytest.mark.parametrize("dst", CRSES)
def test_transform_points_bitwise(src, dst):
    x, y = _points_in(src)
    expected = jax_transform_points(x, y, src, dst)
    actual = transform_points(x, y, src, dst)
    for a, e in zip(actual, expected):
        assert a.dtype == e.dtype
        np.testing.assert_array_equal(a, e)  # NaN in the same places


def test_other_crs_is_not_ported():
    with pytest.raises(NotImplementedError, match="EPSG:32631"):
        transform_points([500000.0], [0.0], "EPSG:32631", "EPSG:4326")


# --- views carried across ---


def _headline():
    source, view = bench.build_view(128)
    return view, bench.full_request(source, 512)


def _stencils():
    source = JaxMemorySource(
        data=(np.random.RandomState(0).rand(1, 256, 256) * 200).astype(np.float32),
        no_data_value=float(np.finfo(np.float32).max),
        projection="EPSG:28992",
        pixel_size=1.0,
        pixel_origin=(135000.0, 456000.0),
        time_first=datetime.datetime(2000, 1, 1),
    )
    view = JaxHillShade(JaxSmooth(JaxMovingMax(source, 3), 5))
    return view, chip_smoke.vals_request(256)


def _algebra():
    """Every other ported block in one view over float32 sources."""
    from dask_geomodeling_tpu import raster as R

    def source(seed, px=256):
        return JaxMemorySource(
            data=(np.random.RandomState(seed).rand(1, px, px) * 200).astype(np.float32),
            no_data_value=float(np.finfo(np.float32).max),
            projection="EPSG:28992",
            pixel_size=1.0,
            pixel_origin=(135000.0, 456000.0),
            time_first=datetime.datetime(2000, 1, 1),
        )

    a, b, small = source(0), source(2), source(3, px=32)
    flags = R.And(R.IsData(a), R.Invert(R.Less(b, 50.0)))
    flags = R.Xor(R.Or(flags, R.Equal(a, b)), R.IsNoData(R.NotEqual(a, 7.0) * 1))
    view = R.Group(
        R.Max(
            R.FillNoData(R.MaskBelow(a, 10.0), b),
            R.Power(b / 10.0, 2),
            R.Step(b, left=0, right=1, value=100.0),
            R.Exp(a / 100.0),
            R.Log(b) - R.Log10(a),
        ),
        R.Dilate(R.Classify(R.Clip(a, R.Greater(b, 100.0)), bins=[50.0, 100.0, 150.0]), values=[1, 3]),
        R.Mask(flags, 3),
        R.Clip(R.GreaterEqual(a, 20.0) * 2, R.LessEqual(b, 180.0)),
        R.Place(small, "EPSG:28992", [135016.0, 455984.0],
                [[135040.0 + 60 * i, 455900.0 - 50 * i] for i in range(4)], statistic="mean"),
    )
    return view, chip_smoke.vals_request(256)


def _hourly48(px=256):
    """48 hourly frames across the switch to summer time in Amsterdam,
    with 5% nodata: chip_smoke.py's temporal source at a small size."""
    rng = np.random.RandomState(4)
    data = (rng.rand(48, px, px) * 200).astype(np.float32)
    data[np.random.default_rng(4).random((48, px, px), dtype=np.float32) < 0.05] = (
        np.finfo(np.float32).max)
    return JaxMemorySource(
        data=data,
        no_data_value=float(np.finfo(np.float32).max),
        projection="EPSG:28992",
        pixel_size=1.0,
        pixel_origin=(135000.0, 456000.0),
        time_first=datetime.datetime(2000, 3, 25),
        time_delta=datetime.timedelta(hours=1),
    )


def _temporal_request(px=256):
    return dict(chip_smoke.vals_request(px), start=datetime.datetime(2000, 3, 25),
                stop=datetime.datetime(2000, 3, 27))


def _temporal():
    """Snap, Cumulative, Resample and Shift: chip_smoke.py's
    temporal-cumulative view."""
    from dask_geomodeling_tpu import raster as R

    source = _hourly48()
    view = R.Snap(
        R.Cumulative(R.Resample(R.Shift(source, 1800000), "2h", direction="backward"),
                     statistic="sum", frequency="D", timezone="Europe/Amsterdam"),
        R.Resample(source, "6h"),
    )
    return view, _temporal_request()


def _aggregate():
    """TemporalAggregate below MovingMax: chip_smoke.py's temporal-median
    view (the percentiles, whose numpy process is slow, are held to it at
    a smaller size in tests/test_torch_temporal.py)."""
    from dask_geomodeling_tpu import raster as R

    view = JaxMovingMax(R.TemporalAggregate(_hourly48(), "6h", statistic="median",
                                            timezone="Europe/Amsterdam"), 3)
    return view, _temporal_request()


def _temporal_sum():
    from dask_geomodeling_tpu import raster as R

    return R.TemporalSum(R.Shift(_hourly48(), -3600000)), _temporal_request()


#: a polygon with a hole and a second part, over chip_smoke's 256^2
#: requests at (135000, 456000)
MULTIPOLYGON = (
    "MULTIPOLYGON (((135010.5 455990.5, 135200 455980, 135180 455800.25, 135020 455810, "
    "135010.5 455990.5), (135050 455950, 135100 455950, 135100 455900, 135050 455950)), "
    "((135210 455790, 135250 455790, 135250 455750, 135210 455790)))"
)


def _rasterize_wkt():
    """Clip(source, RasterizeWKT): both static at 1970-01-01."""
    from dask_geomodeling_tpu import raster as R

    source = JaxMemorySource(
        data=(np.random.RandomState(5).rand(1, 256, 256) * 200).astype(np.float32),
        no_data_value=float(np.finfo(np.float32).max),
        projection="EPSG:28992",
        pixel_size=1.0,
        pixel_origin=(135000.0, 456000.0),
        time_first=datetime.datetime(1970, 1, 1),
    )
    view = R.Clip(source, R.RasterizeWKT(MULTIPOLYGON, "EPSG:28992"))
    return view, dict(chip_smoke.vals_request(256), start=datetime.datetime(1970, 1, 1), stop=None)


def _rasterize():
    from dask_geomodeling_tpu import raster as R

    view = R.Add(R.Rasterize(JaxGeometryWKTSource(MULTIPOLYGON, "EPSG:28992")), 1)
    return view, dict(chip_smoke.vals_request(256), start=datetime.datetime(1970, 1, 1), stop=None)


VIEWS = {"headline": _headline, "stencils": _stencils, "algebra": _algebra,
         "temporal": _temporal, "aggregate": _aggregate, "temporal-sum": _temporal_sum,
         "rasterize-wkt": _rasterize_wkt, "rasterize": _rasterize}


@pytest.fixture(scope="module", params=sorted(VIEWS))
def views(request):
    """(name, JAX view, port view, three tile requests)."""
    jax_view, full = VIEWS[request.param]()
    tiles, _ = tile_requests(full, 128)
    picked = [tiles[0], tiles[len(tiles) // 2], tiles[-1]]
    return request.param, jax_view, from_reference(jax_view.serialize()), picked


def _plan(reachable, toposort, view, request):
    graph, name = view.get_compute_graph(**request)
    return graph, toposort(*reachable(graph, name))


def _jax_plan(view, request):
    # the port stages its coarse warp grid per tile; the JAX planner's
    # own grid is switched off to compare the rest of the plan
    with jax_config.set({"geomodeling.warp-host-grid": False}):
        return _plan(jax_reachable, jax_toposort, view, request)


def _assert_same(port, ref, where):
    if hasattr(ref, "wkt") and hasattr(ref, "bounds"):  # a geometry
        assert type(port).__name__ == type(ref).__name__ and port.wkt == ref.wkt, where
    elif hasattr(ref, "geometry") and hasattr(ref, "columns"):  # a feature frame
        assert sorted(port.columns) == sorted(ref.columns), where
        np.testing.assert_array_equal(port.index.values, ref.index.values)
        for column in ref.columns:
            if column == "geometry":
                assert [g.wkt for g in port[column]] == [g.wkt for g in ref[column]], where
            else:
                assert repr(port[column].tolist()) == repr(ref[column].tolist()), where
    elif dataclasses.is_dataclass(ref):
        assert type(port).__name__ == type(ref).__name__, where
        for field in dataclasses.fields(ref):
            _assert_same(getattr(port, field.name), getattr(ref, field.name), where + "." + field.name)
    elif isinstance(ref, np.ndarray):
        assert isinstance(port, np.ndarray) and port.dtype == ref.dtype, where
        np.testing.assert_array_equal(port, ref, err_msg=where)
    elif isinstance(ref, dict):
        assert sorted(port) == sorted(ref), where
        for key in ref:
            _assert_same(port[key], ref[key], "%s[%r]" % (where, key))
    elif isinstance(ref, (list, tuple)):
        assert type(port) is type(ref) and len(port) == len(ref), where
        for i, (p, r) in enumerate(zip(port, ref)):
            _assert_same(p, r, "%s[%d]" % (where, i))
    else:
        assert type(port) is type(ref) and port == ref, (where, port, ref)


def test_from_reference_plans_the_same_graph(views):
    name, jax_view, view, tiles = views
    assert type(view).__module__.startswith("dask_geomodeling_tpu_torch.")
    for tile in tiles:
        jax_graph, jax_order = _jax_plan(jax_view, tile)
        graph, order = _plan(_reachable, _toposort, view, tile)
        assert len(order) == len(jax_order)
        for key, jax_key in zip(order, jax_order):
            node, jax_node = graph[key], jax_graph[jax_key]
            assert node[0].__name__ == jax_node[0].__name__
            assert node[0] is not jax_node[0]
            assert len(node) == len(jax_node)
            for arg, jax_arg in zip(node[1:], jax_node[1:]):
                if isinstance(jax_arg, str) and jax_arg in jax_graph:
                    assert arg in graph  # a graph key in both
                else:
                    _assert_same(arg, jax_arg, "%s %s" % (name, node[0].__name__))


def test_chip_smoke_builds_the_reference_views():
    """chip_smoke.py's private builders give the views bench.py and
    benchmarks/run.py build, carried across."""
    source, view = bench.build_view(64)
    port_source, port_view = chip_smoke.build_headline_view(64)
    assert from_reference(view.serialize()).token == port_view.token
    assert bench.full_request(source, 100) == chip_smoke.headline_request(port_source, 100)
    jax_source = JaxMemorySource(
        data=(np.random.RandomState(0).rand(1, 64, 64) * 200).astype(np.float32),
        no_data_value=float(np.finfo(np.float32).max),
        projection="EPSG:28992",
        pixel_size=1.0,
        pixel_origin=(135000.0, 456000.0),
        time_first=datetime.datetime(2000, 1, 1),
        time_delta=None,
    )
    jax_view = JaxHillShade(JaxSmooth(JaxMovingMax(jax_source, 3), 5))
    assert from_reference(jax_view.serialize()).token == chip_smoke.build_stencils_view(64)[1].token
    from benchmarks.run import configs

    (_, jax_view, request), = [c for c in configs(256) if c[0] == "temporal+zonal"]
    paths, _ = chip_smoke.build_temporal_paths(mean_px=64, px=64, nodata_share=0.0)
    view, port_request, _, _ = paths["temporal-mean"]
    assert from_reference(jax_view.serialize()).token == view.token
    assert port_request == request


@pytest.mark.parametrize(
    "make, name",
    [
        (lambda source: MergeGeometryBlocks(
            JaxGeometryWKTSource("POINT (1 1)", "EPSG:28992"),
            JaxGeometryWKTSource("POINT (2 1)", "EPSG:28992")),
         "merge.MergeGeometryBlocks"),
        (lambda source: Buffer(JaxGeometryWKTSource("POINT (1 1)", "EPSG:28992"), 1.0, "EPSG:28992"),
         "constructive.Buffer"),
        (lambda source: ParseTextColumn(
            JaxGeometryWKTSource("POINT (1 1)", "EPSG:28992"), "geometry", {"x": "x"}),
         "text.ParseTextColumn"),
    ],
)
def test_from_reference_names_what_is_not_ported(make, name):
    """Each of these raised NotImplementedError naming its class until its
    module was ported; now each comes across as the port's class of the
    same module path and name (what is still left out raises, as
    test_from_reference_names_a_class_missing_from_a_ported_module
    shows)."""
    source, _ = bench.build_view(32)
    view = make(source)
    port = from_reference(view.serialize())
    assert "%s.%s" % (type(port).__module__, type(port).__name__) == \
        "dask_geomodeling_tpu_torch.geometry." + name
    assert port.columns == view.columns


def test_from_reference_names_a_class_missing_from_a_ported_module(monkeypatch):
    """A reference class in a module the port has, where the port's module
    lacks that class (no real one does now, so one is put on the JAX side)."""
    from dask_geomodeling_tpu.geometry import geom_operations as jax_geom_operations

    class Perimeter(jax_geom_operations.Area):
        pass

    Perimeter.__module__ = jax_geom_operations.__name__
    monkeypatch.setattr(jax_geom_operations, "Perimeter", Perimeter, raising=False)
    view = Perimeter(JaxGeometryWKTSource("POINT (1 1)", "EPSG:28992"), "EPSG:28992")
    with pytest.raises(NotImplementedError, match=r"geom_operations\.Perimeter is not ported"):
        from_reference(view.serialize())


def test_from_reference_carries_the_vector_blocks(tmp_path):
    """GeometryFileSource, every field operation, Area, GeometryTiler and
    GeometryFileSink come across: the port's class of the same module
    path and name, with the same arguments."""
    from dask_geomodeling_tpu_torch.geo.features import GeoDataFrame
    from dask_geomodeling_tpu_torch.geo.geometry import box
    from dask_geomodeling_tpu_torch.io.vectorfile import write_vector

    path = str(tmp_path / "pand.gpkg")
    write_vector(GeoDataFrame({"a": [1.5], "b": [2]}, geometry=[box(0, 0, 1, 1)],
                              crs="EPSG:28992"), path, layer="pand")
    source = jax_blocks.GeometryFileSource(path, layer="pand")
    a, b = source["a"], source["b"]
    series = [
        jax_blocks.Classify(a, [1.0, 2.0], ["x", "y", "z"], right=False),
        jax_blocks.ClassifyFromColumns(source, "a", ["b"], ["low", "high"]),
        a + b, a - 1, a * b, a / 2.0, a // b, a ** 2, a % 3, a == b, a != 1, a > b, a >= 1,
        a < b, a <= 2, (a > 1) & (b > 1), (a > 1) | (b > 1), (a > 1) ^ (b > 1), ~(a > 1),
        jax_blocks.Where(a, a > 1, 0.0), jax_blocks.Mask(a, a > 1, b),
        jax_blocks.Round(a, 2), jax_blocks.Interp(a, [0, 1], [1, 3], left=0.0),
        jax_blocks.Choose(a, b, a), jax_blocks.Area(source, "EPSG:28992"),
    ]
    view = jax_blocks.GeometryTiler(jax_blocks.GeometryFileSink(
        source.set(*[x for k, s in enumerate(series) for x in ("c%d" % k, s)]), "/out", "gpkg",
    ), 1000.0, "EPSG:28992")
    serialized = view.serialize()
    ported = from_reference(serialized)
    found = {}

    def walk(block):
        found[type(block).__module__ + "." + type(block).__name__] = block
        for arg in block.args:
            if hasattr(arg, "args") and hasattr(arg, "token"):
                walk(arg)

    walk(ported)
    expected = {value[0].replace("dask_geomodeling_tpu.", "dask_geomodeling_tpu_torch.", 1)
                for value in serialized["graph"].values()}
    assert set(found) == expected
    assert len(expected) >= 27
    assert ported.size == 1000.0 and ported.source.extension == "gpkg"
    assert ported.source.source.columns == view.source.source.columns


# --- the numpy processes and compute_host ---

PROCESSES = {
    "headline": ["process", "add", "_smooth_process", "_classify_process", "_reclassify_process"],
    "stencils": ["process", "_moving_max_process", "_smooth_process", "_hillshade_process"],
    "algebra": [
        "_classify_process", "_clip_process", "_dilate_process", "_fill_no_data_process",
        "_invert_process", "_is_data_process", "_is_no_data_process", "_mask_below_process",
        "_mask_process", "_step_process", "divide", "equal", "exp", "greater", "greater_equal",
        "less", "less_equal", "log", "log10", "logical_and", "logical_or", "logical_xor",
        "multiply", "not_equal", "power", "process", "reduce_max", "subtract",
    ],
    "temporal": ["_cumulative_process", "_resample_process", "_shift_process", "_snap_process",
                 "process"],
    "aggregate": ["_aggregate_process", "_moving_max_process", "process"],
    "temporal-sum": ["_shift_process", "_temporal_sum_process", "process"],
    "rasterize-wkt": ["_clip_process", "process"],
    "rasterize": ["add", "process"],
}


def _copy(arg):
    if isinstance(arg, dict) and isinstance(arg.get("values"), np.ndarray):
        return dict(arg, values=arg["values"].copy())
    return arg


def test_copied_processes_bitwise(views):
    """Every node of the plan, in order: the port's numpy process on the
    inputs the JAX package's processes produced equals the JAX process."""
    name, jax_view, view, tiles = views
    seen = []
    for tile in tiles:
        jax_graph, jax_order = _jax_plan(jax_view, tile)
        graph, order = _plan(_reachable, _toposort, view, tile)
        results, port_results = {}, {}
        for key, jax_key in zip(order, jax_order):
            jax_node = jax_graph[jax_key]
            inputs = [
                results[a] if isinstance(a, str) and a in jax_graph else a
                for a in jax_node[1:]
            ]
            expected = jax_node[0](*[_copy(a) for a in inputs])
            # the port's own literals (its source plan holds its RasterData)
            # and, for features, the port's own frames
            port_inputs = [
                port_results[a] if isinstance(a, str) and a in port_results
                else inp if isinstance(a, str) and a in jax_graph else port_arg
                for a, inp, port_arg in zip(jax_node[1:], inputs, graph[key][1:])
            ]
            actual = graph[key][0](*[_copy(a) for a in port_inputs])
            _assert_result(actual, expected, name)
            results[jax_key] = expected
            if isinstance(expected, dict) and "features" in expected:
                port_results[jax_key] = actual
            seen.append(graph[key][0].__name__)
    assert sorted(set(seen)) == sorted(PROCESSES[name])


def _assert_result(actual, expected, where):
    """A process's answer equal to the JAX process's: pixels bitwise,
    features by _assert_same, time answers equal."""
    if isinstance(expected, dict) and "values" in expected:
        assert actual["no_data_value"] == expected["no_data_value"]
        assert actual["values"].dtype == expected["values"].dtype
        np.testing.assert_array_equal(actual["values"], expected["values"])
    elif isinstance(expected, dict) and "features" in expected:
        assert actual["projection"] == expected["projection"]
        _assert_same(actual["features"], expected["features"], where)
    else:  # the time answers of a Group's time subrequests
        assert actual == expected


def test_compute_host_equals_the_numpy_executor(views):
    _, jax_view, view, tiles = views
    for tile in tiles + [dict(tiles[0], width=97, height=61)]:
        with jax_config.set({"geomodeling.executor": "numpy"}):
            expected = jax_view.get_data(**tile)
        actual = compute_host(*view.get_compute_graph(**tile))
        assert actual["no_data_value"] == expected["no_data_value"]
        assert actual["values"].dtype == expected["values"].dtype
        np.testing.assert_array_equal(actual["values"], expected["values"])


def _zonal_views(statistic):
    """AggregateRaster of a GeometryWKTSource over a 3-frame float32
    source with nodata and NaN, and a zonal request over it."""
    from dask_geomodeling_tpu.geo.geometry import box
    from dask_geomodeling_tpu.geometry import AggregateRaster

    rng = np.random.RandomState(6)
    data = (rng.rand(3, 256, 256) * 200).astype(np.float32)
    data[rng.rand(3, 256, 256) < 0.05] = np.nan
    data[rng.rand(3, 256, 256) < 0.05] = np.finfo(np.float32).max
    source = JaxMemorySource(data=data, no_data_value=float(np.finfo(np.float32).max),
                             projection="EPSG:28992", pixel_size=1.0,
                             pixel_origin=(135000.0, 456000.0),
                             time_first=datetime.datetime(2000, 1, 1),
                             time_delta=datetime.timedelta(hours=1))
    jax_view = AggregateRaster(JaxGeometryWKTSource(MULTIPOLYGON, "EPSG:28992"), source, statistic)
    request = dict(mode="intersects", geometry=box(135000, 455744, 135256, 456000),
                   projection="EPSG:28992", start=datetime.datetime(2000, 1, 1),
                   stop=datetime.datetime(2000, 1, 1, 2))
    return jax_view, from_reference(jax_view.serialize()), request


@pytest.mark.parametrize("statistic", ["mean", "median", "p90"])
def test_zonal_plans_and_processes(statistic):
    """AggregateRaster carried across: the same plan (its pre-flight
    extent request answered on the host), each process equal on the JAX
    package's inputs, compute_host and the device plane equal to the
    numpy executor."""
    from dask_geomodeling_tpu_torch.geo import geometry as port_geometry

    jax_view, view, request = _zonal_views(statistic)
    port_request = dict(request, geometry=port_geometry.from_wkt(request["geometry"].wkt))
    with jax_config.set({"geomodeling.executor": "numpy"}):
        jax_graph, jax_order = _plan(jax_reachable, jax_toposort, jax_view, request)
        expected = jax_view.get_data(**request)
    graph, order = _plan(_reachable, _toposort, view, port_request)
    assert [graph[k][0].__name__ for k in order] == [jax_graph[k][0].__name__ for k in jax_order]
    results, port_results = {}, {}
    for key, jax_key in zip(order, jax_order):
        jax_node, node = jax_graph[jax_key], graph[key]
        for arg, jax_arg in zip(node[1:], jax_node[1:]):
            if not (isinstance(jax_arg, str) and jax_arg in jax_graph):
                _assert_same(arg, jax_arg, node[0].__name__)
        inputs = [results[a] if isinstance(a, str) and a in jax_graph else a for a in jax_node[1:]]
        results[jax_key] = jax_node[0](*[_copy(a) for a in inputs])
        port_inputs = [
            port_results[a] if isinstance(a, str) and a in port_results
            else inp if isinstance(a, str) and a in jax_graph else port_arg
            for a, inp, port_arg in zip(jax_node[1:], inputs, node[1:])
        ]
        port_results[jax_key] = node[0](*[_copy(a) for a in port_inputs])
        _assert_result(port_results[jax_key], results[jax_key], node[0].__name__)
    for actual in (compute_host(*view.get_compute_graph(**port_request)),
                   view.get_data(device="cpu", **port_request)):
        _assert_result(actual, expected, statistic)
