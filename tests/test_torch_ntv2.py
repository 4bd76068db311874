"""The port's NTv2 grid shifts (geo/ntv2.py, crs._datum_shift) against the
JAX package's, on the CPU, with the grids tests/test_ntv2.py builds.

Both packages read the same .gsb files: the parse, the forward shift,
its inverse iteration, the coverage mask and the wiring into
``transform_points`` (the grid leg, the Helmert fallback outside the
grid, a datum on each side) agree bitwise, each package under its own
``geomodeling.ntv2-grids`` setting.  chip_smoke.py writes its grids with
``write_ntv2``, which writes the bytes tests/test_ntv2.py's
``make_gsb`` writes; and its crs-families view over RD New with an
Amersfoort grid answers the JAX package's numpy executor.
"""
import numpy as np
import pytest

import chip_smoke
from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu.geo import ntv2 as jax_ntv2
from dask_geomodeling_tpu.geo.crs import get_sr as jax_get_sr
from dask_geomodeling_tpu.geo.crs import transform_points as jax_transform_points
from dask_geomodeling_tpu_torch import compute_host, from_reference
from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.geo import ntv2
from dask_geomodeling_tpu_torch.geo.crs import get_sr, transform_points
from tests.test_ntv2 import make_gsb

NZGD49 = "+proj=longlat +ellps=intl +towgs84=59.47,-5.04,187.44"


def _linear(lon, lat):
    return (lat - 50.0) * 1.0 + 0.25 * (lon - 2.0), 0.5 * (lon - 2.0) - 0.1 * (lat - 50.0)


@pytest.fixture()
def grids(tmp_path):
    """A constant grid over 2-8 E, 50-55 N at 1 degree, and a linear field
    over the same area at half a degree."""
    paths = {}
    paths["constant"] = str(tmp_path / "const.gsb")
    make_gsb(paths["constant"], 180000.0, 198000.0, -28800.0, -7200.0, 3600.0,
             lambda lon, lat: (2.0, 1.0))
    paths["linear"] = str(tmp_path / "lin.gsb")
    make_gsb(paths["linear"], 180000.0, 198000.0, -28800.0, -7200.0, 1800.0,
             lambda lon, lat: _linear(lon, lat))
    return paths


def _points():
    rng = np.random.RandomState(0)
    lon = np.concatenate([rng.uniform(1.0, 9.0, 200), [5.0, 2.0, 8.0, 100.0, np.nan]])
    lat = np.concatenate([rng.uniform(49.0, 56.0, 200), [52.0, 50.0, 55.0, -30.0, 52.0]])
    return lon, lat


def _same(actual, expected):
    for a, e in zip(actual, expected):
        assert a.dtype == e.dtype
        np.testing.assert_array_equal(a, e)


@pytest.mark.parametrize("name", ["constant", "linear"])
def test_grid_bitwise(grids, name):
    port, jax = ntv2.read_ntv2(grids[name]), jax_ntv2.read_ntv2(grids[name])
    assert (port.from_name, port.to_name) == (jax.from_name, jax.to_name)
    for a, b in zip(port.subgrids, jax.subgrids):
        np.testing.assert_array_equal(a.shifts, b.shifts)
    lon, lat = _points()
    _same(port.forward(lon, lat), jax.forward(lon, lat))
    _same(port.inverse(lon, lat), jax.inverse(lon, lat))
    np.testing.assert_array_equal(port.coverage(lon, lat), jax.coverage(lon, lat))


def test_rejects_non_ntv2(tmp_path):
    path = tmp_path / "junk.gsb"
    path.write_bytes(b"definitely not a grid file")
    with pytest.raises(IOError):
        ntv2.read_ntv2(str(path))


@pytest.mark.parametrize("name", ["constant", "linear"])
@pytest.mark.parametrize("dst", ["EPSG:4326", "EPSG:3857", "EPSG:28992", "EPSG:25832"])
def test_transform_wiring_bitwise(grids, name, dst):
    """A grid registered for NZGD49's datum in both packages: the grid leg
    inside it, the Helmert leg outside, both directions."""
    datum = get_sr(NZGD49).datum
    assert datum == jax_get_sr(NZGD49).datum
    lon, lat = _points()
    setting = {"geomodeling.ntv2-grids": {datum: grids[name]}}
    with config.set(setting), jax_config.set(setting):
        assert ntv2.grid_for_datum(datum) is not None
        expected = jax_transform_points(lon, lat, NZGD49, dst)
        _same(transform_points(lon, lat, NZGD49, dst), expected)
        _same(transform_points(*expected, dst, NZGD49),
              jax_transform_points(*expected, dst, NZGD49))
    unshifted = transform_points(lon, lat, NZGD49, dst)
    assert not np.array_equal(unshifted[1][:200], expected[1][:200])


def test_grids_on_both_datums(grids):
    """A grid for each side's datum (NZGD49 and Amersfoort)."""
    lon, lat = _points()
    x, y = jax_transform_points(lon, lat, "EPSG:4326", "EPSG:28992")
    setting = {"geomodeling.ntv2-grids": {get_sr(NZGD49).datum: grids["constant"],
                                          "Amersfoort": grids["linear"]}}
    with config.set(setting), jax_config.set(setting):
        _same(transform_points(x, y, "EPSG:28992", NZGD49),
              jax_transform_points(x, y, "EPSG:28992", NZGD49))


def test_chip_smoke_writes_the_test_grids(tmp_path):
    ours, theirs = str(tmp_path / "ours.gsb"), str(tmp_path / "theirs.gsb")
    chip_smoke.write_ntv2(ours, 180000.0, 198000.0, -28800.0, -7200.0, 1800.0, _linear)
    make_gsb(theirs, 180000.0, 198000.0, -28800.0, -7200.0, 1800.0, _linear)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_amersfoort_grid_view_answers_the_numpy_executor(tmp_path):
    """chip_smoke's crs-families NTv2 request at 128^2: the port's
    compute_host and its twins on the CPU against the JAX package's numpy
    executor, the grid registered in both packages."""
    from dask_geomodeling_tpu_torch import evaluate_tiled

    grid = str(tmp_path / "amersfoort.gsb")
    chip_smoke.write_amersfoort_grid(grid)
    view, request = chip_smoke.build_family_view(*chip_smoke.NTV2_PLACE, px=128, cell=2.0)
    jax_view = _jax_view(view)
    setting = {"geomodeling.ntv2-grids": {"Amersfoort": grid}}
    with config.set(setting), jax_config.set(dict(setting, **{"geomodeling.executor": "numpy"})):
        expected = jax_view.get_data(**request)
        np.testing.assert_array_equal(compute_host(*view.get_compute_graph(**request))["values"],
                                      expected["values"])
        np.testing.assert_array_equal(view.get_data(device="cpu", **request)["values"],
                                      expected["values"])
        tiled = evaluate_tiled(view, request, tile_size=128, batch=1, device="cpu")
        np.testing.assert_array_equal(tiled["values"], expected["values"])
    with jax_config.set({"geomodeling.executor": "numpy"}):
        helmert = jax_view.get_data(**request)
    assert not np.array_equal(helmert["values"], expected["values"])


def _jax_view(view):
    """The JAX package's view of a port view: the same construction graph
    with the JAX package's class paths, validated."""
    from dask_geomodeling_tpu.core import construct

    serialized = view.serialize()
    graph = {key: [value[0].replace("dask_geomodeling_tpu_torch.", "dask_geomodeling_tpu.")]
             + list(value[1:]) for key, value in serialized["graph"].items()}
    jax_view = construct(graph, serialized["name"], validate=True)
    assert from_reference(jax_view.serialize()).token == view.token
    return jax_view
