"""The building-heights view of chip_smoke.py at small size, end to end
on the CPU, against the JAX package's numpy executor.

A 512^2 sheet (256 m at 0.5 m) and 200 synthetic footprints over it
(chip_smoke.write_sheet, write_buildings), per building the mean and 90th
percentile of Smooth(RasterFileSource(sheet), 3), the rounded mean, the
relief class and the area, exported with ``to_file`` in 128 m tiles (4
tiles) as a GeoPackage, and a sub-area as GeoJSON and as a Shapefile: the
port's files against the JAX package's (GeoPackage contents equal,
GeoJSON and Shapefile byte-identical; on CPU tensors the port's device
plane is bitwise to the host).
"""
import pytest

import chip_smoke
from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu import geometry as jax_blocks
from dask_geomodeling_tpu import raster as jax_raster
from dask_geomodeling_tpu.geo import geometry as jax_geometry
from dask_geomodeling_tpu.runtime import pipeline as jax_pipeline
from dask_geomodeling_tpu_torch import from_reference
from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.geo import geometry
from dask_geomodeling_tpu_torch.geometry.sinks import to_file
from dask_geomodeling_tpu_torch.io import vectorfile
from dask_geomodeling_tpu_torch.runtime import pipeline
from tests.test_torch_vectorfile import _family, gpkg_contents


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    folder = tmp_path_factory.mktemp("buildings")
    sheet = chip_smoke.write_sheet(str(folder), width=512, height=512, block=60)
    from dask_geomodeling_tpu_torch.raster import RasterFileSource

    buildings = chip_smoke.write_buildings(str(folder), RasterFileSource(sheet).geometry.bounds,
                                           200)
    return folder, sheet, buildings


def jax_view(buildings, sheet):
    """build_buildings_view with the JAX package's blocks."""
    source = jax_blocks.GeometryFileSource(buildings, layer="pand")
    dem = jax_raster.Smooth(jax_raster.RasterFileSource(sheet), 3)
    mean = jax_blocks.AggregateRaster(source, dem, "mean")["agg"]
    p90 = jax_blocks.AggregateRaster(source, dem, "p90")["agg"]
    return source.set(
        "h_mean", jax_blocks.Round(mean, 2),
        "h_p90", p90,
        "relief", jax_blocks.Classify(p90 - mean, [0.25, 1.0], ["flat", "sloped", "steep"]),
        "area", jax_blocks.Area(source, "EPSG:28992"),
    )


@pytest.fixture
def root(files):
    folder = files[0]
    pipeline.clear_read_cache()
    jax_pipeline.clear_read_cache()
    with jax_config.set({"geomodeling.root": str(folder), "geomodeling.executor": "numpy"}), \
            config.set({"geomodeling.root": str(folder)}):
        yield folder


def test_the_view_carries_across(root, files):
    _, sheet, buildings = files
    ported = from_reference(jax_view(buildings, sheet).serialize())
    built = chip_smoke.build_buildings_view(buildings, sheet)
    assert ported.token == built.token
    assert ported.columns == jax_view(buildings, sheet).columns


@pytest.mark.parametrize("rtree", [False, True])
def test_tiled_geopackage_export_as_the_jax_package(root, files, rtree):
    _, sheet, buildings = files
    limit = {"geomodeling.vector-windowed-read-limit": 1024 if rtree else 16 * 1024 * 1024}
    request = dict(tile_size=128.0, projection="EPSG:28992", mode="centroid")
    with jax_config.set(limit), config.set(limit):
        jax_view(buildings, sheet).to_file(str(root / "jax.gpkg"), **request)
        to_file(chip_smoke.build_buildings_view(buildings, sheet), str(root / "port.gpkg"),
                device="cpu", **request)
    assert gpkg_contents(str(root / "port.gpkg")) == gpkg_contents(str(root / "jax.gpkg"))
    merged = vectorfile.read_vector(str(root / "port.gpkg"))
    assert len(merged) > 150
    assert set(merged["relief"].tolist()) <= {"flat", "sloped", "steep"}
    (root / "port.gpkg").unlink()
    (root / "jax.gpkg").unlink()


@pytest.mark.parametrize("ext", ["geojson", "shp"])
def test_sub_area_export_as_the_jax_package(root, files, ext):
    _, sheet, buildings = files
    x1, y1, x2, y2 = vectorfile.read_vector(buildings, layer="pand").total_bounds
    sub = (x1 + 40, y1 + 60, x1 + 140, y1 + 160)
    jax_view(buildings, sheet).to_file(str(root / ("jax." + ext)), mode="centroid",
                                       geometry=jax_geometry.box(*sub), projection="EPSG:28992")
    to_file(chip_smoke.build_buildings_view(buildings, sheet), str(root / ("port." + ext)),
            device="cpu", mode="centroid", geometry=geometry.box(*sub), projection="EPSG:28992")
    if ext == "geojson":
        assert (root / "port.geojson").read_bytes() == (root / "jax.geojson").read_bytes()
    else:
        assert _family(str(root / "port.shp")) == _family(str(root / "jax.shp"))
    assert len(vectorfile.read_vector(str(root / ("port." + ext)))) > 5


def test_the_phase_on_the_cpu(root, files, monkeypatch):
    """chip_smoke's check_buildings on CPU tensors: its checks hold (the
    Gaussian's launches counted where the card would launch it)."""
    import time

    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.raster import spatial

    def launching(*args, **kwargs):
        cuda_stencils.launches += 1
        return cuda_stencils.gaussian_blur_reference(*args, **kwargs)

    def unprofiled(run):  # no card to profile: (wall s, busy ms not measured)
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0, None

    monkeypatch.setattr(spatial, "gaussian_blur", launching)
    monkeypatch.setattr(chip_smoke, "device_busy_ms", unprofiled)
    folder = root / "phase"
    folder.mkdir()
    launches, numbers = chip_smoke.check_buildings("cpu", "cpu", str(folder), files[1],
                                                   count=200, tile=128.0, sub_size=100.0)
    assert launches["gaussian_blur"] == numbers["tiles"] == 4
    assert numbers["h_mean_rows_differing"] == 0
