"""The building-rings view of chip_smoke.py at small size, end to end on
the CPU, against the JAX package's numpy executor.

A 512^2 sheet (256 m at 0.5 m) and the footprints of 200 synthetic
buildings over it (chip_smoke.building_frame), of which those inside a
128 m square (about 50) are written with a ``beschrijving``
(write_rings_buildings).  The view (build_rings_view): a 10 m ring per
footprint (Buffer, Difference, Simplify), the mean and p10 of
Smooth(RasterFileSource(sheet), 3) over the ring, merged (left) with the
footprint's own mean, two keys parsed from the description, a
field-operation difference and an Intersection with each tile, exported
with ``to_file`` in 80 m tiles (4 tiles) as a GeoPackage and a sub-area
as GeoJSON: the port's files against the JAX package's (GeoPackage
contents equal, GeoJSON byte-identical; on CPU tensors the port's device
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
from tests.test_torch_vectorfile import gpkg_contents

SIDE = 128.0
TILE = 80.0
FIELDS = {name: name for name in chip_smoke.RINGS_FIELDS}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    folder = tmp_path_factory.mktemp("rings")
    sheet = chip_smoke.write_sheet(str(folder), width=512, height=512, block=60)
    from dask_geomodeling_tpu_torch.raster import RasterFileSource

    bbox = RasterFileSource(sheet).geometry.bounds
    area = chip_smoke.rings_area(bbox, SIDE)
    buildings, count = chip_smoke.write_rings_buildings(str(folder), bbox, area, 200)
    return folder, sheet, buildings, area, count


def jax_view(buildings, sheet):
    """build_rings_view with the JAX package's blocks."""
    footprints = jax_blocks.GeometryFileSource(buildings, layer="pand")
    rings = jax_blocks.Simplify(jax_blocks.Difference(
        jax_blocks.Buffer(footprints, chip_smoke.RINGS_DISTANCE, "EPSG:28992"), footprints),
        chip_smoke.RINGS_SIMPLIFY)
    dem = jax_raster.Smooth(jax_raster.RasterFileSource(sheet), 3)
    stats = rings.set(
        "ring_mean", jax_blocks.Round(jax_blocks.AggregateRaster(rings, dem, "mean")["agg"], 2),
        "ring_p10", jax_blocks.AggregateRaster(rings, dem, "p10")["agg"])
    own = footprints.set(
        "h_mean", jax_blocks.Round(jax_blocks.AggregateRaster(footprints, dem, "mean")["agg"], 2))
    merged = jax_blocks.MergeGeometryBlocks(stats, own, how="left")
    parsed = jax_blocks.ParseTextColumn(merged, "beschrijving",
                                        {"vloerpeil": "peil", "kelder": "kelder"})
    return jax_blocks.Intersection(parsed.set("drempel", parsed["peil"] - parsed["ring_mean"]))


@pytest.fixture
def root(files):
    folder = files[0]
    pipeline.clear_read_cache()
    jax_pipeline.clear_read_cache()
    with jax_config.set({"geomodeling.root": str(folder), "geomodeling.executor": "numpy"}), \
            config.set({"geomodeling.root": str(folder)}):
        yield folder


def test_about_fifty_buildings(files):
    assert 35 <= files[4] <= 70


def test_the_view_carries_across(root, files):
    _, sheet, buildings, _, _ = files
    ported = from_reference(jax_view(buildings, sheet).serialize())
    built = chip_smoke.build_rings_view(buildings, sheet)
    assert ported.token == built.token
    assert ported.columns == jax_view(buildings, sheet).columns


def test_tiled_geopackage_export_as_the_jax_package(root, files):
    _, sheet, buildings, area, count = files
    request = dict(tile_size=TILE, projection="EPSG:28992", mode="centroid")
    jax_view(buildings, sheet).to_file(str(root / "jax.gpkg"), fields=FIELDS,
                                       geometry=jax_geometry.box(*area), **request)
    to_file(chip_smoke.build_rings_view(buildings, sheet), str(root / "port.gpkg"),
            fields=FIELDS, geometry=geometry.box(*area), device="cpu", **request)
    assert gpkg_contents(str(root / "port.gpkg")) == gpkg_contents(str(root / "jax.gpkg"))
    merged = vectorfile.read_vector(str(root / "port.gpkg"))
    assert len(merged) == count
    assert set(merged.columns) == set(FIELDS) | {"geometry"}
    (root / "port.gpkg").unlink()
    (root / "jax.gpkg").unlink()


def test_sub_area_geojson_as_the_jax_package(root, files):
    _, sheet, buildings, area, _ = files
    cx, cy = (area[0] + area[2]) / 2, (area[1] + area[3]) / 2
    sub = (cx - 30, cy - 30, cx + 30, cy + 30)
    jax_view(buildings, sheet).to_file(str(root / "jax.geojson"), fields=FIELDS, mode="centroid",
                                       geometry=jax_geometry.box(*sub), projection="EPSG:28992")
    to_file(chip_smoke.build_rings_view(buildings, sheet), str(root / "port.geojson"),
            fields=FIELDS, device="cpu", mode="centroid", geometry=geometry.box(*sub),
            projection="EPSG:28992")
    assert (root / "port.geojson").read_bytes() == (root / "jax.geojson").read_bytes()
    assert len(vectorfile.read_vector(str(root / "port.geojson"))) > 5


def test_the_phase_on_the_cpu(root, files, monkeypatch):
    """chip_smoke's check_building_rings on CPU tensors: its checks hold
    (the Gaussian's launches counted where the card would launch it)."""
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.raster import spatial

    def launching(*args, **kwargs):
        cuda_stencils.launches += 1
        return cuda_stencils.gaussian_blur_reference(*args, **kwargs)

    monkeypatch.setattr(spatial, "gaussian_blur", launching)
    folder = root / "phase"
    folder.mkdir()
    launches, numbers = chip_smoke.check_building_rings(
        "cpu", "cpu", str(folder), files[1], side=SIDE, tile=TILE, sub_size=60.0, count=200)
    assert numbers["tiles"] == 4
    assert launches["gaussian_blur"] == 2 * numbers["tiles"]
    assert numbers["rows_differing"] == 0 and numbers["geojson_identical"]
    assert set(numbers["phases"]) >= {"buffer", "difference", "vector read", "zonal", "sink"}


def _feature_collection(path, rows):
    import json

    features = [{"type": "Feature", "id": fid, "geometry": None,
                 "properties": dict(props)} for fid, props in rows]
    with open(path, "w") as f:
        json.dump({"type": "FeatureCollection", "features": features}, f)


@pytest.mark.parametrize("case, equal", [
    ("identical", True),
    ("rounded field of a differing row", True),
    ("rounded field of a row not found differing", False),
    ("other field of a differing row", False),
])
def test_geojson_equal_admits_only_the_differing_rounded_fields(tmp_path, case, equal):
    """chip_smoke.geojson_equal: byte-identical but for the rounded fields
    of the rows compare_heights found within one ulp."""
    host = [(1, {"ring_mean": 1.25, "peil": 3.5}), (2, {"ring_mean": 2.5, "peil": 4.0})]
    port = [(fid, dict(props)) for fid, props in host]
    differ = []
    if case == "rounded field of a differing row":
        port[1][1]["ring_mean"] = 2.51
        differ = [2]
    elif case == "rounded field of a row not found differing":
        port[0][1]["ring_mean"] = 1.26
        differ = [2]
    elif case == "other field of a differing row":
        port[1][1]["peil"] = 4.01
        differ = [2]
    _feature_collection(tmp_path / "host.geojson", host)
    _feature_collection(tmp_path / "port.geojson", port)
    assert chip_smoke.geojson_equal(str(tmp_path / "port.geojson"), str(tmp_path / "host.geojson"),
                                    differ, ("ring_mean",)) is equal


def test_mean_ulps_raises_for_a_fid_no_mean_holds(files):
    """chip_smoke.mean_ulps: a differing fid that no mean view holds fails
    the check instead of passing as a rounding difference."""
    from dask_geomodeling_tpu_torch.geometry import AggregateRaster, GeometryFileSource
    from dask_geomodeling_tpu_torch.raster import RasterFileSource, Smooth
    from dask_geomodeling_tpu_torch.geo.geometry import box

    folder, sheet, buildings, area, count = files
    mean_view = AggregateRaster(GeometryFileSource(buildings, layer="pand"),
                                Smooth(RasterFileSource(sheet), 3), "mean")
    request = dict(mode="centroid", geometry=box(*area), projection="EPSG:28992")
    with config.set({"geomodeling.torch-device": "cpu"}):
        ulps = chip_smoke.mean_ulps([mean_view], request, "cpu")
        fids = mean_view.get_data(**request)["features"].index.values
        assert ulps(list(fids[:3])) == [0, 0, 0]
        with pytest.raises(RuntimeError, match="no mean holds it"):
            ulps([10**9])
