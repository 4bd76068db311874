"""The port's PAM raster attribute tables (io/pam.py), held on the CPU to
the JAX package's.

Every case of tests/test_pam_rat.py runs once in each package (``run_both``
of tests/test_torch_raster_formats.py), each over its own package's GeoTIFF
writer, reader and raster blocks: the files written (the GeoTIFFs and the
``.aux.xml`` sidecars) are byte-identical, and the tables, answers and
errors the same.  Tables drawn by hypothesis round-trip through each
package's sidecar alike and give the same Reclassify data, and a sidecar
rewritten under a view built from it changes the next view's answer in
both packages.
"""
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dask_geomodeling_tpu.io import geotiff as jax_geotiff
from dask_geomodeling_tpu.io import pam as jax_pam
from dask_geomodeling_tpu_torch.io import geotiff, pam
from tests.test_pam_rat import GDAL_SIDECAR, RAT
from tests.test_torch_hfa import outcome
from tests.test_torch_raster_formats import _kit, run_both
from tests.test_torch_zarr import error


def _pkit(port):
    """``_kit`` with the package's PAM and GeoTIFF modules."""
    kit = _kit(port)
    kit.pam = pam if port else jax_pam
    kit.geotiff = geotiff if port else jax_geotiff
    return kit


def run_pam(tmp_path, case):
    """``run_both`` with the PAM kits."""
    return run_both(tmp_path, lambda k, root: case(_pkit(k.port), root))


def _tif(k, root, values=None):
    path = str(root / "thematic.tif")
    if values is None:
        values = np.array([[[1, 2], [5, 1]]], np.uint8)
    k.geotiff.write_geotiff(path, values, (0.0, 1.0, 0.0, 2.0, 0.0, -1.0), "EPSG:28992", 255)
    return path


# --- tests/test_pam_rat.py ---


def _read_gdal_sidecar(k, root):
    path = _tif(k, root)
    (root / "thematic.tif.aux.xml").write_text(GDAL_SIDECAR)
    rat = k.pam.read_raster_attribute_table(path)
    assert rat == RAT
    assert isinstance(rat["rows"][0][0], int) and isinstance(rat["rows"][0][2], float)
    return rat


def _absent_or_corrupt_sidecar_is_none(k, root):
    path = _tif(k, root)
    found = [k.pam.read_raster_attribute_table(path)]
    (root / "thematic.tif.aux.xml").write_text("<PAMDataset")
    found.append(k.pam.read_raster_attribute_table(path))
    (root / "thematic.tif.aux.xml").write_text("<PAMDataset/>")
    found.append(k.pam.read_raster_attribute_table(path))
    assert found == [None, None, None]
    return found


def _other_band_is_none(k, root):
    path = _tif(k, root)
    (root / "thematic.tif.aux.xml").write_text(GDAL_SIDECAR)
    assert k.pam.read_raster_attribute_table(path, band=2) is None


def _ragged_rows_skipped(k, root):
    path = _tif(k, root)
    (root / "thematic.tif.aux.xml").write_text(
        GDAL_SIDECAR.replace("        <F>0.75</F>\n", "", 1))
    rat = k.pam.read_raster_attribute_table(path)
    assert [r[0] for r in rat["rows"]] == [1, 5]
    return rat


def _write_roundtrip(k, root):
    path = _tif(k, root)
    k.pam.write_raster_attribute_table(path, RAT)
    rat = k.pam.read_raster_attribute_table(path)
    assert rat == RAT
    return rat


def _write_merges_existing_pam(k, root):
    path = _tif(k, root)
    (root / "thematic.tif.aux.xml").write_text(
        "<PAMDataset><SRS>EPSG:4326</SRS><PAMRasterBand band=\"1\">"
        "<NoDataValue>7</NoDataValue></PAMRasterBand></PAMDataset>")
    k.pam.write_raster_attribute_table(path, RAT)
    assert k.pam.read_raster_attribute_table(path) == RAT
    info = k.geotiff.read_geotiff_info(path)
    assert info.no_data_value == 7
    k.pam.write_raster_attribute_table(path, RAT)  # replace, not append
    text = (root / "thematic.tif.aux.xml").read_text()
    assert text.count("GDALRasterAttributeTable") == 2  # one open, one close
    return info.no_data_value, info.projection, text


def _write_validates_rows(k, root):
    with pytest.raises(ValueError, match="declared fields") as raised:
        k.pam.write_raster_attribute_table("/nonexistent", {"fields": RAT["fields"],
                                                            "rows": [[1]]})
    return error(raised, root)


def _rat_as_reclassify_data_and_view(k, root):
    path = _tif(k, root)
    k.pam.write_raster_attribute_table(path, RAT)
    data = k.pam.rat_as_reclassify_data(k.pam.read_raster_attribute_table(path),
                                        target="SUITABILITY")
    assert data == [[1, 0.25], [2, 0.75], [5, 0.1]]
    view = k.R.Reclassify(k.R.RasterFileSource("thematic.tif"), data, select=True)
    result = k.get_data(view, mode="vals", bbox=(0, 0, 2, 2), projection="EPSG:28992",
                        width=2, height=2)
    np.testing.assert_allclose(result["values"][0], [[0.25, 0.75], [0.1, 0.25]])
    return data, result


def _rat_as_reclassify_data_validation(k, root):
    raised = []
    with pytest.raises(TypeError, match="numeric") as e:
        k.pam.rat_as_reclassify_data(RAT, target="CLASS")
    raised.append(error(e, root))
    with pytest.raises(KeyError, match="no field") as e:
        k.pam.rat_as_reclassify_data(RAT, target="MISSING")
    raised.append(error(e, root))
    by_usage = k.pam.rat_as_reclassify_data(RAT, target="generic", value="VALUE")
    assert by_usage
    no_value = {"fields": [{"name": "X", "type": "float", "usage": "generic"}],
                "rows": [[1.0]]}
    with pytest.raises(KeyError, match="minmax") as e:
        k.pam.rat_as_reclassify_data(no_value, target="X")
    raised.append(error(e, root))
    bad_value = {"fields": [{"name": "VALUE", "type": "float", "usage": "minmax"},
                            {"name": "Y", "type": "float", "usage": "generic"}],
                 "rows": [[1.0, 2.0]]}
    with pytest.raises(TypeError, match="integer column") as e:
        k.pam.rat_as_reclassify_data(bad_value, target="Y")
    raised.append(error(e, root))
    return by_usage, raised


JAX_CASES = {
    "read-gdal-sidecar": _read_gdal_sidecar,
    "absent-or-corrupt-sidecar-is-none": _absent_or_corrupt_sidecar_is_none,
    "other-band-is-none": _other_band_is_none,
    "ragged-rows-skipped": _ragged_rows_skipped,
    "write-roundtrip": _write_roundtrip,
    "write-merges-existing-pam": _write_merges_existing_pam,
    "write-validates-rows": _write_validates_rows,
    "rat-as-reclassify-data-and-view": _rat_as_reclassify_data_and_view,
    "rat-as-reclassify-data-validation": _rat_as_reclassify_data_validation,
}


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_jax_case(tmp_path, name):
    """One case of tests/test_pam_rat.py, in each package."""
    run_pam(tmp_path, JAX_CASES[name])


# --- tables under hypothesis ---

USAGES = ["generic", "pixelcount", "name", "min", "max", "minmax", "red", "green", "blue",
          "alpha", "redmin", "bluemax"]
NAMES = st.text(st.characters(codec="ascii", categories=("L", "N")), min_size=1, max_size=8)
CELLS = {"int": st.integers(-2**40, 2**40),
         "float": st.floats(allow_nan=False, allow_infinity=False, width=64),
         "string": st.text(st.characters(codec="ascii", categories=("L", "N", "Zs")),
                           min_size=1, max_size=12).map(str.strip).filter(bool)}


@st.composite
def tables(draw):
    """A table of one to five fields and up to eight rows, and a band."""
    kinds = draw(st.lists(st.sampled_from(sorted(CELLS)), min_size=1, max_size=5))
    fields = [{"name": draw(NAMES), "type": kind, "usage": draw(st.sampled_from(USAGES))}
              for kind in kinds]
    rows = draw(st.lists(st.tuples(*[CELLS[kind] for kind in kinds]).map(list), max_size=8))
    return {"fields": fields, "rows": rows}, draw(st.integers(1, 3))


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.function_scoped_fixture])
@given(tables(), tables(), st.sampled_from(["VALUE", "X", "minmax", "generic", "pixelcount"]))
def test_tables_round_trip_alike(tmp_path_factory, first, second, target):
    """Two tables written in turn into one sidecar (the second into the
    first's band or another): the same sidecar bytes from both writers,
    each package reads back what the other reads, and the Reclassify
    data of any target, or the error, is the same."""
    folder = tmp_path_factory.mktemp("pam")
    sidecars = []
    for name, module in (("port.tif", pam), ("jax.tif", jax_pam)):
        path = str(folder / name)
        for rat, band in (first, second):
            module.write_raster_attribute_table(path, rat, band=band)
        sidecars.append((folder / (name + ".aux.xml")).read_bytes())
    assert sidecars[0] == sidecars[1]
    path = str(folder / "port.tif")
    for band in (1, 2, 3):
        ours = pam.read_raster_attribute_table(path, band=band)
        assert ours == jax_pam.read_raster_attribute_table(path, band=band)
        if ours is not None:
            mine = outcome(lambda: pam.rat_as_reclassify_data(ours, target))
            theirs = outcome(lambda: jax_pam.rat_as_reclassify_data(ours, target))
            assert mine == theirs


def test_rewritten_sidecar_changes_the_next_view(tmp_path):
    """A view built from a table answers with it; after the sidecar is
    rewritten, a view built anew answers with the new table, in each
    package alike."""
    def case(k, root):
        path = _tif(k, root, np.array([[[1, 2, 5], [5, 1, 3]]], np.uint8))
        answers = []
        for scale in (1, 2):
            rat = {"fields": RAT["fields"],
                   "rows": [row[:2] + [row[2] * scale] for row in RAT["rows"]]}
            k.pam.write_raster_attribute_table(path, rat)
            data = k.pam.rat_as_reclassify_data(k.pam.read_raster_attribute_table(path),
                                                "SUITABILITY")
            view = k.R.Reclassify(k.R.RasterFileSource("thematic.tif"), data, select=True)
            answers.append(k.get_data(view, mode="vals", bbox=(0, 0, 3, 2),
                                      projection="EPSG:28992", width=3, height=2))
        assert not np.array_equal(answers[0]["values"], answers[1]["values"])
        assert answers[1]["values"][0, 1, 2] == answers[1]["no_data_value"]  # 3 is not listed
        return answers

    run_pam(tmp_path, case)
