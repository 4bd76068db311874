"""chip_smoke.py's CRS paths at a small size, on the CPU, against the JAX
package's numpy executor.

- border-reproject: the headline's chain over a 256^2 source in
  EPSG:25832 (ETRS89 / UTM 32N) over Gronau, sent through JSON as a
  service registers a layer (the token kept, the float32 list loaded as
  float64 in both packages), requested at 512^2 in EPSG:28992 over its
  footprint: two datums and two projection families.  compute_host,
  get_data and evaluate_tiled (tile by tile: the Gaussian reaches past
  Smooth's margin, so a tile answers its own window) are bitwise the
  JAX package's answer for the same JSON;
- crs-families: the same chain over a 128^2 source in each CRS of
  chip_smoke.CRS_FAMILIES (LCC 2SP and Belgium, LAEA, Albers, polar
  stereographic, Krovak, Hotine / Swiss, TM with OSGB36, Mercator and a
  proj4 string without an EPSG code), requested in EPSG:3857, bitwise.
"""
import numpy as np
import pytest

import chip_smoke
from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu.core import Block as JaxBlock
from dask_geomodeling_tpu_torch import compute_host, evaluate_tiled
from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests


def _jax_answer(text, request):
    view = JaxBlock.from_json(text.replace("dask_geomodeling_tpu_torch.", "dask_geomodeling_tpu."))
    with jax_config.set({"geomodeling.executor": "numpy"}):
        return view.get_data(**request)


def _hold(view, request, tile):
    """compute_host and get_data on the whole request, evaluate_tiled
    tile by tile, all bitwise the JAX package's numpy executor."""
    text = view.to_json()
    expected = _jax_answer(text, request)
    assert compute_host(*view.get_compute_graph(**request))["values"].dtype == expected[
        "values"].dtype
    np.testing.assert_array_equal(compute_host(*view.get_compute_graph(**request))["values"],
                                  expected["values"])
    with config.set({"geomodeling.tile-size": request["width"]}):
        np.testing.assert_array_equal(view.get_data(device="cpu", **request)["values"],
                                      expected["values"])
    tiled = evaluate_tiled(view, request, tile_size=tile, batch=3, device="cpu")["values"]
    tiles, nx = tile_requests(request, tile)
    for k, tile_request in enumerate(tiles):
        (rows, cols), (tile_rows, tile_cols) = chip_smoke.tile_cells(
            k, nx, request["width"], request["height"], tile)
        np.testing.assert_array_equal(
            tiled[:, rows, cols], _jax_answer(text, tile_request)["values"][:, tile_rows, tile_cols])
    return expected


def test_border_reproject():
    view, loaded = chip_smoke.build_border_view(256)
    assert loaded.token == view.token
    source = loaded.args[0].args[0].args[0].args[0].args[0]
    assert type(source).__name__ == "MemorySource" and source.data.dtype == np.float64
    request = chip_smoke.border_request(loaded, 512)
    assert request["projection"] == "EPSG:28992"
    expected = _hold(loaded, request, tile=128)
    assert expected["values"].shape == (1, 512, 512)
    assert len(np.unique(expected["values"])) > 3


@pytest.mark.parametrize("family", [f[0] for f in chip_smoke.CRS_FAMILIES])
def test_crs_families(family):
    _, projection, place = next(f for f in chip_smoke.CRS_FAMILIES if f[0] == family)
    view, request = chip_smoke.build_family_view(projection, place, px=128, cell=40.0)
    expected = _hold(view, request, tile=64)
    assert len(np.unique(expected["values"])) > 3
