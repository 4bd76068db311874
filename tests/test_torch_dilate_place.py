"""Dilate and Place, carried across from the JAX package and held on the
CPU against its numpy executor (``compute_host``, and the torch twins
through ``get_data`` and ``evaluate_tiled``), and where noted against its
jax executor too.

Dilate grows each value's cells by scipy's default structure on the
(bands, h, w) frame, the rank-3 cross, so a cell also spreads to the
bands before and after it: the fixtures have three bands or more.

Place in warp mode (a store no larger than the request) pastes the store
at every coordinate on the device, each tile at its own offset; the tiles
of a batch are grouped by which placements show data, so sum, count and
argmin see the same stack as numpy (which leaves out placements without
visible data, and answers an empty stack with nodata).  Bitwise for every
statistic but std, var and product (``rtol=1e-6``, as for the reductions).
"""
from datetime import datetime

import numpy as np
import pytest
import torch
from scipy import ndimage

from dask_geomodeling_tpu import raster as R
from dask_geomodeling_tpu_torch import compute_host, from_reference
from dask_geomodeling_tpu_torch.ops.stencils import binary_dilation
from tests.test_torch_elemwise import REQUEST, _numpy, assert_views_agree, source

ONE_FRAME = dict(REQUEST, stop=None)


def test_binary_dilation_is_scipys_rank3_cross():
    rng = np.random.RandomState(0)
    for shape in [(3, 9, 11), (1, 5, 5), (4, 1, 7), (2, 6, 1), (5, 13, 13)]:
        mask = rng.rand(2, *shape) > 0.85
        expected = np.stack([ndimage.binary_dilation(m) for m in mask])
        np.testing.assert_array_equal(binary_dilation(torch.from_numpy(mask)).numpy(), expected)


@pytest.mark.parametrize("values", [[1, 3], [3, 1], [2]])
def test_dilate_across_bands(values):
    classes = R.Classify(source("float32", bands=4), bins=[5.0, 15.0, 25.0])
    result = assert_views_agree(R.Dilate(classes, values), dict(REQUEST, stop=datetime(2000, 1, 1, 3)),
                                jax_twin=values == [1, 3])
    assert result["values"].shape[0] == 4


@pytest.mark.parametrize("dtype", ["uint8", "int16", "float32"])
def test_dilate_source_values(dtype):
    store = source(dtype, bands=3, scale=6)
    assert_views_agree(R.Dilate(store, [0, 3, 2.5]), dict(REQUEST, stop=datetime(2000, 1, 1, 2)))


def _place(statistic, store_shape=(6, 6), coordinates=None, store=None):
    store = store or source("float32", bands=1, shape=store_shape)
    if coordinates is None:
        coordinates = [
            [135004.0, 455990.0],  # inside
            [135006.5, 455988.0],  # overlapping the first
            [135019.0, 455997.0],  # partly outside
            [135050.0, 455900.0],  # wholly outside
            [135010.0, 455995.0],
        ]
    return R.Place(store, "EPSG:28992", [135003.0, 455997.0], coordinates, statistic)


STATISTICS = ["last", "first", "max", "min", "mean", "sum", "count", "argmin", "argmax",
              "median", "p90", "std", "var", "product"]


@pytest.mark.parametrize("statistic", STATISTICS)
def test_place_warp_mode(statistic):
    """Tiles of 8^2 in batches of 3 shift the placements per tile, and
    some tiles see a different subset of them."""
    rtol = 1e-6 if statistic in ("std", "var", "product") else None
    assert_views_agree(_place(statistic), ONE_FRAME, rtol=rtol, per_tile=True,
                       jax_twin=statistic in ("last", "max", "mean"))


@pytest.mark.parametrize("statistic", ["sum", "count", "argmin", "last"])
def test_place_skips_placements_without_visible_data(statistic):
    """The store's top-left 4x4 is nodata: the first placement shows only
    that corner (in the request's south-east tile) and is left out, so
    that tile is all nodata even for sum and count, and argmin counts
    only the placements kept."""
    store = source("float32", bands=1, shape=(6, 6))
    store.data[:, :4, :4] = store.no_data_value
    coordinates = [[135023.0, 455985.0], [135004.0, 455990.0]]
    view = _place(statistic, store=store, coordinates=coordinates)
    assert_views_agree(view, ONE_FRAME, per_tile=True)
    corner = dict(ONE_FRAME, bbox=(135016.0, 455984.0, 135024.0, 455992.0), width=8, height=8)
    expected = assert_views_agree(view, corner)
    assert (expected["values"] == expected["no_data_value"]).all()


def test_place_of_an_all_nodata_store():
    store = source("float32", bands=1, shape=(6, 6))
    store.data[:] = store.no_data_value
    for statistic in ("sum", "count", "max"):
        result = assert_views_agree(_place(statistic, store=store), ONE_FRAME, per_tile=True)
        assert (result["values"] == result["no_data_value"]).all()


@pytest.mark.parametrize("statistic", ["last", "max", "sum", "median"])
def test_place_group_mode(statistic):
    """A store larger than the request: one shifted request a coordinate
    that overlaps, merged on the device."""
    view = _place(statistic, store_shape=(30, 30))
    graph, name = from_reference(view.serialize()).get_compute_graph(**ONE_FRAME)
    assert graph[name][1]["mode"] == "group"
    assert_views_agree(view, ONE_FRAME, tile=32, jax_twin=statistic == "max")


def test_place_empty_and_meta():
    """No coordinate overlaps: the empty plan's nodata raster comes from
    the host, with the time answer it takes (no device node)."""
    view = _place("max", store_shape=(30, 30), coordinates=[[140000.0, 460000.0]])
    port_view = from_reference(view.serialize())
    graph = port_view.get_compute_graph(**ONE_FRAME)
    assert graph[0][graph[1]][1]["mode"] == "empty"
    expected = _numpy(view, ONE_FRAME)
    for actual in (compute_host(*graph), port_view.get_data(device="cpu", **ONE_FRAME)):
        np.testing.assert_array_equal(actual["values"], expected["values"])
        assert actual["no_data_value"] == expected["no_data_value"]
    for mode in ("time", "meta"):
        request = dict(ONE_FRAME, mode=mode)
        assert port_view.get_data(device="cpu", **request) == _numpy(view, request)


def test_place_attributes():
    view = _place("max")
    port_view = from_reference(view.serialize())
    np.testing.assert_allclose(port_view.extent, view.extent)
    assert port_view.projection == view.projection
    assert port_view.geometry.bounds == view.geometry.bounds
