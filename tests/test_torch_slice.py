"""The port's main path end to end, against the numpy executor and the JAX
package.

The view is bench.py's: Classify(Reclassify(Classify(Smooth(source + 1))))
over an EPSG:28992 source requested in EPSG:3857, built by the JAX package
and carried across with ``from_reference``.  Both device paths
interpolate a coarse transformer grid where the numpy executor transforms
every pixel (the JAX package in float32, the port in float64), so across
a CRS boundary a few cells may differ: the share is held to 5e-4 and to
no more than the JAX package's own share.  A same-CRS request is bitwise.
"""
from datetime import datetime

import numpy as np
import pytest
import torch

import bench
from dask_geomodeling_tpu import config
from dask_geomodeling_tpu.runtime.tiles import evaluate_tiled as jax_evaluate_tiled
from dask_geomodeling_tpu_torch import compute_torch, evaluate_tiled, from_reference, get_data
from dask_geomodeling_tpu_torch.config import config as port_config
from dask_geomodeling_tpu_torch.ops import cuda_stencils
from dask_geomodeling_tpu_torch.raster import BaseSingle
from dask_geomodeling_tpu_torch.runtime import executor, tiles
from dask_geomodeling_tpu_torch.runtime.tiles import NotLowerable

MAX_SHARE = 5e-4


class NoTwin(BaseSingle):
    """A block whose process has no torch twin."""

    @staticmethod
    def process(data):
        return data


@pytest.fixture(scope="module")
def main_path():
    """(JAX source, JAX view, port view, request, numpy executor result)."""
    source, jax_view = bench.build_view(512)
    request = bench.full_request(source, 1024)
    with config.set({"geomodeling.executor": "numpy"}):
        expected = jax_view.get_data(**request)
    view = from_reference(jax_view.serialize())
    return source, jax_view, view, request, expected


def _share(actual, expected):
    assert actual.shape == expected.shape and actual.dtype == expected.dtype
    return np.count_nonzero(actual != expected) / expected.size


def test_main_path_share(main_path):
    _, jax_view, view, request, expected = main_path
    port = evaluate_tiled(view, request, tile_size=256, batch=4, device="cpu")
    assert port["no_data_value"] == expected["no_data_value"]
    jax_result = jax_evaluate_tiled(jax_view, request, tile_size=256, batch=4)
    port_share = _share(port["values"], expected["values"])
    jax_share = _share(jax_result["values"], expected["values"])
    assert port_share <= MAX_SHARE
    assert port_share <= jax_share
    # the data region is reached: not all fill
    assert (port["values"] != expected["no_data_value"]).mean() > 0.5


@pytest.mark.cuda
def test_main_path_on_card_equals_cpu(main_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, _, view, request, _ = main_path
    cpu = evaluate_tiled(view, request, tile_size=256, batch=4, device="cpu")
    before, batches = cuda_stencils.launches, tiles.batches_run
    card = evaluate_tiled(view, request, tile_size=256, batch=4, device="cuda")
    # one per batch; tiles whose Smooth sigma differs (it does in its last
    # digits between tile rows of this cross-CRS request) share none
    assert cuda_stencils.launches == before + (tiles.batches_run - batches) >= before + 4
    np.testing.assert_array_equal(card["values"], cpu["values"])


def test_ragged_request_and_padded_batch(main_path):
    source, jax_view, view, _, _ = main_path
    request = bench.full_request(source, 1024)
    x1, y1, x2, y2 = request["bbox"]
    # 700 x 600 px over the lower-left part: edge tiles cropped on
    # assembly, and 9 tiles in batches of 4, the last at its own size
    request.update(
        bbox=(x1, y1, x1 + (x2 - x1) * 700 / 1024, y1 + (y2 - y1) * 600 / 1024),
        width=700,
        height=600,
    )
    with config.set({"geomodeling.executor": "numpy"}):
        expected = jax_view.get_data(**request)
    phases = {}
    port = evaluate_tiled(
        view, request, tile_size=256, batch=4, device="cpu", phase_seconds=phases
    )
    assert _share(port["values"], expected["values"]) <= MAX_SHARE
    assert sorted(phases) == ["assemble", "fetch", "plan", "run"]
    assert all(seconds >= 0 for seconds in phases.values())


def test_get_data_sub_tile_same_crs_bitwise(main_path):
    _, jax_view, view, _, _ = main_path
    request = dict(
        mode="vals",
        bbox=(85100.0, 454700.0, 85300.0, 454900.0),
        projection="EPSG:28992",
        width=200,
        height=200,
        start=datetime(2000, 1, 1),
    )
    with config.set({"geomodeling.executor": "numpy"}):
        expected = jax_view.get_data(**request)
    before = executor.host_node_runs
    actual = get_data(view, device="cpu", **request)
    assert executor.host_node_runs == before
    assert actual["no_data_value"] == expected["no_data_value"]
    np.testing.assert_array_equal(actual["values"], expected["values"])


def test_get_data_tiles_a_large_request(main_path):
    source, _, view, _, _ = main_path
    request = bench.full_request(source, 512)
    with port_config.set({"geomodeling.tile-size": 256, "geomodeling.tile-batch": 4}):
        routed = view.get_data(device="cpu", **request)
    direct = evaluate_tiled(view, request, tile_size=256, batch=4, device="cpu")
    np.testing.assert_array_equal(routed["values"], direct["values"])


def test_node_without_twin(main_path):
    jax_source, _, _, _, _ = main_path
    view = NoTwin(from_reference(jax_source.serialize()))
    request = dict(
        mode="vals",
        bbox=(85000.0, 454900.0, 85100.0, 455000.0),
        projection="EPSG:28992",
        width=100,
        height=100,
        start=datetime(2000, 1, 1),
    )
    with pytest.raises(NotLowerable):
        evaluate_tiled(view, request, tile_size=64, batch=2, device="cpu")
    # the source warps on the device; NoTwin has no twin, so its input
    # would have to come back to the host: the staged executor refuses
    before = executor.host_node_runs
    with pytest.raises(NotLowerable):
        compute_torch(*view.get_compute_graph(**request), device="cpu")
    with pytest.raises(NotLowerable):
        get_data(view, device="cpu", **request)
    assert executor.host_node_runs == before


def test_host_node_feeds_a_twin(main_path):
    """A point request is read on the host (the source twin serves only
    areas); the Add twin then takes the host result onto the device."""
    source, _, _, _, _ = main_path
    jax_view = source + 1
    view = from_reference(jax_view.serialize())
    x1, y1, x2, y2 = source.geo_transform.get_bbox((0, 0), source.data.shape[1:])
    x, y = (x1 + x2) / 2 + 0.5, (y1 + y2) / 2 + 0.5
    request = dict(
        mode="vals",
        bbox=(x, y, x, y),
        projection="EPSG:28992",
        width=1,
        height=1,
        start=datetime(2000, 1, 1),
    )
    with config.set({"geomodeling.executor": "numpy"}):
        expected = jax_view.get_data(**request)
    before = executor.host_node_runs
    actual = get_data(view, device="cpu", **request)
    assert executor.host_node_runs == before + 1
    assert actual["no_data_value"] == expected["no_data_value"]
    assert actual["values"].dtype == expected["values"].dtype
    assert expected["values"][0, 0, 0] != expected["no_data_value"]
    np.testing.assert_array_equal(actual["values"], expected["values"])


def test_cuda_without_a_card_raises(main_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, _, view, request, _ = main_path
    with pytest.raises(RuntimeError, match="cuda"):
        evaluate_tiled(view, request, tile_size=256, batch=4, device="cuda")
    with port_config.set({"geomodeling.torch-device": "cuda"}):
        with pytest.raises(RuntimeError, match="cuda"):
            get_data(view, **request)
    # a Block's own get_data runs on the card unless asked for the CPU
    with pytest.raises(RuntimeError, match="cuda"):
        view.get_data(**request)
