"""The stencils view end to end: HillShade(Smooth(MovingMax(source, 3), 5))
of benchmarks/run.py, built by the JAX package and carried across.

A float32 EPSG:28992 source of 512^2 is requested whole in the same CRS,
in 128^2 tiles.  Each tile's stencils see only that tile's grown request,
so the numpy reference is the JAX package's numpy executor run tile by
tile.  Up to HillShade's input the port is bitwise; HillShade's float32
arctan2/sqrt/sin may round differently in the last bit, which moves a
uint8 cell by 1 at most (the bound tests/test_raster_spatial.py holds the
JAX twin to).
"""
from datetime import datetime

import numpy as np
import pytest
import torch

from dask_geomodeling_tpu import config
from dask_geomodeling_tpu.raster import HillShade, MemorySource, MovingMax, Smooth
from dask_geomodeling_tpu.runtime.tiles import evaluate_tiled as jax_evaluate_tiled
from dask_geomodeling_tpu_torch import evaluate_tiled, from_reference
from dask_geomodeling_tpu_torch.ops import cuda_stencils
from dask_geomodeling_tpu_torch.runtime import executor
from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests

PX = 512
TILE = 128


@pytest.fixture(scope="module")
def stencils():
    """(JAX view, port view, request)."""
    rng = np.random.RandomState(0)
    source = MemorySource(
        data=(rng.rand(1, PX, PX) * 200).astype(np.float32),
        no_data_value=float(np.finfo(np.float32).max),
        projection="EPSG:28992",
        pixel_size=1.0,
        pixel_origin=(135000.0, 456000.0),
        time_first=datetime(2000, 1, 1),
    )
    view = HillShade(Smooth(MovingMax(source, 3), 5))
    request = dict(
        mode="vals",
        bbox=(135000.0, 456000.0 - PX, 135000.0 + PX, 456000.0),
        projection="EPSG:28992",
        width=PX,
        height=PX,
        start=datetime(2000, 1, 1),
        stop=datetime(2000, 1, 2),
    )
    return view, from_reference(view.serialize()), request


def _numpy_tiled(view, request):
    """The JAX package's numpy executor, tile by tile, assembled."""
    tiles, nx = tile_requests(request, TILE)
    out = None
    with config.set({"geomodeling.executor": "numpy"}):
        for k, tile in enumerate(tiles):
            values = view.get_data(**tile)["values"]
            if out is None:
                out = np.empty((values.shape[0], request["height"], request["width"]), values.dtype)
            j, i = divmod(k, nx)
            row_end = request["height"] - j * TILE
            out[:, row_end - TILE : row_end, i * TILE : (i + 1) * TILE] = values
    return out


@pytest.mark.parametrize("batch", [4, 3])  # 3: the last batch is padded
def test_stencils_view_on_cpu(stencils, batch):
    jax_view, view, request = stencils
    before = executor.host_node_runs
    below = evaluate_tiled(view.store, request, tile_size=TILE, batch=batch, device="cpu")
    np.testing.assert_array_equal(below["values"], _numpy_tiled(jax_view.store, request))

    shaded = evaluate_tiled(view, request, tile_size=TILE, batch=batch, device="cpu")
    assert shaded["no_data_value"] == 256
    assert shaded["values"].dtype == np.uint8 and shaded["values"].shape == (1, PX, PX)
    expected = _numpy_tiled(jax_view, request)
    diff = np.abs(shaded["values"].astype(int) - expected.astype(int))
    assert diff.max() <= 1
    assert np.count_nonzero(diff) / diff.size <= 1e-3
    assert executor.host_node_runs == before
    assert len(np.unique(shaded["values"])) > 100  # shaded, not fill


def test_stencils_view_against_jax_tiles(stencils):
    jax_view, view, request = stencils
    port = evaluate_tiled(view, request, tile_size=TILE, batch=4, device="cpu")
    jax_result = jax_evaluate_tiled(jax_view, request, tile_size=TILE, batch=4)
    diff = np.abs(port["values"].astype(int) - np.asarray(jax_result["values"]).astype(int))
    assert diff.max() <= 1


@pytest.mark.cuda
def test_stencils_view_on_card_equals_cpu(stencils):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, view, request = stencils
    cpu_below = evaluate_tiled(view.store, request, tile_size=TILE, batch=4, device="cpu")
    cpu = evaluate_tiled(view, request, tile_size=TILE, batch=4, device="cpu")
    cuda_stencils.reset_launches()
    card_below = evaluate_tiled(view.store, request, tile_size=TILE, batch=4, device="cuda")
    assert cuda_stencils.moving_max_launches == 4 and cuda_stencils.fused_launches == 4
    np.testing.assert_array_equal(card_below["values"], cpu_below["values"])
    card = evaluate_tiled(view, request, tile_size=TILE, batch=4, device="cuda")
    diff = np.abs(card["values"].astype(int) - cpu["values"].astype(int))
    assert diff.max() <= 1
