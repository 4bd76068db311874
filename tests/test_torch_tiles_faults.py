"""The tile runtime's repaired faults, each held on the CPU to the port's
``compute_host`` (and, where it answers, the JAX package's numpy
executor):

- an empty time window over a tiled request answers None;
- tiles whose plans differ in structure (Place: a tile no placement
  reaches plans its source as a time request) raise NotLowerable, and
  ``get_data`` then runs the whole request through ``compute_torch`` on
  the same device, bitwise to ``compute_host``;
- a static literal that differs between tiles runs each tile with its own
  literal (tiles are batched by their static literals), and a twin that
  cannot serve one tile's literals sends the request to the fallback;
- the last batch runs at its own size, with no padding.
"""
from datetime import datetime

import numpy as np
import pytest
import torch

from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu import raster as R
from dask_geomodeling_tpu_torch import compute_host, evaluate_tiled, from_reference, get_data
from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.raster import BaseSingle, MemorySource, Place
from dask_geomodeling_tpu_torch.registry import register
from dask_geomodeling_tpu_torch.runtime import executor, tiles
from dask_geomodeling_tpu_torch.runtime.tiles import NotLowerable, TileProgram

ORIGIN = (135000.0, 456000.0)


def _store(px, seed=0):
    data = (np.random.RandomState(seed).rand(1, px, px) * 200).astype(np.float32)
    return MemorySource(data=data, no_data_value=float(np.finfo(np.float32).max),
                        projection="EPSG:28992", pixel_size=1.0, pixel_origin=ORIGIN,
                        time_first=datetime(2000, 1, 1))


def _request(px, **extra):
    x0, y0 = ORIGIN
    return dict(mode="vals", bbox=(x0, y0 - px, x0 + px, y0), projection="EPSG:28992",
                width=px, height=px, start=datetime(2000, 1, 1), **extra)


def _assert_bitwise(actual, expected):
    assert actual["no_data_value"] == expected["no_data_value"]
    assert actual["values"].dtype == expected["values"].dtype
    np.testing.assert_array_equal(actual["values"], expected["values"])


def test_empty_time_window_answers_none():
    """Add(source, 1.0) at 1024^2 with start and stop in 2001, outside the
    source's one frame: None through get_data (tiled), as compute_torch
    answers at 256^2 and both of the JAX package's executors answer."""
    data = (np.random.RandomState(0).rand(1, 1024, 1024) * 200).astype(np.float32)
    jax_source = R.MemorySource(data=data, no_data_value=float(np.finfo(np.float32).max),
                                projection="EPSG:28992", pixel_size=1.0, pixel_origin=ORIGIN,
                                time_first=datetime(2000, 1, 1))
    jax_view = R.Add(jax_source, 1.0)
    view = from_reference(jax_view.serialize())
    window = dict(start=datetime(2001, 1, 1), stop=datetime(2001, 1, 2))
    request = dict(_request(1024), **window)
    with jax_config.set({"geomodeling.executor": "numpy"}):
        assert jax_view.get_data(**request) is None
    assert compute_host(*view.get_compute_graph(**request)) is None
    assert view.get_data(device="cpu", **request) is None
    assert get_data(view, device="cpu", **dict(_request(256), **window)) is None
    assert evaluate_tiled(view, request, tile_size=256, batch=3, device="cpu") is None


@pytest.fixture
def fallback_devices(monkeypatch):
    """The devices get_data's fallback passes to compute_torch."""
    seen = []
    original = executor.compute_torch

    def spy(graph, name, device=None):
        seen.append(device)
        return original(graph, name, device=device)

    monkeypatch.setattr(executor, "compute_torch", spy)
    return seen


def test_place_two_placements_falls_back(fallback_devices):
    """Place with two placements over its own 256^2 store (anchor at the
    store's centre, coordinates 64 m and 192 m right of and below its
    top-left corner, maximum), in 64^2 tiles: the tiles plan differently,
    and the whole request runs on the same device, bitwise."""
    x0, y0 = ORIGIN
    store = _store(256)
    view = Place(store, "EPSG:28992", anchor=[x0 + 128.0, y0 - 128.0],
                 coordinates=[[x0 + 64.0, y0 - 64.0], [x0 + 192.0, y0 - 192.0]],
                 statistic="max")
    request = _request(256)
    with pytest.raises(NotLowerable):
        evaluate_tiled(view, request, tile_size=64, batch=4, device="cpu")
    with config.set({"geomodeling.tile-size": 64}):
        actual = view.get_data(device="cpu", **request)
    assert fallback_devices == ["cpu"]
    _assert_bitwise(actual, compute_host(*view.get_compute_graph(**request)))


def test_place_in_one_tile_falls_back(fallback_devices):
    """A 128^2 store placed once in the south-west quarter of a 256^2
    request, in 64^2 tiles: the tiles it misses plan the store as a time
    request (the structure differs, so no tile is staged wrongly)."""
    x0, y0 = ORIGIN
    store = _store(128, seed=1)
    view = Place(store, "EPSG:28992", anchor=[x0 + 64.0, y0 - 64.0],
                 coordinates=[[x0 + 64.0, y0 - 192.0]], statistic="max")
    request = _request(256)
    with pytest.raises(NotLowerable, match="structure"):
        evaluate_tiled(view, request, tile_size=64, batch=4, device="cpu")
    with config.set({"geomodeling.tile-size": 64}):
        actual = view.get_data(device="cpu", **request)
    assert fallback_devices == ["cpu"]
    expected = compute_host(*view.get_compute_graph(**request))
    _assert_bitwise(actual, expected)
    assert (expected["values"][0, 128:, :128] != expected["no_data_value"]).all()
    assert (expected["values"][0, :128] == expected["no_data_value"]).all()


# --- a static literal that differs from tile to tile ---


def _offset_process(data, offset):
    """Adds the request's west edge over 100 m, floored: a constant of
    the tile, not named in torch_dynamic."""
    if data is None or "values" not in data:
        return data
    keep = data["values"] == data["no_data_value"]
    values = np.where(keep, data["values"], data["values"] + np.float32(offset["value"]))
    return {"values": values, "no_data_value": data["no_data_value"]}


def _offset_torch(data, offset):
    if data is None or "values" not in data:
        return data
    values = data["values"]
    keep = values == data["no_data_value"]
    return {"values": torch.where(keep, values, values + np.float32(offset["value"])),
            "no_data_value": data["no_data_value"]}


def _offset_capable(data, offset):
    return offset["value"] < offset["capable_below"]


class Offset(BaseSingle):
    """Adds a constant that depends on the request's west edge; the twin
    serves only constants below ``capable_below``."""

    def __init__(self, store, capable_below=1e12):
        super().__init__(store, capable_below)

    def get_sources_and_requests(self, **request):
        west = request["bbox"][0]
        offset = {"value": float(np.floor((west - ORIGIN[0]) / 100.0)),
                  "capable_below": self.args[1]}
        return [(self.store, request), (offset, None)]

    process = staticmethod(_offset_process)


register(_offset_process, _offset_torch, capable=_offset_capable)


def test_static_literal_differs_between_tiles():
    """Each 64^2 tile of a 256^2 request adds its own constant (0, 0, 1
    and 1 across a row): the tiled run equals compute_host tile by tile,
    and get_data runs it so."""
    view = Offset(_store(256, seed=2))
    request = _request(256)
    before = tiles.batches_run
    actual = evaluate_tiled(view, request, tile_size=64, batch=16, device="cpu")
    assert tiles.batches_run - before == 2  # two literals, two batches
    for k, tile in enumerate(tiles.tile_requests(request, 64)[0]):
        j, i = divmod(k, 4)
        rows = slice(256 - 64 * (j + 1), 256 - 64 * j)
        cols = slice(64 * i, 64 * (i + 1))
        np.testing.assert_array_equal(
            actual["values"][:, rows, cols],
            compute_host(*view.get_compute_graph(**tile))["values"],
        )
    with config.set({"geomodeling.tile-size": 64}):
        _assert_bitwise(view.get_data(device="cpu", **request), actual)


def test_capability_checked_in_every_tile(fallback_devices):
    """The twin serves the template tile (west) but not the tiles 100 m
    east and more: evaluate_tiled raises NotLowerable, and get_data serves
    the whole request (whose west edge the twin serves) on the same
    device."""
    view = Offset(_store(256, seed=3), capable_below=1.0)
    request = _request(256)
    program = TileProgram(view, tiles.tile_requests(request, 64)[0][0], torch.device("cpu"))
    assert not any(program.on_host)
    with pytest.raises(NotLowerable, match="every tile"):
        evaluate_tiled(view, request, tile_size=64, batch=16, device="cpu")
    with config.set({"geomodeling.tile-size": 64}):
        actual = view.get_data(device="cpu", **request)
    assert fallback_devices == ["cpu"]
    _assert_bitwise(actual, compute_host(*view.get_compute_graph(**request)))


def test_last_batch_is_not_padded(monkeypatch):
    """9 tiles in batches of 4 run as 4, 4 and 1, and copy as much."""
    sizes = []
    original = TileProgram.run

    def run(self, plans):
        result = original(self, plans)
        sizes.append((len(plans), result.shape[0]))
        return result

    monkeypatch.setattr(TileProgram, "run", run)
    view = _add_one(_store(192, seed=4))
    request = _request(192)
    actual = evaluate_tiled(view, request, tile_size=64, batch=4, device="cpu")
    assert sizes == [(4, 4), (4, 4), (1, 1)]
    _assert_bitwise(actual, compute_host(*view.get_compute_graph(**request)))


def _add_one(store):
    from dask_geomodeling_tpu_torch.raster import Add

    return Add(store, 1.0)
