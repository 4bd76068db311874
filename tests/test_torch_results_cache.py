"""The port's cross-request result cache (runtime/results.py): every case
of tests/test_results_cache.py, carried across, and the device in the key.

The views come from the JAX package through ``from_reference`` and run on
the CPU (``geomodeling.torch-device`` "cpu"); answers are held to the JAX
package's numpy executor.  Where the JAX cases count calls of
MemorySource's process, these count the evaluations behind ``get_data``
(``raster/base.py:_get_data_uncached``): the port's twins are registered
on the process functions, which a patched ``process`` would bypass.  The
JAX cache serves one executor's answer to the other; the port keys a vals
request by its device as well, so a CPU answer is never handed to a
request for another device.
"""
import numpy as np
import pytest

from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu.raster import MemorySource as JaxMemorySource
from dask_geomodeling_tpu_torch import from_reference
from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.ipyleaflet_plugin import render_wms_tile
from dask_geomodeling_tpu_torch.raster import base
from dask_geomodeling_tpu_torch.runtime import results


@pytest.fixture(autouse=True)
def fresh_cache():
    results.clear()
    with config.set({"geomodeling.torch-device": "cpu"}):
        yield
    results.clear()


@pytest.fixture
def jax_source():
    return JaxMemorySource(
        data=np.arange(100, dtype="u1").reshape(1, 10, 10),
        no_data_value=255,
        projection="EPSG:28992",
        pixel_size=1.0,
        pixel_origin=(0, 10),
    )


@pytest.fixture
def source(jax_source):
    return from_reference(jax_source.serialize())


def request(**overrides):
    base_request = dict(
        mode="vals", bbox=(0, 0, 10, 10), projection="EPSG:28992",
        width=10, height=10,
    )
    base_request.update(overrides)
    return base_request


def counted(monkeypatch):
    calls = [0]
    original = base._get_data_uncached

    def wrapper(*args, **kwargs):
        calls[0] += 1
        return original(*args, **kwargs)

    monkeypatch.setattr(base, "_get_data_uncached", wrapper)
    return calls


def numpy_executor(view, **req):
    with jax_config.set({"geomodeling.executor": "numpy"}):
        return view.get_data(**req)


def test_hit_skips_recompute(monkeypatch, source, jax_source):
    calls = counted(monkeypatch)
    view = source + 1
    with config.set({"geomodeling.result-cache-size": 10**6}):
        first = view.get_data(**request())
        assert calls[0] == 1
        second = view.get_data(**request())
        assert calls[0] == 1  # served from cache
    np.testing.assert_array_equal(first["values"], second["values"])
    assert first["no_data_value"] == second["no_data_value"]
    expected = numpy_executor(jax_source + 1, **request())
    np.testing.assert_array_equal(second["values"], expected["values"])
    assert second["values"].dtype == expected["values"].dtype
    st = results.stats()
    assert st["hits"] == 1 and st["misses"] == 1 and st["entries"] == 1


def test_off_by_default(monkeypatch, source):
    calls = counted(monkeypatch)
    source.get_data(**request())
    source.get_data(**request())
    assert calls[0] == 2
    assert results.stats()["entries"] == 0


def test_distinct_requests_distinct_entries(source):
    with config.set({"geomodeling.result-cache-size": 10**6}):
        a = source.get_data(**request())
        b = source.get_data(**request(bbox=(0, 0, 5, 5), width=5, height=5))
    assert a["values"].shape != b["values"].shape
    assert results.stats()["entries"] == 2


def test_miss_mutable_hit_frozen(source):
    with config.set({"geomodeling.result-cache-size": 10**6}):
        first = source.get_data(**request())
        first["values"][0, 0, 0] = 42  # fine: the caller owns a miss
        second = source.get_data(**request())
        assert second["values"][0, 0, 0] == 0
        with pytest.raises((ValueError, RuntimeError)):
            second["values"][0, 0, 0] = 42
        third = source.get_data(**request())
    np.testing.assert_array_equal(third["values"][0].ravel(), np.arange(100))


class _TokenStub:
    token = "results-container-roundtrip"


def _unreachable():
    raise AssertionError("hit path must not recompute")


def test_container_types_roundtrip():
    response = {"time": [1, 2], "bands": (3, 4), "no_data_value": None}
    out_miss = results.get_or_compute(_TokenStub(), {"mode": "time"}, lambda: response, 10**6)
    assert out_miss is response
    out_hit = results.get_or_compute(_TokenStub(), {"mode": "time"}, _unreachable, 10**6)
    assert out_hit == response
    assert isinstance(out_hit["time"], list)
    assert isinstance(out_hit["bands"], tuple)


def test_eviction_under_budget(source):
    with config.set({"geomodeling.result-cache-size": 800}):
        for i in range(1, 9):
            source.get_data(**request(bbox=(0, 0, i, i), width=i, height=i))
    st = results.stats()
    assert st["evictions"] > 0
    assert st["bytes"] <= 800


def test_time_and_meta_modes_cached(monkeypatch, source, jax_source):
    calls = counted(monkeypatch)
    with config.set({"geomodeling.result-cache-size": 10**6}):
        t1 = source.get_data(mode="time", start=None, stop=None)
        t2 = source.get_data(mode="time", start=None, stop=None)
        assert calls[0] == 1
        m1 = source.get_data(mode="meta", start=None, stop=None)
        m2 = source.get_data(mode="meta", start=None, stop=None)
        assert calls[0] == 2
    assert t1 == t2 == numpy_executor(jax_source, mode="time", start=None, stop=None)
    assert isinstance(t2["time"], list)
    assert m1 == m2


def test_clear(source):
    with config.set({"geomodeling.result-cache-size": 10**6}):
        source.get_data(**request())
        assert results.stats()["entries"] == 1
        results.clear()
        assert results.stats()["entries"] == 0
        assert results.stats()["bytes"] == 0


def test_wms_serving_reuse(monkeypatch, source):
    calls = counted(monkeypatch)
    params = {
        "layers": source.to_json(), "srs": "EPSG:28992",
        "bbox": "0,0,10,10", "width": "64", "height": "64",
        "vmax": "100",
    }
    with config.set({"geomodeling.result-cache-size": 10**6}):
        first = render_wms_tile(params)
        second = render_wms_tile(params)
    assert first == second
    assert calls[0] == 1


def test_device_spellings_share_entries(source, jax_source):
    """test_executors_share_semantics: one device, however it is named
    (the configured default, "cpu", a torch.device), is one key; the
    answer is the JAX numpy executor's."""
    import torch

    view = source * 2
    with config.set({"geomodeling.result-cache-size": 10**6}):
        a = view.get_data(**request())
        b = view.get_data(device="cpu", **request())
        c = view.get_data(device=torch.device("cpu"), **request())
    np.testing.assert_array_equal(a["values"], b["values"])
    np.testing.assert_array_equal(c["values"],
                                  numpy_executor(jax_source * 2, **request())["values"])
    st = results.stats()
    assert st["misses"] == 1 and st["hits"] == 2 and st["entries"] == 1


def test_the_device_is_part_of_the_key(monkeypatch, source):
    """A vals answer computed for one device is never handed to a request
    for another; a time or meta answer, computed on the host, is shared."""
    seen = []

    def fake(view, device, req):
        seen.append(str(device))
        if req["mode"] == "time":
            return {"time": ["t"]}
        return {"values": np.full((1, 2, 2), len(seen), "u1"), "no_data_value": 255}

    monkeypatch.setattr(base, "_get_data_uncached", fake)
    with config.set({"geomodeling.result-cache-size": 10**6}):
        on_cpu = source.get_data(device="cpu", **request())
        on_meta = source.get_data(device="meta", **request())
        again = source.get_data(device="cpu", **request())
        times = [source.get_data(device=d, mode="time") for d in ("cpu", "meta")]
    assert seen == ["cpu", "meta", "cpu"]  # the time request ran once
    assert on_cpu["values"][0, 0, 0] == 1 and on_meta["values"][0, 0, 0] == 2
    assert again["values"][0, 0, 0] == 1
    assert times[0] == times[1] == {"time": ["t"]}
    st = results.stats()
    assert st["misses"] == 3 and st["hits"] == 2 and st["entries"] == 3


def test_a_missing_device_raises_before_the_cache(source):
    """A request for a device that is absent raises with the cache on as
    it does with it off, and leaves no entry."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with config.set({"geomodeling.result-cache-size": 10**6}):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            source.get_data(device="cuda", **request())
    assert results.stats()["entries"] == 0
