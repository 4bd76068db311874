"""The port's executor=auto router (runtime/router.py) against the JAX
package's.

Every case of tests/test_router.py, carried across: the JAX route "jax"
is the port's "torch", and the card's route runs on
``geomodeling.torch-device`` "cpu" here (the tile runtime, else
``compute_torch``).  Then the port's own rules: "auto" with CUDA asked
for and absent raises; a device exception propagates and is not served
from the host; the default executor ("torch") never reaches the host
route; the port's state file is not the JAX package's; and both routers
make the same choices on the same seeded sequences of measurements.
The JAX package's host-only pin (a failed card run routes its key to the
host for good) is not ported: its two cases become the port's rule that
a failed card run measures and pins nothing, and that a saved pin is not
read back.
"""
from datetime import datetime

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu.runtime import router as jax_router
from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.core.scheduler import get_sync
from dask_geomodeling_tpu_torch.raster import Add, MemorySource
from dask_geomodeling_tpu_torch.runtime import host, router


@pytest.fixture(autouse=True)
def clean_router():
    """No state file (tests/conftest.py nulls only the JAX package's),
    the card's route on the CPU, and an empty table around each test."""
    with config.set({"geomodeling.router-state": None, "geomodeling.torch-device": "cpu"}):
        router.reset()
        yield
        router.reset()


@pytest.fixture
def big_source():
    rng = np.random.RandomState(0)
    return MemorySource(
        data=(rng.rand(1, 320, 320) * 200).astype(np.float32),
        no_data_value=float(np.finfo(np.float32).max),
        projection="EPSG:28992",
        pixel_size=1.0,
        pixel_origin=(135000.0, 456000.0),
        time_first=datetime(2000, 1, 1),
    )


def big_request(px=320):
    return dict(
        mode="vals",
        bbox=(135000.0, 456000.0 - px, 135000.0 + px, 456000.0),
        projection="EPSG:28992",
        width=px,
        height=px,
        start=datetime(2000, 1, 1),
    )


class TestChoose:
    def test_ineligible_is_host(self, big_source):
        request = big_request()
        assert router.choose(big_source, request, eligible=False) == "numpy"

    def test_first_call_is_host(self, big_source):
        assert router.choose(big_source, big_request(), True) == "numpy"

    def test_explores_device_after_host_measurement(self, big_source):
        request = big_request()
        router.record(big_source, request, "numpy", 0.01)
        assert router.choose(big_source, request, True) == "torch"

    def test_first_device_run_is_compile_tainted(self, big_source):
        request = big_request()
        router.record(big_source, request, "numpy", 0.01)
        router.record(big_source, request, "torch", 60.0)  # warm-up run
        assert router.choose(big_source, request, True) == "torch"
        router.record(big_source, request, "torch", 0.001)  # warm run
        assert router.choose(big_source, request, True) == "torch"

    def test_close_call_stays_on_host(self, big_source):
        request = big_request()
        router.record(big_source, request, "numpy", 0.0100)
        router.record(big_source, request, "torch", 1.0)  # warm-up
        router.record(big_source, request, "torch", 0.0095)  # ~5% faster
        assert router.choose(big_source, request, True) == "torch"  # 2nd chance
        router.record(big_source, request, "torch", 0.0095)
        assert router.choose(big_source, request, True) == "numpy"
        with config.set({"geomodeling.auto-margin": 1.0}):
            assert router.choose(big_source, request, True) == "torch"

    def test_winner_by_measured_rate(self, big_source):
        request = big_request()
        router.record(big_source, request, "numpy", 0.001)  # fast host
        router.record(big_source, request, "torch", 1.0)
        router.record(big_source, request, "torch", 1.0)  # slow card
        assert router.choose(big_source, request, True) == "numpy"

    def test_lowering_failure_pins_host(self, big_source):
        """The port's counterpart: a card run that raises measures
        nothing and pins nothing, so the card is still explored."""
        request = big_request()
        router.record(big_source, request, "numpy", 0.01)
        with pytest.raises(RuntimeError):
            with router.timed_route(big_source, request, "torch"):
                raise RuntimeError("lowering failed")
        assert router.choose(big_source, request, True) == "torch"
        state = router.state_of(big_source, request)
        assert state["torch_runs"] == 0 and state["torch"] is None
        assert "host_only" not in state

    def test_size_buckets_are_independent(self, big_source):
        small = big_request(64)
        big = big_request(320)
        router.record(big_source, big, "numpy", 0.01)
        assert router.choose(big_source, small, True) == "numpy"
        assert router.choose(big_source, big, True) == "torch"

    def test_ema_adapts(self, big_source):
        request = big_request()
        router.record(big_source, request, "numpy", 1.0)
        for _ in range(3):
            router.record(big_source, request, "torch", 1.0)
        for _ in range(10):
            router.record(big_source, request, "numpy", 0.01)
        assert router.choose(big_source, request, True) == "numpy"


class TestGetDataIntegration:
    def test_auto_explores_then_settles(self, big_source, monkeypatch):
        """Full get_data flow: host first, the card twice, then the winner."""
        from dask_geomodeling_tpu_torch.runtime import tiles

        calls = []
        real = tiles.evaluate_tiled

        def spy(view, request, tile_size=512, batch=None, device=None):
            calls.append("torch")
            return real(view, request, tile_size=tile_size, batch=batch, device=device)

        monkeypatch.setattr(tiles, "evaluate_tiled", spy)
        view = Add(big_source, 1.0)
        request = big_request()
        with config.set({
            "geomodeling.executor": "auto",
            "geomodeling.auto-min-device-px": 1024,
            "geomodeling.tile-size": 128,
        }):
            results = [view.get_data(**request) for _ in range(5)]
        assert 2 <= len(calls) <= 5
        reference = results[0]["values"]
        for result in results[1:]:
            np.testing.assert_array_equal(result["values"], reference)

    def test_auto_small_requests_never_touch_device(self, big_source, monkeypatch):
        from dask_geomodeling_tpu_torch.runtime import executor, tiles

        def boom(*args, **kwargs):
            raise AssertionError("device path must not run")

        monkeypatch.setattr(tiles, "evaluate_tiled", boom)
        monkeypatch.setattr(executor, "compute_torch", boom)
        view = Add(big_source, 1.0)
        request = big_request(32)
        with config.set({"geomodeling.executor": "auto"}):
            for _ in range(4):
                view.get_data(**request)

    def test_auto_non_tileable_view_uses_staged_executor(self, big_source, monkeypatch):
        """A view the tile runtime cannot run still gets a measured card
        route, through compute_torch."""
        from dask_geomodeling_tpu_torch.runtime import tiles

        calls = []

        def failing(view, request, tile_size=512, batch=None, device=None):
            calls.append("try")
            raise tiles.NotLowerable("host-only node")

        monkeypatch.setattr(tiles, "evaluate_tiled", failing)
        view = Add(big_source, 1.0)
        request = big_request()
        with config.set({
            "geomodeling.executor": "auto",
            "geomodeling.auto-min-device-px": 1024,
            "geomodeling.tile-size": 128,
        }):
            with config.set({"geomodeling.executor": "numpy"}):
                expected = view.get_data(**request)
            results = [view.get_data(**request) for _ in range(4)]
        assert calls
        assert any(s["torch_runs"] > 0 for s in router.stats().values())
        for result in results:
            np.testing.assert_array_equal(result["values"], expected["values"])

    def test_concurrent_auto_requests_consistent(self, big_source):
        from concurrent.futures import ThreadPoolExecutor

        view = Add(big_source, 1.0)
        request = big_request()
        with config.set({
            "geomodeling.executor": "auto",
            "geomodeling.auto-min-device-px": 1024,
            "geomodeling.tile-size": 128,
        }):
            expected = view.get_data(**request)["values"]
            with ThreadPoolExecutor(max_workers=6) as pool:
                results = list(pool.map(lambda _: view.get_data(**request)["values"], range(18)))
        for result in results:
            np.testing.assert_array_equal(result, expected)
        state = router.stats()[router._key(view, request)]
        assert state["numpy"] is not None

    def test_numpy_executor_untouched(self, big_source, monkeypatch):
        from dask_geomodeling_tpu_torch.runtime import executor, tiles

        def boom(*args, **kwargs):
            raise AssertionError("device path must not run")

        monkeypatch.setattr(tiles, "evaluate_tiled", boom)
        monkeypatch.setattr(executor, "compute_torch", boom)
        view = Add(big_source, 1.0)
        with config.set({"geomodeling.executor": "numpy"}):
            for _ in range(3):
                view.get_data(**big_request())


class TestPersistence:
    """Router state survives process restarts via geomodeling.router-state."""

    def _measure(self, source, request, torch_rate):
        router.record(source, request, "numpy", 0.1)  # 1.024 Mpx/s
        router.record(source, request, "torch", 1.0)  # warm-up (ignored)
        elapsed = (request["width"] * request["height"]) / 1e6 / torch_rate
        router.record(source, request, "torch", elapsed)

    def test_save_load_roundtrip(self, big_source, tmp_path):
        path = str(tmp_path / "routes.json")
        request = big_request()
        self._measure(big_source, request, torch_rate=50.0)
        assert router.choose(big_source, request, True) == "torch"
        router.save(path)

        router.reset()
        assert router.choose(big_source, request, True) == "numpy"

        router.reset()
        with config.set({"geomodeling.router-state": path}):
            assert router.choose(big_source, request, True) == "torch"
            st_ = router.stats()
        assert any(v["torch_runs"] >= 2 for v in st_.values())

    def test_autosave_after_enough_measurements(self, big_source, tmp_path):
        import os

        path = str(tmp_path / "routes.json")
        request = big_request()
        with config.set({"geomodeling.router-state": path}):
            for _ in range(router._SAVE_EVERY + 2):
                router.record(big_source, request, "numpy", 0.1)
        assert os.path.exists(path)

    def test_corrupt_state_file_is_ignored(self, big_source, tmp_path):
        path = str(tmp_path / "routes.json")
        with open(path, "w") as f:
            f.write("{not json")
        with config.set({"geomodeling.router-state": path}):
            assert router.choose(big_source, big_request(), True) == "numpy"

    def test_loaded_host_only_pin_survives(self, big_source, tmp_path):
        """The port's counterpart: a state file holding the JAX package's
        host-only pin loads its rates, and the pin is not read back."""
        import json

        path = str(tmp_path / "routes.json")
        request = big_request()
        router.record(big_source, request, "numpy", 0.1)
        router.save(path)
        with open(path) as f:
            saved = json.load(f)
        for state in saved.values():
            state["host_only"] = True
        with open(path, "w") as f:
            json.dump(saved, f)
        router.reset()
        with config.set({"geomodeling.router-state": path}):
            assert router.choose(big_source, request, True) == "torch"
            st_ = router.stats()
        assert all("host_only" not in v for v in st_.values())
        assert any(v["numpy"] is not None for v in st_.values())

    def test_reset_default_reseeds_from_state_file(self, big_source, tmp_path):
        path = str(tmp_path / "routes.json")
        request = big_request()
        with config.set({"geomodeling.router-state": path}):
            self._measure(big_source, request, torch_rate=50.0)
            router.save()
            assert router.choose(big_source, request, True) == "torch"
            router.reset()
            assert router.choose(big_source, request, True) == "torch"
            router.reset(reseed=False)
            assert router.choose(big_source, request, True) == "numpy"

    def test_reset_reseed_restores_routes(self, big_source, tmp_path):
        path = str(tmp_path / "routes.json")
        request = big_request()
        with config.set({"geomodeling.router-state": path}):
            self._measure(big_source, request, torch_rate=50.0)
            router.save()
            router.reset(reseed=True)
            assert router.choose(big_source, request, True) == "torch"
            assert any(v["torch_runs"] >= 2 for v in router.stats().values())

    def test_reset_reseed_without_state_file_is_plain_reset(self, big_source):
        request = big_request()
        self._measure(big_source, request, torch_rate=50.0)
        router.reset(reseed=True)
        assert router.choose(big_source, request, True) == "numpy"


class TestRefreshProbe:
    def test_host_pinned_key_reprobes(self, big_source):
        request = big_request()
        router.record(big_source, request, "numpy", 0.01)
        router.record(big_source, request, "torch", 1.0)  # warm-up
        router.record(big_source, request, "torch", 0.1)  # clearly slower
        router.record(big_source, request, "torch", 0.1)  # 2nd chance: slow
        routes = [router.choose(big_source, request, True)
                  for _ in range(router._REFRESH_EVERY)]
        assert routes[:-1] == ["numpy"] * (router._REFRESH_EVERY - 1)
        assert routes[-1] == "torch"
        router.record(big_source, request, "torch", 0.0005)
        router.record(big_source, request, "torch", 0.0005)
        assert router.choose(big_source, request, True) == "torch"


# --- the port's own rules ---


def test_auto_with_cuda_and_no_card_raises(big_source):
    """Small or large, an "auto" request for the card raises where there
    is none: nothing quietly runs on the host in its place."""
    if torch.cuda.is_available():
        pytest.skip("the card is present")
    with config.set({"geomodeling.executor": "auto", "geomodeling.torch-device": "cuda"}):
        for px in (32, 320):
            with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
                Add(big_source, 1.0).get_data(**big_request(px))
    assert router.stats() == {}


def test_device_exception_propagates(big_source, monkeypatch):
    """A failure on the card's route raises to the caller: the request is
    not served from the host, and the key is not pinned to the host."""
    from dask_geomodeling_tpu_torch.runtime import tiles

    def failing(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    host_calls = []

    def counting_host(graph, keys):
        host_calls.append(1)
        return get_sync(graph, keys)

    monkeypatch.setattr(tiles, "evaluate_tiled", failing)
    view = Add(big_source, 1.0)
    request = big_request()
    with config.set({"geomodeling.executor": "auto", "geomodeling.auto-min-device-px": 1024,
                     "geomodeling.tile-size": 128, "scheduler": counting_host}):
        view.get_data(**request)  # the host's first measurement
        assert host_calls == [1]
        with pytest.raises(RuntimeError, match="illegal memory access"):
            view.get_data(**request)
        assert host_calls == [1]
    state = router.state_of(view, request)
    assert state["torch_runs"] == 0 and state["torch"] is None


@pytest.mark.parametrize("px", [32, 320])
def test_default_executor_never_reaches_the_host(big_source, monkeypatch, px):
    """With no geomodeling.executor set, get_data runs on the device (the
    tile runtime or compute_torch) and never reaches the host route (the
    scheduler compute() runs) nor compute_host, nor touches the router."""
    from dask_geomodeling_tpu_torch.runtime import tiles

    def boom(*args, **kwargs):
        raise AssertionError("the host route ran")

    monkeypatch.setattr(host, "compute_host", boom)
    runs = tiles.batches_run
    with config.set({"geomodeling.tile-size": 128, "scheduler": boom}):
        out = Add(big_source, 1.0).get_data(**big_request(px))
    assert out["values"].shape == (1, px, px)
    assert (tiles.batches_run > runs) == (px > 128)
    assert router.stats() == {}


def test_state_path_is_the_ports_own():
    import importlib

    port_path = importlib.import_module("dask_geomodeling_tpu_torch.config").defaults[
        "geomodeling.router-state"]
    jax_default = importlib.import_module("dask_geomodeling_tpu.config").defaults[
        "geomodeling.router-state"]
    assert port_path != jax_default
    assert jax_config.get("geomodeling.router-state", None) is None  # conftest nulls it
    assert port_path.endswith("router-state.json")
    assert "dask_geomodeling_tpu_torch" in port_path.split("/")


def test_route_of_changes_nothing(big_source):
    """route_of answers what choose would, with no entry made, no LRU
    move and no host route counted towards the refresh probe."""
    request = big_request()
    assert router.route_of(big_source, request) == "numpy"
    assert router.stats() == {}
    router.record(big_source, request, "numpy", 0.01)
    router.record(big_source, request, "torch", 1.0)  # warm-up
    router.record(big_source, request, "torch", 0.1)
    router.record(big_source, request, "torch", 0.1)  # a clear loser
    for _ in range(router._REFRESH_EVERY * 2):
        assert router.route_of(big_source, request) == "numpy"
    assert router.state_of(big_source, request)["host_streak"] == 0
    assert router.route_of(big_source, request, eligible=False) == "numpy"
    assert router.state_of(big_source, big_request(64)) is None


class _View:
    def __init__(self, token):
        self.token = token


_STEP = st.one_of(
    st.tuples(st.just("numpy"), st.floats(1e-4, 1.0)),
    st.tuples(st.just("device"), st.floats(1e-4, 1.0)),
    st.tuples(st.just("choose"), st.booleans()),
)


@settings(max_examples=60, deadline=None)
@given(steps=st.lists(st.tuples(st.sampled_from([64, 300, 320]), _STEP), max_size=60),
       margin=st.sampled_from([1.0, 1.15, 2.0]))
def test_choices_follow_the_jax_router(steps, margin):
    """The same sequence of measurements and choices gives the same
    routes in both routers, case for case (the JAX "jax" is "torch")."""
    view = _View("seeded")
    router.reset(reseed=False)
    jax_router.reset(reseed=False)
    names = {"numpy": "numpy", "device": ("torch", "jax")}
    try:
        with config.set({"geomodeling.auto-margin": margin}), \
                jax_config.set({"geomodeling.auto-margin": margin}):
            for px, (kind, value) in steps:
                request = big_request(px)
                if kind == "choose":
                    before = router.stats()
                    peek = router.route_of(view, request, value)
                    assert router.stats() == before
                    port = router.choose(view, request, value)
                    assert peek == port
                    ref = jax_router.choose(view, request, value)
                    assert {"torch": "jax"}.get(port, port) == ref
                else:
                    port_name, jax_name = (("numpy", "numpy") if kind == "numpy"
                                           else names["device"])
                    router.record(view, request, port_name, value)
                    jax_router.record(view, request, jax_name, value)
        port_stats = router.stats()
        jax_stats = jax_router.stats()
        assert set(port_stats) == set(jax_stats)
        for key, state in port_stats.items():
            ref = jax_stats[key]
            assert (state["numpy"], state["torch"], state["torch_runs"]) == (
                ref["numpy"], ref["jax"], ref["jax_runs"])
            assert not ref["host_only"]
    finally:
        jax_router.reset(reseed=False)
