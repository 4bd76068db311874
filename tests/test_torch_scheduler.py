"""The port's host schedulers, disk spill, ``compute``, profiler and
status snapshot.

- ``get_sync``, ``get_threaded`` and ``get_processes`` (core/scheduler.py)
  give ``compute_host``'s answers bitwise, and ``compute`` runs them under
  ``geomodeling.executor`` "numpy" and the torch executor under "torch";
- the pooled schedulers spill under ``geomodeling.scheduler-memory-limit``
  (parallel/spill.py) and still answer bitwise;
- every case of tests/test_profile.py, carried across: the JAX package's
  default route for these small requests is the host, which the port
  takes under "auto"; its "jax" executor is the port's "torch" on the
  CPU; ``torch_trace`` writes a Chrome trace on the CPU;
- ``status.snapshot()`` is JSON-serialisable.
"""
import io
import json
from datetime import datetime, timedelta

import numpy as np
import pytest

import chip_smoke
from dask_geomodeling_tpu_torch import compute_host
from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.core import compute
from dask_geomodeling_tpu_torch.core import scheduler
from dask_geomodeling_tpu_torch.parallel.spill import SpillBuffer
from dask_geomodeling_tpu_torch.raster import Add, MemorySource, Multiply
from dask_geomodeling_tpu_torch.runtime.profile import (
    Profiler,
    ProgressBar,
    active_profiler,
    torch_trace,
)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The device route on the CPU, no router state file."""
    with config.set({"geomodeling.torch-device": "cpu", "geomodeling.router-state": None}):
        yield


@pytest.fixture
def source():
    return MemorySource(
        data=np.arange(100, dtype=np.uint8).reshape(1, 10, 10),
        no_data_value=255,
        projection="EPSG:28992",
        pixel_size=0.5,
        pixel_origin=(135000, 456000),
        time_first=datetime(2000, 1, 1),
        time_delta=timedelta(hours=1),
    )


@pytest.fixture
def request_full():
    return {
        "mode": "vals",
        "start": datetime(2000, 1, 1),
        "width": 10,
        "height": 10,
        "bbox": (135000, 455995, 135005, 456000),
        "projection": "EPSG:28992",
    }


# --- the schedulers against compute_host ---


def _views():
    """A few seeded views of the port: chip_smoke's stencils view, and
    executor-fuzz trees (wide ones, so the pools run branches at once)."""
    _, stencils = chip_smoke.build_stencils_view(64)
    views = [(stencils, chip_smoke.vals_request(64))]
    sources = chip_smoke.fuzz_sources()
    for seed in (1, 7, 12, 45):
        views.append(chip_smoke.fuzz_view(seed, sources))
    return views


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for key in a:
            _same(a[key], b[key])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b or (a != a and b != b)


@pytest.mark.parametrize("name", ["sync", "threads", "processes"])
def test_schedulers_give_compute_hosts_answers(name):
    for view, request in _views()[: 2 if name == "processes" else None]:
        graph, key = view.get_compute_graph(**request)
        expected = compute_host(graph, key)
        kwargs = {"num_workers": 2} if name == "processes" else {}
        (got,) = scheduler.get_scheduler(name)(graph, [key], **kwargs)
        _same(got, expected)


@pytest.mark.parametrize("executor", ["numpy", "torch"])
def test_compute_follows_the_executor(executor, monkeypatch):
    from dask_geomodeling_tpu_torch.runtime import executor as torch_executor

    view, request = _views()[0]
    graph, key = view.get_compute_graph(**request)
    calls = []
    real = torch_executor.compute_torch
    monkeypatch.setattr(torch_executor, "compute_torch",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with config.set({"geomodeling.executor": executor, "scheduler": "threads"}):
        got = compute(graph, key)
    assert calls == ([1] if executor == "torch" else [])
    expected = compute_host(graph, key)
    if executor == "numpy":
        _same(got, expected)
    else:  # HillShade's float32 transcendentals: within 1
        assert np.abs(got["values"].astype(int) - expected["values"].astype(int)).max() <= 1


@pytest.mark.parametrize("executor", ["numpy", "auto"])
def test_get_data_host_routes_run_the_configured_scheduler(executor):
    """get_data's host route (the "numpy" executor, and "auto" on its
    first, host-measured request) runs under the configured scheduler,
    through compute, and answers as compute_host does, bitwise."""
    from dask_geomodeling_tpu_torch.runtime import router

    calls = []

    def counting(graph, keys):
        calls.append(len(keys))
        return scheduler.get_threaded(graph, keys, num_workers=2)

    for view, request in _views():
        del calls[:]
        router.reset(reseed=False)
        with config.set({"geomodeling.executor": executor, "scheduler": counting,
                         "geomodeling.router-state": None, "geomodeling.torch-device": "cpu"}):
            got = view.get_data(**request)
        assert calls == [1]
        _same(got, compute_host(*view.get_compute_graph(**request)))
    router.reset(reseed=False)


def test_get_scheduler_names():
    assert scheduler.get_scheduler() is scheduler.get_sync
    assert scheduler.get_scheduler("threads") is scheduler.get_threaded
    assert scheduler.get_scheduler(scheduler.get_sync) is scheduler.get_sync
    with config.set({"scheduler": "processes"}):
        assert scheduler.get_scheduler() is scheduler.get_processes
    with pytest.raises(ValueError, match="Unknown scheduler"):
        scheduler.get_scheduler("sideways")


def test_sync_hands_the_failing_key_to_pack_exception():
    """``pack_exception`` finds the key being evaluated one frame up, as
    the reference's construct error callback reads it."""
    import sys

    def fail(x):
        raise ValueError("bad input")

    def prefix_key(e, dumps):
        e.args = ("%s: %s" % (sys._getframe(1).f_locals.get("key"), e),)
        raise e

    graph = {"a": 1, "b": (fail, "a")}
    with pytest.raises(ValueError, match="^b: bad input$"):
        scheduler.get_sync(graph, ["b"], pack_exception=prefix_key)


# --- the spill ---


def test_spill_buffer_roundtrip(tmp_path):
    buf = SpillBuffer(1000, directory=str(tmp_path))
    arrays = {k: np.full(100, k, dtype=np.float64) for k in range(5)}  # 800 B each
    for key, value in arrays.items():
        buf[key] = value
    assert buf.n_spilled >= 3
    assert len(buf) == 5 and all(k in buf for k in arrays)
    for key, value in arrays.items():
        np.testing.assert_array_equal(buf[key], value)
    assert buf.n_restored >= 3
    np.testing.assert_array_equal(buf.pop(2), arrays[2])
    assert 2 not in buf and buf.pop(2, "gone") == "gone"
    buf.close()
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("name", ["threads", "processes"])
def test_pooled_schedulers_spill_under_a_memory_limit(name, monkeypatch):
    """A limit below one intermediate forces every result through the
    disk; the answers stay compute_host's, bitwise."""
    made = []
    real = scheduler._make_result_cache

    def tracking():
        cache = real()
        made.append(cache)
        return cache

    monkeypatch.setattr(scheduler, "_make_result_cache", tracking)
    view, request = _views()[0]
    graph, key = view.get_compute_graph(**request)
    with config.set({"geomodeling.scheduler-memory-limit": 1024}):
        kwargs = {"num_workers": 2} if name == "processes" else {}
        (got,) = scheduler.get_scheduler(name)(graph, [key], **kwargs)
    _same(got, compute_host(graph, key))
    (cache,) = made
    assert isinstance(cache, SpillBuffer)
    assert cache.n_spilled > 0


def test_no_limit_keeps_a_plain_dict():
    assert scheduler._make_result_cache() == {}


# --- tests/test_profile.py, carried across ---


def test_records_host_tasks(source, request_full):
    view = Multiply(Add(source, 10), 2)
    with config.set({"geomodeling.executor": "auto"}):
        with Profiler() as prof:
            view.get_data(**request_full)
    names = {e["name"] for e in prof.events}
    assert any("add" in n for n in names)
    assert any("multiply" in n for n in names)
    assert all(e["duration"] >= 0 for e in prof.events)
    assert prof.total > 0


def test_records_executor_phases(source, request_full):
    view = Add(source, 10)
    with config.set({"geomodeling.executor": "torch"}):
        with Profiler() as prof:
            view.get_data(**request_full)
    categories = {e["category"] for e in prof.events}
    assert "device" in categories
    assert "transfer" in categories


def test_summary_and_chrome_trace(source, request_full, tmp_path):
    view = Add(source, 10)
    with Profiler() as prof:
        view.get_data(**request_full)
    summary = prof.summary()
    assert "wall clock" in summary
    assert "count" in summary

    path = tmp_path / "trace.json"
    prof.to_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    assert len(trace["traceEvents"]) == len(prof.events)
    assert all(e["ph"] == "X" for e in trace["traceEvents"])


def test_inactive_outside_context(source, request_full):
    assert active_profiler() is None
    with Profiler() as prof:
        assert active_profiler() is prof
    assert active_profiler() is None


def test_nested_profiler_raises():
    with Profiler():
        with pytest.raises(RuntimeError):
            Profiler().__enter__()


class TestProgressBar:
    def test_reports_task_progress(self, source, request_full):
        stream = io.StringIO()
        view = Multiply(Add(source, 10), 2)
        with config.set({"geomodeling.executor": "auto"}):
            with ProgressBar(stream=stream) as bar:
                view.get_data(**request_full)
        output = stream.getvalue()
        assert bar.done > 0
        assert bar.total >= bar.done
        assert "100%" in output
        assert output.endswith("\n")

    def test_reports_tile_batches(self, source, request_full):
        from dask_geomodeling_tpu_torch.runtime.tiles import evaluate_tiled

        stream = io.StringIO()
        request = dict(request_full, width=20, height=20)
        with ProgressBar(stream=stream) as bar:
            evaluate_tiled(Add(source, 10), request, tile_size=10, batch=2, device="cpu")
        assert bar.done == bar.total >= 2
        assert "%d/%d" % (bar.done, bar.total) in stream.getvalue()

    def test_nested_raises(self):
        with ProgressBar():
            with pytest.raises(RuntimeError):
                ProgressBar().__enter__()


def test_profiler_covers_threaded_scheduler(source, request_full):
    """get_data's host route runs under the configured scheduler, through
    compute, as in the JAX package."""
    view = Multiply(Add(source, 10), 2)
    with config.set({"scheduler": "threads", "geomodeling.executor": "numpy"}):
        with Profiler() as prof:
            view.get_data(**request_full)
    names = {e["name"] for e in prof.events}
    assert any("multiply" in n for n in names)


def test_runtime_status_snapshot():
    """One JSON-serialisable dict over every runtime counter."""
    from dask_geomodeling_tpu_torch.runtime import results, router, status

    router.reset()
    results.clear()
    source = MemorySource(
        data=np.arange(64, dtype="u1").reshape(1, 8, 8), no_data_value=255,
        projection="EPSG:28992", pixel_size=1.0, pixel_origin=(0, 8),
    )
    request = dict(mode="vals", bbox=(0, 0, 8, 8), projection="EPSG:28992", width=8, height=8)
    try:
        with config.set({
            "geomodeling.executor": "auto",
            "geomodeling.result-cache-size": 10**6,
            "geomodeling.auto-min-device-px": 0,
        }):
            for _ in range(3):
                source.get_data(**request)
        snap = status.snapshot()
        json.dumps(snap)  # fully serialisable
        assert snap["router"]["routes"] >= 1
        assert snap["result_cache"]["misses"] >= 1
        assert set(snap["tiles"]) == {"programs", "batches"}
        assert set(snap["router"]) == {"routes", "torch_routes"}
        assert "gather" not in snap
    finally:
        router.reset(reseed=False)
        results.clear()


def test_torch_trace_writes_a_chrome_trace(source, request_full, tmp_path):
    view = Multiply(Add(source, 10), 2)
    with torch_trace(str(tmp_path / "trace")) as prof:
        view.get_data(**request_full)
    path = tmp_path / "trace" / "trace.json"
    assert path.stat().st_size > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    assert prof.key_averages()
