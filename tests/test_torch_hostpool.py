"""The port's TCP host pool (parallel/hostpool.py, parallel/hostworker.py).

Every case of tests/test_hostpool.py and the pool cases of
tests/test_spill_dashboard.py (``TestDashboard``), through the port: the
workers run ``python -m dask_geomodeling_tpu_torch.parallel.hostworker``
(and ``adapt`` spawns that module), the graphs and views are the port's.
A port view's compute graph through ``pool.scheduler`` equals the sync
scheduler's and ``compute_host``'s; ``get_data`` under
``geomodeling.executor`` "numpy" with the pool as ``scheduler`` equals
its answer under the sync scheduler.
"""
import json
import operator
import os
import subprocess
import sys
import threading
import time
import urllib.request
from datetime import datetime

import numpy as np
import pytest

from dask_geomodeling_tpu_torch import compute_host
from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.core.scheduler import get_sync
from dask_geomodeling_tpu_torch.parallel import HostPool
from dask_geomodeling_tpu_torch.parallel import hostpool as hostpool_module
from dask_geomodeling_tpu_torch.parallel.hostpool import worker_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spawn_worker(address, token="hunter2"):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(
        [
            sys.executable,
            "-m",
            "dask_geomodeling_tpu_torch.parallel.hostworker",
            address,
            "--token",
            token,
        ],
        env=env,
        cwd=REPO,
    )


@pytest.fixture
def pool():
    with HostPool(token="hunter2") as p:
        workers = [_spawn_worker(p.address) for _ in range(2)]
        try:
            p.wait_for_workers(2, timeout=60)
            yield p
        finally:
            for w in workers:
                w.kill()
                w.wait()


def _boom():
    raise ValueError("boom")


def boom():
    # module-level so it pickles across the pool boundary
    raise ValueError("nope")


def _slow_identity(x):
    time.sleep(2.0)
    return x


def _view_and_request():
    from dask_geomodeling_tpu_torch.raster import Classify, MemorySource, Smooth

    source = MemorySource(
        data=(np.random.RandomState(0).rand(1, 32, 32) * 200).astype(np.float32),
        no_data_value=float(np.finfo(np.float32).max),
        projection="EPSG:28992",
        pixel_size=1.0,
        pixel_origin=(135000, 456000),
        time_first=datetime(2000, 1, 1),
        time_delta=None,
    )
    view = Classify(Smooth(source + 1, size=3), bins=[50.0, 150.0])
    request = dict(
        mode="vals",
        bbox=(135000, 455968, 135032, 456000),
        projection="EPSG:28992",
        width=32,
        height=32,
        start=datetime(2000, 1, 1),
    )
    return view, request


class TestHostPool:
    def test_graph_evaluation(self, pool):
        graph = {
            "a": (operator.add, 1, 2),
            "b": (operator.mul, "a", 10),
            "c": (operator.add, "a", "b"),
        }
        assert pool.scheduler(graph, ["c", "a"]) == [33, 3]

    def test_view_get_data_matches_sync(self, pool):
        view, request = _view_and_request()
        with config.set({"geomodeling.executor": "numpy", "scheduler": "sync"}):
            expected = view.get_data(**request)
        with config.set({"geomodeling.executor": "numpy", "scheduler": pool.scheduler}):
            distributed = view.get_data(**request)
        np.testing.assert_array_equal(distributed["values"], expected["values"])
        assert distributed["no_data_value"] == expected["no_data_value"]

    def test_view_graph_matches_sync_and_compute_host(self, pool):
        """The pickled Blocks' process functions run in the workers."""
        view, request = _view_and_request()
        graph, name = view.get_compute_graph(**request)
        (pooled,) = pool.scheduler(graph, [name])
        (synced,) = get_sync(graph, [name])
        host = compute_host(graph, name)
        for answer in (synced, host):
            np.testing.assert_array_equal(pooled["values"], answer["values"])
            assert pooled["values"].dtype == answer["values"].dtype
        assert pool.status()["completed"] >= len(graph) - 1

    def test_exception_propagates(self, pool):
        with pytest.raises(ValueError, match="boom"):
            pool.scheduler({"x": (_boom,)}, ["x"])

    def test_worker_death_requeues(self):
        with HostPool(token="t") as p:
            first = _spawn_worker(p.address, token="t")
            try:
                p.wait_for_workers(1, timeout=60)
                future = p.submit(_slow_identity, 42)
                time.sleep(0.5)  # the (only) worker is mid-sleep
                first.kill()
                first.wait()
                replacement = _spawn_worker(p.address, token="t")
                try:
                    # the requeued task completes on the replacement
                    assert future.result(timeout=60) == 42
                finally:
                    replacement.kill()
                    replacement.wait()
            finally:
                first.kill()
                first.wait()

    def test_bad_token_rejected(self):
        with HostPool(token="right") as p:
            worker = _spawn_worker(p.address, token="wrong")
            try:
                assert worker.wait(timeout=60) != 0
                assert p.n_workers == 0
            finally:
                worker.kill()
                worker.wait()

    def test_empty_pool_refuses_to_schedule(self):
        with HostPool(token="t") as p:
            with pytest.raises(RuntimeError, match="dask_geomodeling_tpu_torch.parallel"):
                p.scheduler({"x": (operator.add, 1, 2)}, ["x"])


def _returns_unpicklable():
    return lambda: 1  # lambdas cannot pickle


def test_unpicklable_result_fails_cleanly():
    """A task whose RESULT cannot pickle must fail the future with a
    RuntimeError instead of killing workers one by one."""
    with HostPool(token="t") as p:
        worker = _spawn_worker(p.address, token="t")
        try:
            p.wait_for_workers(1, timeout=60)
            future = p.submit(_returns_unpicklable)
            with pytest.raises(RuntimeError, match="unpicklable"):
                future.result(timeout=60)
            # the worker survived and serves the next task
            assert p.submit(operator.add, 2, 3).result(timeout=60) == 5
        finally:
            worker.kill()
            worker.wait()


class TestAdaptiveScaling:
    def test_scale_up_then_down(self):
        """adapt() spawns workers for queued tasks and retires them when
        the queue stays idle (dask.distributed's Adaptive role)."""
        with HostPool(token="hunter2") as pool:
            pool.adapt(minimum=0, maximum=2, interval=0.05, idle_time=0.4)
            futures = [pool.submit(operator.add, i, 1) for i in range(6)]
            assert [f.result(timeout=60) for f in futures] == list(range(1, 7))
            assert pool.n_adaptive_workers >= 1
            deadline = time.time() + 30
            while pool.n_adaptive_workers > 0 and time.time() < deadline:
                time.sleep(0.05)
            assert pool.n_adaptive_workers == 0
            assert pool.status()["adaptive_workers"] == 0

    def test_minimum_kept_alive(self):
        with HostPool(token="hunter2") as pool:
            pool.adapt(minimum=1, maximum=2, interval=0.05, idle_time=0.1)
            pool.wait_for_workers(1, timeout=60)
            assert pool.submit(operator.mul, 6, 7).result(timeout=60) == 42
            time.sleep(0.6)  # well past idle_time: the floor holds
            assert pool.n_adaptive_workers >= 1
            with pytest.raises(RuntimeError):
                pool.adapt()
        deadline = time.time() + 10
        while pool.n_adaptive_workers > 0 and time.time() < deadline:
            time.sleep(0.05)
        assert pool.n_adaptive_workers == 0  # close() reaps the floor

    def test_inflight_task_blocks_scale_down(self):
        """A task slower than idle_time must not get its worker
        terminated mid-run."""
        with HostPool(token="hunter2") as pool:
            pool.adapt(minimum=0, maximum=1, interval=0.05, idle_time=0.3)
            future = pool.submit(_slow_identity, "done")
            assert future.result(timeout=120) == "done"
            assert pool.status()["requeued"] == 0

    def test_spawn_failure_does_not_kill_adapt_thread(self, monkeypatch):
        """A failing spawn must back off, not crash the scaler."""
        def broken_popen(*args, **kwargs):
            raise OSError("no exec")

        with HostPool(token="hunter2") as pool:
            monkeypatch.setattr(subprocess, "Popen", broken_popen)
            pool.adapt(minimum=0, maximum=2, interval=0.05, idle_time=0.2)
            future = pool.submit(operator.add, 1, 1)
            time.sleep(1.0)
            assert pool._adaptive["thread"].is_alive()
            assert pool.n_adaptive_workers == 0
            future.cancel()

    def test_adapt_spawns_the_port_worker(self, monkeypatch):
        """adapt() starts the port's worker module, not the JAX package's."""
        commands = []

        def recording_popen(command, **kwargs):
            commands.append(command)
            raise OSError("recorded")

        with HostPool(token="hunter2") as pool:
            monkeypatch.setattr(subprocess, "Popen", recording_popen)
            pool.adapt(minimum=1, maximum=1, interval=0.05)
            deadline = time.time() + 10
            while not commands and time.time() < deadline:
                time.sleep(0.05)
        assert commands
        assert commands[0][1:4] == ["-m", "dask_geomodeling_tpu_torch.parallel.hostworker",
                                    pool.address]


class TestDashboard:
    def test_status_endpoint(self):
        with HostPool(token="t", dashboard_port=0) as pool:
            worker = threading.Thread(
                target=worker_main,
                args=(pool.address,),
                kwargs={"token": "t"},
                daemon=True,
            )
            worker.start()
            pool.wait_for_workers(1, timeout=10)
            future = pool.submit(sum, [1, 2, 3])
            assert future.result(timeout=10) == 6

            status = pool.status()
            assert status["n_workers"] == 1
            assert status["completed"] == 1
            assert status["failed"] == 0

            url = "http://%s/status.json" % pool.dashboard_address
            with urllib.request.urlopen(url, timeout=10) as response:
                payload = json.loads(response.read())
            assert payload["completed"] == 1
            assert payload["n_workers"] == 1
            assert payload["per_worker"]
            html = urllib.request.urlopen(
                "http://%s/" % pool.dashboard_address, timeout=10
            ).read()
            assert b"HostPool" in html

    def test_failed_task_counted(self):
        with HostPool(token="t", dashboard_port=0) as pool:
            worker = threading.Thread(
                target=worker_main,
                args=(pool.address,),
                kwargs={"token": "t"},
                daemon=True,
            )
            worker.start()
            pool.wait_for_workers(1, timeout=10)
            future = pool.submit(boom)
            with pytest.raises(ValueError):
                future.result(timeout=10)
            assert pool.status()["failed"] == 1


def test_status_keys_as_the_jax_pool():
    """The dashboard's JSON has the JAX pool's keys."""
    from dask_geomodeling_tpu.parallel.hostpool import HostPool as JaxHostPool

    with HostPool(token="t") as port, JaxHostPool(token="t") as jax:
        assert sorted(port.status()) == sorted(jax.status())
    assert hostpool_module.__all__ == ["HostPool", "worker_main"]
