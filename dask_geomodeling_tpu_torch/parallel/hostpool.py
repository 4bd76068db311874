"""Multi-machine host-plane scheduling: a TCP worker pool.

Counterpart of dask_geomodeling_tpu/parallel/hostpool.py.  The reference
hands its task graphs to dask.distributed for multi-machine evaluation
(reference core/graphs.py:42-49: any dask scheduler works).  This module
scales the port's HOST plane (geometry algebra, file feeds, the numpy
process functions) across machines with a self-contained pool:

    pool = HostPool(port=7777, token="s3cret")      # on the scheduler
    # on each worker machine:
    #   python -m dask_geomodeling_tpu_torch.parallel.hostworker \
    #       scheduler-host:7777 --token s3cret
    pool.wait_for_workers(4)
    with config.set({"geomodeling.executor": "numpy",
                     "scheduler": pool.scheduler}):
        view.get_data(...)                           # graph fans out

The ``scheduler`` key is read off the "torch" executor only
(core/graphs.py:compute), so a view's pixels reach the pool under
``geomodeling.executor`` "numpy" (or on "auto"'s host routes).  Tasks and
results travel as pickles (like dask.distributed's default; the port's
Blocks pickle through ``Block.__reduce__``): run it on trusted networks
only, authenticated by the shared token.  Worker disconnects requeue the
in-flight task on another worker; application exceptions propagate to the
caller.  ``dashboard_port`` serves ``status()`` as ``/status.json`` and an
HTML page at ``/``.
"""
import io
import json
import logging
import pickle
import queue
import socket
import struct
import threading
import time
from concurrent.futures import Future

logger = logging.getLogger(__name__)

__all__ = ["HostPool", "worker_main"]

_HEADER = struct.Struct("<Q")


def _send_msg(sock, payload):
    data = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_HEADER.pack(len(data)) + data)


def _recv_exact(sock, size):
    buf = io.BytesIO()
    while buf.tell() < size:
        chunk = sock.recv(size - buf.tell())
        if not chunk:
            raise ConnectionError("Connection closed")
        buf.write(chunk)
    return buf.getvalue()


def _recv_msg(sock):
    (size,) = _HEADER.unpack(_recv_exact(sock, _HEADER.size))
    return pickle.loads(_recv_exact(sock, size))


class HostPool:
    """Accepts worker connections and distributes task callables to them.

    Also usable as a drop-in for the scheduler pools: ``submit`` returns a
    concurrent.futures.Future, and ``scheduler`` is a callable accepted by
    ``config.set({"scheduler": ...})``.
    """

    def __init__(self, port=0, host="127.0.0.1", token="", dashboard_port=None):
        self._token = token
        self._tasks = queue.Queue()  # (payload_bytes, Future)
        self._workers = set()
        self._lock = threading.Lock()
        self._closed = False
        self._worker_joined = threading.Condition(self._lock)
        self._started = time.time()
        #: per-worker and pool-wide task counters (the dashboard's data)
        self._stats = {"completed": 0, "failed": 0, "requeued": 0}
        #: tasks taken off the queue but not yet resolved (dashboard)
        self._inflight = 0
        #: tasks submitted but not yet resolved — adapt()'s idle check
        #: uses this instead of qsize()+inflight because a task sits in
        #: neither during the dequeue->send window, and terminating a
        #: worker in that window would kill it mid-task
        self._unresolved = 0
        self._worker_stats = {}
        self._server = socket.create_server((host, port))
        self.address = "%s:%d" % self._server.getsockname()[:2]
        self._acceptor = threading.Thread(target=self._accept_loop, daemon=True)
        self._acceptor.start()
        self._dashboard = None
        self.dashboard_address = None
        self._adaptive = None
        if dashboard_port is not None:
            self._start_dashboard(host, dashboard_port)

    # --- worker side of the pool ---

    def _accept_loop(self):
        while not self._closed:
            try:
                sock, peer = self._server.accept()
            except OSError:
                return  # server closed
            threading.Thread(
                target=self._serve_worker, args=(sock, peer), daemon=True
            ).start()

    def _serve_worker(self, sock, peer):
        try:
            hello = _recv_msg(sock)
            if hello != {"token": self._token}:
                _send_msg(sock, {"error": "bad token"})
                sock.close()
                return
            _send_msg(sock, {"ok": True})
        except (ConnectionError, pickle.UnpicklingError, OSError):
            sock.close()
            return
        with self._worker_joined:
            self._workers.add(peer)
            self._worker_joined.notify_all()
        logger.info("host worker %s joined (%d total)", peer, len(self._workers))
        try:
            while not self._closed:
                task = self._tasks.get()
                if task is None:  # shutdown sentinel
                    self._tasks.put(None)  # wake the next handler too
                    return
                payload, future = task
                if future.done():
                    continue
                with self._lock:
                    self._inflight += 1
                try:
                    sock.sendall(_HEADER.pack(len(payload)) + payload)
                    status, value = _recv_msg(sock)
                except (ConnectionError, OSError):
                    # worker died mid-task: requeue.  The pool is elastic —
                    # the task waits for any remaining or newly joining
                    # worker (callers bound their own patience via
                    # Future.result(timeout) / wait_for_workers).
                    logger.warning("host worker %s lost; requeueing task", peer)
                    with self._lock:
                        self._stats["requeued"] += 1
                        self._inflight -= 1
                    self._tasks.put((payload, future))
                    return
                except Exception as e:
                    # the reply arrived but could not be unpickled (e.g. a
                    # result class importable only on the worker): this is
                    # deterministic, so fail the caller instead of
                    # requeueing it into every worker
                    with self._lock:
                        self._inflight -= 1
                    future.set_exception(
                        RuntimeError(
                            "Could not deserialize the worker reply: %r" % e
                        )
                    )
                    return
                with self._lock:
                    self._inflight -= 1
                    counters = self._worker_stats.setdefault(
                        "%s:%d" % peer, {"completed": 0, "failed": 0}
                    )
                    if status == "ok":
                        self._stats["completed"] += 1
                        counters["completed"] += 1
                    else:
                        self._stats["failed"] += 1
                        counters["failed"] += 1
                if status == "ok":
                    future.set_result(value)
                else:
                    future.set_exception(value)
        finally:
            with self._worker_joined:
                self._workers.discard(peer)
            sock.close()

    # --- diagnostics dashboard (the dask.distributed dashboard role) ---

    def status(self):
        """A JSON-able snapshot: workers, queue depth, task counters."""
        with self._lock:
            return {
                "address": self.address,
                "uptime_sec": round(time.time() - self._started, 1),
                "n_workers": len(self._workers),
                "workers": sorted("%s:%d" % w for w in self._workers),
                "queued_tasks": self._tasks.qsize(),
                "inflight_tasks": self._inflight,
                "adaptive_workers": self.n_adaptive_workers,
                **self._stats,
                "per_worker": {
                    k: dict(v) for k, v in self._worker_stats.items()
                },
            }

    def _start_dashboard(self, host, port):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        pool = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path in ("/", "/status", "/status.json"):
                    body = json.dumps(pool.status(), indent=2).encode()
                    ctype = "application/json"
                    if self.path == "/":
                        body = (
                            b"<html><body><h2>HostPool %s</h2><pre>%s</pre>"
                            b"</body></html>"
                            % (pool.address.encode(), body)
                        )
                        ctype = "text/html"
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(404)
                    self.end_headers()

            def log_message(self, *args):
                pass  # stay quiet; the pool has its own logger

        self._dashboard = ThreadingHTTPServer((host, port), Handler)
        self.dashboard_address = "%s:%d" % self._dashboard.server_address[:2]
        threading.Thread(
            target=self._dashboard.serve_forever, daemon=True
        ).start()

    # --- caller side ---

    @property
    def n_workers(self):
        with self._lock:
            return len(self._workers)

    def wait_for_workers(self, count, timeout=30.0):
        with self._worker_joined:
            if not self._worker_joined.wait_for(
                lambda: len(self._workers) >= count, timeout=timeout
            ):
                raise TimeoutError(
                    "Only %d/%d workers joined" % (len(self._workers), count)
                )

    def _task_resolved(self, _future):
        with self._lock:
            self._unresolved -= 1

    def submit(self, func, *args):
        future = Future()
        payload = pickle.dumps(
            (func, args), protocol=pickle.HIGHEST_PROTOCOL
        )
        with self._lock:
            self._unresolved += 1
        # fires on set_result/set_exception AND cancel, so the counter
        # cannot leak however the future ends
        future.add_done_callback(self._task_resolved)
        self._tasks.put((payload, future))
        return future

    def scheduler(self, graph, keys, **kwargs):
        """A scheduler callable over this pool (config: ``scheduler``)."""
        from dask_geomodeling_tpu_torch.core.scheduler import _get_pooled_impl

        if self.n_workers == 0 and self._adaptive is None:
            # with adapt() active, queued tasks trigger worker spawns,
            # so an empty pool is fine to schedule into
            raise RuntimeError(
                "No host workers connected to %s; start them with "
                "python -m dask_geomodeling_tpu_torch.parallel.hostworker"
                % self.address
            )
        pool = self

        class _View:
            """Non-closing executor view for the pooled scheduler impl."""

            def __init__(self, _n):
                pass

            def __enter__(self):
                return pool

            def __exit__(self, *exc):
                return False

        return _get_pooled_impl(_View, graph, keys, None)

    # --- adaptive scaling (dask.distributed's Adaptive role) ---

    def adapt(self, minimum=0, maximum=4, interval=0.25, idle_time=2.0):
        """Maintain between ``minimum`` and ``maximum`` locally spawned
        worker processes, sized to the queue depth.

        The pool's shared task queue makes work *stealing* structurally
        unnecessary (idle workers pull the next task themselves; a lost
        worker's task requeues) — this covers the other half of
        dask.distributed's Adaptive: elastic capacity.  Extra workers
        spawn while tasks queue; after ``idle_time`` seconds with an
        empty queue, spawned workers retire one per tick down to
        ``minimum``.  A worker terminated mid-task requeues its task
        (the ordinary disconnect path), so scale-down is always safe.
        Remote workers that connect on their own are never retired.
        """
        import os
        import subprocess
        import sys

        if self._adaptive is not None:
            raise RuntimeError("adapt() is already active on this pool")

        # make this package importable in the spawned interpreter even
        # when it runs from a source tree rather than an installation
        package_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (package_root, env.get("PYTHONPATH")) if p
        )

        def spawn():
            return subprocess.Popen(
                [
                    sys.executable, "-m",
                    "dask_geomodeling_tpu_torch.parallel.hostworker",
                    self.address, "--token", self._token,
                ],
                stdin=subprocess.DEVNULL,
                env=env,
            )

        state = {
            "procs": [], "stop": threading.Event(), "last_busy": 0.0,
            "backoff_until": 0.0, "fast_deaths": 0, "queued_streak": 0,
        }

        def try_spawn(now):
            if now < state["backoff_until"]:
                return False
            try:
                state["procs"].append((spawn(), now))
            except Exception:
                # spawn failure (ENOMEM, exec error) must not kill the
                # adapt thread — scheduler() relies on it staying alive
                logger.exception("adaptive worker spawn failed; backing off")
                state["fast_deaths"] += 1
                state["backoff_until"] = now + min(
                    2.0 ** state["fast_deaths"], 60.0
                )
                return False
            return True

        def loop():
            while not state["stop"].is_set() and not self._closed:
                now = time.time()
                survivors = []
                for proc, born in state["procs"]:
                    if proc.poll() is None:
                        survivors.append((proc, born))
                    elif now - born < 5.0:
                        # died right after spawning: a broken worker env
                        # would otherwise respawn every tick forever
                        state["fast_deaths"] += 1
                        state["backoff_until"] = now + min(
                            2.0 ** state["fast_deaths"], 60.0
                        )
                        logger.warning(
                            "adaptive worker died %.1fs after spawn; "
                            "backing off %.1fs",
                            now - born, state["backoff_until"] - now,
                        )
                    else:
                        state["fast_deaths"] = 0
                state["procs"] = survivors
                alive = len(state["procs"])
                queued = self._tasks.qsize()
                with self._lock:
                    busy = self._unresolved
                    connected = len(self._workers)
                    idle_capacity = connected - self._inflight
                if busy:
                    state["last_busy"] = now
                state["queued_streak"] = (
                    state["queued_streak"] + 1 if queued else 0
                )
                # spawn only for a queue that survived one full tick
                # (a sub-pickup-latency blip next to idle remote workers
                # would otherwise churn local interpreters), and never
                # when idle connected capacity already covers the demand
                if state["queued_streak"] >= 2 and queued > max(
                    idle_capacity, 0
                ):
                    deficit = min(queued, maximum - alive)
                    for _ in range(deficit):
                        if not try_spawn(now):
                            break
                elif queued and connected == 0 and alive == 0:
                    try_spawn(now)  # cold start: nothing can drain at all
                if alive < minimum:
                    try_spawn(now)
                elif (
                    alive > minimum
                    and not busy
                    and now - state["last_busy"] > idle_time
                ):
                    state["procs"].pop()[0].terminate()
                state["stop"].wait(interval)
            for proc, _born in state["procs"]:
                proc.terminate()

        state["thread"] = threading.Thread(target=loop, daemon=True)
        self._adaptive = state
        state["thread"].start()
        return self

    @property
    def n_adaptive_workers(self):
        """Spawned (adaptive) worker processes currently alive."""
        state = self._adaptive
        if state is None:
            return 0
        return sum(1 for p, _born in state["procs"] if p.poll() is None)

    def close(self):
        self._closed = True
        if self._adaptive is not None:
            self._adaptive["stop"].set()
            self._adaptive["thread"].join(timeout=5)
        self._tasks.put(None)
        if self._dashboard is not None:
            self._dashboard.shutdown()
            self._dashboard.server_close()
        try:
            self._server.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def worker_main(address, token="", once=False):
    """Connect to a HostPool and execute tasks until disconnected.

    ``address`` is "host:port".  With ``once`` the worker exits after the
    first task (used by tests).
    """
    host, _, port = address.rpartition(":")
    sock = socket.create_connection((host, int(port)))
    try:
        _send_msg(sock, {"token": token})
        reply = _recv_msg(sock)
        if reply != {"ok": True}:
            raise PermissionError("Pool rejected the worker: %r" % (reply,))
        while True:
            func, args = _recv_msg(sock)
            try:
                result = ("ok", func(*args))
            except Exception as e:  # application error: ship it back
                result = ("error", e)
            # both results and exceptions must survive pickling, or the
            # failed send would kill this worker (and, via requeue, the
            # next one, and the next...)
            try:
                pickle.dumps(result[1])
            except Exception as e:
                result = (
                    "error",
                    RuntimeError(
                        "Task %s was unpicklable: %r" % (result[0], e)
                    ),
                )
            _send_msg(sock, result)
            if once:
                return
    except ConnectionError:
        pass
    finally:
        sock.close()
