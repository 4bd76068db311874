"""Task-graph schedulers of the numpy processes.

Counterpart of dask_geomodeling_tpu/core/scheduler.py, copied: dask's
pluggable schedulers (dask.local.get_sync and its pools) over the graph
format of the planner::

    graph = {key: (callable, arg1, arg2, ...), ...}

where an ``arg`` that is a string present in ``graph`` refers to the result
of that entry.  Available schedulers:

- ``get_sync``      — single-threaded, depth-first (the default)
- ``get_threaded``  — thread-pool based, runs independent branches in parallel
- ``get_processes`` — process-pool based (tasks must be picklable)

They run what ``core/graphs.py:compute`` hands them under
``geomodeling.executor`` "numpy"; the torch executor (runtime/executor.py)
is not a scheduler here.  ``runtime/host.py:compute_host`` is the
synchronous ground truth they are held to.
"""
import os
import sys
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

from dask_geomodeling_tpu_torch.runtime import profile as _profile

__all__ = ["get_sync", "get_threaded", "get_processes", "get_scheduler"]


def _is_key(arg, graph):
    return isinstance(arg, str) and arg in graph


def _is_task(value):
    return isinstance(value, tuple) and len(value) >= 1 and callable(value[0])


def get_sync(graph, keys, pack_exception=None):
    """Evaluate ``keys`` from ``graph`` single-threaded; returns a list.

    ``pack_exception(exc, dumps)`` may re-raise a decorated exception; the
    graph key being evaluated is available to it as the local variable
    ``key`` one frame up (compatibility with the reference's construct error
    callback, reference graphs.py:21-27).
    """
    cache = {}
    if _profile.active():
        _profile.announce_total(sum(1 for v in graph.values() if _is_task(v)))

    def evaluate(key):
        if key in cache:
            return cache[key]
        value = graph[key]
        result = _run_task(key, value)
        cache[key] = result
        return result

    def _run_task(key, value):
        # ``key`` is read via the frame by pack_exception callbacks
        if not _is_task(value):
            return _resolve(value)
        func = value[0]
        args = [_resolve(arg) for arg in value[1:]]
        try:
            if not _profile.active():
                return func(*args)
            t0 = time.perf_counter()
            result = func(*args)
            _profile.record(
                getattr(func, "__qualname__", getattr(func, "__name__", "?")),
                "task",
                time.perf_counter() - t0,
                t0,
            )
            return result
        except Exception as e:
            if pack_exception is not None:
                pack_exception(e, None)
            raise

    def _resolve(arg):
        if _is_key(arg, graph):
            return evaluate(arg)
        return arg

    # deep graphs recurse per node; raise the limit proportionally
    if sys.getrecursionlimit() < len(graph) * 4 + 100:
        sys.setrecursionlimit(len(graph) * 4 + 100)
    return [evaluate(key) for key in keys]


def _dependencies(graph, key):
    value = graph[key]
    if not _is_task(value):
        return {value} if _is_key(value, graph) else set()
    return {arg for arg in value[1:] if _is_key(arg, graph)}


def _toposort_needed(graph, keys):
    """Return the set of keys needed to compute ``keys`` plus dep maps."""
    needed = set()
    stack = list(keys)
    while stack:
        key = stack.pop()
        if key in needed:
            continue
        needed.add(key)
        stack.extend(_dependencies(graph, key))
    deps = {key: _dependencies(graph, key) for key in needed}
    dependents = {key: set() for key in needed}
    for key, ds in deps.items():
        for d in ds:
            dependents[d].add(key)
    return needed, deps, dependents


def _make_result_cache():
    """The intermediate-result store: a plain dict, or a disk-spilling
    buffer when ``geomodeling.scheduler-memory-limit`` is set (the
    dask.distributed memory-spilling analog)."""
    from dask_geomodeling_tpu_torch.config import config

    limit = config.get("geomodeling.scheduler-memory-limit", None)
    if not limit:
        return {}
    from dask_geomodeling_tpu_torch.parallel.spill import SpillBuffer

    return SpillBuffer(int(limit))


def _get_pooled_impl(pool_cls, graph, keys, num_workers):
    _, deps, dependents = _toposort_needed(graph, keys)
    if _profile.active():
        _profile.announce_total(
            sum(1 for key in deps if _is_task(graph[key]))
        )
    cache = _make_result_cache()
    remaining = {key: len(ds) for key, ds in deps.items()}
    pending_uses = {key: len(ds) for key, ds in dependents.items()}
    requested = set(keys)
    ready = [key for key, n in remaining.items() if n == 0]

    def _resolve(arg):
        return cache[arg] if _is_key(arg, graph) else arg

    def _release(used_keys):
        # results whose last consumer just ran leave the cache (bounds
        # peak memory over wide graphs, like dask's key release)
        for key in used_keys:
            pending_uses[key] -= 1
            if pending_uses[key] == 0 and key not in requested:
                cache.pop(key, None)

    def _complete(key, result):
        cache[key] = result
        _release(deps[key])
        for dep in dependents[key]:
            remaining[dep] -= 1
            if remaining[dep] == 0:
                ready.append(dep)

    try:
        with pool_cls(num_workers) as pool:
            futures = {}
            while ready or futures:
                while ready:
                    key = ready.pop()
                    value = graph[key]
                    if not _is_task(value):
                        _complete(key, _resolve(value))
                        continue
                    func = value[0]
                    args = [_resolve(arg) for arg in value[1:]]
                    futures[pool.submit(_timed_call, func, args)] = key
                if not futures:
                    continue
                done, _ = wait(list(futures), return_when=FIRST_COMPLETED)
                for fut in done:
                    _complete(futures.pop(fut), fut.result())
        return [cache[key] for key in keys]
    finally:
        # a raising task must not leak the spill tempdir (close also
        # runs on success, after the results left the cache)
        close = getattr(cache, "close", None)
        if close is not None:
            close()


def _timed_call(func, args):
    if not _profile.active():
        return func(*args)
    t0 = time.perf_counter()
    result = func(*args)
    _profile.record(
        getattr(func, "__qualname__", getattr(func, "__name__", "?")),
        "task",
        time.perf_counter() - t0,
        t0,
    )
    return result


def get_threaded(graph, keys, num_workers=None, **kwargs):
    """Thread-pool scheduler: independent graph branches run concurrently."""
    num_workers = num_workers or min(32, (os.cpu_count() or 4))
    return _get_pooled_impl(ThreadPoolExecutor, graph, keys, num_workers)


def get_processes(graph, keys, num_workers=None, **kwargs):
    """Process-pool scheduler. Tasks and data must be picklable.

    Workers use the 'spawn' start method: forking a process after torch
    (or any threaded runtime) has initialized in the parent can deadlock."""
    import functools
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    num_workers = num_workers or (os.cpu_count() or 4)
    pool_cls = functools.partial(
        ProcessPoolExecutor, mp_context=multiprocessing.get_context("spawn")
    )
    return _get_pooled_impl(pool_cls, graph, keys, num_workers)


_SCHEDULERS = {
    None: get_sync,
    "sync": get_sync,
    "synchronous": get_sync,
    "single-threaded": get_sync,
    "threads": get_threaded,
    "threading": get_threaded,
    "processes": get_processes,
    "multiprocessing": get_processes,
}


def get_scheduler(name=None):
    """Resolve a scheduler callable from a name or the global config."""
    if callable(name):
        return name
    if name is None:
        from dask_geomodeling_tpu_torch.config import config

        name = config.get("scheduler", None)
        if callable(name):
            return name
    try:
        return _SCHEDULERS[name]
    except KeyError:
        raise ValueError("Unknown scheduler %r" % (name,)) from None
