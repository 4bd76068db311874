"""``compute_host``: the numpy ground truth of a compute graph, and
``compute_metadata``, which answers time, meta and extent requests.

``compute_host`` evaluates a port graph with the port's numpy process
functions in topological order, on the host, as the JAX package's numpy
executor does (its synchronous scheduler): raster graphs and geometry
graphs alike (features, AggregateRaster's scipy.ndimage path).  It is
what chip_smoke.py and the card tests check the torch executors against;
it is called explicitly and never reached from ``get_data``.
``compute_metadata`` is the same walk for a request that holds no pixels
(a raster's time or meta request, a geometry's extent request): it is
what ``get_data`` runs for one, with no device resolved, and it counts a
node that did return pixels in ``executor.host_node_runs``.
"""
from dask_geomodeling_tpu_torch.runtime.executor import (
    _is_task,
    _reachable,
    _toposort,
    run_on_host,
)

__all__ = ["compute_host", "compute_metadata"]


def _call(func, args):
    return func(*args)


def compute_host(graph, name, run=_call):
    """Evaluate ``name`` in a compute graph with the numpy processes,
    each node as ``run(process, args)``."""
    needed, deps = _reachable(graph, name)
    cache = {}
    for key in _toposort(needed, deps):
        value = graph[key]
        if not _is_task(value):
            cache[key] = value
            continue
        cache[key] = run(
            value[0],
            [cache[arg] if isinstance(arg, str) and arg in graph else arg for arg in value[1:]],
        )
    return cache[name]


def compute_metadata(graph, name):
    """A time, meta or extent request's graph on the host, each node
    through ``run_on_host``."""
    return compute_host(graph, name, run=run_on_host)
