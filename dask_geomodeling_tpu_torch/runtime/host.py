"""``compute_host``: the numpy ground truth of a compute graph.

Evaluates a port graph with the port's numpy process functions in
topological order, on the host, as the JAX package's numpy executor does
(its synchronous scheduler).  It is what chip_smoke.py and the card tests
check the torch executors against; it is called explicitly and never
reached from ``get_data``.
"""
from dask_geomodeling_tpu_torch.runtime.executor import _is_task, _reachable, _toposort

__all__ = ["compute_host"]


def compute_host(graph, name):
    """Evaluate ``name`` in a compute graph with the numpy processes."""
    needed, deps = _reachable(graph, name)
    cache = {}
    for key in _toposort(needed, deps):
        value = graph[key]
        if not _is_task(value):
            cache[key] = value
            continue
        cache[key] = value[0](
            *[
                cache[arg] if isinstance(arg, str) and arg in graph else arg
                for arg in value[1:]
            ]
        )
    return cache[name]
