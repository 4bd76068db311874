"""The torch executor: walk a compute graph, run each twin on the device.

Counterpart of dask_geomodeling_tpu/runtime/executor.py:compute_jax, with
that module's graph walk (``_is_task``, ``_reachable``, ``_toposort``,
``_map_structure``) copied here.  PyTorch runs eagerly, so there is
nothing to stage or compile: nodes run one by one in topological order.
A node whose process function has a capable twin (registry.py) runs on
the device.  A node without one runs its numpy process on the host only
while all its inputs are still on the host, as file reads do in the JAX
executor; one that would take a device result raises ``NotLowerable``, so
device data never goes back to the host to be computed on.  The exception
is a process that accepts device tensors (``torch_accepts_device_tensors``,
AggregateRaster's): it gets its device inputs as they are and reduces
them on the device.  A twin that
fails raises: no request is quietly served from the host instead.

Twins work batch-first (registry.py).  Here the batch is one request,
B = 1; runtime/tiles.py runs the same twins over B tiles at once.
"""
import dataclasses

import numpy as np
import torch

from dask_geomodeling_tpu_torch import registry
from dask_geomodeling_tpu_torch.device import resolve_device
from dask_geomodeling_tpu_torch.raster.sources import to_device

__all__ = [
    "compute_torch",
    "batch_literals",
    "stack_host_results",
    "static_key",
    "NotLowerable",
    "host_node_runs",
]


class NotLowerable(Exception):
    """The view does not reduce to one chain of twins over a tile batch."""


#: nodes that ran their numpy process on the host (no capable twin) and
#: returned pixel arrays, since import: compute_torch's and the tile
#: runtime's; a time or meta answer, which holds none, is not counted
host_node_runs = 0


def run_on_host(func, args):
    """``func(*args)`` on the host, counted in ``host_node_runs`` when the
    result holds pixel arrays."""
    global host_node_runs
    result = func(*args)
    if _arrays_in(result):
        host_node_runs += 1
    return result


def _is_task(value):
    return isinstance(value, tuple) and len(value) >= 1 and callable(value[0])


def _reachable(graph, name):
    """Keys needed for ``name`` plus the key-dependency map."""
    needed = []
    seen = set()
    stack = [name]
    while stack:
        key = stack.pop()
        if key in seen:
            continue
        seen.add(key)
        needed.append(key)
        value = graph[key]
        if _is_task(value):
            for arg in value[1:]:
                if isinstance(arg, str) and arg in graph:
                    stack.append(arg)
    deps = {
        key: [
            arg
            for arg in (graph[key][1:] if _is_task(graph[key]) else ())
            if isinstance(arg, str) and arg in graph
        ]
        for key in needed
    }
    return needed, deps


def _toposort(needed, deps):
    """``needed`` in an order where every key follows its dependencies."""
    order = []
    state = {}
    for root in needed:
        if state.get(root) == 2:
            continue
        stack = [(root, iter(deps[root]))]
        state[root] = 1
        while stack:
            node, it = stack[-1]
            advanced = False
            for dep in it:
                if state.get(dep) == 1:
                    raise ValueError("Cycle in compute graph")
                if state.get(dep) != 2:
                    state[dep] = 1
                    stack.append((dep, iter(deps[dep])))
                    advanced = True
                    break
            if not advanced:
                state[node] = 2
                order.append(node)
                stack.pop()
    return order


def _map_structure(func, obj):
    """``func`` applied to every leaf of nested dicts, lists, tuples and
    dataclasses, keeping the structure."""
    if isinstance(obj, dict):
        return {k: _map_structure(func, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_structure(func, v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(
            obj,
            **{
                f.name: _map_structure(func, getattr(obj, f.name))
                for f in dataclasses.fields(obj)
            },
        )
    return func(obj)


def literal_args(value, graph):
    """A node's literal args, graph-key args as None (what a twin's
    ``capable`` sees)."""
    return [
        None if (isinstance(arg, str) and arg in graph) else arg
        for arg in value[1:]
    ]


def batch_literals(per_tile, dynamic, device):
    """One literal argument of a twin, batched over tiles.

    ``per_tile`` holds the literal as each tile's plan gives it.  Fields
    named in ``dynamic`` (the process function's ``torch_dynamic``) vary per
    tile: each is stacked into a tensor with a leading B axis, numbers as
    float64 like the JAX executor's ``_dynamicize``.  Everything else must
    be the same in every tile, or NotLowerable is raised: each array (a
    source payload) becomes one shared resident tensor, and the remaining
    fields and bare literals (a block's constants) are the first tile's.
    """
    first = per_tile[0]
    if isinstance(first, dict) and dynamic:
        varying = {
            key: torch.from_numpy(
                np.stack([_as_dynamic(tile[key]) for tile in per_tile])
            ).to(device)
            for key in dynamic
            if key in first and _is_dynamic_value(first[key])
        }
        static = {k: v for k, v in first.items() if k not in varying}
        others = [{k: v for k, v in t.items() if k not in varying} for t in per_tile]
        return dict(_shared_arrays(static, others, device), **varying)
    return _shared_arrays(first, per_tile, device)


def _is_dynamic_value(value):
    return isinstance(
        value, (int, float, tuple, list, np.ndarray)
    ) and not isinstance(value, bool)


def _as_dynamic(value):
    if isinstance(value, np.ndarray):
        return value
    return np.asarray(value, dtype=np.float64)


def _arrays_in(obj):
    found = []
    _map_structure(
        lambda leaf: found.append(leaf) if isinstance(leaf, np.ndarray) else None,
        obj,
    )
    return found


#: arrays up to this many elements are keyed by their bytes in
#: ``static_key``, larger ones (source payloads) by their identity
_KEYED_BY_VALUE = 4096


def _leaf_key(leaf):
    if isinstance(leaf, np.ndarray):
        if leaf.size <= _KEYED_BY_VALUE:
            return ("array", leaf.dtype.str, leaf.shape, np.ascontiguousarray(leaf).tobytes())
        return ("array", id(leaf))
    if isinstance(leaf, (float, np.floating)) and np.isnan(leaf):
        return ("nan", type(leaf))
    try:
        hash(leaf)
    except TypeError:
        return (type(leaf), repr(leaf))
    return (type(leaf), leaf)


def static_key(literal, dynamic, arrays=True):
    """A hashable key of what ``batch_literals`` requires to be the same in
    every tile: the literal but the fields ``dynamic`` names, its nesting
    and each leaf (without arrays when ``arrays`` is False)."""
    if isinstance(literal, dict) and dynamic:
        literal = {
            k: v for k, v in literal.items() if not (k in dynamic and _is_dynamic_value(v))
        }
    leaves = _leaves(literal)
    if not arrays:
        leaves = [leaf for leaf in leaves if not isinstance(leaf, np.ndarray)]
    return _skeleton(literal), tuple(_leaf_key(leaf) for leaf in leaves)


def _skeleton(obj):
    """The nesting ``_map_structure`` walks: containers, keys and fields,
    in its order, with None for each leaf."""
    if isinstance(obj, dict):
        return ("dict",) + tuple((k, _skeleton(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__,) + tuple(_skeleton(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__qualname__,) + tuple(
            (f.name, _skeleton(getattr(obj, f.name))) for f in dataclasses.fields(obj)
        )
    return None


def _same_array(a, b):
    # payloads are the same ndarray object in every tile's plan: identity
    # first, so a large source is never compared element by element
    return a is b or (
        a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)
    )


def _leaves(obj):
    found = []
    _map_structure(found.append, obj)
    return found


def _same_leaf(a, b):
    """Whether two leaves of a literal are the same value: arrays element
    by element, NaN equal to NaN."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return isinstance(a, np.ndarray) and isinstance(b, np.ndarray) and _same_array(a, b)
    if a is b:
        return True
    if type(a) is not type(b):
        return False
    try:
        if bool(a == b):
            return True
    except (TypeError, ValueError):
        return False
    return isinstance(a, (float, np.floating)) and np.isnan(a) and np.isnan(b)


def _shared_arrays(first, per_tile, device):
    """``first`` with each array replaced by its resident tensor, after
    checking that every tile carries the same literal: the same arrays and
    the same other leaves."""
    leaves = _leaves(first)
    for other in per_tile[1:]:
        others = _leaves(other)
        if len(others) != len(leaves) or not all(
            _same_leaf(a, b) for a, b in zip(leaves, others)
        ):
            raise NotLowerable("a literal varies from tile to tile")
    return _map_structure(
        lambda leaf: to_device(leaf, device) if isinstance(leaf, np.ndarray) else leaf,
        first,
    )


def stack_host_results(per_tile, device):
    """A host node's per-tile results as one twin input: each array
    stacked over the tiles into a tensor with a leading B axis; every
    other leaf from the first tile."""
    stacked = iter(
        [
            torch.from_numpy(np.stack(arrays)).to(device)
            for arrays in zip(*[_arrays_in(result) for result in per_tile])
        ]
    )
    return _map_structure(
        lambda leaf: next(stacked) if isinstance(leaf, np.ndarray) else leaf,
        per_tile[0],
    )


def to_host(obj):
    """A twin's batch-first result for one request: tensors -> numpy,
    dropping the batch axis of 1."""
    return _map_structure(
        lambda leaf: leaf[0].cpu().numpy() if isinstance(leaf, torch.Tensor) else leaf,
        obj,
    )


def without_batch(obj):
    """A twin's batch-first result for one request, left on the device:
    each tensor without its batch axis of 1."""
    return _map_structure(
        lambda leaf: leaf[0] if isinstance(leaf, torch.Tensor) else leaf, obj
    )


def from_host(obj, device):
    """A host node's result as a twin input: arrays -> tensors with a
    batch axis of 1."""
    return _map_structure(
        lambda leaf: torch.from_numpy(np.ascontiguousarray(leaf)).to(device)[None]
        if isinstance(leaf, np.ndarray)
        else leaf,
        obj,
    )


def compute_torch(graph, name, device=None):
    """Evaluate ``name`` in a compute graph; twins run on ``device``."""
    device = resolve_device(device)
    needed, deps = _reachable(graph, name)
    order = _toposort(needed, deps)
    remaining = {key: 0 for key in order}
    for key in order:
        for dep in deps[key]:
            remaining[dep] += 1

    cache = {}
    on_device = set()
    for key in order:
        value = graph[key]
        if not _is_task(value):
            cache[key] = value
            continue
        func = value[0]
        twin = None
        if registry.is_capable(func, literal_args(value, graph)):
            twin = registry.twin_for(func)
        if twin is None:
            takes_tensors = getattr(func, "torch_accepts_device_tensors", False)
            if not takes_tensors and any(dep in on_device for dep in deps[key]):
                raise NotLowerable(
                    "node %s has no capable torch twin and takes a device result"
                    % key.split("_")[0]
                )
            cache[key] = run_on_host(
                func,
                [
                    (without_batch(cache[arg]) if arg in on_device else cache[arg])
                    if isinstance(arg, str) and arg in graph
                    else arg
                    for arg in value[1:]
                ],
            )
        else:
            args = []
            for arg in registry.stage(func, value[1:]):
                if isinstance(arg, str) and arg in graph:
                    result = cache[arg]
                    if arg not in on_device:
                        result = from_host(result, device)
                    args.append(result)
                else:
                    args.append(
                        batch_literals(
                            [arg], getattr(func, "torch_dynamic", None), device
                        )
                    )
            cache[key] = twin(*args)
            on_device.add(key)
        # release each intermediate after its last consumer
        for dep in deps[key]:
            remaining[dep] -= 1
            if remaining[dep] == 0 and dep != name:
                cache.pop(dep, None)

    result = cache[name]
    return to_host(result) if name in on_device else result
