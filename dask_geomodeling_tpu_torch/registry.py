"""The port's twin registry, keyed by its own process functions.

``register`` maps a numpy process function (raster/*.py) to its torch
twin, and the executors look twins up with ``twin_for``.  The JAX package
hangs its device twins on its process functions as attributes
(``jax_impl``, ``jax_capable``); the port keeps one table instead.

A twin takes the process function's arguments, batch-first: every raster
``values`` is a (B, bands, h, w) tensor, and every literal named by the
process function's ``torch_dynamic`` attribute arrives as a tensor with a
leading B axis (runtime/executor.py:batch_literals).  It returns the same
structure the process function returns, with tensors in place of arrays.
A twin may also name host work to do per tile before batching (``stage``).

A process function without a twin may carry ``torch_accepts_device_tensors
= True`` (AggregateRaster's, the counterpart of the JAX package's
``jax_accepts_device_arrays``): ``compute_torch`` then hands it its device
inputs as they are, with the batch axis of 1 dropped, and runs it on the
host, where it reduces them on the device itself.  Any other process
without a twin refuses a device input (``NotLowerable``).
"""

__all__ = ["register", "twin_for", "is_capable", "stage"]

_TWINS = {}


def register(process_fn, twin, capable=None, stage=None):
    """Serve ``process_fn`` nodes with ``twin``.

    ``capable`` (optional) sees the node's literal args (graph-key args as
    None) and says whether the twin can serve this node; without it the
    twin serves every node.  ``stage`` (optional) is host work done per
    tile before the literals are batched: it takes the node's args and
    returns them with its literals replaced (the source computes its
    coarse index grid there).
    """
    _TWINS[process_fn] = (twin, capable, stage)


def twin_for(process_fn):
    """The registered twin of ``process_fn``, or None."""
    entry = _TWINS.get(process_fn)
    return None if entry is None else entry[0]


def stage(process_fn, args):
    """``args`` of a ``process_fn`` node after its twin's host staging."""
    entry = _TWINS.get(process_fn)
    if entry is None or entry[2] is None:
        return tuple(args)
    return tuple(entry[2](*args))


def is_capable(process_fn, literals):
    """Whether ``process_fn`` has a twin that can serve a node with these
    literal args (graph-key args replaced by None)."""
    entry = _TWINS.get(process_fn)
    if entry is None:
        return False
    capable = entry[1]
    return capable is None or bool(capable(*literals))
