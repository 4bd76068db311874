"""``from_reference``: carry a view of the JAX package across to the port.

The JAX package's ``view.serialize()`` gives ``{"version", "graph",
"name"}``, with each Block as ``[import_path, *args]``: class paths are
strings, sub-Blocks are graph keys, and the data travel as numpy arrays
(or, after a JSON round trip, nested lists).  Each
``dask_geomodeling_tpu.<module>.<Class>`` maps to
``dask_geomodeling_tpu_torch.<module>.<Class>`` and is constructed with
the same arguments, so the port's constructors validate them again.  This
is the port's counterpart of carrying weights across: the data are the
MemorySource payloads.  Only strings and arrays are read; nothing of the
JAX package is imported.
"""
import importlib

from dask_geomodeling_tpu_torch.core.graphs import PACKAGE, construct

__all__ = ["from_reference"]

#: the package whose serialized views ``from_reference`` reads: the one
#: this package is the port of
REFERENCE_PACKAGE = PACKAGE[: -len("_torch")]


def _port_class_path(path):
    """The port's import path for the reference class at ``path``;
    NotImplementedError when the port has no such class."""
    prefix = REFERENCE_PACKAGE + "."
    if not path.startswith(prefix):
        raise ValueError("%r is not a class of %s" % (path, REFERENCE_PACKAGE))
    module, name = (PACKAGE + "." + path[len(prefix):]).rsplit(".", 1)
    try:
        found = hasattr(importlib.import_module(module), name)
    except ModuleNotFoundError as e:
        if not (e.name or "").startswith(PACKAGE):
            raise
        found = False
    if not found:
        raise NotImplementedError("%s is not ported" % path)
    return module + "." + name


def from_reference(serialized):
    """The port's view of a serialized JAX-package view."""
    graph = {
        key: [_port_class_path(value[0])] + list(value[1:])
        for key, value in serialized["graph"].items()
    }
    return construct(graph, serialized["name"])
