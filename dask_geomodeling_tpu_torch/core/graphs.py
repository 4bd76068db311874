"""The Block graph: lazy, immutable views and their compute graphs.

Counterpart of dask_geomodeling_tpu/core/graphs.py (``Block``, ``arg``,
``construct``).  A view answers a request in two steps: each Block
rewrites the request for its sources (``get_sources_and_requests``), and
its static ``process`` combines what they return.  The recursion gives a
compute graph ``{name_token: (process, *args)}`` whose keys are content
hashes, so shared (block, request) pairs appear once.

``Block.get_data`` runs the graph with the port's torch executor
(runtime/executor.py) on the card unless the caller passes
``device="cpu"``; runtime/host.py:compute_host evaluates it with the
numpy processes, synchronously, when asked to.  ``compute`` is the JAX
package's entry point of the same name: the torch executor under
``geomodeling.executor`` "torch", else the numpy processes under the
configured ``scheduler`` (core/scheduler.py).

A view travels as JSON (``to_json``, ``from_json``): class paths as
strings, arrays as nested lists.  Deserializing imports only the port's
own package, and under ``geomodeling.block-import-paths`` only the
prefixes it lists, checked before anything is imported: a layer that
names a class of the JAX package is refused, and neither that package
nor jax is loaded.
"""
import json
import logging
import sys

from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.core.tokens import tokenize

logger = logging.getLogger(__name__)

__all__ = ["construct", "arg", "Block", "compute"]

#: the port's own package: the only one ``from_import_path`` imports from
PACKAGE = "dask_geomodeling_tpu_torch"

_ARG_MISSING = object()


def arg(index, doc=None, default=_ARG_MISSING):
    """Declarative accessor binding a Block attribute to a constructor
    argument: ``size = arg(1)``."""

    def fget(self):
        try:
            return self.args[index]
        except IndexError:
            if default is not _ARG_MISSING:
                return default
            raise

    if doc:
        fget.__doc__ = doc
    return property(fget)


def compute(graph, name, device=None):
    """Compute ``name`` of a graph ``{name: (func, *args)}`` with the
    configured executor: "torch" runs ``compute_torch`` on ``device``
    (``None``: ``geomodeling.torch-device``); any other runs the numpy
    processes under the configured ``scheduler``."""
    if config.get("geomodeling.executor", "torch") == "torch":
        from dask_geomodeling_tpu_torch.runtime.executor import compute_torch

        return compute_torch(graph, name, device=device)
    from dask_geomodeling_tpu_torch.core.scheduler import get_scheduler

    return get_scheduler()(graph, [name])[0]


def construct(graph, name):
    """Construct the Block ``name`` (and the Blocks it depends on) from a
    construction graph ``{name: [cls_or_import_path, *args]}``; an arg
    that is a key of the graph stands for that Block."""
    built = {}

    def build(key):
        if key not in built:
            value = graph[key]
            cls = value[0]
            if isinstance(cls, str):
                cls = Block.from_import_path(cls)
            if not (isinstance(cls, type) and issubclass(cls, Block)):
                raise TypeError("Cannot construct from object of type '{}'".format(cls))
            args = [
                build(a) if isinstance(a, str) and a in graph else a
                for a in value[1:]
            ]
            try:
                built[key] = cls(*args)
            except Exception as e:
                e.args = ("{0}: {1}".format(key, e),)
                raise
        return built[key]

    return build(name)


def _under(module, prefix):
    """Whether ``module`` is the package ``prefix`` or inside it (a
    shared leading string is not enough: ``dask_geomodeling_tpu`` does
    not hold ``dask_geomodeling_tpu_torch``)."""
    return module == prefix or module.startswith(prefix + ".")


class Block:
    """A lazy, immutable node in a computation view.

    Subclasses override ``__init__`` for argument validation (calling
    ``super().__init__`` with all args, kept in ``self.args``),
    ``get_sources_and_requests`` to rewrite the request per source, and
    the static ``process`` that combines the source data.
    """

    JSON_VERSION = 2

    def __init__(self, *args):
        self.args = args

    @property
    def token(self):
        """Unique, deterministic content hash of this view."""
        cached = getattr(self, "_cached_token", None)
        if cached is None:
            parts = [
                arg.token if isinstance(arg, Block) else arg
                for arg in self.args
            ]
            cached = self._cached_token = tokenize(
                self.get_import_path(), *parts
            )
        return cached

    @staticmethod  # must remain a static method: it is shipped in graphs
    def process(data):
        """Combine source data; default passes single-source data through."""
        return data

    def get_sources_and_requests(self, **request):
        """``(source, request)`` pairs; non-Block sources are passed to
        ``process`` as they are (their request is ignored)."""
        return ((source, request) for source in self.args)

    def get_data(self, device=None, **request):
        """Evaluate the request with the torch twins on ``device``."""
        from dask_geomodeling_tpu_torch.runtime.executor import compute_torch

        return compute_torch(*self.get_compute_graph(**request), device=device)

    def get_compute_graph(self, cached_compute_graph=None, **request):
        """``(graph, name)``: graph maps ``name_token -> (process, *args)``
        and args may name other keys."""
        token = tokenize([self.token, request])
        name = "{}_{}".format(type(self).__name__.lower(), token)
        graph = cached_compute_graph if cached_compute_graph is not None else {}

        if name in graph:
            return graph, name

        args = [self.process]
        for source, req in self.get_sources_and_requests(**request):
            if isinstance(source, Block) and req is not None:
                graph, compute_name = source.get_compute_graph(
                    cached_compute_graph=graph, **req
                )
                args.append(compute_name)
            else:
                args.append(source)

        graph[name] = tuple(args)
        return graph, name

    def get_graph(self, serialize=False):
        """``(graph, name)`` defining this Block and its dependencies;
        values are ``[cls_or_import_path, *construction_args]``."""
        args = [self.get_import_path()] if serialize else [type(self)]
        graph = {}
        for arg in self.args:
            if isinstance(arg, Block):
                sub_graph, sub_name = arg.get_graph(serialize=serialize)
                graph.update(sub_graph)
                args.append(sub_name)
            else:
                args.append(arg)
        name = self.name
        graph[name] = args
        return graph, name

    @property
    def name(self):
        return "{}_{}".format(type(self).__name__, self.token)

    @classmethod
    def get_import_path(cls):
        """The import path serialized graphs name this class by; it must
        resolve back to the class."""
        module, name = cls.__module__, cls.__name__
        try:
            __import__(module)
            resolved = getattr(sys.modules[module], name)
        except (ImportError, KeyError, AttributeError):
            resolved = None
        if resolved is not cls:
            raise RuntimeError(
                "Can't serialize %r: it does not resolve back to %s.%s"
                % (cls, module, name)
            )
        return "%s.%s" % (module, name)

    @staticmethod
    def from_import_path(path):
        """The Block class at ``path``, which must lie in the port's own
        package and, when ``geomodeling.block-import-paths`` lists
        prefixes, under one of them (both checked before anything is
        imported)."""
        module, name = path.rsplit(".", 1)
        if not _under(module, PACKAGE):
            raise TypeError(
                '"{}" is outside the package {}.'.format(path, PACKAGE)
            )
        allowed = config.get("geomodeling.block-import-paths", None)
        if allowed is not None and not any(_under(module, prefix) for prefix in allowed):
            raise TypeError(
                '"{}" is outside the allowed block import paths.'.format(path)
            )
        __import__(module)
        klass = getattr(sys.modules[module], name, None)
        if isinstance(klass, type) and issubclass(klass, Block):
            return klass
        raise TypeError('"{}" is not a valid Block.'.format(path))

    @classmethod
    def from_json(cls, val, **kwargs):
        return cls.deserialize(json.loads(val, **kwargs))

    def to_json(self, **kwargs):
        kwargs.setdefault("cls", _BlockArgsEncoder)
        return json.dumps(self.serialize(), **kwargs)

    def serialize(self):
        graph, name = self.get_graph(serialize=True)
        return {"version": self.JSON_VERSION, "graph": graph, "name": name}

    @classmethod
    def deserialize(cls, val):
        version = val.get("version")
        if version is not None and version > cls.JSON_VERSION:
            logger.warning(
                "Deserializing a version %s graph with a version %s runtime",
                version,
                cls.JSON_VERSION,
            )
        return construct(val["graph"], val["name"])

    def __repr__(self):
        return "{}({})".format(
            type(self).__name__, ", ".join(repr(x) for x in self.args)
        )


class _BlockArgsEncoder(json.JSONEncoder):
    """JSON encoder for common Block argument types: arrays as nested
    lists (constructors coerce them again), numpy scalars as Python
    numbers, datetimes as ISO strings and timedeltas as seconds."""

    def default(self, o):
        import datetime

        import numpy as np

        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, np.generic):
            return o.item()
        if isinstance(o, datetime.datetime):
            return o.isoformat()
        if isinstance(o, datetime.timedelta):
            return o.total_seconds()
        return super().default(o)
