"""The Block graph: lazy, immutable views and their compute graphs.

Counterpart of dask_geomodeling_tpu/core/graphs.py (``Block``, ``arg``,
``construct``).  A view answers a request in two steps: each Block
rewrites the request for its sources (``get_sources_and_requests``), and
its static ``process`` combines what they return.  The recursion gives a
compute graph ``{name_token: (process, *args)}`` whose keys are content
hashes, so shared (block, request) pairs appear once.

There is no scheduler: ``Block.get_data`` runs the graph with the port's
torch executor (runtime/executor.py) on the card unless the caller passes
``device="cpu"``, and runtime/host.py:compute_host evaluates it with the
numpy processes when asked to.
"""
import sys

from dask_geomodeling_tpu_torch.core.tokens import tokenize

__all__ = ["construct", "arg", "Block"]

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
        package (checked before anything is imported)."""
        module, name = path.rsplit(".", 1)
        if not (module == PACKAGE or module.startswith(PACKAGE + ".")):
            raise TypeError(
                '"{}" is outside the package {}.'.format(path, PACKAGE)
            )
        __import__(module)
        klass = getattr(sys.modules[module], name, None)
        if isinstance(klass, type) and issubclass(klass, Block):
            return klass
        raise TypeError('"{}" is not a valid Block.'.format(path))

    def serialize(self):
        graph, name = self.get_graph(serialize=True)
        return {"version": self.JSON_VERSION, "graph": graph, "name": name}

    @classmethod
    def deserialize(cls, val):
        return construct(val["graph"], val["name"])

    def __repr__(self):
        return "{}({})".format(
            type(self).__name__, ", ".join(repr(x) for x in self.args)
        )
