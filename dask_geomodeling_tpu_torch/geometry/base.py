"""Base geometry block classes, and ``GeometryBlock.get_data``.

Counterpart of dask_geomodeling_tpu/geometry/base.py: a GeometryBlock
answers requests with mode 'intersects' | 'centroid' | 'extent',
returning ``{"features": GeoDataFrame, "projection": str}`` or
``{"extent": tuple_or_None, "projection": str}``; SeriesBlocks represent
single feature-property columns.  The frame is the port's pandas-free
one (geo/features.py).  The geometry plane runs on the host; only
AggregateRaster takes device tensors (its raster), through
``compute_torch``.

The series operators build the field operations
(geometry/field_operations.py) and ``to_file`` exports through the sinks
(geometry/sinks.py), as in the JAX package.
"""
from dask_geomodeling_tpu_torch.core import Block, arg, expect_instance
from dask_geomodeling_tpu_torch.geo.features import Series

__all__ = [
    "GeometryBlock",
    "SeriesBlock",
    "GetSeriesBlock",
    "SetSeriesBlock",
    "BaseSingle",
    "BaseSingleSeries",
]


class GeometryBlock(Block):
    """The base block for feature geometries.

    Required attribute: ``columns`` — the set of column names in the frame.

    Request fields: ``mode`` ('intersects'|'centroid'|'extent'),
    ``geometry`` (filter geometry), ``projection``, ``limit``, ``min_size``,
    ``start``, ``stop``, ``filters`` (Django-style property filters).
    """

    def get_data(self, device=None, **request):
        """Evaluate ``request``.  An extent request holds no pixels: it
        runs the numpy processes on the host and resolves no device, as a
        time request does (AggregateRaster asks its source for one while
        planning).  Any other request runs through ``compute_torch`` on
        ``device`` (``None``: ``geomodeling.torch-device``)."""
        from dask_geomodeling_tpu_torch.runtime.executor import compute_torch
        from dask_geomodeling_tpu_torch.runtime.host import compute_metadata

        if request.get("mode") == "extent":
            return compute_metadata(*self.get_compute_graph(**request))
        return compute_torch(*self.get_compute_graph(**request), device=device)

    def __getitem__(self, name):
        return GetSeriesBlock(self, name)

    def __setitem__(self, *args, **kwargs):
        raise NotImplementedError("Please use block.set to set a column.")

    def set(self, *args):
        # block instances are immutable: setting returns a new view
        return SetSeriesBlock(self, *args)

    def to_file(self, *args, **kwargs):
        """Export features to a file; see
        :func:`dask_geomodeling_tpu_torch.geometry.sinks.to_file`."""
        from dask_geomodeling_tpu_torch.geometry.sinks import to_file

        return to_file(self, *args, **kwargs)


def _series_operator(block_name, unary=False, const=None):
    """An operator overload building the named field-operation block
    lazily (field_operations imports this module)."""
    if unary:

        def method(self):
            import dask_geomodeling_tpu_torch.geometry as blocks

            cls = getattr(blocks, block_name)
            return cls(self) if const is None else cls(self, const)

    else:

        def method(self, other):
            import dask_geomodeling_tpu_torch.geometry as blocks

            return getattr(blocks, block_name)(self, other)

    method.__doc__ = "Build a %s block from this series." % block_name
    return method


class SeriesBlock(Block):
    """A block representing one column of a GeometryBlock."""

    __add__ = __radd__ = _series_operator("Add")
    __mul__ = __rmul__ = _series_operator("Multiply")
    __neg__ = _series_operator("Multiply", unary=True, const=-1)
    __sub__ = _series_operator("Subtract")
    __floordiv__ = _series_operator("FloorDivide")
    __mod__ = _series_operator("Modulo")
    __truediv__ = _series_operator("Divide")
    __pow__ = _series_operator("Power")
    __eq__ = _series_operator("Equal")
    __ne__ = _series_operator("NotEqual")
    __gt__ = _series_operator("Greater")
    __ge__ = _series_operator("GreaterEqual")
    __lt__ = _series_operator("Less")
    __le__ = _series_operator("LessEqual")
    __invert__ = _series_operator("Invert", unary=True)
    __and__ = _series_operator("And")
    __or__ = _series_operator("Or")
    __xor__ = _series_operator("Xor")

    __hash__ = Block.__hash__


class GetSeriesBlock(SeriesBlock):
    """Obtain a single property column from a GeometryBlock.

    Args:
      source (GeometryBlock): block with the column to load
      name (str): name of the column
    """

    def __init__(self, source, name):
        expect_instance(source, GeometryBlock, "source")
        expect_instance(name, str, "name")
        if name not in source.columns:
            raise KeyError("Column '{}' is not available".format(name))
        super().__init__(source, name)

    source = arg(0)

    @staticmethod
    def process(data, name):
        if "features" not in data or name not in data["features"].columns:
            return Series([], name=name).astype(float)
        return data["features"][name]


class SetSeriesBlock(GeometryBlock):
    """Add property columns (SeriesBlocks or constants) to a GeometryBlock.

    Args:
      source (GeometryBlock): base block
      column (str), value (SeriesBlock or constant): repeated pairs
    """

    def __init__(self, source, column, value, *args):
        expect_instance(source, GeometryBlock, "source")
        args = (column, value) + args
        if len(args) % 2 != 0:
            raise ValueError("The number of arguments should be even")
        for column in args[::2]:
            expect_instance(column, str, "column")
        super().__init__(source, *args)

    source = arg(0)

    @property
    def columns(self):
        return self.source.columns | set(self.args[1::2])

    @staticmethod
    def process(data, *col_val_pairs):
        if "features" not in data or len(data["features"]) == 0:
            return data
        features = data["features"].copy()
        for column, value in zip(col_val_pairs[::2], col_val_pairs[1::2]):
            features[column] = value
        return {"features": features, "projection": data["projection"]}


class BaseSingle(GeometryBlock):
    """Base for geometry blocks wrapping a single geometry source."""

    def __init__(self, source, *args):
        expect_instance(source, GeometryBlock, "source")
        super().__init__(source, *args)

    source = arg(0)

    @property
    def columns(self):
        return self.source.columns


class BaseSingleSeries(SeriesBlock):
    """Base for series blocks wrapping a single series source."""

    def __init__(self, source, *args):
        expect_instance(source, SeriesBlock, "source")
        super().__init__(source, *args)

    source = arg(0)
