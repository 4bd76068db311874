"""GeoSeries and GeoDataFrame: columnar feature tables without pandas.

Counterpart of dask_geomodeling_tpu/geo/features.py, whose classes are
pandas subclasses.  The port runs where pandas is not installed (the card
machine has none), so its frame is its own: numpy columns (one 1-D array
each, an object array where cells are geometries or lists), an ``Index``
(values and a name), a ``crs`` and the name of the active geometry
column.  Rows are selected by position (``iloc``) or by a boolean mask,
never by label, and a column assigned from another frame's series takes
its values in order: every frame of a request shares one index.

It holds what the ported blocks ask of a frame (geometry sources,
Rasterize, AggregateRaster), and no more: ``len``, ``copy``, ``columns``,
column get and set (a list of lists makes one list cell per row, the
multiband output of AggregateRaster), ``name in frame``, ``values``,
``iloc``, ``index`` with ``name`` and ``to_series()``, ``set_index``,
``set_geometry``, ``to_crs`` and ``total_bounds``; on the series,
``bounds``, ``centroid``, ``x``, ``y``, ``intersects``, ``within`` (the
in-memory source's centroid mode) and ``is_empty``.
"""
import numpy as np

from dask_geomodeling_tpu_torch.geo import geometry as geom_mod
from dask_geomodeling_tpu_torch.geo.crs import get_projection, get_transform_func

__all__ = ["Index", "Series", "GeoSeries", "GeoDataFrame"]


def _objects(items):
    """A 1-D object array holding ``items`` as they are (numpy would
    unpack geometries, lists and arrays into more dimensions)."""
    items = list(items)
    out = np.empty(len(items), dtype=object)
    for i, item in enumerate(items):
        out[i] = item
    return out


def _as_column(values, length=None):
    """A column's values as a 1-D array: a scalar is repeated ``length``
    times, a list holding lists, arrays, geometries or strings becomes an
    object array of those cells."""
    if isinstance(values, (Series, Index)):
        return values.values
    if isinstance(values, np.ndarray):
        return values if values.ndim == 1 else _objects(values)
    if values is None or np.isscalar(values):
        if isinstance(values, str) or values is None:
            return _objects([values] * (length or 0))
        return np.full(length or 0, values)
    values = list(values)
    if any(not np.isscalar(v) or isinstance(v, str) for v in values if v is not None):
        return _objects(values)
    if any(v is None for v in values):
        return np.array([np.nan if v is None else v for v in values], dtype=float)
    return np.asarray(values)


def _row_selector(key, length):
    """Positions (or a boolean mask) of the rows ``key`` selects."""
    if isinstance(key, Series):
        key = key.values
    key = np.asarray(key) if not isinstance(key, slice) else key
    if isinstance(key, np.ndarray):
        if key.dtype == bool:
            if len(key) != length:
                raise IndexError("boolean mask of %d for %d rows" % (len(key), length))
        elif key.size and key.dtype.kind not in "iu":
            raise IndexError("rows are selected by position or by a boolean mask")
        else:
            key = key.astype(np.intp)
    return key


class Index:
    """The labels of a frame's rows, with a ``name``."""

    def __init__(self, values, name=None):
        self.values = np.asarray(values) if not isinstance(values, np.ndarray) else values
        self.name = name

    def __len__(self):
        return len(self.values)

    def __iter__(self):
        return iter(self.values)

    def __getitem__(self, key):
        return Index(self.values[key], self.name)

    def to_series(self):
        """A series of the labels, indexed by them (pandas' to_series)."""
        return Series(self.values.copy(), index=self, name=self.name)

    def __repr__(self):
        return "Index(%r, name=%r)" % (self.values.tolist(), self.name)


def _default_index(length):
    return Index(np.arange(length, dtype=np.int64))


class _ILoc:
    def __init__(self, owner):
        self.owner = owner

    def __getitem__(self, key):
        return self.owner._take(key)


class Series:
    """One column: a 1-D numpy array, an ``Index`` and a ``name``."""

    def __init__(self, values, index=None, name=None):
        self.values = _as_column(values)
        self.index = _default_index(len(self.values)) if index is None else index
        self.name = name

    def _new(self, values, index):
        return Series(values, index=index, name=self.name)

    @property
    def dtype(self):
        return self.values.dtype

    def __len__(self):
        return len(self.values)

    def __iter__(self):
        return iter(self.values)

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.values, dtype=dtype)

    def __getitem__(self, key):
        """Rows by a boolean mask (a series or an array)."""
        return self._take(key)

    def _take(self, key):
        if np.isscalar(key):
            return self.values[key]
        key = _row_selector(key, len(self))
        return self._new(self.values[key], self.index[key])

    @property
    def iloc(self):
        return _ILoc(self)

    def astype(self, dtype):
        return self._new(self.values.astype(dtype), self.index)

    def tolist(self):
        return self.values.tolist()

    def __repr__(self):
        return "Series(%r, name=%r)" % (self.values.tolist(), self.name)


class GeoSeries(Series):
    """A series of geometries (an object array) with a ``crs``."""

    def __init__(self, data=None, index=None, crs=None, name=None):
        if isinstance(data, Series):
            index = data.index if index is None else index
            name = data.name if name is None else name
            crs = getattr(data, "crs", None) if crs is None else crs
            data = data.values
        super().__init__(_objects([] if data is None else data), index=index, name=name)
        self.crs = crs

    def _new(self, values, index):
        return GeoSeries(values, index=index, crs=self.crs, name=self.name)

    def _map(self, func, dtype):
        if dtype is object:
            return _objects([None if g is None else func(g) for g in self.values])
        fill = False if dtype is bool else np.nan
        return np.array([fill if g is None else func(g) for g in self.values], dtype=dtype)

    # predicates
    def intersects(self, other):
        return Series(self._map(lambda g: bool(g.intersects(other)), bool), self.index)

    def within(self, other):
        return Series(self._map(lambda g: bool(g.within(other)), bool), self.index)

    @property
    def is_empty(self):
        return Series(self._map(lambda g: bool(g.is_empty), bool), self.index)

    # measures
    @property
    def centroid(self):
        return GeoSeries(self._map(lambda g: g.centroid, object), self.index, crs=self.crs)

    @property
    def x(self):
        return Series(self._map(lambda g: float(g.x), float), self.index)

    @property
    def y(self):
        return Series(self._map(lambda g: float(g.y), float), self.index)

    @property
    def bounds(self):
        """A frame of minx, miny, maxx and maxy; NaN for empty geometries."""
        rows = np.array(
            [(np.nan,) * 4 if g is None or g.is_empty else g.bounds for g in self.values],
            dtype=float,
        ).reshape(len(self), 4)
        return GeoDataFrame(
            {name: rows[:, i] for i, name in enumerate(("minx", "miny", "maxx", "maxy"))},
            index=self.index,
        )

    @property
    def total_bounds(self):
        b = self.bounds.values
        with np.errstate(invalid="ignore"):
            return np.array([np.nanmin(b[:, 0]), np.nanmin(b[:, 1]),
                             np.nanmax(b[:, 2]), np.nanmax(b[:, 3])])

    def to_crs(self, crs):
        """All geometries transformed to another CRS."""
        if self.crs is None:
            raise ValueError("Cannot transform naive geometries (no crs set)")
        src = get_projection(self.crs)
        dst = get_projection(crs)
        if src.upper() == dst.upper():
            return GeoSeries(self.values.copy(), index=self.index, crs=dst, name=self.name)
        func = get_transform_func(src, dst)
        return GeoSeries(
            self._map(lambda g: geom_mod.transform(func, g), object),
            index=self.index, crs=dst, name=self.name,
        )


class GeoDataFrame:
    """Numpy columns with an index, a ``crs`` and an active geometry column.

    ``data`` is None or empty (no rows and no columns), a dict of columns,
    or another frame (copied); ``geometry`` (a sequence of geometries) adds
    a "geometry" column and makes it the active one.
    """

    def __init__(self, data=None, geometry=None, crs=None, index=None):
        self._columns = {}
        self._geometry_column_name = None
        self.crs = crs
        length = 0
        if isinstance(data, GeoDataFrame):
            self._columns = {k: v.copy() for k, v in data._columns.items()}
            self._geometry_column_name = data._geometry_column_name
            self.crs = data.crs if crs is None else crs
            index = data.index if index is None else index
            length = len(data)
        elif isinstance(data, dict):
            for key, values in data.items():
                self._columns[key] = _as_column(values)
            length = len(next(iter(self._columns.values()))) if self._columns else 0
        elif data is not None and len(data):
            raise TypeError("a frame is built from a dict of columns or from records")
        if geometry is not None:
            if isinstance(geometry, str):
                self._geometry_column_name = geometry
            else:
                geometry = GeoSeries(geometry)
                if self.crs is None:
                    self.crs = geometry.crs
                if not self._columns:
                    length = len(geometry)
                    index = geometry.index if index is None else index
                self._columns["geometry"] = geometry.values
                self._geometry_column_name = "geometry"
        elif self._geometry_column_name is None and "geometry" in self._columns:
            self._geometry_column_name = "geometry"
        self.index = _default_index(length) if index is None else index

    @classmethod
    def from_records(cls, records):
        """A frame of one row per record (a dict), one column per key in
        the order the keys first appear (pandas' DataFrame.from_records)."""
        records = list(records)
        keys = []
        for record in records:
            keys += [k for k in record if k not in keys]
        return cls({k: _as_column([r.get(k) for r in records]) for k in keys})

    # --- shape and columns ---

    def __len__(self):
        return len(self.index)

    @property
    def columns(self):
        return list(self._columns)

    def __contains__(self, name):
        return name in self._columns

    @property
    def values(self):
        """The columns side by side, (rows, columns)."""
        if not self._columns:
            return np.empty((len(self), 0))
        return np.column_stack([self._columns[k] for k in self._columns])

    def copy(self):
        return GeoDataFrame(self)

    def _column(self, name):
        values = self._columns[name]
        if name == self._geometry_column_name:
            return GeoSeries(values, index=self.index, crs=self.crs, name=name)
        return Series(values, index=self.index, name=name)

    def __getitem__(self, key):
        """A column by name, or the rows of a boolean mask."""
        if isinstance(key, str):
            if key not in self._columns:
                raise KeyError(key)
            return self._column(key)
        return self._take(key)

    def __setitem__(self, name, value):
        if isinstance(value, Series) and len(value) != len(self):
            raise ValueError("a column of %d for %d rows" % (len(value), len(self)))
        values = _as_column(value, len(self))
        if len(values) != len(self):
            raise ValueError("a column of %d for %d rows" % (len(values), len(self)))
        self._columns[name] = values

    # --- rows ---

    def _take(self, key):
        key = _row_selector(key, len(self))
        if isinstance(key, np.integer) or np.isscalar(key) or getattr(key, "ndim", 1) == 0:
            position = int(key)
            return {k: v[position] for k, v in self._columns.items()}
        frame = GeoDataFrame(crs=self.crs)
        frame._columns = {k: v[key] for k, v in self._columns.items()}
        frame._geometry_column_name = self._geometry_column_name
        frame.index = self.index[key]
        return frame

    @property
    def iloc(self):
        """Rows by position: an int gives a dict of the row's cells, a
        list, array or slice gives a frame."""
        return _ILoc(self)

    def set_index(self, name, inplace=False):
        frame = self if inplace else self.copy()
        frame.index = Index(frame._columns.pop(name), name)
        if not inplace:
            return frame

    # --- geometry ---

    @property
    def geometry(self):
        name = self._geometry_column_name or "geometry"
        if name not in self._columns:
            raise AttributeError("No geometry column set")
        return GeoSeries(self._columns[name], index=self.index, crs=self.crs, name=name)

    def set_geometry(self, col, crs=None, inplace=False):
        frame = self if inplace else self.copy()
        if isinstance(col, str):
            frame._geometry_column_name = col
        else:
            series = GeoSeries(col)
            if not frame._columns and not len(frame):
                frame.index = _default_index(len(series))
            frame["geometry"] = series.values
            frame._geometry_column_name = "geometry"
            crs = crs or series.crs
        if crs is not None:
            frame.crs = crs
        if not inplace:
            return frame

    def to_crs(self, crs):
        frame = self.copy()
        name = self._geometry_column_name or "geometry"
        frame._columns[name] = self.geometry.to_crs(crs).values
        frame.crs = get_projection(crs)
        frame._geometry_column_name = name
        return frame

    @property
    def total_bounds(self):
        return self.geometry.total_bounds

    def __repr__(self):
        return "GeoDataFrame(%d rows, columns=%r, crs=%r)" % (len(self), self.columns, self.crs)
