"""GeoSeries and GeoDataFrame: columnar feature tables without pandas.

Counterpart of dask_geomodeling_tpu/geo/features.py, whose classes are
pandas subclasses.  The port runs where pandas is not installed (the card
machine has none), so its frame is its own: numpy columns (one 1-D array
each, an object array where cells are geometries, strings or lists), an
``Index`` (values and a name), a ``crs`` and the name of the active
geometry column.

It holds what the ported blocks ask of a frame, with pandas 3's answers:

- rows by position (``iloc``) or by a boolean mask; ``len``, ``copy``,
  ``columns``, ``name in frame``, ``values``, ``set_index``,
  ``iterrows`` (cells as Python scalars, as pandas gives them for a frame
  that holds geometries), ``set_geometry``, ``to_crs``, ``total_bounds``
  and ``concat``;
- columns aligned by index label, as pandas aligns them: a series
  assigned to a frame, and the operands of an arithmetic or logic
  operation, whose indexes differ are reindexed (NaN where a label is
  missing; the union of both indexes, sorted, for an operation); a
  comparison of series whose indexes differ raises, as in pandas;
- on a series: arithmetic, comparison and logic operators (NaN and None
  are missing: a comparison with a missing value is False but for ``!=``;
  an integer division or modulo by zero gives pandas' inf and NaN),
  ``isna``, ``all``, ``round`` (numpy's half to even), ``map``, ``where``,
  ``mask``, ``reindex`` and item assignment by a mask;
- on a geometry series: ``area``, ``bounds``, ``centroid``, ``x``, ``y``,
  ``intersects``, ``within``, ``is_empty``, ``isnull``, ``to_crs``, a
  settable ``crs``, and the operations ``buffer``, ``simplify``,
  ``intersection`` and ``difference``;
- ``merge`` of two frames on their indexes, as pandas' ``merge`` with
  ``left_index=True, right_index=True`` answers it.

Column types follow pandas' inference from records (and from a list,
which infers alike): numbers with None (or NaN with None) become float64
with NaN, strings with None keep NaN for the missing ones
(pandas 3's ``str`` dtype), bools with None and all-None columns stay
object columns of the values.  Strings are held in object arrays.
"""
import operator

import numpy as np

from dask_geomodeling_tpu_torch.geo import geometry as geom_mod
from dask_geomodeling_tpu_torch.geo.crs import get_projection, get_transform_func

__all__ = ["Index", "Series", "GeoSeries", "GeoDataFrame", "concat", "merge", "is_null"]


def _objects(items):
    """A 1-D object array holding ``items`` as they are (numpy would
    unpack geometries, lists and arrays into more dimensions)."""
    items = list(items)
    out = np.empty(len(items), dtype=object)
    for i, item in enumerate(items):
        out[i] = item
    return out


def is_null(value):
    """pandas' ``isna`` of one cell: None, a float NaN or a NaT."""
    if value is None:
        return True
    if isinstance(value, (float, np.floating)):
        return value != value
    if isinstance(value, (np.datetime64, np.timedelta64)):
        return bool(np.isnat(value))
    return False


def _is_number(value):
    return isinstance(value, (int, float, np.integer, np.floating)) and not isinstance(
        value, (bool, np.bool_)
    )


def _infer(values):
    """A column from a list of cells, typed as pandas infers a column of
    records: numbers (with None as NaN) float64 unless all are integers
    (int64, or uint64 where one is past int64 and all fit it),
    bools bool, strings with None a string column with NaN missing, dates
    datetime64[us] (None as NaT), anything else (or a mix) an object
    column of the cells as they are."""
    present = [v for v in values if not is_null(v)]
    if not present:
        if any(isinstance(v, (float, np.floating)) for v in values) and all(
                v is None or isinstance(v, (float, np.floating)) for v in values):
            return np.array([np.nan if v is None else v for v in values], dtype=float)
        return _objects(values)
    if all(isinstance(v, (bool, np.bool_)) for v in present):
        return np.array(values, dtype=bool) if len(present) == len(values) else _objects(values)
    if all(_is_number(v) for v in present):
        if len(present) == len(values) and all(
            isinstance(v, (int, np.integer)) for v in present
        ):
            # past int64: uint64 where every value fits it, else the cells
            if all(-2**63 <= v < 2**63 for v in present):
                return np.array(values, dtype=np.int64)
            if all(0 <= v < 2**64 for v in present):
                return np.array(values, dtype=np.uint64)
            return _objects(values)
        return np.array([np.nan if v is None else v for v in values], dtype=float)
    if all(isinstance(v, str) for v in present):
        return _objects([np.nan if is_null(v) else v for v in values])
    if all(isinstance(v, np.datetime64) for v in present):
        return np.array([np.datetime64("NaT") if v is None else v for v in values],
                        dtype="datetime64[us]")
    return _objects(values)


def _as_column(values, length=None):
    """A column's values as a 1-D array: a scalar is repeated ``length``
    times, a list is typed as pandas types a column of records
    (``_infer``); a list holding lists, arrays or geometries becomes an
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
    if any(not np.isscalar(v) and v is not None for v in values):
        return _objects(values)
    return _infer(values)


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

    @property
    def is_unique(self):
        return len(set(self.values.tolist())) == len(self.values)

    def equals(self, other):
        """The same labels in the same order (pandas' Index.equals)."""
        if self is other or self.values is other.values:
            return True
        return len(self) == len(other) and bool(
            np.all(self.values == other.values)
            if self.values.dtype != object and other.values.dtype != object
            else self.values.tolist() == other.values.tolist()
        )

    def tolist(self):
        return self.values.tolist()

    def to_series(self):
        """A series of the labels, indexed by them (pandas' to_series)."""
        return Series(self.values.copy(), index=self, name=self.name)

    def __repr__(self):
        return "Index(%r, name=%r)" % (self.values.tolist(), self.name)


def _default_index(length):
    return Index(np.arange(length, dtype=np.int64))


def _union_labels(a, b):
    """The labels of an outer join of two indexes, sorted as pandas sorts
    a union (numbers, then strings, where they do not compare)."""
    labels = list(dict.fromkeys(a.values.tolist() + b.values.tolist()))
    try:
        labels = sorted(labels)
    except TypeError:
        labels = sorted(labels, key=lambda v: (isinstance(v, str), v))
    values = np.asarray(labels) if labels and not any(isinstance(v, str) for v in labels) \
        else _objects(labels)
    return Index(values)


def _missing_fill(values):
    """``values`` as a column that can hold NaN: integers become float64,
    bools object; floats and objects stay."""
    if values.dtype.kind in "iu":
        return values.astype(float)
    if values.dtype.kind == "b":
        return values.astype(object)
    return values


def _reindexed(values, index, target):
    """``values`` (labelled by ``index``) at the labels of ``target``,
    NaN where a label is missing."""
    if index.equals(target):
        return values
    positions = {}
    for i, label in enumerate(index.values.tolist()):
        if label in positions:
            raise ValueError("cannot reindex on an axis with duplicate labels")
        positions[label] = i
    take = np.array([positions.get(label, -1) for label in target.values.tolist()],
                    dtype=np.intp)
    missing = take < 0
    if not missing.any():
        return values[take]
    out = _missing_fill(values)[np.where(missing, 0, take)].copy() if len(values) \
        else np.full(len(take), np.nan)
    out[missing] = np.nan
    return out


def _aligned(left, right):
    """(index, left values, right values) of two operands; a scalar right
    operand stays as it is."""
    if not isinstance(right, Series):
        return left.index, left.values, right
    if left.index.equals(right.index):
        return left.index, left.values, right.values
    index = _union_labels(left.index, right.index)
    return (index, _reindexed(left.values, left.index, index),
            _reindexed(right.values, right.index, index))


_COMPARISONS = {operator.eq, operator.ne, operator.lt, operator.le, operator.gt, operator.ge}
_LOGIC = {operator.and_, operator.or_, operator.xor}


def _null_mask(values):
    if isinstance(values, np.ndarray):
        if values.dtype.kind in "fc":
            return np.isnan(values)
        if values.dtype == object:
            return np.fromiter((is_null(v) for v in values), bool, len(values))
        return np.zeros(len(values), bool)
    return np.bool_(is_null(values))


def _compare_objects(op, a, b):
    """pandas' comparison of object cells: a missing cell compares False
    (True for ``!=``)."""
    n = len(a) if isinstance(a, np.ndarray) else len(b)
    left = a if isinstance(a, np.ndarray) else [a] * n
    right = b if isinstance(b, np.ndarray) else [b] * n
    out = np.empty(n, dtype=bool)
    for i, (x, y) in enumerate(zip(left, right)):
        if is_null(x) or is_null(y):
            out[i] = op is operator.ne
        else:
            out[i] = bool(op(x, y))
    return out


def _logic_objects(op, a, b):
    """pandas' logic on object cells: a missing cell counts as False."""
    def as_bool(values):
        if isinstance(values, np.ndarray):
            return np.array([False if is_null(v) else bool(v) for v in values], dtype=bool)
        return False if is_null(values) else bool(values)

    return op(as_bool(a), as_bool(b))


def _arith_objects(op, a, b):
    """Arithmetic on object cells: NaN where either cell is missing."""
    n = len(a) if isinstance(a, np.ndarray) else len(b)
    left = a if isinstance(a, np.ndarray) else [a] * n
    right = b if isinstance(b, np.ndarray) else [b] * n
    out = np.empty(n, dtype=object)
    for i, (x, y) in enumerate(zip(left, right)):
        out[i] = np.nan if is_null(x) or is_null(y) else op(x, y)
    return out


def _integer_division_fill(op, a, b, result):
    """pandas' answers of an integer ``//`` or ``%`` by zero: x // 0 is
    +-inf (0 // 0 NaN) and x % 0 NaN, in a float64 result."""
    divisor = np.broadcast_to(np.asarray(b), np.shape(result))
    zero = divisor == 0
    if not zero.any():
        return result
    dividend = np.broadcast_to(np.asarray(a), np.shape(result))
    out = result.astype(float)
    if op is operator.floordiv:
        with np.errstate(invalid="ignore"):
            fill = np.sign(dividend[zero]) * np.inf
        fill[dividend[zero] == 0] = np.nan
        out[zero] = fill
    else:
        out[zero] = np.nan
    return out


def _binary_values(op, a, b):
    """``op`` over aligned values (arrays or a scalar) as pandas computes it."""
    objects = any(isinstance(v, np.ndarray) and v.dtype == object for v in (a, b)) or any(
        isinstance(v, str) or v is None for v in (a, b)
    )
    if op in _COMPARISONS:
        if objects:
            return _compare_objects(op, a, b)
        with np.errstate(invalid="ignore"):
            return np.asarray(op(a, b), dtype=bool)
    if op in _LOGIC:
        if objects or any(isinstance(v, float) or (isinstance(v, np.ndarray) and v.dtype.kind == "f")
                          for v in (a, b)):
            return _logic_objects(op, a, b)
        return op(a, b)
    if objects:
        return _arith_objects(op, a, b)
    with np.errstate(all="ignore"):
        result = op(a, b)
    if op in (operator.floordiv, operator.mod) and np.asarray(result).dtype.kind in "iu":
        result = _integer_division_fill(op, a, b, result)
    return result


def _binary(op):
    def method(self, other):
        if isinstance(other, Series):
            if op in _COMPARISONS and not self.index.equals(other.index):
                raise ValueError("Can only compare identically-labeled Series objects")
            index, a, b = _aligned(self, other)
        else:
            index, a, b = self.index, self.values, other
        return Series(_binary_values(op, a, b), index=index,
                      name=self.name if not isinstance(other, Series) or other.name == self.name
                      else None)

    return method


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

    def __setitem__(self, key, value):
        """Cells by a boolean mask (or positions) set to ``value``; an
        integer or bool column that cannot hold it is widened first."""
        key = _row_selector(key, len(self))
        if isinstance(value, Series):
            value = value.values[key]
        if self.values.dtype.kind in "iub" and value is not None and np.size(value) and (
            np.result_type(self.values, np.asarray(value)) != self.values.dtype
        ):
            self.values = self.values.astype(np.result_type(self.values, np.asarray(value)))
        self.values[key] = value

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

    def copy(self):
        return self._new(self.values.copy(), self.index)

    def tolist(self):
        return self.values.tolist()

    def to_numpy(self):
        return self.values

    # --- missing values ---

    def isna(self):
        return Series(_null_mask(self.values), index=self.index, name=self.name)

    def all(self):
        return bool(np.all(self.values))

    # --- alignment and element-wise methods ---

    def reindex(self, index):
        """The values at the labels of ``index``; NaN where one is missing."""
        return self._new(_reindexed(self.values, self.index, index), index)

    def round(self, decimals=0, out=None):
        """numpy's ``around`` (half to even, in the column's dtype); what
        ``np.around(series)`` calls."""
        return self._new(np.around(self.values, decimals), self.index)

    def map(self, func):
        """``func`` of every cell, the result typed as pandas infers it."""
        return self._new(_infer([func(v) for v in self.values.tolist()]), self.index)

    def where(self, cond, other=np.nan):
        """Keep the cells where ``cond`` holds, ``other`` elsewhere (both
        aligned to this series by label; a missing condition is False)."""
        return self._replace(~self._condition(cond), other)

    def mask(self, cond, other=np.nan):
        """Replace the cells where ``cond`` holds by ``other``."""
        return self._replace(self._condition(cond), other)

    def _condition(self, cond):
        if isinstance(cond, Series):
            values = _reindexed(cond.values, cond.index, self.index)
        else:
            values = np.asarray(cond)
        if values.dtype != bool:
            values = np.array([False if is_null(v) else bool(v) for v in values], dtype=bool)
        return values

    def _replace(self, replace, other):
        if not replace.any():
            return self.copy()
        if isinstance(other, Series):
            other = _reindexed(other.values, other.index, self.index)
        values = self.values
        if values.dtype.kind in "iu" and np.ndim(other) == 0 and _is_number(other) and (
            float(other) == int(other) if np.isfinite(float(other)) else False
        ):
            other = values.dtype.type(other)  # pandas keeps integers that hold it
        if values.dtype == object or (isinstance(other, np.ndarray) and other.dtype == object) \
                or isinstance(other, str) or other is None:
            out = values.astype(object)
            out[replace] = other[replace] if isinstance(other, np.ndarray) else other
        else:
            out = np.where(replace, other, values)
        return self._new(out, self.index)

    # the field operations call these with the series on the left
    __add__ = _binary(operator.add)
    __sub__ = _binary(operator.sub)
    __mul__ = _binary(operator.mul)
    __truediv__ = _binary(operator.truediv)
    __floordiv__ = _binary(operator.floordiv)
    __mod__ = _binary(operator.mod)
    __pow__ = _binary(operator.pow)
    __eq__ = _binary(operator.eq)
    __ne__ = _binary(operator.ne)
    __lt__ = _binary(operator.lt)
    __le__ = _binary(operator.le)
    __gt__ = _binary(operator.gt)
    __ge__ = _binary(operator.ge)
    __and__ = _binary(operator.and_)
    __or__ = _binary(operator.or_)
    __xor__ = _binary(operator.xor)
    __hash__ = None

    def __invert__(self):
        return self._new(~self.values, self.index)

    def __repr__(self):
        return "Series(%r, name=%r)" % (self.values.tolist(), self.name)


#: a label a series holds more than once (pandas' ``get`` gives a series)
_MANY = object()


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
    def area(self):
        return Series(self._map(lambda g: float(g.area), float), self.index)

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

    def isnull(self):
        """The JAX package's ``GeoSeries.isnull``: None or an empty
        geometry (a NaN cell is not null there)."""
        return Series(np.array([g is None or (hasattr(g, "is_empty") and g.is_empty)
                                for g in self.values], dtype=bool), self.index)

    # operations
    def _geometries(self, func):
        return GeoSeries(self._map(func, object), index=self.index, crs=self.crs)

    def buffer(self, distance, resolution=16):
        return self._geometries(lambda g: g.buffer(distance, resolution))

    def simplify(self, tolerance, preserve_topology=True):
        return self._geometries(lambda g: g.simplify(tolerance))

    def intersection(self, other):
        return self._geometries(lambda g: g.intersection(other))

    def difference(self, other):
        """Element-wise difference with a series aligned by label, or with
        one geometry.  By label, as the JAX package's pandas ``get`` finds
        it: a geometry whose label ``other`` lacks, or holds more than
        once, stays as it is."""
        if not isinstance(other, Series):
            return self._geometries(lambda g: g.difference(other))
        found = {}
        for label, value in zip(other.index.values.tolist(), other.values):
            found[label] = _MANY if label in found else value
        result = []
        for label, g in zip(self.index.values.tolist(), self.values):
            value = found.get(label)
            if g is None or value is None or value is _MANY:
                result.append(g)
            else:
                result.append(g.difference(value))
        return GeoSeries(result, index=self.index, crs=self.crs)

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
    a "geometry" column and makes it the active one.  ``index`` alone
    makes a frame of that many rows and no columns.
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
        if index is not None and not self._columns:
            length = len(index)
        if geometry is not None:
            if isinstance(geometry, str):
                self._geometry_column_name = geometry
            else:
                geometry = GeoSeries(geometry)
                if self.crs is None:
                    self.crs = geometry.crs
                if not self._columns and index is None:
                    length = len(geometry)
                    index = geometry.index
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
        """A column by name, the columns of a list of names, or the rows
        of a boolean mask."""
        if isinstance(key, str):
            if key not in self._columns:
                raise KeyError(key)
            return self._column(key)
        if isinstance(key, list) and all(isinstance(k, str) for k in key) and key:
            missing = [k for k in key if k not in self._columns]
            if missing:
                raise KeyError(missing)
            frame = GeoDataFrame(index=self.index, crs=self.crs)
            frame._columns = {k: self._columns[k] for k in key}
            return frame
        return self._take(key)

    def __setitem__(self, name, value):
        """A column: a series is aligned to the frame's index by label
        (NaN where a label is missing), anything else taken in order."""
        if isinstance(value, Series):
            values = _reindexed(value.values, value.index, self.index)
        else:
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

    def iterrows(self):
        """(label, {column: cell}) per row, the cells as Python scalars
        where they are numbers, as pandas' iterrows gives them for a frame
        that holds an object column."""
        labels = self.index.values.tolist()
        columns = {
            k: (v.astype("datetime64[us]") if v.dtype.kind == "M" else v).tolist()
            for k, v in self._columns.items()
        }
        for i, label in enumerate(labels):
            yield label, {k: cells[i] for k, cells in columns.items()}

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


def _concat_columns(parts):
    """One column from the parts of the frames, typed as pandas' concat
    types it: one dtype stays, numbers of several dtypes widen (integers
    and floats to a float, bools with numbers to object), anything else
    becomes an object column."""
    kinds = {p.dtype.kind for p in parts}
    if len({p.dtype for p in parts}) == 1:
        return np.concatenate(parts)
    if kinds <= set("iuf") or kinds <= set("iu"):
        return np.concatenate(parts).astype(np.result_type(*parts))
    return np.concatenate([p.astype(object) for p in parts])


def concat(frames):
    """The rows of ``frames`` one after another (pandas' concat): the
    indexes concatenated (the name kept where all agree), the columns in
    order of first appearance, a column a frame lacks NaN there; the crs
    and the geometry column of the first frame."""
    frames = list(frames)
    if not frames:
        raise ValueError("No objects to concatenate")
    names = []
    for frame in frames:
        names += [k for k in frame.columns if k not in names]
    columns = {}
    for name in names:
        parts = []
        for frame in frames:
            if name in frame._columns:
                parts.append(frame._columns[name])
            else:
                parts.append(np.full(len(frame), np.nan))
        if any(name not in frame._columns for frame in frames):
            parts = [_missing_fill(p) for p in parts]
        columns[name] = _concat_columns(parts)
    index_names = {frame.index.name for frame in frames}
    labels = [frame.index.values for frame in frames]
    index = Index(
        _concat_columns(labels) if labels else np.empty(0, np.int64),
        index_names.pop() if len(index_names) == 1 else None,
    )
    out = GeoDataFrame(index=index, crs=frames[0].crs)
    out._columns = columns
    out._geometry_column_name = frames[0]._geometry_column_name
    return out


def _sorted_labels(labels):
    """Labels in pandas' sort order (numbers, then strings, where they do
    not compare)."""
    try:
        return sorted(labels)
    except TypeError:
        return sorted(labels, key=lambda v: (isinstance(v, str), v))


def _monotonic(keys):
    try:
        return all(a <= b for a, b in zip(keys, keys[1:]))
    except TypeError:
        return False


def _stable_argsort(codes):
    return np.argsort(np.asarray(codes, dtype=np.intp), kind="stable")


def _inner_non_unique(lkeys, rkeys, right_first):
    """pandas' ``libjoin.inner_join(..., sort=False)`` over keys coded in
    order of first appearance (the right's first where ``right_first``,
    as ``_factorize_keys`` codes numbers): the pairs by code, then put
    back in the left's order, where pandas takes a short cut when the
    pairs are as many as the left's rows, and that short cut orders them
    by the left's sort order instead."""
    codes = {}
    for key in (rkeys + lkeys if right_first else lkeys + rkeys):
        codes.setdefault(key, len(codes))
    llab = [codes[k] for k in lkeys]
    rlab = [codes[k] for k in rkeys]
    left_sorter, right_sorter = _stable_argsort(llab), _stable_argsort(rlab)
    lcount = np.bincount(llab, minlength=len(codes)) if llab else np.zeros(len(codes), int)
    rcount = np.bincount(rlab, minlength=len(codes)) if rlab else np.zeros(len(codes), int)
    pairs, lpos, rpos = [], 0, 0
    for code in range(len(codes)):
        lc, rc = int(lcount[code]), int(rcount[code])
        if lc and rc:
            pairs += [(left_sorter[lpos + j], right_sorter[rpos + k])
                      for j in range(lc) for k in range(rc)]
        lpos += lc
        rpos += rc
    if not pairs:
        return np.empty(0, np.intp), np.empty(0, np.intp)
    li, ri = (np.array(p, dtype=np.intp) for p in zip(*pairs))
    if len(lkeys) == len(li):
        rev = np.empty(len(lkeys), np.intp)
        rev[left_sorter] = np.arange(len(lkeys))
    else:
        rev = _stable_argsort(li)
    return li[rev], ri[rev]


def _join_positions(left, right, how):
    """(left positions, right positions) of the rows of pandas'
    ``Index.join(..., sort=False)`` of two indexes, -1 where a side has
    no row: "left" in the left's order, "right" in the right's, "inner"
    in the left's, "outer" by sorted label; a label on both sides more
    than once gives every pair, left-major.  An inner join whose right
    holds a label twice, of indexes that are not both sorted, follows
    pandas' ``inner_join`` (``_inner_non_unique``); an outer join with
    one side empty, its ``_join_empty``."""
    lkeys, rkeys = left.tolist(), right.tolist()
    if how == "outer" and bool(lkeys) != bool(rkeys):
        # one side empty: pandas' _join_empty sorts the other side with
        # numpy's default (unstable) argsort unless it is sorted already
        keys = left if lkeys else right
        order = np.arange(len(keys)) if _monotonic(keys.tolist()) else np.argsort(keys)
        missing = np.full(len(keys), -1, np.intp)
        return (order.astype(np.intp), missing) if lkeys else (missing, order.astype(np.intp))
    if how == "inner" and len(set(rkeys)) < len(rkeys) and lkeys and not (
            _monotonic(lkeys) and _monotonic(rkeys) and len(set(lkeys)) == len(lkeys)):
        return _inner_non_unique(lkeys, rkeys, right_first=left.dtype.kind in "iufb")
    lpos, rpos = {}, {}
    for i, key in enumerate(lkeys):
        lpos.setdefault(key, []).append(i)
    for j, key in enumerate(rkeys):
        rpos.setdefault(key, []).append(j)
    if how == "left":
        pairs = [(i, j) for i, key in enumerate(lkeys) for j in rpos.get(key, [-1])]
    elif how == "right":
        pairs = [(i, j) for j, key in enumerate(rkeys) for i in lpos.get(key, [-1])]
    elif how == "inner":
        pairs = [(i, j) for i, key in enumerate(lkeys) for j in rpos.get(key, [])]
    else:
        pairs = [(i, j) for key in _sorted_labels(set(lkeys) | set(rkeys))
                 for i in lpos.get(key, [-1]) for j in rpos.get(key, [-1])]
    if not pairs:
        return np.empty(0, np.intp), np.empty(0, np.intp)
    positions = np.array(pairs, dtype=np.intp)
    return positions[:, 0], positions[:, 1]


def _take_or_missing(values, positions):
    """``values`` at ``positions``, NaN where a position is -1 (an integer
    column becomes float64 and a bool column object there, as pandas
    fills a missing row)."""
    missing = positions < 0
    if not missing.any():
        return values[positions]
    out = _missing_fill(values)
    out = out[np.where(missing, 0, positions)] if len(values) else \
        np.empty(len(positions), out.dtype)
    if out.dtype.kind == "M":
        out[missing] = np.datetime64("NaT")
    else:
        out[missing] = np.nan
    return out


def merge(left, right, how="inner", suffixes=("_x", "_y")):
    """pandas' ``merge(left, right, how, suffixes=suffixes,
    left_index=True, right_index=True)`` of two frames: the rows as
    ``_join_positions`` gives them, the left's columns then the right's,
    a column name both hold suffixed on each side, and a row a side lacks
    filled with NaN there.  The result's index takes the labels of the
    side that has the row (the right's name for "right", else the
    left's); its active geometry column is "geometry" where it has one.
    An empty side keeps the other side's order ("outer": sorted)."""
    if how not in ("left", "right", "inner", "outer"):
        raise ValueError("how must be left, right, inner or outer, not %r" % (how,))
    shared = [name for name in left.columns if name in right._columns]
    if shared and not (suffixes[0] or suffixes[1]):
        raise ValueError("columns overlap but no suffix specified: %s" % shared)
    lvalues, rvalues = left.index.values, right.index.values
    lpos, rpos = _join_positions(lvalues, rvalues, how)
    if lvalues.dtype == object or rvalues.dtype == object:
        labels = _objects([lvalues[i] if i >= 0 else rvalues[j] for i, j in zip(lpos, rpos)])
    else:
        dtype = np.result_type(lvalues, rvalues)
        labels = np.where(lpos >= 0, lvalues.astype(dtype)[np.maximum(lpos, 0)]
                          if len(lvalues) else np.zeros(len(lpos), dtype),
                          rvalues.astype(dtype)[np.maximum(rpos, 0)]
                          if len(rvalues) else np.zeros(len(rpos), dtype))
    columns = {}
    for frame, positions, suffix in ((left, lpos, suffixes[0]), (right, rpos, suffixes[1])):
        for name, values in frame._columns.items():
            target = name + suffix if name in shared else name
            if target in columns:
                raise ValueError("suffixes %r cause duplicate columns %r" % (suffixes, target))
            columns[target] = _take_or_missing(values, positions)
    name = right.index.name if how == "right" else left.index.name
    out = GeoDataFrame(index=Index(labels, name), crs=left.crs)
    out._columns = columns
    out._geometry_column_name = "geometry" if "geometry" in columns else None
    return out
