"""Operations on non-geometry feature columns (SeriesBlocks).

Counterpart of dask_geomodeling_tpu/geometry/field_operations.py, on the
port's pandas-free series (geo/features.py), with pandas 3's answers:
element-wise algebra, pd.cut's classification (``right``, the open outer
bins with +-inf) cast to the labels' dtype as the JAX package casts it,
Where/Mask with non-boolean conditions interpreted as notnull, Interp and
Choose.  Series of one request share their index; series whose indexes
differ are aligned by label, as pandas aligns them.
"""
import operator

import numpy as np

from dask_geomodeling_tpu_torch.core import arg, expect_instance
from dask_geomodeling_tpu_torch.geo.features import Series, _objects
from dask_geomodeling_tpu_torch.geometry.base import (
    BaseSingleSeries,
    GeometryBlock,
    SeriesBlock,
)

__all__ = [
    "Classify",
    "ClassifyFromColumns",
    "Add",
    "Subtract",
    "Multiply",
    "Divide",
    "FloorDivide",
    "Power",
    "Modulo",
    "Equal",
    "NotEqual",
    "Greater",
    "GreaterEqual",
    "Less",
    "LessEqual",
    "And",
    "Or",
    "Xor",
    "Invert",
    "Where",
    "Mask",
    "Round",
    "Interp",
    "Choose",
]


def _none_to_nan(series):
    """Replace None by NaN; all-None series downcast to float."""
    if series.dtype == object:
        nones = series.isna()
        if nones.all():
            return Series(np.full(len(series), np.nan), index=series.index, name=series.name)
        series = series.copy()
        series[nones] = np.nan
    return series


def _label_array(labels):
    """``labels`` and a NaN after them, typed as pandas types
    ``pd.Series(labels + [np.nan])``: numbers float64, anything else an
    object array."""
    if all(isinstance(label, (int, float, np.integer, np.floating))
           and not isinstance(label, (bool, np.bool_)) for label in labels):
        return np.array(labels + [np.nan], dtype=float)
    return _objects(labels + [np.nan])


def _cut(series, bins, right, labels):
    """pd.cut's bin of each value (intervals closed on the right, or on
    the left with ``right=False``; the outer edges excluded), as the
    labels' dtype with NaN outside the bins and for NaN."""
    values = np.asarray(series.values, dtype=float)
    bins = np.asarray(bins, dtype=float)
    if (np.diff(bins) == 0).any():
        raise ValueError("Bin edges must be unique: %r." % bins.tolist())
    slot = np.searchsorted(bins, values, side="left" if right else "right")
    valid = (slot >= 1) & (slot <= len(bins) - 1) & ~np.isnan(values)
    lookup = _label_array(list(labels))
    return Series(lookup[np.where(valid, slot - 1, len(labels))], index=series.index,
                  name=series.name)


def _require(condition, exc, message):
    if not condition:
        raise exc(message)


def _typecheck(value, types):
    expect_instance(value, types, "value")


def _check_labels(labels, n_edges):
    _require(
        len(labels) in (n_edges - 1, n_edges + 1),
        ValueError,
        "Expected {} or {} labels, got {}".format(
            n_edges - 1, n_edges + 1, len(labels)
        ),
    )
    _require(
        len(set(labels)) == len(labels), ValueError, "Labels should be unique"
    )


class Classify(BaseSingleSeries):
    """Classify a value column into bins.

    Args:
      source (SeriesBlock): numeric data to classify
      bins (list): increasing bin edges
      labels (list): classes; length len(bins)+1 (open outer bounds) or
        len(bins)-1 (out-of-bins values become 'no data')
      right (bool): whether the right bin edge is closed (default True)
    """

    def __init__(self, source, bins, labels, right=True):
        for arg, types in ((bins, list), (labels, list), (right, bool)):
            _typecheck(arg, types)
        _require(
            np.asarray(bins).ndim == 1, TypeError,
            "'bins' must be one-dimensional",
        )
        _require(
            not (np.diff(bins) < 0).any(), ValueError,
            "'bins' must increase monotonically.",
        )
        _check_labels(labels, len(bins))
        super().__init__(source, bins, labels, right)

    bins = arg(1)
    labels = arg(2)
    right = arg(3)

    @staticmethod
    def process(series, bins, labels, right):
        series = _none_to_nan(series)
        open_bounds = len(labels) == len(bins) + 1
        if open_bounds:
            bins = np.concatenate([[-np.inf], bins, [np.inf]])
        binned = _cut(series, bins, right, labels)  # labels' dtype + NaN room
        if open_bounds:
            # ±inf input must still classify into the outer labels
            edge, fix = (-np.inf, labels[0]) if right else (np.inf, labels[-1])
            binned[series == edge] = fix
        return binned


class ClassifyFromColumns(SeriesBlock):
    """Classify a value column using per-feature bin edges from other
    columns (ordered low to high)."""

    def __init__(self, source, value_column, bin_columns, labels, right=True):
        for arg, types in (
            (source, GeometryBlock),
            (value_column, str),
            (bin_columns, list),
            (labels, list),
            (right, bool),
        ):
            _typecheck(arg, types)
        missing_columns = (set(bin_columns) | {value_column}) - source.columns
        _require(
            not missing_columns, KeyError,
            "Columns '{}' are not present".format(missing_columns),
        )
        _check_labels(labels, len(bin_columns))
        super().__init__(source, value_column, bin_columns, labels, right)

    source = arg(0)
    value_column = arg(1)
    bin_columns = arg(2)
    labels = arg(3)
    right = arg(4)

    @staticmethod
    def process(data, value_column, bin_columns, labels, right):
        features = data.get("features")
        if features is None or len(features) == 0:
            return Series(np.empty(0))
        values = _none_to_nan(features[value_column]).values
        edges = features[bin_columns].values

        # rank each value among its own row of edges
        passes = np.greater if right else np.greater_equal
        with np.errstate(invalid="ignore"):
            rank = passes(values[:, None], edges).sum(axis=1)

        nan_slot = len(labels)  # the NaN sentinel appended to the lookup
        if len(labels) == len(bin_columns) + 1:
            rank[np.isnan(values)] = nan_slot
        else:
            # closed outer intervals: below the first edge is out of range
            # (above the last lands on nan_slot by itself)
            rank = rank - 1
            rank[rank == -1] = nan_slot

        return Series(_label_array(list(labels))[rank], index=features.index)


class BaseFieldOperation(BaseSingleSeries):
    """Base for binary operations between a series and a series/constant."""

    def __init__(self, source, other):
        expect_instance(other, (SeriesBlock, int, float, bool), "other")
        super().__init__(source, other)

    other = arg(1)


class Add(BaseFieldOperation):
    """Element-wise addition."""

    process = staticmethod(operator.add)


class Subtract(BaseFieldOperation):
    """Element-wise subtraction."""

    process = staticmethod(operator.sub)


class Multiply(BaseFieldOperation):
    """Element-wise multiplication."""

    process = staticmethod(operator.mul)


class Divide(BaseFieldOperation):
    """Element-wise division."""

    process = staticmethod(operator.truediv)


class FloorDivide(BaseFieldOperation):
    """Element-wise floor division."""

    process = staticmethod(operator.floordiv)


class Power(BaseFieldOperation):
    """Element-wise exponentiation."""

    def __init__(self, source, other):
        super().__init__(source, float(other))

    process = staticmethod(operator.pow)


class Modulo(BaseFieldOperation):
    """Element-wise modulo."""

    process = staticmethod(operator.mod)


class Equal(BaseFieldOperation):
    """Element-wise equality ('no data' never equals 'no data')."""

    process = staticmethod(operator.eq)


class NotEqual(BaseFieldOperation):
    """Element-wise inequality."""

    process = staticmethod(operator.ne)


class Greater(BaseFieldOperation):
    """Element-wise greater-than."""

    process = staticmethod(operator.gt)


class GreaterEqual(BaseFieldOperation):
    """Element-wise greater-or-equal."""

    process = staticmethod(operator.ge)


class Less(BaseFieldOperation):
    """Element-wise less-than."""

    process = staticmethod(operator.lt)


class LessEqual(BaseFieldOperation):
    """Element-wise less-or-equal."""

    process = staticmethod(operator.le)


class BaseLogicOperation(BaseFieldOperation):
    """Base for logic operations; the second operand must be a series."""

    def __init__(self, source, other):
        expect_instance(other, SeriesBlock, "other")
        super().__init__(source, other)


class And(BaseLogicOperation):
    """Element-wise logical AND."""

    process = staticmethod(operator.and_)


class Or(BaseLogicOperation):
    """Element-wise logical OR."""

    process = staticmethod(operator.or_)


class Xor(BaseLogicOperation):
    """Element-wise logical XOR."""

    process = staticmethod(operator.xor)


class Invert(BaseSingleSeries):
    """Invert a boolean series."""

    process = staticmethod(operator.inv)


class Where(BaseSingleSeries):
    """Replace values where a condition is False.

    Non-boolean conditions are interpreted as notnull (all data values,
    including 0, count as True)."""

    def __init__(self, source, cond, other):
        expect_instance(cond, SeriesBlock, "cond")
        super().__init__(source, cond, other)

    cond = arg(1)
    other = arg(2)

    @staticmethod
    def process(source, cond, other):
        if cond.dtype != bool:
            cond = ~cond.isna()
        return source.where(cond, other)


class Mask(BaseSingleSeries):
    """Replace values where a condition is True (complement of Where)."""

    def __init__(self, source, cond, other):
        expect_instance(cond, SeriesBlock, "cond")
        super().__init__(source, cond, other)

    cond = arg(1)
    other = arg(2)

    @staticmethod
    def process(source, cond, other):
        if cond.dtype != bool:
            cond = ~cond.isna()
        return source.mask(cond, other)


class Round(BaseSingleSeries):
    """Round values to the given number of decimals."""

    def __init__(self, source, decimals=0):
        expect_instance(decimals, int, "decimals")
        super().__init__(source, decimals)

    process = staticmethod(np.around)


class Interp(BaseSingleSeries):
    """Piecewise-linear interpolation of the source values over (xp, fp)."""

    def __init__(self, source, xp, fp, left=None, right=None):
        knots, ordinates = (
            [float(value) for value in sequence] for sequence in (xp, fp)
        )
        if any(b < a for a, b in zip(knots, knots[1:])):
            raise ValueError("xp must be monotonically increasing")
        clamps = tuple(
            None if value is None else float(value) for value in (left, right)
        )
        super().__init__(source, knots, ordinates, *clamps)

    xp = arg(1, "interpolation knots (monotonically increasing)")
    fp = arg(2, "ordinate at each knot")

    @staticmethod
    def process(data, xp, fp, left, right):
        return Series(np.interp(data, xp, fp, left, right), index=data.index)


class Choose(BaseSingleSeries):
    """Per-feature selection from multiple series by an integer source
    (out-of-bounds indices become 'no data')."""

    def __init__(self, source, *choices):
        if not len(choices) >= 2:
            raise ValueError("The number of choices must be greater than one.")
        if not all(isinstance(choice, SeriesBlock) for choice in choices):
            raise TypeError("All choices must be SeriesBlock objects")
        super().__init__(source, *choices)

    @property
    def choices(self):
        return self.args[1:]

    @staticmethod
    def process(source, *choices):
        # one vectorized row pick instead of a per-choice masked scan:
        # align every choice to the source index, then gather rows whose
        # selector is a valid integer; everything else stays 'no data'
        table = np.empty((len(choices), len(source)), dtype=object)
        for slot, choice in enumerate(choices):
            table[slot] = choice.reindex(source.index).to_numpy()
        raw = source.to_numpy()
        if raw.dtype.kind in "iufb":
            selector = raw.astype(float)
        else:
            # object selectors: only NUMBERS select (string "1" never
            # equals 1 — the reference's masked-equality semantics)
            selector = np.array(
                [
                    float(value)
                    if isinstance(value, (int, float, np.integer, np.floating))
                    else np.nan
                    for value in raw
                ],
                dtype=float,
            )
        with np.errstate(invalid="ignore"):
            valid = (
                np.isfinite(selector)
                & (selector >= 0)
                & (selector < len(choices))
                & (selector == np.floor(selector))
            )
        picked = np.full(len(source), np.nan, dtype=object)
        rows = np.flatnonzero(valid)
        picked[rows] = table[selector[rows].astype(np.intp), rows]
        return Series(picked, index=source.index)
