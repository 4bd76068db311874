"""The field operations and Area, held on the CPU to the JAX package.

Every case of tests/test_geometry_field_ops.py, each view built twice:
over tests/factories.py:MockGeometry with the JAX package's blocks and
over its copy ``chip_smoke.mock_geometry_class()`` with the port's.  The
port's answers (pandas-free series) must be the JAX package's pandas
answers: the same values (NaN alike), the same numeric dtype, the same
index.  Then the port's own alignment by index label against pandas, and
Area bitwise.
"""
import operator

import numpy as np
import pandas as pd
import pytest

import chip_smoke
from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu import geometry as jax_blocks
from dask_geomodeling_tpu.geo import geometry as jax_geometry
from dask_geomodeling_tpu_torch import geometry as port_blocks
from dask_geomodeling_tpu_torch.geo import geometry
from dask_geomodeling_tpu_torch.geo.features import GeoDataFrame, Series
from tests.factories import MockGeometry as JaxMockGeometry

VALUES = [-float("inf"), -2, 1.2, 5.0, float("inf"), float("nan")]
SQUARE = ((2.0, 2.0), (8.0, 2.0), (8.0, 8.0), (2.0, 8.0))


def _properties(values=VALUES):
    return [
        {
            "id": i,
            "id_value": float(i),
            "col_1": x,
            "col_2": 2 * x,
            "bool_1": x > 0,
            "bool_2": x > 2,
            "col_source": float(i * 2 + 1),
            "col_choice_1": chr(i + 65),
            "col_choice_2": chr(i + 70),
            "none": None,
        }
        for i, x in enumerate(values)
    ]


class Pair:
    """A MockGeometry source and its block namespace, in one package."""

    def __init__(self, blocks, source_class, geometry_module, properties=None,
                 polygons=None):
        properties = _properties() if properties is None else properties
        polygons = [SQUARE] * len(properties) if polygons is None else polygons
        self.G = blocks
        self.box = geometry_module.box
        self.source = source_class([list(p) for p in polygons], properties)

    def request(self, **overrides):
        return dict(dict(mode="intersects", projection="EPSG:3857",
                         geometry=self.box(0, 0, 10, 10)), **overrides)


def _pairs(**kwargs):
    return (Pair(jax_blocks, JaxMockGeometry, jax_geometry, **kwargs),
            Pair(port_blocks, chip_smoke.mock_geometry_class(), geometry, **kwargs))


def _get(pair, view, **request):
    if pair.G is jax_blocks:
        with jax_config.set({"geomodeling.executor": "numpy"}):
            return view.get_data(**pair.request(**request))
    return view.get_data(device="cpu", **pair.request(**request))


def assert_same_series(port, ref):
    """The port's series against pandas': values (NaN alike), dtype where
    pandas has a numpy one, index labels."""
    assert isinstance(port, Series)
    assert repr(port.tolist()) == repr(ref.tolist())
    if isinstance(ref.dtype, np.dtype) and ref.dtype != object:
        assert port.dtype == ref.dtype
    else:  # pandas' object or str: the port holds an object array
        assert port.dtype == object
    assert port.index.values.tolist() == ref.index.tolist()


def both(build, **request):
    """``build(G, source)`` over each package; the port's answer against
    the JAX package's."""
    jax_pair, port_pair = _pairs()
    ref = _get(jax_pair, build(jax_pair.G, jax_pair.source), **request)
    port = _get(port_pair, build(port_pair.G, port_pair.source), **request)
    if isinstance(ref, pd.Series):
        assert_same_series(port, ref)
    else:
        assert_same_frame(port["features"], ref["features"])
    return port, ref


def assert_same_frame(port, ref):
    assert port.columns == list(ref.columns)
    assert port.index.values.tolist() == ref.index.tolist()
    for column in ref.columns:
        if column == "geometry":
            assert [g.wkb for g in port[column]] == [g.wkb for g in ref[column]]
        else:
            assert_same_series(port[column], ref[column])


# --- Classify (TestClassify) ---

CLASSIFY_CASES = {
    "closed": ("col_1", [0, 1.2, 5.0], ["A", "B"], True),
    "left": ("col_1", [0, 1.2, 10.0], ["A", "B"], False),
    "open_bounds": ("col_1", [1.2, 5], ["A", "B", "C"], True),
    "open_bounds_left": ("col_1", [1.2, 5], ["A", "B", "C"], False),
    "none": ("none", [0, 0.2], ["A"], True),
    "int_labels_as_float": ("col_source", [0, 1.0, 5.0], [2, 3], True),
    "not_categorical": ("col_source", [0, 0.5, 1.0], ["A", "B", "C", "D"], True),
    "bool_labels": ("col_1", [0, 1.2, 5.0], [True, False], True),
}


@pytest.mark.parametrize("case", sorted(CLASSIFY_CASES))
def test_classify(case):
    column, bins, labels, right = CLASSIFY_CASES[case]
    port, ref = both(lambda G, s: G.Classify(s[column], bins=bins, labels=labels, right=right))
    assert not isinstance(ref.dtype, pd.CategoricalDtype)


def test_classify_duplicate_edges_raise_as_pandas():
    for G, source in ((jax_blocks, _pairs()[0]), (port_blocks, _pairs()[1])):
        view = G.Classify(source.source["col_1"], bins=[0, 1.0, 1.0], labels=["A", "B"])
        with pytest.raises(ValueError, match="unique"):
            _get(source, view)


# --- ClassifyFromColumns (TestClassifyFromColumns) ---


def test_classify_from_columns_empty():
    for pair in _pairs():
        view = pair.G.ClassifyFromColumns(pair.source, "col_1", ["id_value"], labels=["A", "B"])
        result = _get(pair, view, geometry=pair.box(0, 0, 0, 0))
        assert len(result) == 0


@pytest.mark.parametrize("case", [
    ("none", ["id_value"], ["A", "B"], True),
    ("col_1", ["id_value"], ["lower", "higher"], True),
    ("col_1", ["id_value"], ["lower", "higher"], False),
    ("col_1", ["id_value", "col_source"], ["a", "b", "c"], True),
    ("col_source", ["id_value", "col_2"], [1, 2, 3], False),
])
def test_classify_from_columns(case):
    value, bins, labels, right = case
    both(lambda G, s: G.ClassifyFromColumns(s, value, bins, labels=labels, right=right))


@pytest.mark.parametrize("right", [True, False])
@pytest.mark.parametrize("bins, labels", [
    ([0, 1.2, 5.0], ["A", "B"]),
    ([1.2, 5.0], ["A", "B", "C"]),
])
def test_classify_from_columns_matches_classify(bins, labels, right):
    names = ["bin_%d" % i for i in range(len(bins))]

    def build(G, s):
        pairs = [x for name, edge in zip(names, bins) for x in (name, edge)]
        return G.ClassifyFromColumns(s.set(*pairs), "col_1", names, labels=labels, right=right)

    port, ref = both(build)
    expected, _ = both(lambda G, s: G.Classify(s["col_1"], bins=bins, labels=labels,
                                               right=right))
    assert repr(port.tolist()) == repr(expected.tolist())


# --- Choose (TestChoose) ---


@pytest.mark.parametrize("selector, choices", [
    ("id_value", ["col_1", "col_2", "bool_1"]),
    ("col_source", ["col_1", "col_2", "bool_1"]),
    ("id_value", ["col_choice_1", "col_choice_2"]),
    ("col_1", ["col_choice_1", "col_2"]),
])
def test_choose(selector, choices):
    both(lambda G, s: G.Choose(s[selector], *[s[c] for c in choices]))


def test_choose_string_selector_never_selects():
    from dask_geomodeling_tpu.geometry.field_operations import Choose as JaxChoose

    index = pd.RangeIndex(4)
    ref = JaxChoose.process(pd.Series(["1", 0, 1.0, None], index=index, dtype=object),
                            pd.Series(["a0", "a1", "a2", "a3"], index=index),
                            pd.Series(["b0", "b1", "b2", "b3"], index=index))
    port = port_blocks.Choose.process(Series(np.array(["1", 0, 1.0, None], dtype=object)),
                                      Series(["a0", "a1", "a2", "a3"]),
                                      Series(["b0", "b1", "b2", "b3"]))
    assert_same_series(port, ref)


def test_choose_different_length():
    values = VALUES + [1]
    other_properties = [{"id_value": float(i)} for i in range(len(values))]
    jax_pair, port_pair = _pairs()
    answers = []
    for pair, cls in ((jax_pair, JaxMockGeometry),
                      (port_pair, chip_smoke.mock_geometry_class())):
        other = cls([list(SQUARE)] * len(values), other_properties)
        s = pair.source
        view = pair.G.Choose(other["id_value"], s["col_choice_1"], s["col_2"], s["bool_1"])
        answers.append(_get(pair, view))
    ref, port = answers
    assert len(port) == len(values)
    assert_same_series(port, ref)


# --- operators (TestOperators) ---

BINARY = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "truediv": operator.truediv, "floordiv": operator.floordiv, "mod": operator.mod,
    "lt": operator.lt, "le": operator.le, "eq": operator.eq, "ne": operator.ne,
    "gt": operator.gt, "ge": operator.ge,
}


@pytest.mark.parametrize("op", sorted(BINARY))
@pytest.mark.parametrize("left, right", [("col_1", "col_2"), ("col_source", "id_value"),
                                         ("id_value", "col_1")])
def test_binary_operators_of_fields(op, left, right):
    both(lambda G, s: s.set("result", BINARY[op](s[left], s[right])))


@pytest.mark.parametrize("op", sorted(BINARY))
@pytest.mark.parametrize("constant", [2, 2.1, 0, float("inf"), float("nan")])
def test_binary_operators_with_constants(op, constant):
    both(lambda G, s: s.set("result", BINARY[op](s["col_1"], constant)))


@pytest.mark.parametrize("exponent", [-1, 0.5, 2])
def test_power(exponent):
    both(lambda G, s: s.set("result", s["col_1"] ** exponent))


@pytest.mark.parametrize("op", [operator.and_, operator.or_, operator.xor])
def test_logic_operators(op):
    both(lambda G, s: s.set("result", op(s["bool_1"], s["bool_2"])))


def test_invert_and_negate():
    both(lambda G, s: s.set("not", ~s["bool_1"], "neg", -s["col_1"]))


def test_set_multiple_columns():
    both(lambda G, s: s.set("sum", s["col_1"] + s["col_2"], "product", s["col_1"] * s["col_2"]))


# --- Round, Interp, Where, Mask (TestRoundInterp, TestWhereMask) ---


def test_round_validation():
    for G in (jax_blocks, port_blocks):
        source = _pairs()[0 if G is jax_blocks else 1].source
        with pytest.raises(TypeError):
            G.Round(source["col_1"], "s")


@pytest.mark.parametrize("decimals", [0, 2])
def test_round(decimals):
    both(lambda G, s: G.Round(s["col_1"] / 3, decimals))


def test_round_half_to_even():
    ref = np.around(pd.Series([0.125, 0.375, 2.5, -0.5, 1.005], dtype=np.float32), 2)
    port = np.around(Series(np.array([0.125, 0.375, 2.5, -0.5, 1.005], np.float32)), 2)
    assert_same_series(port, ref)


def test_interp():
    both(lambda G, s: G.Interp(s["col_1"], [0.0, 5.0], [0.0, 10.0], left=-1.0, right=11.0))


@pytest.mark.parametrize("block", ["Where", "Mask"])
@pytest.mark.parametrize("cond, other", [("bool_1", "col_2"), ("bool_1", 0.0), ("col_1", 7),
                                         ("none", -1.0)])
def test_where_and_mask(block, cond, other):
    def build(G, s):
        value = s[other] if isinstance(other, str) else other
        return s.set("result", getattr(G, block)(s["col_1"], cond=s[cond], other=value))

    both(build)


def test_where_on_integers_keeps_the_dtype_where_pandas_does():
    ref = pd.Series([1, 2, 3]).where(pd.Series([True, False, True]), 0.0)
    port = Series(np.array([1, 2, 3])).where(Series([True, False, True]), 0.0)
    assert_same_series(port, ref)
    ref = pd.Series([1, 2, 3]).where(pd.Series([True, False, True]), 0.5)
    port = Series(np.array([1, 2, 3])).where(Series([True, False, True]), 0.5)
    assert_same_series(port, ref)


# --- alignment by index label, against pandas ---


def _series_pair(values, labels):
    return Series(list(values), index=_index(labels)), pd.Series(values, index=labels)


def _index(labels):
    from dask_geomodeling_tpu_torch.geo.features import Index

    return Index(np.asarray(labels))


@pytest.mark.parametrize("labels", [[2, 0, 1], [1, 5], [0, 1, 2, 3], [7]])
@pytest.mark.parametrize("op", [operator.add, operator.mul, operator.gt, operator.ne])
def test_binary_operations_align_by_label(labels, op):
    """Arithmetic aligns on the union of the labels; a comparison of
    differently labelled series raises, in pandas and in the port."""
    left = _series_pair([1.5, -2.0, 4.0], [0, 1, 2])
    right = _series_pair(np.arange(len(labels), dtype=float) * 3 - 1, labels)
    if op in (operator.gt, operator.ne):
        for a, b in zip(left, right):
            with pytest.raises(ValueError, match="identically-labeled"):
                op(a, b)
        return
    assert_same_series(op(left[0], right[0]), op(left[1], right[1]))


@pytest.mark.parametrize("labels, values", [
    ([2, 0, 1], [10, 20, 30]),  # another order
    ([2, 0], [10, 20]),  # a missing label: NaN, integers widened
    ([1, 2, 0, 9], [True, False, True, True]),  # an extra one, bools
    ([2, 1, 0], ["x", "y", "z"]),
])
def test_frame_assignment_aligns_by_label(labels, values):
    port = GeoDataFrame({"a": np.array([1.0, 2.0, 3.0])}, index=_index([0, 1, 2]))
    ref = pd.DataFrame({"a": [1.0, 2.0, 3.0]}, index=[0, 1, 2])
    port["b"], ref["b"] = _series_pair(values, labels)
    assert_same_series(port["b"], ref["b"])


def test_view_with_a_series_of_another_source_aligns_by_label():
    """SetSeriesBlock writes a series whose index is another source's:
    in another order, and with labels the frame lacks."""
    shuffled = [_properties()[i] for i in (3, 0, 5, 1)]
    jax_pair, port_pair = _pairs()
    answers = []
    for pair, cls in ((jax_pair, JaxMockGeometry),
                      (port_pair, chip_smoke.mock_geometry_class())):
        other = cls([list(SQUARE)] * len(shuffled), shuffled)
        view = pair.source.set("other", other["col_2"], "sum", pair.source["col_1"] + other["col_2"])
        answers.append(_get(pair, view)["features"])
    assert_same_frame(answers[1], answers[0])


# --- Area ---


@pytest.mark.parametrize("projection", ["EPSG:3857", "EPSG:28992", "EPSG:4326"])
def test_area(projection):
    polygons = [SQUARE, ((0, 0), (3.5, 0), (3.5, 1.25), (0, 1.25)),
                ((1, 1), (9, 1), (5, 7.5))]
    properties = [{"id": 4 + i} for i in range(3)]
    jax_pair, port_pair = _pairs(properties=properties, polygons=polygons)
    ref = _get(jax_pair, jax_blocks.Area(jax_pair.source, projection))
    port = _get(port_pair, port_blocks.Area(port_pair.source, projection))
    assert_same_series(port, ref)


def test_area_of_no_features():
    for pair in _pairs():
        view = pair.G.Area(type(pair.source)([], []), "EPSG:28992")
        result = _get(pair, view)
        assert len(result) == 0 and result.dtype == float
