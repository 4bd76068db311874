"""The temporal blocks: Snap, Shift, TemporalSum, TemporalAggregate,
Cumulative and Resample, carried across from the JAX package.

Every case of tests/test_raster_temporal.py is here, as a JAX-package
view and request; its MockRaster stores become MemorySources with the
same frames, values and metadata.  Each is held, on the CPU, against the
JAX package's numpy executor: the port's ``compute_host`` and its torch
twins (``get_data`` and ``evaluate_tiled`` on ``device="cpu"``) give the
same values and dtype, or the same time and meta lists.  Then every
statistic over uint8, int32 and float32 sources with nodata, even-count
medians, ``p0``/``p50``/``p90``/``p100``, empty bins and bins across a DST
switch; the daily-label quirk of ``_aggregate_process`` (its labels step
in naive UTC); and the tokens of views carried across.

Tolerances: every value bitwise, var and ``p<q>`` included (the twins
follow numpy's summation order, its float64 division and its ``_lerp``),
but std over a float64 working copy (an int32 source), within
``rtol=1e-6``: torch's float64 square root on the CPU is not always
correctly rounded (the card's is).
Planning (the nested time queries of Snap, Cumulative and Resample)
leaves ``host_node_runs`` unchanged.
"""
from datetime import datetime, timedelta

import numpy as np
import pytest

from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu import raster as R
from dask_geomodeling_tpu_torch import compute_host, evaluate_tiled, from_reference
from dask_geomodeling_tpu_torch import raster as port
from dask_geomodeling_tpu_torch.runtime import executor

T0 = datetime(2000, 1, 1)
HOUR = timedelta(hours=1)
BBOX = (135000, 455996, 135004, 456000)
REQUEST = dict(mode="vals", start=T0, stop=datetime(2000, 1, 2), bbox=BBOX,
               projection="EPSG:28992", width=4, height=4)


def constant(values, time_first=T0, time_delta=HOUR, nodata=255, metadata=None):
    """(t,) values -> constant (t, 4, 4) uint8 MemorySource
    (tests/test_raster_temporal.py:make_source)."""
    data = np.stack([np.full((4, 4), v, dtype=np.uint8) for v in values])
    return R.MemorySource(data=data, no_data_value=nodata, projection="EPSG:28992",
                          pixel_size=1.0, pixel_origin=(135000, 456000),
                          time_first=time_first, time_delta=time_delta, metadata=metadata)


def mock(bands, minutes, value=1):
    """tests/factories.py:MockRaster(origin=T0, timedelta=minutes, bands,
    value) as a MemorySource: the same frames and meta."""
    return constant([value] * bands, time_delta=timedelta(minutes=minutes),
                    metadata=["Testmeta for band %d" % i for i in range(bands)])


def empty():
    return R.MemorySource(data=np.empty((0, 0, 0), dtype=np.uint8), no_data_value=255,
                          projection="EPSG:28992", pixel_size=1.0, pixel_origin=(135000, 456000))


HOURLY = constant([0, 1, 2, 255, 4, 5])
WEEKLY = constant(list(range(10)), time_first=datetime(2000, 1, 10), time_delta=timedelta(days=7))


def t(minute):
    return datetime(2000, 1, 1, 0, minute)


def _numpy(view, request):
    with jax_config.set({"geomodeling.executor": "numpy"}):
        return view.get_data(**request)


def _same(actual, expected, what, rtol=None):
    if expected is None or "values" not in expected:
        assert actual == expected, what
        return
    assert actual["values"].dtype == expected["values"].dtype, what
    assert actual["no_data_value"] == expected["no_data_value"], what
    if rtol is None:
        np.testing.assert_array_equal(actual["values"], expected["values"], err_msg=what)
    else:
        np.testing.assert_allclose(actual["values"], expected["values"], rtol=rtol, err_msg=what)


def agree(jax_view, request, tile=2, batch=3, rtol=None):
    """The port's view of ``jax_view`` against the JAX package's numpy
    executor: compute_host, get_data and (for vals wider than ``tile``)
    evaluate_tiled on the CPU, with no node returning pixels on the host.
    Where the numpy executor raises, the port raises the same error.
    compute_host is always bitwise; the twins within ``rtol`` if given.
    Returns the numpy result."""
    view = from_reference(jax_view.serialize())
    try:
        expected = _numpy(jax_view, request)
    except Exception as error:
        for run in (lambda: compute_host(*view.get_compute_graph(**request)),
                    lambda: view.get_data(device="cpu", **request)):
            with pytest.raises(type(error)):
                run()
        return error
    before = executor.host_node_runs
    graph = view.get_compute_graph(**request)
    assert executor.host_node_runs == before, "planning ran a pixel node on the host"
    _same(compute_host(*graph), expected, "compute_host")
    before = executor.host_node_runs
    _same(view.get_data(device="cpu", **request), expected, "get_data", rtol)
    if request.get("mode") == "vals" and expected is not None and request["width"] > tile:
        _same(evaluate_tiled(view, request, tile_size=tile, batch=batch, device="cpu"),
              expected, "evaluate_tiled", rtol)
    assert executor.host_node_runs == before, "a node ran on the host"
    return expected


# --- the cases of tests/test_raster_temporal.py ---

SNAP_REQUEST = dict(mode="vals", width=1, height=1, bbox=(135000, 455999, 135001, 456000),
                    projection="EPSG:28992")
META_WINDOWS = [(6, 9), (6, 7), (8, 9), (12, 15), (5, 10), (7, 9), (6, 8)]

CASES = {
    # TestSnapDetailed (a 5-minute store, value 7, on a 3-minute index)
    "snap empty index": (lambda: R.Snap(mock(3, 5, 7), empty()),
                         dict(SNAP_REQUEST, start=T0, stop=datetime(2010, 1, 1, 2))),
    "snap no result vals": (lambda: R.Snap(mock(3, 5, 7), mock(6, 3)),
                            dict(SNAP_REQUEST, start=datetime(2001, 1, 1), stop=datetime(2002, 1, 1))),
    "snap no result meta": (lambda: R.Snap(mock(3, 5, 7), mock(6, 3)),
                            dict(mode="meta", start=datetime(2001, 1, 1), stop=datetime(2002, 1, 1))),
    "snap no result time": (lambda: R.Snap(mock(3, 5, 7), mock(6, 3)),
                            dict(mode="time", start=datetime(2001, 1, 1), stop=datetime(2002, 1, 1))),
    "snap single band vals": (lambda: R.Snap(mock(3, 5, 7), mock(6, 3)), SNAP_REQUEST),
    "snap single band meta": (lambda: R.Snap(mock(3, 5, 7), mock(6, 3)), dict(mode="meta")),
    "snap single band time": (lambda: R.Snap(mock(3, 5, 7), mock(6, 3)), dict(mode="time")),
    "snap multiband time": (lambda: R.Snap(mock(3, 5, 7), mock(6, 3)),
                            dict(mode="time", start=t(6), stop=t(9))),
    "snap multiband vals": (lambda: R.Snap(mock(3, 5, 7), mock(6, 3)),
                            dict(SNAP_REQUEST, start=t(6), stop=t(9))),
    "snap inner no data": (lambda: R.Snap(mock(6, 3), mock(3, 5, 7)),
                           dict(mode="meta", start=t(3), stop=t(5))),
    "snap repeat": (lambda: R.Snap(mock(1, 5), mock(3, 5)),
                    dict(mode="meta", start=T0, stop=datetime(2001, 1, 1))),
    # TestSnap
    "snap static store": (lambda: R.Snap(constant([9], time_delta=None), HOURLY), REQUEST),
    "snap temporal": (lambda: R.Snap(constant([10, 20], datetime(2000, 1, 1, 0, 40),
                                              timedelta(hours=4)), HOURLY), REQUEST),
    "snap time mode": (lambda: R.Snap(constant([9], time_delta=None), HOURLY),
                       dict(REQUEST, mode="time")),
    "snap empty store": (lambda: R.Snap(empty(), HOURLY), REQUEST),
    # TestShift
    "shift values": (lambda: R.Shift(HOURLY, 3600000),
                     dict(REQUEST, start=datetime(2000, 1, 1, 1), stop=None)),
    "shift time": (lambda: R.Shift(HOURLY, 3600000), dict(REQUEST, mode="time")),
    "shift window": (lambda: R.Shift(HOURLY, -5400000), REQUEST),
    # TestTemporalSum
    "temporal sum": (lambda: R.TemporalSum(HOURLY), REQUEST),
    "temporal sum time": (lambda: R.TemporalSum(HOURLY), dict(REQUEST, mode="time")),
    # TestTemporalAggregate
    "aggregate none frequency": (lambda: R.TemporalAggregate(HOURLY, None, statistic="sum"), REQUEST),
    "aggregate sum 2h": (lambda: R.TemporalAggregate(HOURLY, "2h", statistic="sum"), REQUEST),
    "aggregate mean 2h": (lambda: R.TemporalAggregate(HOURLY, "2h", statistic="mean"), REQUEST),
    "aggregate count": (lambda: R.TemporalAggregate(HOURLY, "2h", statistic="count"), REQUEST),
    "aggregate p50": (lambda: R.TemporalAggregate(HOURLY, "2h", statistic="p50"), REQUEST),
    "aggregate time mode": (lambda: R.TemporalAggregate(HOURLY, "2h", statistic="sum"),
                            dict(REQUEST, mode="time")),
    "aggregate day labels right": (
        lambda: R.TemporalAggregate(HOURLY, "D", statistic="sum", closed="right", label="right"),
        dict(REQUEST, mode="time")),
    "aggregate timezone": (
        lambda: R.TemporalAggregate(HOURLY, "D", statistic="sum", timezone="Europe/Amsterdam"),
        dict(REQUEST, start=datetime(1999, 12, 31))),
    "aggregate out of range": (lambda: R.TemporalAggregate(HOURLY, "2h", statistic="sum"),
                               dict(REQUEST, start=datetime(2010, 1, 1), stop=datetime(2010, 1, 2))),
    "aggregate meta": (lambda: R.TemporalAggregate(mock(6, 60), "2h", statistic="sum"),
                       dict(REQUEST, mode="meta")),
    # TestCumulative
    "cumulative sum": (lambda: R.Cumulative(HOURLY, statistic="sum"), REQUEST),
    "cumulative reset 3h": (lambda: R.Cumulative(HOURLY, statistic="sum", frequency="3h"), REQUEST),
    "cumulative count": (lambda: R.Cumulative(HOURLY, statistic="count"), REQUEST),
    "cumulative count reset 3h": (
        lambda: R.Cumulative(HOURLY, statistic="count", frequency="3h"), REQUEST),
    "cumulative partial": (lambda: R.Cumulative(HOURLY, statistic="sum"),
                           dict(REQUEST, start=datetime(2000, 1, 1, 4), stop=datetime(2000, 1, 1, 5))),
    "cumulative time": (lambda: R.Cumulative(HOURLY, statistic="sum", frequency="3h"),
                        dict(REQUEST, mode="time")),
    "cumulative meta": (lambda: R.Cumulative(mock(6, 60), statistic="sum", frequency="3h"),
                        dict(REQUEST, mode="meta")),
    # TestResample and TestResampleDirections
    "resample nearest": (lambda: R.Resample(HOURLY, "2h"), REQUEST),
    "resample nearest time": (lambda: R.Resample(HOURLY, "2h"), dict(REQUEST, mode="time")),
    "resample single timestep": (lambda: R.Resample(HOURLY, "2h"),
                                 dict(SNAP_REQUEST, start=datetime(2000, 1, 1, 2))),
    "resample single timestep closed": (
        lambda: R.Resample(HOURLY, "2h"),
        dict(SNAP_REQUEST, start=datetime(2000, 1, 1, 2), stop=datetime(2000, 1, 1, 2))),
    "resample single timestep time": (lambda: R.Resample(HOURLY, "2h"),
                                      dict(mode="time", start=datetime(2000, 1, 1, 2))),
    "resample forward": (lambda: R.Resample(HOURLY, "2h", direction="forward"), REQUEST),
    "resample backward": (lambda: R.Resample(HOURLY, "2h", direction="backward"), REQUEST),
    "resample meta": (lambda: R.Resample(mock(6, 60), "90min"), dict(REQUEST, mode="meta")),
    # TestMonthStartFrequency
    "aggregate MS": (lambda: R.TemporalAggregate(WEEKLY, statistic="sum", frequency="MS"),
                     dict(REQUEST, stop=datetime(2000, 4, 1))),
    "aggregate MS time": (lambda: R.TemporalAggregate(WEEKLY, statistic="sum", frequency="MS"),
                          dict(REQUEST, mode="time", stop=datetime(2000, 4, 1))),
    "cumulative MS": (lambda: R.Cumulative(WEEKLY, statistic="sum", frequency="MS"),
                      dict(REQUEST, stop=datetime(2000, 4, 1))),
}
for _start, _stop in META_WINDOWS:
    CASES["snap meta %d-%d" % (_start, _stop)] = (
        lambda: R.Snap(mock(3, 5, 7), mock(6, 3)), dict(mode="meta", start=t(_start), stop=t(_stop)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_case(case):
    make, request = CASES[case]
    agree(make(), dict(request))


@pytest.mark.parametrize("make", [
    lambda: R.Snap(mock(3, 5, 7), mock(6, 3)),
    lambda: R.Shift(HOURLY, 3600000),
    lambda: R.TemporalAggregate(HOURLY, "2h", statistic="mean"),
    lambda: R.TemporalAggregate(HOURLY, None, statistic="sum"),
    lambda: R.Cumulative(HOURLY, statistic="sum", frequency="3h"),
    lambda: R.Resample(HOURLY, "2h"),
    lambda: R.Resample(HOURLY, "2h", direction="forward"),
    lambda: R.Resample(HOURLY, "90min", direction="backward"),
])
def test_attributes(make):
    view = make()
    ported = from_reference(view.serialize())
    for name in ("period", "timedelta", "temporal", "dtype", "fillvalue"):
        assert getattr(ported, name) == getattr(view, name), name
    assert len(ported) == len(view)


def test_validation():
    with pytest.raises(TypeError):
        port.Shift(port.MemorySource(np.zeros((1, 2, 2)), 0, "EPSG:28992", 1, (0, 0)), "1 hour")
    source = from_reference(HOURLY.serialize())
    with pytest.raises(ValueError):
        port.TemporalAggregate(source, "h", statistic="bogus")
    with pytest.raises(ValueError):
        port.TemporalAggregate(source, "h", closed="middle")
    with pytest.raises(ValueError):
        port.Cumulative(source, statistic="mean")
    with pytest.raises(ValueError):
        port.Resample(source, "2h", direction="sideways")
    with pytest.raises(NotImplementedError, match="BME"):
        port.TemporalAggregate(source, "BME")
    with pytest.raises(NotImplementedError, match="SMS"):
        port.Resample(source, "SMS")
    with pytest.raises(Exception):
        port.Cumulative(source, frequency="D", timezone="Nowhere/Atlantis")


def test_tokens_carry_across():
    """A view carried across equals one built with the port's classes
    from the same arguments: the normalized frequency enters the token as
    the JAX package writes it."""
    cases = [
        (R.TemporalAggregate(HOURLY, "H", statistic="P90", timezone="Europe/Amsterdam"),
         lambda s: port.TemporalAggregate(s, "h", statistic="p90.0", timezone="Europe/Amsterdam")),
        (R.Cumulative(HOURLY, frequency="A-JAN"), lambda s: port.Cumulative(s, frequency="YE-JAN")),
        (R.Resample(HOURLY, "1.5h", "backward"), lambda s: port.Resample(s, "90min", "backward")),
        (R.Snap(HOURLY, R.Shift(HOURLY, 60000)), lambda s: port.Snap(s, port.Shift(s, 60000))),
        (R.TemporalSum(HOURLY), lambda s: port.TemporalSum(s)),
    ]
    source = from_reference(HOURLY.serialize())
    for view, build in cases:
        ported = from_reference(view.serialize())
        assert ported.token == build(source).token
        assert [a for a in ported.args if not isinstance(a, port.RasterBlock)] == [
            a for a in view.args if not isinstance(a, R.RasterBlock)]


# --- every statistic, over integer and float sources with nodata ---

NODATA = {"uint8": 255, "int32": -2147483648, "float32": float(np.finfo(np.float32).max)}
STATISTICS = ["sum", "count", "min", "max", "mean", "median", "std", "var",
              "p0", "p50", "p90", "p100", "p33.3"]


def random_source(dtype, frames, time_first=T0, step=HOUR, seed=0, shape=(5, 6)):
    """Frames of ``dtype`` with 30% nodata, one cell nodata in every frame,
    and repeated values (ties in the sorts)."""
    rng = np.random.RandomState(seed)
    values = rng.rand(frames, *shape) * 200
    if dtype != "float32":
        values = np.round(values)
    data = values.astype(dtype)
    data[:, 1, 2] = data[0, 1, 2]  # one value repeated in every frame
    data[rng.rand(*data.shape) < 0.3] = NODATA[dtype]
    data[:, 0, 0] = NODATA[dtype]  # a cell without data
    return R.MemorySource(data=data, no_data_value=NODATA[dtype], projection="EPSG:28992",
                          pixel_size=1.0, pixel_origin=(135000, 456000),
                          time_first=time_first, time_delta=step)


def stat_request(start, stop, shape=(5, 6)):
    height, width = shape
    return dict(mode="vals", start=start, stop=stop, bbox=(135000, 456000 - height,
                135000 + width, 456000), projection="EPSG:28992", width=width, height=height)


@pytest.mark.parametrize("statistic", STATISTICS)
@pytest.mark.parametrize("dtype", ["uint8", "int32", "float32"])
@pytest.mark.parametrize("frequency", ["2h", "3h", "30min"])  # even, odd and empty bins
def test_every_statistic(dtype, statistic, frequency):
    source = random_source(dtype, 12)
    view = R.TemporalAggregate(source, frequency, statistic=statistic)
    rtol = 1e-6 if statistic == "std" and dtype == "int32" else None
    expected = agree(view, stat_request(T0, datetime(2000, 1, 1, 12)), tile=3, batch=2, rtol=rtol)
    assert expected["values"].shape[0] > 1


@pytest.mark.parametrize("statistic", ["mean", "median", "p90", "count"])
@pytest.mark.parametrize("frequency, closed, label", [
    ("6h", None, None), ("6h", "right", "left"), ("D", None, None), ("D", "right", "right"),
])
def test_aggregate_across_dst(statistic, frequency, closed, label):
    """48 hourly frames across the spring switch in Amsterdam: 6h bins of
    5 and 6 frames, and the daily labels of the naive-UTC quirk."""
    source = random_source("float32", 48, time_first=datetime(2000, 3, 25), seed=1)
    view = R.TemporalAggregate(source, frequency, statistic=statistic, closed=closed,
                               label=label, timezone="Europe/Amsterdam")
    request = stat_request(datetime(2000, 3, 25), datetime(2000, 3, 27))
    agree(view, request, tile=3, batch=4)
    agree(view, dict(request, mode="time"))


def test_daily_labels_step_in_naive_utc():
    """The JAX package's quirk, kept: ``_aggregate_process`` labels with a
    naive-UTC date range, so daily labels in Amsterdam across the spring
    switch give one band (2000-03-25 23:00) where pandas' own bins would
    label a second day at 2000-03-26 22:00."""
    source = random_source("float32", 48, time_first=datetime(2000, 3, 25), seed=2)
    view = R.TemporalAggregate(source, "D", statistic="sum", timezone="Europe/Amsterdam")
    request = stat_request(datetime(2000, 3, 25), datetime(2000, 3, 27))
    assert agree(view, dict(request, mode="time"))["time"] == [datetime(2000, 3, 25, 23)]
    assert agree(view, request)["values"].shape[0] == 1


@pytest.mark.parametrize("dtype", ["uint8", "int32", "float32"])
@pytest.mark.parametrize("statistic", ["sum", "count"])
@pytest.mark.parametrize("frequency, timezone", [(None, "UTC"), ("3h", "UTC"),
                                                 ("D", "Europe/Amsterdam")])
def test_cumulative_statistics(dtype, statistic, frequency, timezone):
    source = random_source(dtype, 48, time_first=datetime(2000, 3, 25), seed=3)
    view = R.Cumulative(source, statistic=statistic, frequency=frequency, timezone=timezone)
    agree(view, stat_request(datetime(2000, 3, 25, 5), datetime(2000, 3, 26, 20)), tile=3, batch=4)


@pytest.mark.parametrize("statistic", ["p90", "p0"])
def test_cumulative_percentile_raises(statistic):
    """The constructor takes ``p<q>``, and the numpy process raises over
    it (it masks a bin's (h, w) percentile with a per-frame mask).  The
    port's compute_host raises the same error; the twin serves no such
    node, so the device runs raise NotLowerable instead of returning
    running sums."""
    source = random_source("float32", 48, time_first=datetime(2000, 3, 25), seed=3)
    jax_view = R.Cumulative(source, statistic=statistic, frequency="D", timezone="Europe/Amsterdam")
    request = stat_request(datetime(2000, 3, 25, 5), datetime(2000, 3, 26, 20))
    with pytest.raises(IndexError):
        _numpy(jax_view, request)
    view = from_reference(jax_view.serialize())
    with pytest.raises(IndexError):
        compute_host(*view.get_compute_graph(**request))
    with pytest.raises(executor.NotLowerable):
        view.get_data(device="cpu", **request)
    with pytest.raises(executor.NotLowerable):
        evaluate_tiled(view, request, tile_size=3, batch=4, device="cpu")


@pytest.mark.parametrize("dtype", ["uint8", "int32", "float32"])
def test_temporal_sum_dtypes(dtype):
    """numpy sums the frames in uint64 or int64 for the integer types."""
    expected = agree(R.TemporalSum(random_source(dtype, 7)), stat_request(T0, datetime(2000, 1, 2)),
                     tile=3)
    assert expected["values"].dtype == np.dtype(dtype).type(0).sum().dtype


@pytest.mark.parametrize("direction", ["nearest", "forward", "backward"])
@pytest.mark.parametrize("frequency, timezone", [("2h", "UTC"), ("90min", "Europe/Amsterdam"),
                                                 ("D", "Europe/Amsterdam")])
def test_resample_directions(direction, frequency, timezone):
    source = random_source("float32", 48, time_first=datetime(2000, 3, 25), seed=4)
    view = R.Resample(R.Shift(source, 1800000), frequency, direction=direction, timezone=timezone)
    request = stat_request(datetime(2000, 3, 25, 3), datetime(2000, 3, 26, 21))
    agree(view, request, tile=3, batch=4)
    agree(view, dict(request, mode="time"))


def test_cumulative_path_view():
    """chip_smoke.py's temporal-cumulative view at a small size: Shift,
    Resample, a daily reset in Amsterdam and Snap, with the nested
    planning queries of all three."""
    source = random_source("float32", 48, time_first=datetime(2000, 3, 25), seed=5)
    view = R.Snap(
        R.Cumulative(R.Resample(R.Shift(source, 1800000), "2h", direction="backward"),
                     statistic="sum", frequency="D", timezone="Europe/Amsterdam"),
        R.Resample(source, "6h"),
    )
    request = stat_request(datetime(2000, 3, 25), datetime(2000, 3, 27))
    assert agree(view, request, tile=3, batch=4)["values"].shape[0] == 9


def test_time_queries_resolve_no_device():
    """A time request, and the planning of a view that makes one, need
    no device: both work with the default device set to a card that is
    not there."""
    from dask_geomodeling_tpu_torch.config import config

    view = from_reference(R.Snap(HOURLY, R.Resample(HOURLY, "2h")).serialize())
    with config.set({"geomodeling.torch-device": "cuda:7"}):
        assert view.get_data(mode="time", start=T0, stop=datetime(2000, 1, 2))["time"]
        view.get_compute_graph(**REQUEST)


@pytest.mark.parametrize("statistic", ["p90", "std", "var"])
def test_port_is_bitwise_where_the_jax_twin_is_not(statistic):
    """The JAX package's twin of ``_aggregate_process`` (its jax executor,
    on the CPU) differs from numpy in the last bits of many cells for
    ``p<q>``, std and var; the port's twin is bitwise on the same view."""
    source = random_source("float32", 48, time_first=datetime(2000, 3, 25), seed=1,
                           shape=(64, 64))
    view = R.TemporalAggregate(source, "6h", statistic=statistic, timezone="Europe/Amsterdam")
    request = stat_request(datetime(2000, 3, 25), datetime(2000, 3, 27), shape=(64, 64))
    expected = agree(view, request, tile=32, batch=4)["values"]
    with jax_config.set({"geomodeling.executor": "jax"}):
        jax_twin = view.get_data(**request)["values"]
    assert np.count_nonzero(jax_twin != expected) > 0
    np.testing.assert_allclose(jax_twin, expected, rtol=1e-5)
