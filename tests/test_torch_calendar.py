"""The port's resample calendar (geo/calendar.py) against pandas 3.0.3.

Every function of the calendar is held to pandas, or to the JAX package's
pandas helpers (dask_geomodeling_tpu/raster/temporal.py), with hypothesis:
every supported family with multiples 1-7 and every anchor, ``closed`` and
``label`` in {None, left, right}, the zones UTC, Europe/Amsterdam,
America/New_York, Asia/Kolkata and Australia/Lord_Howe (a 30-minute DST
shift), and instants around DST switches, month and year ends and
29 February.  The offset strings of ``normalize_offset`` are held to the
JAX package's for every alias, and each unsupported pandas family raises
NotImplementedError naming it.  This is the only port test that imports
pandas.
"""
import warnings
from datetime import datetime, timedelta
from zoneinfo import ZoneInfo

import pandas as pd
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dask_geomodeling_tpu.geo import normalize_offset as jax_normalize_offset
from dask_geomodeling_tpu.geo import offset_to_timedelta as jax_offset_to_timedelta
from dask_geomodeling_tpu.geo.timeutils import _REMOVED_ALIASES
from dask_geomodeling_tpu.raster import temporal as reference
from dask_geomodeling_tpu_torch.geo import calendar, normalize_offset, offset_to_timedelta

ZONES = ["UTC", "Europe/Amsterdam", "America/New_York", "Asia/Kolkata", "Australia/Lord_Howe"]
DAYS = ["MON", "TUE", "WED", "THU", "FRI", "SAT", "SUN"]
MONTHS = ["JAN", "FEB", "MAR", "APR", "MAY", "JUN", "JUL", "AUG", "SEP", "OCT", "NOV", "DEC"]
# DST switches of the zones above in 2000, month and year ends, 29 February
ANCHORS = [
    datetime(2000, 3, 26, 1), datetime(2000, 10, 29, 1),  # Europe
    datetime(2000, 4, 2, 7), datetime(2000, 10, 29, 6),  # New York
    datetime(2000, 3, 25, 15), datetime(2000, 10, 28, 15, 30),  # Lord Howe
    datetime(2000, 2, 29, 12), datetime(1999, 12, 31, 23), datetime(2000, 4, 30, 22),
]
FAMILIES = (
    ["us", "ms", "s", "min", "h", "D", "MS", "ME"]
    + ["W-" + d for d in DAYS]
    + [kind + "-" + m for kind in ("QS", "QE", "YS", "YE") for m in MONTHS]
)
UNSUPPORTED = ["B", "C", "BME", "BMS", "CBME", "CBMS", "SME", "SMS", "BQE", "BQS", "BYE",
               "BYS", "HYE", "HYS", "WOM-1MON", "LWOM-MON", "REQ-N-DEC-MON-1", "bh", "cbh",
               "ns", "2B", "5ns"]
SETTINGS = settings(max_examples=150, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])


def _us(ts):
    return ts.value // 1000


def _pandas(call, *args, **kwargs):
    """The pandas answer, or the ValueError it raised."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return call(*args, **kwargs)
        except ValueError:
            return ValueError


def _port(call, *args, **kwargs):
    try:
        return call(*args, **kwargs)
    except ValueError:
        return ValueError


@st.composite
def frequencies(draw):
    return "%d%s" % (draw(st.integers(1, 7)), draw(st.sampled_from(FAMILIES)))


@st.composite
def instants(draw, frequency, count):
    """``count`` naive-UTC datetimes near an anchor, spread over at most a
    few hundred steps of ``frequency`` (a tick of microseconds must not
    span days: pandas would build billions of bins)."""
    anchor = draw(st.sampled_from(ANCHORS))
    step = calendar.to_offset(frequency).step_us
    spread = 3000 * 60 * 10**6 if step is None or step >= 60 * 10**6 else 300 * step
    offsets = draw(st.lists(st.integers(-spread, spread), min_size=count, max_size=count))
    return sorted({anchor + timedelta(microseconds=o) for o in offsets})


# --- parsing ---


@pytest.mark.parametrize("alias", sorted(_REMOVED_ALIASES))
@pytest.mark.parametrize("prefix", ["", "2"])
@pytest.mark.parametrize("anchor", ["", "-JAN", "-NOV"])
def test_normalize_offset_removed_aliases(alias, prefix, anchor):
    freq = prefix + alias + anchor
    try:
        actual = _port(normalize_offset, freq)
    except NotImplementedError as e:  # only for the families the calendar leaves out
        family = _REMOVED_ALIASES[alias]
        assert family in ("BME", "SME", "CBME", "BQE", "BYE", "BYS", "bh", "cbh", "ns")
        assert family in str(e)
        return
    assert actual == _pandas(jax_normalize_offset, freq)


@pytest.mark.parametrize("freq", [
    "H", "1D", "5T", "1.5h", "60min", "24h", "W", "M", "Q", "QS", "A", "Y", "YS", "2D",
    "W-MON", "3W-sun", "2ME", "QE-NOV", "YS-MAR", "1h30min", "1.5D", "0.5D0.5D", "d", "MIN",
    "Us", "1.333h", "1.0000000001s", "2 h", "+2h", "-1h", "me", "QS-jan", "h-SUN", "ME-JAN",
    "1.5W", "2W3W", "", "bogus", "1e3s",
])
def test_normalize_offset_examples(freq):
    assert _port(normalize_offset, freq) == _pandas(jax_normalize_offset, freq)
    assert _port(offset_to_timedelta, freq) == _pandas(jax_offset_to_timedelta, freq)


@pytest.mark.parametrize("freq", UNSUPPORTED)
def test_unsupported_families_raise(freq):
    expected = _pandas(pd.tseries.frequencies.to_offset, freq)
    assert expected is not ValueError  # pandas knows them
    name = freq.lstrip("0123456789").split("-")[0]
    with pytest.raises(NotImplementedError, match=name):
        calendar.to_offset(freq)
    with pytest.raises(NotImplementedError, match=name):
        normalize_offset(freq)


@SETTINGS
@given(st.lists(st.tuples(
    st.sampled_from(["", "1", "2", "7", "0.5", "1.5", ".25", "0.3", "3.3", "12", "36", "-1"]),
    st.sampled_from(["us", "ms", "s", "min", "h", "D", "d", "Min", "US", "W", "MS", "ME", "QS",
                     "QE-FEB", "YS", "YE-JUN", "W-WED", "H", "T"]),
    st.sampled_from(["", " "]),
), min_size=1, max_size=3))
def test_to_offset_freqstr(parts):
    freq = "".join(stride + space + name for stride, name, space in parts)
    expected = _pandas(lambda f: pd.tseries.frequencies.to_offset(f).freqstr, freq)
    try:
        actual = calendar.to_offset(freq).freqstr
    except ValueError:
        actual = ValueError
    except NotImplementedError:
        assert expected is not ValueError and expected.endswith("ns")
        return
    assert actual == expected


# --- resampling ---


@SETTINGS
@given(st.data())
def test_resample_indices(data):
    frequency = data.draw(frequencies())
    zone = data.draw(st.sampled_from(ZONES))
    closed = data.draw(st.sampled_from([None, "left", "right"]))
    label = data.draw(st.sampled_from([None, "left", "right"]))
    times = data.draw(instants(frequency, data.draw(st.integers(1, 25))))
    series = pd.Series(index=times, dtype=float).tz_localize("UTC").tz_convert(zone)
    expected = _pandas(lambda: {
        _us(k): list(v) for k, v in series.resample(frequency, closed=closed, label=label)
        .indices.items()})
    closed, label = calendar.default_closed_label(frequency, closed, label)
    actual = _port(calendar.resample_indices, [calendar.to_us(t) for t in times], frequency,
                   closed, label, ZoneInfo(zone))
    assert actual == expected


@SETTINGS
@given(st.data())
def test_bin_helpers(data):
    """_get_bin_label, _get_bin_start, _get_closest_label (every side)
    and _shift_datetime (whole and half steps) of the JAX package."""
    frequency = data.draw(frequencies())
    zone = data.draw(st.sampled_from(ZONES))
    closed = data.draw(st.sampled_from(["left", "right"]))
    label = data.draw(st.sampled_from(["left", "right"]))
    dt = data.draw(instants(frequency, 1))[0]
    tz = ZoneInfo(zone)
    us = calendar.to_us(dt)

    def port(call, *args):
        result = _port(call, *args)
        return result if result is ValueError else calendar.from_us(result)

    assert port(calendar.bin_label, us, frequency, closed, label, tz) == _pandas(
        reference._get_bin_label, dt, frequency, closed, label, zone)
    start = _pandas(reference._get_bin_start, dt, frequency, closed, label, zone)
    if start is not ValueError:
        start = reference._ts_to_dt(start, zone)
    assert port(calendar.bin_start, us, frequency, closed, tz) == start
    for side in ("both", "left", "right"):
        assert port(calendar.closest_label, us, frequency, tz, side) == _pandas(
            reference._get_closest_label, dt, frequency, zone, side)
    for n in (0, 1, -1, 3, 0.5, -0.5, 1.5):
        assert port(calendar.shift_fraction, us, frequency, n, tz) == _pandas(
            reference._shift_datetime, dt, frequency, zone, n)


@SETTINGS
@given(st.data())
def test_date_range(data):
    """Zoned (as _get_label_range uses it) and naive (as
    _aggregate_process's labels use it)."""
    frequency = data.draw(frequencies())
    zone = data.draw(st.sampled_from(ZONES))
    drawn = data.draw(instants(frequency, 2))
    start, stop = drawn[0], drawn[-1]
    tz = ZoneInfo(zone)
    expected = _pandas(reference._get_label_range, start, stop, frequency, zone)
    actual = _port(calendar.date_range, calendar.to_us(start), calendar.to_us(stop),
                   frequency, tz)
    assert (actual if actual is ValueError else [calendar.from_us(u) for u in actual]) == expected
    naive = _pandas(lambda: list(pd.date_range(start, stop, freq=frequency).to_pydatetime()))
    actual = _port(calendar.date_range, calendar.to_us(start), calendar.to_us(stop),
                   frequency, None)
    assert (actual if actual is ValueError else [calendar.from_us(u) for u in actual]) == naive


def test_tick_adds_absolute_time_and_day_calendar_time():
    """Across the spring switch in Amsterdam a day has 23 hours."""
    tz = ZoneInfo("Europe/Amsterdam")
    noon = calendar.to_us(datetime(2000, 3, 25, 11))
    day = calendar.shift(noon, calendar.to_offset("D"), 1, tz)
    hours = calendar.shift(noon, calendar.to_offset("24h"), 1, tz)
    assert calendar.from_us(day) == datetime(2000, 3, 26, 10)
    assert calendar.from_us(hours) == datetime(2000, 3, 26, 11)


@pytest.mark.parametrize("wall, ambiguous, nonexistent, expected", [
    (datetime(2000, 3, 26, 2, 30), "raise", "shift_forward", datetime(2000, 3, 26, 1)),
    (datetime(2000, 10, 29, 2, 30), True, "raise", datetime(2000, 10, 29, 0, 30)),
    (datetime(2000, 3, 26, 2, 30), "raise", "raise", ValueError),
    (datetime(2000, 10, 29, 2, 30), "raise", "raise", ValueError),
])
def test_localize_like_pandas(wall, ambiguous, nonexistent, expected):
    tz = ZoneInfo("Europe/Amsterdam")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            ts = pd.Timestamp(wall).tz_localize("Europe/Amsterdam", ambiguous=ambiguous,
                                                nonexistent=nonexistent)
            assert ts.tz_convert("UTC").tz_localize(None).to_pydatetime() == expected
        except ValueError:
            assert expected is ValueError
    result = _port(calendar.localize, calendar.to_us(wall), tz, ambiguous, nonexistent)
    assert (result if result is ValueError else calendar.from_us(result)) == expected
