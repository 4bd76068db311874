"""A pandas-free, timezone-aware resample calendar.

The JAX package computes the bins and labels of its temporal blocks with
pandas (dask_geomodeling_tpu/raster/temporal.py:235-436, :484-511,
:770-784, :863-875, and geo/timeutils.py:127-151).  This module gives the
same answers as pandas 3.0.3 without it, for the offset families the
blocks accept:

- the ticks ``us``, ``ms``, ``s``, ``min`` and ``h``, and the calendar
  day ``D``, with any multiple;
- ``W-<DAY>``, ``MS``/``ME``, ``QS-<MON>``/``QE-<MON>`` and
  ``YS-<MON>``/``YE-<MON>``.

Every other pandas alias (business days and hours, semi-months, weeks of
the month, fiscal years, half years, nanoseconds) raises
``NotImplementedError`` naming it; a string pandas rejects raises
``ValueError``.

An instant is an integer count of microseconds since 1970-01-01 UTC (the
resolution pandas gives an index built from Python datetimes).  A "wall"
value counts the same microseconds on a zone's local clock.  As in
pandas, a tick adds absolute time, and every other offset moves the wall
clock and localizes the result again; a local time that falls twice or
never raises unless the caller says how to resolve it.  Zones are
``zoneinfo.ZoneInfo`` objects from the system zone database (a zone it
lacks raises); None stands for a naive clock, wall = UTC.
"""
import calendar as _calendar
import re
from dataclasses import dataclass
from datetime import datetime, timedelta, timezone

__all__ = [
    "Offset",
    "to_offset",
    "to_us",
    "from_us",
    "shift",
    "resample_bins",
    "resample_indices",
    "bin_label",
    "bin_start",
    "date_range",
    "closest_label",
    "shift_fraction",
]

DAY_US = 86400 * 10**6
_EPOCH = datetime(1970, 1, 1)
_EPOCH_UTC = datetime(1970, 1, 1, tzinfo=timezone.utc)

#: microseconds per tick unit, finest first
_TICK_US = {"us": 1, "ms": 10**3, "s": 10**6, "min": 60 * 10**6, "h": 3600 * 10**6}
#: each tick unit's next finer unit and the factor between them
_FINER = {"h": ("min", 60), "min": ("s", 60), "s": ("ms", 1000), "ms": ("us", 1000),
          "us": ("ns", 1000)}
_DAYS = ["MON", "TUE", "WED", "THU", "FRI", "SAT", "SUN"]
_MONTHS = ["JAN", "FEB", "MAR", "APR", "MAY", "JUN", "JUL", "AUG", "SEP", "OCT", "NOV", "DEC"]
#: anchored families: default anchor (pandas' ``_from_name`` default)
_ANCHORED = {"W": None, "QS": 1, "QE": 12, "YS": 1, "YE": 12}
_MONTHLY = {"MS", "ME"}
#: pandas offset prefixes this calendar does not implement
_UNSUPPORTED = {"B", "BHYE", "BHYS", "BME", "BMS", "BQE", "BQS", "BYE", "BYS", "C",
                "CBME", "CBMS", "HYE", "HYS", "LWOM", "RE", "REQ", "SME", "SMS", "WOM",
                "bh", "cbh", "ns"}
#: pandas' ``_lite_rule_alias`` and ``_dont_uppercase``
_LITE_ALIAS = {"W": "W-SUN", "QE": "QE-DEC", "YE": "YE-DEC", "YS": "YS-JAN", "BYE": "BYE-DEC",
               "BYS": "BYS-JAN", "Min": "min", "min": "min", "ms": "ms", "us": "us", "ns": "ns"}
_DONT_UPPERCASE = {"h", "bh", "cbh", "MS", "ms", "s"}
#: pandas' ``opattern``: a signed, maybe fractional stride and a name
_OPATTERN = re.compile(r"([+\-]?\d*|[+\-]?\d*\.\d*)\s*([A-Za-z]+([\-][\dA-Za-z\-]+)?)")


@dataclass(frozen=True)
class Offset:
    """One offset: ``kind`` is a tick unit (us, ms, s, min, h), "D", "W",
    "MS", "ME", "QS", "QE", "YS" or "YE"; ``anchor`` is the weekday (0 =
    Monday) of "W" and the (starting) month of the quarterly and yearly
    kinds."""

    kind: str
    n: int = 1
    anchor: int = None

    @property
    def is_tick(self):
        return self.kind in _TICK_US

    @property
    def rule_code(self):
        if self.kind == "W":
            return "W-" + _DAYS[self.anchor]
        if self.kind in _ANCHORED:
            return "%s-%s" % (self.kind, _MONTHS[self.anchor - 1])
        return self.kind

    @property
    def freqstr(self):
        return self.rule_code if self.n == 1 else "%d%s" % (self.n, self.rule_code)

    @property
    def step_us(self):
        """The fixed length of a tick or of whole days, else None."""
        if self.is_tick:
            return self.n * _TICK_US[self.kind]
        if self.kind == "D":
            return self.n * DAY_US
        return None

    def __mul__(self, k):
        return Offset(self.kind, self.n * k, self.anchor)


# --- parsing ---


def _resolve(name):
    """(kind, anchor) of an offset name, as pandas' ``_get_offset``
    resolves it; ValueError for names pandas rejects."""
    if name.lower() not in _DONT_UPPERCASE:
        name = name.upper()
        name = _LITE_ALIAS.get(name, name)
        name = _LITE_ALIAS.get(name.lower(), name)
    else:
        name = _LITE_ALIAS.get(name, name)
    prefix, *suffix = name.split("-")
    if prefix in _UNSUPPORTED:
        raise NotImplementedError("the offset alias %r is not supported" % prefix)
    if len(suffix) > 1:
        raise ValueError("Invalid frequency: %s" % name)
    suffix = suffix[0] if suffix else None
    if prefix in _TICK_US or prefix == "D" or prefix in _MONTHLY:
        if suffix:
            raise ValueError("Bad freq suffix %s" % suffix)
        return prefix, None
    if prefix not in _ANCHORED:
        raise ValueError("Invalid frequency: %s" % name)
    if suffix is None:
        return prefix, _ANCHORED[prefix]
    table = _DAYS if prefix == "W" else _MONTHS
    if suffix not in table:
        raise ValueError("Invalid frequency: %s" % name)
    return prefix, table.index(suffix) + (prefix != "W")


def _validate_alias(name):
    """pandas 3 refuses lower-case spellings of the S/E aliases."""
    upper = name.upper()
    if upper != name and name.lower() not in {"s", "ms", "us", "ns"}:
        if upper.split("-")[0].endswith(("S", "E")):
            raise ValueError("Invalid frequency: %s" % name)


def _tick_times(unit, n, factor):
    """pandas' ``Tick * float``: the same unit when the product is whole
    (within 1e-8), else the next finer unit."""
    product = factor * n
    if abs(product % 1) <= 1e-8:
        return unit, int(product)
    if unit == "ns":
        raise ValueError("Could not convert to integer offset at any resolution")
    finer, ratio = _FINER[unit]
    return _tick_times(finer, n * ratio, factor)


def _ns_to_tick(ns):
    """pandas' ``delta_to_tick`` of a duration in nanoseconds."""
    if ns % 10**9 == 0:
        seconds = ns // 10**9
        if seconds % 3600 == 0:
            return "h", seconds // 3600
        if seconds % 60 == 0:
            return "min", seconds // 60
        return "s", seconds
    if ns % 10**6 == 0:
        return "ms", ns // 10**6
    if ns % 1000 == 0:
        return "us", ns // 1000
    return "ns", ns


def _ns_of(unit, n):
    return n * (86400 * 10**9 if unit == "D" else 1 if unit == "ns" else _TICK_US[unit] * 1000)


def to_offset(freq):
    """The Offset of a pandas frequency string, as pandas 3.0.3's
    ``to_offset`` parses it (several components such as "1h30min" add
    up; a fractional stride moves to a finer unit)."""
    if isinstance(freq, Offset):
        return freq
    if not isinstance(freq, str):
        raise TypeError("frequency must be a string")
    split = _OPATTERN.split(freq)
    if split[-1] != "" and not split[-1].isspace():
        raise ValueError("Invalid frequency: %s (last element must be blank)" % freq)
    parts = list(zip(split[0::4], split[1::4], split[2::4]))
    if not parts:
        raise ValueError("Invalid frequency: %s" % freq)
    result = None  # ("offset", Offset) for the anchored kinds, else (unit, n) or ("td", ns)
    saw_day = False
    stride_sign = None
    for i, (sep, stride, name) in enumerate(parts):
        _validate_alias(name)
        if sep != "" and not sep.isspace():
            raise ValueError("Invalid frequency: %s (separator must be spaces)" % freq)
        kind, anchor = _resolve(name)
        if stride_sign is None:
            stride_sign = -1 if stride.startswith("-") else 1
        if not stride:
            stride = "1"
        if kind in _TICK_US or kind == "D":
            factor = float(stride)
            if kind == "D":
                saw_day = True
                part = ("D", int(factor)) if factor.is_integer() else _tick_times("h", 24, factor)
            else:
                part = _tick_times(kind, 1, factor)
            if i != 0 and stride_sign < 0:
                part = (part[0], -part[1])
        else:
            part = ("offset", Offset(kind, int(abs(int(stride)) * stride_sign), anchor))
        result = part if result is None else _add_parts(result, part)
    if result[0] == "offset":
        return result[1]
    if result[0] == "td":
        result = _ns_to_tick(result[1])
    unit, n = result
    if saw_day and unit == "h" and n % 24 == 0:
        unit, n = "D", n // 24
    if unit == "ns":
        raise NotImplementedError("the offset alias 'ns' is not supported")
    return Offset(unit, n)


def _add_parts(a, b):
    """pandas' sum of two parsed components: ticks of one unit (or days)
    add their counts, a day and a tick make a Timedelta, and a tick with
    another tick or a Timedelta makes the tick of their total duration;
    anchored offsets do not add."""
    if a[0] == "offset" or b[0] == "offset":
        raise ValueError("Invalid frequency: cannot add anchored offsets")
    if "D" in (a[0], b[0]) and a[0] != b[0]:
        ns = (a[1] if a[0] == "td" else _ns_of(*a)) + _ns_of(*b)
        return "td", ns
    if a[0] == "td":
        a = _ns_to_tick(a[1])
    if a[0] == b[0]:
        return a[0], a[1] + b[1]
    return _ns_to_tick(_ns_of(*a) + _ns_of(*b))


# --- instants, zones and wall clocks ---


def to_us(dt):
    """A naive-UTC datetime as an instant."""
    delta = dt - _EPOCH
    return (delta.days * 86400 + delta.seconds) * 10**6 + delta.microseconds


def from_us(us):
    """An instant (or wall value) as a naive datetime."""
    return _EPOCH + timedelta(microseconds=us)


def _offset_us(tz, us):
    """The zone's UTC offset at instant ``us``, in microseconds."""
    local = (_EPOCH_UTC + timedelta(microseconds=us)).astimezone(tz)
    return local.utcoffset() // timedelta(microseconds=1)


def to_wall(us, tz):
    return us if tz is None else us + _offset_us(tz, us)


def localize(wall, tz, ambiguous="raise", nonexistent="raise"):
    """The instant of a wall value, as pandas' ``tz_localize``: an
    ambiguous time raises or (``ambiguous=True``) takes its DST, earlier,
    instant; a nonexistent time raises or (``"shift_forward"``) takes the
    first instant after the gap."""
    if tz is None:
        return wall
    naive = from_us(wall)
    candidates = sorted({wall - naive.replace(tzinfo=tz, fold=fold).utcoffset()
                         // timedelta(microseconds=1) for fold in (0, 1)})
    valid = [c for c in candidates if to_wall(c, tz) == wall]
    if len(valid) == 1:
        return valid[0]
    if len(valid) == 2:
        if ambiguous is True:
            return valid[0]
        raise ValueError("Cannot infer dst time from %s, try using the 'ambiguous' argument"
                         % naive)
    if nonexistent != "shift_forward":
        raise ValueError("%s is a nonexistent time due to daylight savings time" % naive)
    # the transition lies in (candidates[0], candidates[1]]: find it
    lo, hi = candidates
    after = _offset_us(tz, hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if _offset_us(tz, mid) == after:
            hi = mid
        else:
            lo = mid
    return hi


def _normalize(us, tz):
    """pandas' ``Timestamp.normalize``: local midnight of the instant."""
    wall = to_wall(us, tz)
    return localize(wall - wall % DAY_US, tz)


# --- offsets on a wall clock (pandas' ``_apply``) ---


def _split(wall):
    """(date, microseconds into the day) of a wall value."""
    return from_us(wall - wall % DAY_US).date(), wall % DAY_US


def _join(day, rest):
    return to_us(datetime(day.year, day.month, day.day)) + rest


def _days_in_month(year, month):
    return _calendar.monthrange(year, month)[1]


def _offset_day(offset, year, month):
    return 1 if offset.kind.endswith("S") else _days_in_month(year, month)


def _shift_month(day, months, offset):
    total = day.month - 1 + months
    year, month = day.year + total // 12, total % 12 + 1
    return day.replace(year=year, month=month, day=_offset_day(offset, year, month))


def _roll_qtrday(day, n, month, offset, modby):
    since = day.month - month if modby == 12 else day.month % modby - month % modby
    compare = _offset_day(offset, day.year, day.month)
    if n > 0:
        if since < 0 or (since == 0 and day.day < compare):
            n -= 1
    elif since > 0 or (since == 0 and day.day > compare):
        n += 1
    return n


def _apply_wall(wall, offset):
    """``wall + offset`` on a naive clock."""
    if offset.is_tick or offset.kind == "D":
        return wall + offset.step_us
    day, rest = _split(wall)
    n = offset.n
    if offset.kind == "W":
        weekday = day.weekday()
        if weekday != offset.anchor:
            day = day + timedelta(days=(offset.anchor - weekday) % 7)
            if n > 0:
                n -= 1
        return _join(day + timedelta(weeks=n), rest)
    if offset.kind in _MONTHLY:
        compare = _offset_day(offset, day.year, day.month)
        if n > 0 and day.day < compare:
            n -= 1
        elif n <= 0 and day.day > compare:
            n += 1
        return _join(_shift_month(day, n, offset), rest)
    if offset.kind in ("QS", "QE"):
        since = day.month % 3 - offset.anchor % 3
        quarters = _roll_qtrday(day, n, offset.anchor, offset, 3)
        return _join(_shift_month(day, quarters * 3 - since, offset), rest)
    years = _roll_qtrday(day, n, offset.anchor, offset, 12)
    return _join(_shift_month(day, years * 12 + offset.anchor - day.month, offset), rest)


def _on_offset(wall, offset):
    if offset.is_tick or offset.kind == "D":
        return True
    day = _split(wall)[0]
    if offset.kind == "W":
        return day.weekday() == offset.anchor
    on_day = day.day == _offset_day(offset, day.year, day.month)
    if offset.kind in _MONTHLY:
        return on_day
    if offset.kind in ("QS", "QE"):
        return on_day and (day.month - offset.anchor) % 3 == 0
    return on_day and day.month == offset.anchor


def _roll_wall(wall, offset, forward):
    if _on_offset(wall, offset):
        return wall
    return _apply_wall(wall, Offset(offset.kind, 1 if forward else -1, offset.anchor))


def shift(us, offset, k, tz):
    """The instant ``us + k * offset`` in zone ``tz`` (pandas' tz-aware
    ``Timestamp + k * offset``): a tick adds absolute time, any other
    offset moves the wall clock and localizes again, raising on an
    ambiguous or nonexistent result."""
    offset = to_offset(offset) * k
    if offset.is_tick:
        return us + offset.step_us
    return localize(_apply_wall(to_wall(us, tz), offset), tz)


def _rollback(us, offset, tz):
    wall = to_wall(us, tz)
    if _on_offset(wall, offset):
        return us
    return shift(us, Offset(offset.kind, 1, offset.anchor), -1, tz)


# --- ranges ---


def _regular(start, end, stride):
    """pandas' ``generate_regular_range``: start, start + stride, ...
    through end."""
    if end < start:
        return []
    return list(range(start, start + (end - start) // stride * stride + 1, stride))


def _generate(start, end, offset):
    """pandas' ``_generate_range`` of an anchored offset on a naive clock."""
    if not _on_offset(start, offset):
        start = _roll_wall(start, offset, forward=True)
    out = []
    current = start
    while current <= end:
        out.append(current)
        if current == end:
            break
        following = _apply_wall(current, offset)
        if following <= current:
            raise ValueError("Offset %s did not increment date" % offset.freqstr)
        current = following
    return out


def date_range(start, end, offset, tz=None, ambiguous="raise", nonexistent="raise"):
    """pandas' ``date_range(start, end, freq=offset)``, both ends
    included: instants in zone ``tz``, or naive values when ``tz`` is
    None.  Ticks step in absolute time; days and the anchored offsets step
    the wall clock, and each value is localized as ``ambiguous`` and
    ``nonexistent`` say."""
    offset = to_offset(offset)
    if offset.is_tick:
        return _regular(start, end, offset.step_us)
    start, end = to_wall(start, tz), to_wall(end, tz)
    if offset.kind == "D":
        walls = _regular(start, end, offset.step_us)
    else:
        walls = _generate(start, end, offset)
    # pandas localizes the ends again as well, raising as it would for a value
    localize(start, tz, ambiguous, nonexistent)
    localize(end, tz, ambiguous, nonexistent)
    return [localize(w, tz, ambiguous, nonexistent) for w in walls]


# --- resampling (pandas' TimeGrouper) ---

#: offsets whose bins pandas closes and labels on the right by default
END_TYPES = {"W", "ME", "QE", "YE"}


def default_closed_label(offset, closed, label):
    """pandas' defaults: right for the end-anchored kinds, else left."""
    edge = "right" if to_offset(offset).kind in END_TYPES else "left"
    return closed or edge, label or edge


def _anchored_edges(first, last, step, closed, tz):
    """pandas' ``_adjust_dates_anchored`` with origin "start_day"."""
    origin = _normalize(first, tz)
    foffset = (first - origin) % step
    loffset = (last - origin) % step
    if closed == "right":
        fresult = first - foffset if foffset > 0 else first - step
        lresult = last + (step - loffset) if loffset > 0 else last
    else:
        fresult = first - foffset if foffset > 0 else first
        lresult = last + (step - loffset) if loffset > 0 else last + step
    return fresult, lresult


def resample_bins(instants, offset, closed, label, tz):
    """(labels, ends) of pandas' resampling of the sorted ``instants``:
    bin k holds the instants at positions ends[k-1] (0 for k = 0) to
    ends[k], and is labelled labels[k].  ``closed`` and ``label`` are
    "left" or "right"."""
    offset = to_offset(offset)
    first, last = instants[0], instants[-1]
    if offset.is_tick:
        first, last = _anchored_edges(first, last, offset.step_us, closed, tz)
        binner = _regular(first, last, offset.step_us)
    else:
        first, last = _normalize(first, tz), _normalize(last, tz)
        if closed == "left":
            first = _rollback(first, offset, tz)
        else:
            first = shift(first, offset, -1, tz)
        last = shift(last, offset, 1, tz)
        binner = date_range(first, last, offset, tz, ambiguous=True,
                            nonexistent="shift_forward")
    edges = binner
    if offset.kind in END_TYPES:
        if closed == "right":
            # the bins of an end-anchored offset reach to the end of its day
            edges = [localize(to_wall(b, tz) + DAY_US - 1, tz) for b in binner]
        if edges[-2] > instants[-1]:
            edges, binner = edges[:-1], binner[:-1]
    if instants[0] < edges[0]:
        raise ValueError("Values falls before first bin")
    if instants[-1] > edges[-1]:
        raise ValueError("Values falls after last bin")
    ends = []
    j = 0
    for edge in edges[1:]:
        while j < len(instants) and (
            instants[j] <= edge if closed == "right" else instants[j] < edge
        ):
            j += 1
        ends.append(j)
    labels = binner[1:] if label == "right" else binner
    return labels[: len(ends)], ends


def resample_indices(instants, offset, closed, label, tz):
    """pandas' ``Resampler.indices``: label -> positions of the instants in
    its bin, for the bins that hold any, in label order."""
    labels, ends = resample_bins(instants, offset, closed, label, tz)
    indices = {}
    begin = 0
    for at, end in zip(labels, ends):
        if begin < end:
            indices[at] = list(range(begin, end))
            begin = end
    return indices


def bin_label(us, offset, closed, label, tz):
    """The label of the bin of a one-instant resample holding ``us``
    (temporal.py's ``_get_bin_label``)."""
    labels, ends = resample_bins([us], offset, closed, label, tz)
    return labels[[i for i, end in enumerate(ends) if end > 0][0]]


def bin_start(us, offset, closed, tz):
    """The first left label of a one-instant resample (temporal.py's
    ``_get_bin_start``)."""
    return resample_bins([us], offset, closed, "left", tz)[0][0]


def shift_fraction(us, offset, n, tz):
    """temporal.py's ``_shift_datetime``: ``n`` steps of ``offset``; a
    fractional ``n`` moves that fraction through the span of the step it
    lands in (a Timedelta times a float, truncated to microseconds)."""
    if n == 0:
        return us
    offset = to_offset(offset)
    if not isinstance(n, float):
        return shift(us, offset, n, tz)
    whole = int(n // 1.0)
    lo = shift(us, offset, whole, tz)
    span = shift(us, offset, whole + 1, tz) - lo
    frac = n % 1.0 if n > 0 else -(n % 1.0)
    return lo + int(frac * float(span))


def closest_label(us, offset, tz, side="both"):
    """temporal.py's ``_get_closest_label``: the label nearest ``us``
    among the left-closed, left-labelled bin label of ``us`` and its two
    neighbours; ``side`` "right" keeps labels at or after ``us``, "left"
    at or before it."""
    offset = to_offset(offset)
    seed = bin_label(us, offset, "left", "left", tz)
    best = None
    for labelled in (shift(seed, offset, -1, tz), seed, shift(seed, offset, 1, tz)):
        gap = labelled - us
        if (side == "right" and gap < 0) or (side == "left" and gap > 0):
            continue
        if best is None or abs(gap) < abs(best - us):
            best = labelled
    return best
