"""Band snapping, neighbour search and offset strings (counterparts of
dask_geomodeling_tpu/geo/timeutils.py).

``normalize_offset`` and ``offset_to_timedelta`` read offsets with the
port's own calendar (geo/calendar.py) in place of pandas; the normalized
string is a Block argument, so it enters the token, and it is pandas
3.0.3's ``freqstr`` exactly.
"""
import re
from datetime import datetime, timedelta, timezone

import numpy as np

from dask_geomodeling_tpu_torch.geo.calendar import to_offset

__all__ = [
    "snap_start_stop",
    "find_neigbours",
    "dt_to_ms",
    "ms_to_dt",
    "filter_none",
    "offset_to_timedelta",
    "normalize_offset",
]

# aliases removed in pandas 3.0 (kept for user-facing compatibility with
# views serialized by older pandas-based deployments)
_REMOVED_ALIASES = {
    "M": "ME", "BM": "BME", "SM": "SME", "CBM": "CBME",
    "Q": "QE", "BQ": "BQE", "Y": "YE", "BY": "BYE",
    "A": "YE", "BA": "BYE", "AS": "YS", "BAS": "BYS",
    "H": "h", "BH": "bh", "CBH": "cbh",
    "T": "min", "S": "s", "L": "ms", "U": "us", "N": "ns",
}


def snap_start_stop(start, stop, time_first, time_delta, length):
    """Snap requested [start, stop] onto an equidistant time axis.

    Returns ``(start, stop, first_i, last_i)``; all None for empty rasters
    or non-overlapping closed intervals.  Variants:

    - start is None: the last frame
    - stop is None: the frame nearest to start (clamped to the period)
    - both given: all frames in the closed interval
    """
    if length == 0:
        return (None,) * 4
    if length > 1 and time_delta is None:
        raise ValueError("Length > 1 requires a timedelta")

    last = length - 1

    def frame(i):
        return time_first if length == 1 else time_first + time_delta * i

    axis_end = frame(last)

    if start is None:
        return axis_end, axis_end, last, last

    if stop is None:
        if length == 1 or start <= time_first:
            i = 0
        elif start >= axis_end:
            i = last
        else:
            i = int(round((start - time_first) / time_delta))
        return frame(i), frame(i), i, i

    if start > axis_end or stop < time_first:
        return (None,) * 4
    if length == 1:
        return time_first, time_first, 0, 0
    first_i = max(int(np.ceil((start - time_first) / time_delta)), 0)
    last_i = min(int(np.floor((stop - time_first) / time_delta)), last)
    if first_i > last_i:
        # the closed interval lies strictly between two frames
        return (None,) * 4
    return frame(first_i), frame(last_i), first_i, last_i


def find_neigbours(array, value, direction="nearest"):
    """Indices of the nearest/forward/backward neighbours of ``value`` in a
    sorted 1-D ``array``; never out of bounds."""
    array = np.asarray(array)
    value = np.asarray(value)
    if array.size == 1:
        return np.zeros(value.shape, dtype=int)
    if direction == "forward":
        raw = np.searchsorted(array, value, side="left")
    elif direction == "backward":
        raw = np.searchsorted(array, value, side="right") - 1
    elif direction == "nearest":
        # bisect against the midpoints: which side of a midpoint a value
        # falls on decides which element is nearest
        raw = np.searchsorted(array[:-1] + (array[1:] - array[:-1]) / 2, value)
    else:
        raise ValueError("Unknown direction: {}".format(direction))
    return np.clip(raw, 0, array.size - 1)


def dt_to_ms(dt):
    """Naive-UTC datetime -> POSIX milliseconds."""
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return int(dt.timestamp() * 1000)


def ms_to_dt(ms):
    """POSIX milliseconds -> naive-UTC datetime."""
    return datetime(1970, 1, 1) + timedelta(milliseconds=ms)


def filter_none(lst):
    """Drop None entries from a list."""
    return [x for x in lst if x is not None]


def offset_to_timedelta(freq):
    """Frequency string -> timedelta for the fixed offsets (the ticks and
    ``D``), None for the others (e.g. month ends) and for strings that are
    no offset."""
    try:
        step = to_offset(normalize_offset(freq)).step_us
    except (TypeError, ValueError, NotImplementedError):
        return None
    return None if step is None else timedelta(microseconds=step)


def normalize_offset(freq):
    """Normalize a frequency string to pandas 3's ``freqstr`` (pre-3.0
    aliases like 'M', 'H', 'S' are translated, including anchored forms
    like 'Q-DEC' or 'A-JAN')."""
    if freq is None:
        return None
    match = re.match(r"^(\d*)([^-]+)(-.+)?$", freq)
    if match:
        prefix, alias, anchor = match.groups()
        if alias in _REMOVED_ALIASES:
            freq = prefix + _REMOVED_ALIASES[alias] + (anchor or "")
    return to_offset(freq).freqstr
