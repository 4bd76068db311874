"""Band snapping of a request's time window (counterparts of
dask_geomodeling_tpu/geo/timeutils.py:snap_start_stop, dt_to_ms and
filter_none)."""
from datetime import timezone

import numpy as np

__all__ = ["snap_start_stop", "dt_to_ms", "filter_none"]


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


def dt_to_ms(dt):
    """Naive-UTC datetime -> POSIX milliseconds."""
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return int(dt.timestamp() * 1000)


def filter_none(lst):
    """Drop None entries from a list."""
    return [x for x in lst if x is not None]
