"""Temporal raster blocks: Snap, Shift, TemporalSum, TemporalAggregate,
Cumulative, Resample, with their numpy processes and torch twins.

Counterparts of dask_geomodeling_tpu/raster/temporal.py.  The bin and
label arithmetic runs on the host while planning, on the port's own
resample calendar (geo/calendar.py) where the JAX package uses pandas; it
gives pandas 3.0.3's answers, the JAX package's quirks included (the
labels of TemporalAggregate step in naive UTC, ``_aggregate_labels``).
The numpy processes are copied; each twin follows its numpy process, not
the JAX package's twin, wherever the two differ:

- Snap and Resample gather frames along the band axis of (B, bands, h, w);
- Shift passes the values through;
- TemporalSum adds the frames one after another in numpy's result dtype
  (uint64 or int64 for the integer types, the float's own type);
- TemporalAggregate works on numpy's NaN-masked float copy
  (``_nan_masked_frames``: exact ``==`` nodata, ``result_type(float32,
  dtype)``); sums add the bin's frames in order, as numpy's reduction over
  the outer axis does; a mean or variance divides in float64 before
  rounding; the median is numpy's masked median (the two middle values
  halved) and ``p<q>`` numpy's linear method with its ``_lerp``;
- Cumulative accumulates each bin frame by frame.

Every statistic is served on the device.  The time subrequests that
TemporalAggregate and Cumulative take, and the time queries that Snap,
Cumulative and Resample make while planning, hold no pixels: they run on
the host and resolve no device (raster/base.py:get_data).
"""
import functools
import warnings
from datetime import timedelta as Timedelta
from functools import partial
from zoneinfo import ZoneInfo

import numpy as np
import torch

from dask_geomodeling_tpu_torch.core import arg, expect_instance
from dask_geomodeling_tpu_torch.device import equal_scalar, numpy_dtype, torch_dtype
from dask_geomodeling_tpu_torch.geo import (
    dtype_for_statistic,
    find_neigbours,
    get_dtype_max,
    normalize_offset,
    offset_to_timedelta,
    parse_percentile_statistic,
)
from dask_geomodeling_tpu_torch.geo import calendar
from dask_geomodeling_tpu_torch.geo.calendar import from_us, to_us
from dask_geomodeling_tpu_torch.raster.base import BaseSingle, RasterBlock
from dask_geomodeling_tpu_torch.raster.reduction import _nan_reduce
from dask_geomodeling_tpu_torch.registry import register

__all__ = [
    "Snap",
    "Shift",
    "TemporalSum",
    "TemporalAggregate",
    "Cumulative",
    "Resample",
]

MICROSECOND = Timedelta(microseconds=1)


def _validate_timezone(timezone):
    """Return the canonical IANA key, validating it exists."""
    return str(ZoneInfo(timezone).key)


def _snap_process(process_kwargs, data=None):
    """Re-index the store's frames onto the index raster's time axis.
    Reference: dask_geomodeling/raster/temporal.py (Snap.process)."""
    if process_kwargs is None or data is None:
        return data
    picks = np.asarray(process_kwargs["nearest"])
    if "values" in data:
        return {
            "values": data["values"][picks],
            "no_data_value": data["no_data_value"],
        }
    if "meta" in data:
        meta = data["meta"]
        return {"meta": [meta[i] for i in picks]}
    return data


def _snap_torch(process_kwargs, data=None):
    """Twin of ``_snap_process``: a gather on the band axis of (B, bands,
    h, w); anything without values runs the numpy process."""
    if process_kwargs is None or data is None or "values" not in data:
        return _snap_process(process_kwargs, data)
    values = data["values"]
    picks = np.asarray(process_kwargs["nearest"])
    if picks.dtype.kind not in "iu":  # numpy refuses an empty (float) index too
        raise IndexError("arrays used as indices must be of integer (or boolean) type")
    picks = torch.from_numpy(picks.astype(np.int64)).to(values.device)
    return {"values": values.index_select(1, picks), "no_data_value": data["no_data_value"]}


class Snap(BaseSingle):
    """Take cell values from 'store' with the time structure of 'index'.

    Spatial attributes delegate to the store (BaseSingle); the temporal
    ones — period, timedelta, temporal, length — come from the index.
    During planning this block queries the time structure of both inputs
    (nested host-side get_data, reference temporal.py:131)."""

    def __init__(self, store, index):
        expect_instance(index, RasterBlock, "index")
        super().__init__(store, index)

    index = arg(1)

    def __len__(self):
        return len(self.index)

    @property
    def period(self):
        return self.index.period if self.store else None

    @property
    def timedelta(self):
        return self.index.timedelta

    @property
    def temporal(self):
        return self.index.temporal

    def get_sources_and_requests(self, **request):
        store_period = self.store.period
        index_period = self.index.period

        if store_period is None or index_period is None:
            return [(None, None)]

        if request["mode"] == "time":
            return [(None, None), (self.index, request)]

        start = request.get("start")
        stop = request.get("stop")
        index_result = self.index.get_data(mode="time", start=start, stop=stop)
        if index_result is None:
            return [(None, None)]
        index_time = index_result["time"]

        if stop is None:
            request["start"] = index_time[0]
            return [(None, None), (self.store, request)]

        if store_period[0] == store_period[1]:
            store_time = [store_period[0]]
        else:
            # time structure near start, inside the interval, and near stop:
            # result frames may snap to store frames outside [start, stop]
            store_time = _probe_time_union(
                self.store, (start, None), (start, stop), (stop, None)
            )

        request["start"] = store_time[0]
        request["stop"] = store_time[-1]
        nearest = find_neigbours(store_time, index_time)
        process_kwargs = {"nearest": nearest.tolist()}
        return [(process_kwargs, None), (self.store, request)]

    process = staticmethod(_snap_process)


def _shift_process(data, time):
    if data is None:
        return None
    if "time" in data:
        return {"time": [t + time for t in data["time"]]}
    return data


class Shift(BaseSingle):
    """Shift a temporal raster by a timedelta (positive = into the future).

    Args:
      store (RasterBlock): raster to shift
      time (int or timedelta): shift in milliseconds
    """

    def __init__(self, store, time):
        if isinstance(time, Timedelta):
            time = int(time.total_seconds() * 1000)
        expect_instance(time, int, "time")
        super().__init__(store, time)

    @property
    def time(self):
        return Timedelta(milliseconds=self.args[1])

    @property
    def period(self):
        period = self.store.period
        if period is None:
            return None
        return period[0] + self.time, period[1] + self.time

    def get_sources_and_requests(self, **request):
        start = request.get("start", None)
        stop = request.get("stop", None)
        if start is not None:
            request["start"] = start - self.time
        if stop is not None:
            request["stop"] = stop - self.time
        return [(self.store, request), (self.time, None)]

    process = staticmethod(_shift_process)


def _temporal_sum_process(data):
    """Collapse the band axis with a plain sum, labelled by the LAST
    frame (time and meta keep only their final entry).  No nodata
    handling by design — TemporalAggregate is the nodata-aware variant.
    Reference: dask_geomodeling/raster/temporal.py (TemporalSum)."""
    if data is None:
        return None
    for key in ("time", "meta"):
        if key in data:
            return {key: data[key][-1:]}
    if "values" not in data:
        return data
    return {
        "values": data["values"].sum(axis=0, keepdims=True),
        "no_data_value": data["no_data_value"],
    }


def _in_order(layers):
    """The layers added one after another from the first, as numpy's
    reduction over an array's outer axis adds them."""
    return functools.reduce(torch.add, layers)


def _temporal_sum_torch(data):
    """Twin of ``_temporal_sum_process``: numpy's ``sum(axis=0)`` in its
    result dtype (integers widen to int64, or uint64 for the unsigned,
    which torch adds as int64 with the same bits)."""
    if data is None or "values" not in data:
        return _temporal_sum_process(data)
    values = data["values"]
    dtype = np.zeros(1, dtype=numpy_dtype(values.dtype)).sum().dtype
    work = torch.int64 if dtype.kind in "iub" else torch_dtype(dtype)
    total = _in_order(values.to(work).unbind(1))[:, None]
    if dtype == np.uint64:
        total = total.view(torch.uint64)
    return {"values": total, "no_data_value": data["no_data_value"]}


class TemporalSum(BaseSingle):
    """Sum all frames into a single band (no nodata handling; see
    TemporalAggregate for the nodata-aware variant)."""

    process = staticmethod(_temporal_sum_process)


# --- label/bin helpers (host-side metadata math, on geo/calendar.py) ---


def _get_bin_label(dt, frequency, closed, label, timezone):
    """The label of the resampling bin that ``dt`` falls in."""
    return from_us(calendar.bin_label(to_us(dt), frequency, closed, label, ZoneInfo(timezone)))


def _get_bin_start(dt, frequency, closed, label, timezone):
    """The (left) start of the bin ``dt`` falls in."""
    return from_us(calendar.bin_start(to_us(dt), frequency, closed, ZoneInfo(timezone)))


def _shift_datetime(dt, frequency, timezone, n):
    """Shift a naive datetime ``n`` frequency steps; fractions interpolate."""
    return from_us(calendar.shift_fraction(to_us(dt), frequency, n, ZoneInfo(timezone)))


def _get_closest_label(dt, frequency, timezone, side="both"):
    """The resampling label nearest ``dt``; ``side`` restricts direction."""
    return from_us(calendar.closest_label(to_us(dt), frequency, ZoneInfo(timezone), side))


def _validate_resampling(statistic, allowed, frequency, closed, label, timezone):
    """Shared constructor validation for the resampling blocks; returns
    the normalized (statistic, frequency, closed, label, timezone)."""
    if frequency is not None:
        expect_instance(frequency, str, "frequency")
        frequency = normalize_offset(frequency)
        if closed not in {None, "left", "right"}:
            raise ValueError("closed must be None, 'left', or 'right'.")
        if label not in {None, "left", "right"}:
            raise ValueError("label must be None, 'left', or 'right'.")
        expect_instance(timezone, str, "timezone")
        timezone = _validate_timezone(timezone)
    else:
        closed = label = timezone = None
    expect_instance(statistic, str, "statistic")
    statistic, percentile = parse_percentile_statistic(statistic.lower())
    if percentile is not None:
        statistic = "p{0}".format(percentile)
    elif statistic not in allowed:
        raise ValueError("Unknown statistic '{}'".format(statistic))
    return statistic, frequency, closed, label, timezone


def _bin_conventions(frequency, closed, label, timezone):
    """The keyword set every label/bin helper consumes."""
    if frequency is None:
        closed, label = "right", "right"
    else:
        closed, label = calendar.default_closed_label(frequency, closed, label)
    return {
        "frequency": frequency,
        "closed": closed,
        "label": label,
        "timezone": timezone,
    }


def _bin_bounds(dt, frequency, closed, label, timezone, side):
    """One bound of the bin labeled ``dt``: the bin spans one frequency
    step anchored at its label (shifted when labels sit on the other
    edge), and the open edge is nudged by a microsecond per the pandas
    closed/label conventions."""
    zone = ZoneInfo(timezone)
    us = to_us(dt)
    # the far edge for each side, and which way the label shift points
    other, inward = ("right", False) if side == "start" else ("left", True)
    if label == other:
        us = calendar.shift(us, frequency, 1 if inward else -1, zone)
    if closed == other:
        us = us - 1 if inward else us + 1
    return from_us(us)


def _resampled_period(period, frequency, closed, label, timezone):
    """The (start, stop) label interval containing data after resampling."""
    if period is None:
        return None
    if frequency is None:
        return period[-1], period[-1]
    return tuple(
        _get_bin_label(x, frequency, closed, label, timezone) for x in period
    )


def _snap_to_resampled_labels(period, start, stop, frequency, timezone):
    """Clamp a requested [start, stop] window onto resampled bin labels.

    Returns ``(None, None)`` when the window misses the labelled period
    entirely; an instant request (``stop is None``) keeps ``stop`` None.
    """
    if period is None:
        return None, None
    first, last = period

    if stop is None:
        # instant request: the single nearest label (newest by default)
        at = last if start is None else min(max(start, first), last)
        if first < at < last:
            at = _get_closest_label(at, frequency, timezone, side="both")
        return at, None

    lo = last if start is None else start
    if lo > last or stop < first:
        return None, None
    if lo > first:
        lo = _get_closest_label(lo, frequency, timezone, side="right")
    else:
        lo = first
    hi = last
    if stop < last:
        hi = _get_closest_label(stop, frequency, timezone, side="left")
    if lo > hi:
        return None, None
    return lo, hi


def _labels_to_start_stop(start_label, stop_label, frequency, closed, label, timezone):
    """Source start/stop covering the bins of the given labels."""
    assert frequency is not None
    edges = ((start_label, "start"), (stop_label or start_label, "end"))
    return tuple(
        _bin_bounds(dt, frequency, closed, label, timezone, side)
        for dt, side in edges
    )


def _get_label_range(start_label, stop_label, frequency, timezone):
    """Every label from ``start_label`` through ``stop_label``, inclusive."""
    if stop_label is None:
        return [start_label]
    ticks = calendar.date_range(
        to_us(start_label), to_us(stop_label), frequency, ZoneInfo(timezone)
    )
    return [from_us(tick) for tick in ticks]


def count_not_nan(x, *args, **kwargs):
    """Count of non-NaN values along an axis."""
    return np.sum(~np.isnan(x), *args, **kwargs)


def _probe_time_union(block, *windows):
    """Sorted union of a block's time structure over several windows."""
    instants = set()
    for start, stop in windows:
        result = block.get_data(mode="time", start=start, stop=stop)
        if result is not None:
            instants |= set(result["time"])
    return sorted(instants)


def _resolve_reducer(statistic_string, table):
    """(reducer, extensive) for a statistic name or p<percentile>."""
    statistic, percentile = parse_percentile_statistic(statistic_string)
    if percentile is not None:
        return partial(np.nanpercentile, q=percentile), False
    return table[statistic]["func"], table[statistic]["extensive"]


def _nan_masked_frames(data, expected_frames, dtype):
    """Float working copy of the pixel stack with NaN at nodata cells."""
    values = data["values"]
    if values.shape[0] != expected_frames:
        raise RuntimeError("Shape of raster does not match number of timestamps")
    out = values.astype(np.result_type(np.float32, dtype))
    out[values == data["no_data_value"]] = np.nan
    return out


def _nan_masked_frames_torch(data, expected_frames, dtype):
    """Twin of ``_nan_masked_frames`` on (B, frames, h, w)."""
    values = data["values"]
    if values.shape[1] != expected_frames:
        raise RuntimeError("Shape of raster does not match number of timestamps")
    work = torch_dtype(np.result_type(np.float32, dtype))
    nodata = equal_scalar(values, data["no_data_value"])
    return torch.where(nodata, torch.nan, values.to(work))


class _StatisticDtypeMixin:
    """dtype/fillvalue derived from the source dtype and the statistic."""

    @property
    def dtype(self):
        return dtype_for_statistic(self.source.dtype, self.statistic)

    @property
    def fillvalue(self):
        return get_dtype_max(self.dtype)


def _sorted_instants(times):
    """The instants of a time answer in ascending order, as pandas sorts
    the index it resamples (bin positions refer to that order)."""
    return sorted(to_us(t) for t in times)


def _aggregate_labels(process_kwargs):
    """TemporalAggregate's labels: a naive date range from start to stop,
    read as UTC instants (pandas' ``date_range`` of naive datetimes, then
    ``tz_localize("UTC")``, temporal.py:492-501).  Across a DST switch
    this steps in UTC, not in the block's zone."""
    start, stop = process_kwargs["start"], process_kwargs["stop"]
    frequency = process_kwargs["frequency"]
    if frequency is None:
        return [to_us(start)]
    return calendar.date_range(to_us(start), to_us(stop or start), frequency, None)


def _aggregate_labels_and_indices(process_kwargs, time_data):
    """Shared host-side label/bin-index computation for TemporalAggregate:
    the labels, and label -> frame positions for the bins holding any."""
    labels = _aggregate_labels(process_kwargs)
    times = _sorted_instants(time_data["time"])
    frequency = process_kwargs["frequency"]
    if frequency is None:
        return labels, {labels[0]: list(range(len(times)))}
    indices = calendar.resample_indices(
        times, frequency, process_kwargs["closed"], process_kwargs["label"],
        ZoneInfo(process_kwargs["timezone"]),
    )
    return labels, indices


def _aggregate_process(process_kwargs, time_data=None, data=None):
    mode = process_kwargs["mode"]
    if process_kwargs.get("empty"):
        return None if mode == "vals" else {mode: []}
    if mode == "time":
        return {"time": [from_us(label) for label in _aggregate_labels(process_kwargs)]}

    if time_data is None or not time_data.get("time"):
        return None if mode == "vals" else {mode: []}

    labels, indices = _aggregate_labels_and_indices(process_kwargs, time_data)

    if mode == "meta":
        if data is None or "meta" not in data:
            return {"meta": []}
        meta = data["meta"]
        return {"meta": [[meta[i] for i in indices.get(ts, [])] for ts in labels]}

    if data is None or "values" not in data:
        return None

    agg_func, extensive = _resolve_reducer(
        process_kwargs["statistic"], TemporalAggregate.STATISTICS
    )
    dtype = process_kwargs["dtype"]
    fillvalue = 0 if extensive else get_dtype_max(dtype)
    values = _nan_masked_frames(data, len(time_data["time"]), dtype)

    result = np.full(
        shape=(len(labels), values.shape[1], values.shape[2]),
        fill_value=fillvalue,
        dtype=dtype,
    )

    for i, timestamp in enumerate(labels):
        inds = indices.get(timestamp, [])
        if len(inds) == 0:
            continue
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", category=RuntimeWarning)
            aggregated = agg_func(values[inds], axis=0)
        no_data_mask = ~np.isfinite(aggregated)
        if dtype != aggregated.dtype:
            aggregated = aggregated.astype(dtype)
        aggregated[no_data_mask] = fillvalue
        result[i] = aggregated

    return {"values": result, "no_data_value": get_dtype_max(dtype)}


def _bin_statistic(stack, statistic, percentile):
    """numpy's nan-statistic over the frames (axis 0) of ``stack``, in the
    stack's float dtype (count in int64): the reductions' statistic with
    the frames summed in order; cells without data come out NaN, but for
    sum and count."""
    count = (~torch.isnan(stack)).sum(0)
    if statistic == "count":
        return count
    reduced = _nan_reduce(stack, statistic, percentile, add=_in_order)
    if statistic == "sum":
        return reduced
    return torch.where(count > 0, reduced, torch.nan)


def _to_output(aggregated, dtype, fillvalue):
    """numpy's ``aggregated.astype(dtype)`` with the non-finite cells set
    to ``fillvalue``."""
    finite = torch.isfinite(aggregated)
    cast = aggregated.to(torch_dtype(dtype))
    return torch.where(finite, cast, torch.full((), fillvalue, dtype=cast.dtype, device=cast.device))


def _aggregate_torch(process_kwargs, time_data=None, data=None):
    """Twin of ``_aggregate_process`` for vals: the labels and bins come
    from the host, each bin's statistic runs on the device over the
    batch's (B, frames, h, w)."""
    if time_data is None or not time_data.get("time") or data is None or "values" not in data:
        return _aggregate_process(process_kwargs, time_data, data)
    labels, indices = _aggregate_labels_and_indices(process_kwargs, time_data)
    statistic, percentile = parse_percentile_statistic(process_kwargs["statistic"])
    extensive = percentile is None and TemporalAggregate.STATISTICS[statistic]["extensive"]
    dtype = np.dtype(process_kwargs["dtype"])
    fillvalue = dtype.type(0 if extensive else get_dtype_max(dtype)).item()
    values = _nan_masked_frames_torch(data, len(time_data["time"]), dtype)
    batch, _, height, width = values.shape
    result = torch.full((batch, len(labels), height, width), fillvalue,
                        dtype=torch_dtype(dtype), device=values.device)
    for i, timestamp in enumerate(labels):
        inds = indices.get(timestamp, [])
        if inds:
            stack = values[:, inds].movedim(1, 0)
            result[:, i] = _to_output(_bin_statistic(stack, statistic, percentile), dtype, fillvalue)
    return {"values": result, "no_data_value": get_dtype_max(dtype)}


def _vals_plan(process_kwargs, *args):
    """The temporal twins serve vals plans that are not empty; time, meta
    and empty answers come from the numpy processes on the host."""
    return (
        isinstance(process_kwargs, dict)
        and not process_kwargs.get("empty")
        and process_kwargs.get("mode") == "vals"
    )


class TemporalAggregate(_StatisticDtypeMixin, BaseSingle):
    """Aggregate a temporal raster into resampling bins.

    Args:
      source (RasterBlock): input raster
      frequency (str or None): pandas offset string; None aggregates the
        whole period into one frame
      statistic (str): sum count min max mean median std var p<percentile>
      closed, label (str or None): bin interval conventions (pandas)
      timezone (str): timezone the resampling is performed in
    """

    STATISTICS = {
        "sum": {"func": np.nansum, "extensive": True},
        "count": {"func": count_not_nan, "extensive": True},
        "min": {"func": np.nanmin, "extensive": False},
        "max": {"func": np.nanmax, "extensive": False},
        "mean": {"func": np.nanmean, "extensive": False},
        "median": {"func": np.nanmedian, "extensive": False},
        "std": {"func": np.nanstd, "extensive": False},
        "var": {"func": np.nanvar, "extensive": False},
    }

    def __init__(
        self,
        source,
        frequency,
        statistic="sum",
        closed=None,
        label=None,
        timezone="UTC",
    ):
        expect_instance(source, RasterBlock, "source")
        statistic, frequency, closed, label, timezone = _validate_resampling(
            statistic, self.STATISTICS, frequency, closed, label, timezone
        )
        super().__init__(source, frequency, statistic, closed, label, timezone)

    source = arg(0)
    statistic = arg(2)
    closed = arg(3)
    label = arg(4)
    timezone = arg(5)

    @property
    def frequency(self):
        return normalize_offset(self.args[1])

    @property
    def _snap_kwargs(self):
        return _bin_conventions(
            self.frequency, self.closed, self.label, self.timezone
        )

    @property
    def period(self):
        return _resampled_period(self.source.period, **self._snap_kwargs)

    @property
    def timedelta(self):
        if self.frequency is None:
            return None
        return offset_to_timedelta(self.frequency)

    @property
    def temporal(self):
        return self.frequency is not None

    def get_sources_and_requests(self, **request):
        mode = request["mode"]
        start_label, stop_label = _snap_to_resampled_labels(
            self.period,
            request.get("start"),
            request.get("stop"),
            frequency=self.frequency,
            timezone=self.timezone,
        )
        if start_label is None:
            return [({"empty": True, "mode": mode}, None)]

        conventions = self._snap_kwargs
        plan = dict(conventions, mode=mode, start=start_label, stop=stop_label)
        if mode == "time":
            return [(plan, None)]

        # the source window covering the labeled bins
        if self.frequency is None:
            window = self.source.period
        else:
            window = _labels_to_start_stop(start_label, stop_label, **conventions)
        request["start"], request["stop"] = window

        if mode == "vals":
            plan["dtype"] = np.dtype(self.dtype).str
            plan["statistic"] = self.statistic

        time_request = {"mode": "time", "start": window[0], "stop": window[1]}
        if "time_resolution" in request:
            time_request["time_resolution"] = request["time_resolution"]
        return [(plan, None), (self.source, time_request), (self.source, request)]

    process = staticmethod(_aggregate_process)


def accumulate_count_not_nan(x, *args, **kwargs):
    """Running count of non-NaN values along an axis."""
    return np.cumsum(~np.isnan(x), *args, **kwargs)


def _cumulative_bins(process_kwargs, time_data):
    """(sorted instants, label -> positions of the bins holding any) of
    Cumulative's resets."""
    times = _sorted_instants(time_data["time"])
    frequency = process_kwargs["frequency"]
    if frequency is None:
        return times, {None: list(range(len(times)))}
    return times, calendar.resample_indices(
        times, frequency, process_kwargs["closed"], process_kwargs["label"],
        ZoneInfo(process_kwargs["timezone"]),
    )


def _cumulative_process(process_kwargs, time_data=None, data=None):
    mode = process_kwargs["mode"]
    if process_kwargs.get("empty"):
        return None if mode == "vals" else {mode: []}
    if mode == "time":
        return time_data
    if time_data is None or not time_data.get("time"):
        return None if mode == "vals" else {mode: []}

    times, indices = _cumulative_bins(process_kwargs, time_data)
    start_ts = to_us(process_kwargs["start"])
    stop_ts = to_us(process_kwargs["stop"])

    if mode == "meta":
        if data is None or "meta" not in data:
            return {"meta": []}
        meta = data["meta"]
        result = []
        for indices_in_bin in indices.values():
            for length in range(1, len(indices_in_bin) + 1):
                indices_for_cumulative = indices_in_bin[:length]
                ts = times[indices_for_cumulative[-1]]
                if ts < start_ts or ts > stop_ts:
                    continue
                result.append([meta[i] for i in indices_for_cumulative])
        return {"meta": result}

    if data is None or "values" not in data:
        return None

    agg_func, extensive = _resolve_reducer(
        process_kwargs["statistic"], Cumulative.STATISTICS
    )
    dtype = process_kwargs["dtype"]
    fillvalue = 0 if extensive else get_dtype_max(dtype)
    values = _nan_masked_frames(data, len(times), dtype)

    instants = np.asarray(times)
    output_mask = (instants >= start_ts) & (instants <= stop_ts)
    output_offset = np.where(output_mask)[0][0]
    n_frames = output_mask.sum()
    result = np.full(
        shape=(n_frames, values.shape[1], values.shape[2]),
        fill_value=fillvalue,
        dtype=dtype,
    )

    for indices_in_bin in indices.values():
        mask = output_mask[np.asarray(indices_in_bin)]
        bin_data = values[np.asarray(indices_in_bin)]
        accumulated = agg_func(bin_data, axis=0)[mask]
        no_data_mask = ~np.isfinite(accumulated)
        if dtype != accumulated.dtype:
            accumulated = accumulated.astype(dtype)
        accumulated[no_data_mask] = fillvalue
        indices_in_result = np.asarray(indices_in_bin)[mask] - output_offset
        result[indices_in_result] = accumulated

    return {"values": result, "no_data_value": get_dtype_max(dtype)}


def _cumulative_plan(process_kwargs, *args):
    """The twin serves the vals plans of the statistics it accumulates,
    sum and count.  The constructor also takes ``p<q>``, over which the
    numpy process raises (it masks the bin's (h, w) percentile with a
    per-frame mask); such a node has no twin."""
    return _vals_plan(process_kwargs) and process_kwargs.get("statistic") in ("sum", "count")


def _cumulative_torch(process_kwargs, time_data=None, data=None):
    """Twin of ``_cumulative_process`` for vals: each bin accumulates
    frame by frame on the device (numpy's ``nancumsum`` order), and the
    frames inside the requested window are written out."""
    if time_data is None or not time_data.get("time") or data is None or "values" not in data:
        return _cumulative_process(process_kwargs, time_data, data)
    times, indices = _cumulative_bins(process_kwargs, time_data)
    start_ts = to_us(process_kwargs["start"])
    stop_ts = to_us(process_kwargs["stop"])
    dtype = np.dtype(process_kwargs["dtype"])
    fillvalue = dtype.type(0).item()  # sum and count are extensive
    values = _nan_masked_frames_torch(data, len(times), dtype)
    inside = [start_ts <= t <= stop_ts for t in times]
    offset = inside.index(True)
    batch, _, height, width = values.shape
    result = torch.full((batch, sum(inside), height, width), fillvalue,
                        dtype=torch_dtype(dtype), device=values.device)
    count = process_kwargs["statistic"] == "count"
    for indices_in_bin in indices.values():
        running = None
        for position in indices_in_bin:
            frame = values[:, position]
            nan = torch.isnan(frame)
            step = (~nan).to(torch.int64) if count else torch.where(nan, 0, frame)
            running = step if running is None else running + step
            if inside[position]:
                result[:, position - offset] = _to_output(running, dtype, fillvalue)
    return {"values": result, "no_data_value": get_dtype_max(dtype)}


class Cumulative(_StatisticDtypeMixin, BaseSingle):
    """Accumulate cell values over time, resetting each frequency period.

    Args:
      source (RasterBlock): input raster
      statistic (str): "sum" or "count"
      frequency (str or None): reset period as pandas offset string
      timezone (str): timezone the period reset is computed in
    """

    STATISTICS = {
        "sum": {"func": np.nancumsum, "extensive": True},
        "count": {"func": accumulate_count_not_nan, "extensive": True},
    }

    def __init__(self, source, statistic="sum", frequency=None, timezone="UTC"):
        expect_instance(source, RasterBlock, "source")
        statistic, frequency, _, _, timezone = _validate_resampling(
            statistic, self.STATISTICS, frequency, "right", "right", timezone
        )
        super().__init__(source, statistic, frequency, timezone)

    source = arg(0)
    statistic = arg(1)
    timezone = arg(3)

    @property
    def frequency(self):
        return normalize_offset(self.args[2])

    @property
    def _snap_kwargs(self):
        return _bin_conventions(self.frequency, "right", "right", self.timezone)

    def get_sources_and_requests(self, **request):
        mode = request["mode"]
        if mode == "time":
            return [({"mode": "time"}, None), (self.source, request)]

        # nested host-side evaluation: the output times determine how far
        # back the accumulation must reach (reference temporal.py:875)
        time_data = self.source.get_data(
            mode="time", start=request.get("start"), stop=request.get("stop")
        )
        if time_data is None or not time_data.get("time"):
            return [({"empty": True, "mode": mode}, None)]
        first, last = time_data["time"][0], time_data["time"][-1]

        conventions = self._snap_kwargs
        if self.frequency is None:
            request["start"] = self.source.period[0]
            request["stop"] = last
        else:
            # reach back to the start of the bin containing the first frame
            request["start"] = _get_bin_start(first, **conventions)
            request["stop"] = last
            if conventions["closed"] != "left":
                request["stop"] += MICROSECOND

        plan = dict(conventions, mode=mode, start=first, stop=last)
        if mode == "vals":
            plan["dtype"] = np.dtype(self.dtype).str
            plan["statistic"] = self.statistic

        time_request = {
            "mode": "time",
            "start": request["start"],
            "stop": request["stop"],
        }
        return [(plan, None), (self.source, time_request), (self.source, request)]

    process = staticmethod(_cumulative_process)


def _resample_process(process_kwargs, data=None):
    mode = process_kwargs["mode"]
    if process_kwargs.get("empty"):
        return None if mode == "vals" else {mode: []}
    if mode == "time":
        labels = _get_label_range(
            process_kwargs["start"],
            process_kwargs["stop"],
            frequency=process_kwargs["frequency"],
            timezone=process_kwargs["timezone"],
        )
        return {"time": labels}
    # vals/meta: re-index the source frames onto the labels
    return _snap_process({"nearest": process_kwargs["nearest"]}, data)


def _resample_torch(process_kwargs, data=None):
    """Twin of ``_resample_process`` for vals: Snap's band gather."""
    return _snap_torch({"nearest": process_kwargs["nearest"]}, data)


class Resample(BaseSingle):
    """Re-snap raster frames to a new time frequency.

    Args:
      source (RasterBlock): input raster
      frequency (str): pandas offset string to resample to
      direction (str): 'nearest', 'backward', or 'forward'
      timezone (str): timezone the label math is performed in
    """

    def __init__(self, source, frequency, direction="nearest", timezone="UTC"):
        expect_instance(source, RasterBlock, "source")
        expect_instance(frequency, str, "frequency")
        frequency = normalize_offset(frequency)
        expect_instance(timezone, str, "timezone")
        timezone = _validate_timezone(timezone)
        expect_instance(direction, str, "direction")
        if direction not in {"nearest", "backward", "forward"}:
            raise ValueError(
                "direction must be one of 'nearest', 'backward', or 'forward'."
            )
        super().__init__(source, frequency, direction, timezone)

    source = arg(0)
    direction = arg(2)
    timezone = arg(3)

    @property
    def frequency(self):
        return normalize_offset(self.args[1])

    def _label_kwargs(self):
        return {"frequency": self.frequency, "timezone": self.timezone}

    @property
    def period(self):
        """The (start, stop) label period of the resampled raster.

        Labels snap to source frames within one period of them; the edge
        labels are found by inverting that relation per direction (see the
        reference's derivation, temporal.py:1080-1125)."""
        source_period = self.source.period
        if source_period is None:
            return None
        kwargs = self._label_kwargs()
        if self.direction in {"forward", "backward"}:
            side = "left" if self.direction == "forward" else "right"
            return (
                _get_closest_label(source_period[0], side=side, **kwargs),
                _get_closest_label(source_period[1], side=side, **kwargs),
            )
        period_start = _get_closest_label(source_period[0], side="left", **kwargs)
        if source_period[0] >= _shift_datetime(period_start, n=0.5, **kwargs):
            period_start = _get_closest_label(
                source_period[0], side="right", **kwargs
            )
        period_end = _get_closest_label(source_period[1], side="right", **kwargs)
        if source_period[1] < _shift_datetime(period_end, n=-0.5, **kwargs):
            period_end = _get_closest_label(source_period[1], side="left", **kwargs)
        return (period_start, period_end)

    @property
    def timedelta(self):
        return offset_to_timedelta(self.frequency)

    def get_sources_and_requests(self, **request):
        process_kwargs = {
            "mode": request["mode"],
            "direction": self.direction,
            **self._label_kwargs(),
        }

        process_kwargs["start"], process_kwargs["stop"] = _snap_to_resampled_labels(
            self.period,
            request.get("start"),
            request.get("stop"),
            **self._label_kwargs(),
        )
        if process_kwargs["start"] is None:
            return [({"empty": True, "mode": process_kwargs["mode"]}, None)]

        if process_kwargs["mode"] == "time":
            return [(process_kwargs, None)]

        index_time = _get_label_range(
            process_kwargs["start"], process_kwargs["stop"], **self._label_kwargs()
        )
        if self.direction == "forward":
            shift = 0
        elif self.direction == "backward":
            shift = -1
        else:
            shift = -0.5
        index_start = _shift_datetime(
            process_kwargs["start"], n=shift, **self._label_kwargs()
        )
        index_stop = _shift_datetime(
            process_kwargs["stop"] or process_kwargs["start"],
            n=shift + 1,
            **self._label_kwargs(),
        )

        store_time = _probe_time_union(
            self.store,
            (index_start, None),
            (index_start, index_stop),
            (index_stop, None),
        )
        if not store_time:
            return [({"empty": True, "mode": process_kwargs["mode"]}, None)]
        nearest = find_neigbours(store_time, index_time, self.direction)
        request["start"] = store_time[nearest.min()]
        request["stop"] = store_time[nearest.max()]
        process_kwargs["nearest"] = (nearest - nearest.min()).tolist()
        return [(process_kwargs, None), (self.store, request)]

    process = staticmethod(_resample_process)


register(_snap_process, _snap_torch)
register(_shift_process, _shift_process)  # the values pass through as they are
register(_temporal_sum_process, _temporal_sum_torch)
register(_aggregate_process, _aggregate_torch, capable=_vals_plan)
register(_cumulative_process, _cumulative_torch, capable=_cumulative_plan)
register(_resample_process, _resample_torch, capable=_vals_plan)
