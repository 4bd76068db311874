"""Raster combination: Group, its numpy process and its torch twin.

Counterpart of dask_geomodeling_tpu/raster/combine.py: greedy attributes
(period/extent unions), relevant-source selection by period overlap with
a closest-store fallback, and two merge strategies.  ``by_bands`` serves
sources that tick on one aligned clock (slice assignment into the result
stack); ``by_time`` serves the others, with extra mode='time'
subrequests that map each source's frames onto the unified axis.  Those
time requests run on the host (their inputs are host literals); only the
vals merges have a twin, which works batch-first on (B, bands, h, w).
"""
import itertools
from datetime import timedelta as Timedelta

import numpy as np
import torch

from dask_geomodeling_tpu_torch.core import expect_instance
from dask_geomodeling_tpu_torch.device import data_mask, torch_dtype
from dask_geomodeling_tpu_torch.geo import (
    Extent,
    GeoTransform,
    filter_none,
    get_dtype_max,
    get_index,
)
from dask_geomodeling_tpu_torch.raster.base import RasterBlock
from dask_geomodeling_tpu_torch.registry import register

__all__ = ["Group"]


def _combined(values, reduce_many):
    """None when nothing is present, the single value when one is, the
    reduction otherwise: the shape of every greedy Group attribute."""
    present = filter_none(values)
    if not present:
        return None
    if len(present) == 1:
        return present[0]
    return reduce_many(present)


class BaseCombine(RasterBlock):
    """Base for blocks combining rasters into a larger one (greedy
    attributes; rasters without data are ignored)."""

    def __init__(self, *args):
        for source in args:
            expect_instance(source, RasterBlock, "source")
        super().__init__(*args)

    @staticmethod
    def get_aligned_timedelta(sources):
        """The common timedelta if all sources tick on one clock, else None."""
        clocks = [
            (s.timedelta, s.period[0])
            for s in sources
            if s.timedelta is not None and s.period is not None
        ]
        if not clocks:
            return None
        step, anchor = clocks[0]
        if any(other_step != step for other_step, _ in clocks[1:]):
            return None
        seconds = step.total_seconds()
        # every origin must sit a whole number of steps from the first
        if any(
            (anchor - origin).total_seconds() % seconds
            for _, origin in clocks[1:]
        ):
            return None
        return step

    @property
    def timedelta(self):
        return self.get_aligned_timedelta(self.args)

    @property
    def temporal(self):
        return any(source.temporal for source in self.args)

    @property
    def period(self):
        return _combined(
            [source.period for source in self.args],
            lambda spans: (
                min(span[0] for span in spans),
                max(span[1] for span in spans),
            ),
        )

    @property
    def extent(self):
        return _combined(
            [source.extent for source in self.args],
            lambda boxes: (
                min(box[0] for box in boxes),
                min(box[1] for box in boxes),
                max(box[2] for box in boxes),
                max(box[3] for box in boxes),
            ),
        )

    @property
    def dtype(self):
        return np.result_type(*self.args)

    @property
    def fillvalue(self):
        return get_dtype_max(self.dtype)

    @property
    def geometry(self):
        def union_all(geometries):
            extent = Extent.from_geometry(geometries[0])
            for geometry in geometries[1:]:
                extent = extent.union(Extent.from_geometry(geometry))
            return extent.as_geometry()

        return _combined([source.geometry for source in self.args], union_all)

    @property
    def projection(self):
        candidates = [source.projection for source in self.args]
        first = candidates[0]
        if first is None or any(other != first for other in candidates[1:]):
            return None
        return first

    @property
    def geo_transform(self):
        first = self.args[0].geo_transform
        if first is None:
            return None
        first = GeoTransform(first)
        for source in self.args[1:]:
            other = source.geo_transform
            if other is None or not first.aligns_with(other):
                return None
        return first


def _snap_window_to_grid(start, stop, period, td_sec):
    """Clamp [start, stop] to ``period`` and snap both ends onto the
    equidistant frame grid anchored at the period origin (start rounds up
    to the next frame, stop rounds down to the previous one)."""
    origin, period_end = period
    if start is None:
        start = period_end
    elif start < origin:
        start = origin
    else:
        remainder = (origin - start).total_seconds() % td_sec
        start += Timedelta(seconds=remainder)
    if stop is None:
        stop = start
    elif stop > period_end:
        stop = period_end
    else:
        remainder = (stop - origin).total_seconds() % td_sec
        stop -= Timedelta(seconds=remainder)
    return start, stop


_NOTHING = (dict(combine_mode="simple"), None)


class Group(BaseCombine):
    """Combine rasters along x, y and time; rightmost raster wins where
    multiple have data at the same timestep."""

    def get_relevant_sources(self, start, stop):
        """Sources whose period is relevant for [start, stop]."""
        stores = [s for s in self.args if s.period is not None]
        if not stores:
            return []

        if start is None:
            # latest frame only: every store ending at the global maximum
            last = max(s.period[1] for s in stores)
            return [s for s in stores if s.period[1] == last]

        if stop is None:
            # single instant: stores containing it, else the closest edge(s)
            containing = [s for s in stores if s.period[0] <= start <= s.period[1]]
            if containing:
                return containing
            edges = [edge for s in stores for edge in s.period]
            closest = min(edges, key=lambda edge: abs(edge - start))
            return [s for s in stores if closest in s.period]

        return [
            s for s in stores if not (stop < s.period[0] or start > s.period[1])
        ]

    def get_sources_and_requests(self, **request):
        start = request.get("start", None)
        stop = request.get("stop", None)
        mode = request["mode"]

        span = self.period
        if span is None:
            return [_NOTHING]
        if start is not None and stop is not None:
            if start > span[1] or stop < span[0]:
                return [_NOTHING]

        timedelta = self.timedelta
        if timedelta is None:
            return self._plan_by_time(request, mode, start, stop)
        return self._plan_by_bands(request, mode, start, stop, timedelta)

    def _plan_by_time(self, request, mode, start, stop):
        """Unaligned sources: each vals/meta subrequest is paired with a
        time subrequest mapping its frames onto the unified axis."""
        sources = self.get_relevant_sources(start, stop)
        if not sources:
            return [_NOTHING]
        plan = dict(combine_mode="by_time", mode=mode, start=start, stop=stop)
        if mode == "vals":
            plan["dtype"] = self.dtype
        data_requests = [(source, request) for source in sources]
        if mode == "time":
            return [(plan, None)] + data_requests
        axis_request = dict(mode="time", start=start, stop=stop)
        return (
            [(plan, None)]
            + data_requests
            + [(source, axis_request) for source in sources]
        )

    def _plan_by_bands(self, request, mode, start, stop, timedelta):
        """Aligned sources: every source's window maps to a band slice of
        the result stack."""
        td_sec = timedelta.total_seconds()
        start, stop = _snap_window_to_grid(start, stop, self.period, td_sec)

        if mode == "time":
            plan = dict(
                combine_mode="by_bands",
                mode=mode,
                start=start,
                stop=stop,
                timedelta=timedelta,
            )
            return [(plan, None)]

        data_requests, bands = [], []
        for source in self.get_relevant_sources(start, stop):
            lo_time = max(start, source.period[0])
            hi_time = min(stop, source.period[1])
            lo = int((lo_time - start).total_seconds() // td_sec)
            hi = int((hi_time - start).total_seconds() // td_sec)
            bands.append((lo, hi + 1))
            data_requests.append(
                (source, dict(request, start=lo_time, stop=hi_time))
            )

        plan = dict(combine_mode="by_bands", mode=mode, bands=bands)
        nbands = int((stop - start).total_seconds() // td_sec) + 1
        if mode == "meta":
            plan["nbands"] = nbands
        elif mode == "vals":
            plan["dtype"] = self.dtype
            plan["shape"] = (nbands, request["height"], request["width"])
        return [(plan, None)] + data_requests

    # --- process-side helpers ---

    @staticmethod
    def _unique_times(multi):
        times = filter_none([data.get("time", None) for data in multi])
        return sorted(set(itertools.chain(*times)))

    @staticmethod
    def _nearest_index(time, start):
        if start is None:
            return len(time) - 1
        return min(enumerate(time), key=lambda d: abs(d[1] - start))[0]

    @staticmethod
    def _split_by_time_args(args):
        """by_time vals/meta args are [data...] + [time axis...] halves."""
        n = len(args) // 2
        return filter_none(args[:n]), filter_none(args[n:])

    @staticmethod
    def _present_bands(args, bands):
        """Drop sources that returned no data, with their band slices."""
        pairs = [(d, b) for d, b in zip(args, bands) if d is not None]
        return [d for d, _ in pairs], [b for _, b in pairs]

    @staticmethod
    def _band_placements(multi, times, band_of):
        """Yield ``(target_band, source_index, data)`` for every frame the
        sources contributed, later sources overwriting earlier ones."""
        for data, time in zip(multi, times):
            for source_index, instant in enumerate(time["time"]):
                yield band_of[instant], source_index, data

    @staticmethod
    def _single_band(sorted_times, kwargs):
        """The band a request without ``stop`` collapses to (the nearest
        to its start), or None to keep every band."""
        if kwargs["stop"] is not None or len(sorted_times) < 2:
            return None
        return Group._nearest_index(sorted_times, kwargs["start"])

    @staticmethod
    def _cut_single_band(stack, sorted_times, kwargs):
        """Requests without ``stop`` collapse to one band: nearest start."""
        index = Group._single_band(sorted_times, kwargs)
        return stack if index is None else stack[index : index + 1]

    @staticmethod
    def _merge_vals_by_time(multi, times, kwargs):
        sorted_times = Group._unique_times(times)
        band_of = {t: i for i, t in enumerate(sorted_times)}
        fillvalue = get_dtype_max(kwargs["dtype"])
        shape = (len(sorted_times),) + multi[0]["values"].shape[1:]
        values = np.full(shape, fillvalue, dtype=kwargs["dtype"])

        for band, source_index, data in Group._band_placements(
            multi, times, band_of
        ):
            frame = data["values"][source_index]
            index = get_index(frame, data["no_data_value"])
            values[band][index] = frame[index]

        values = Group._cut_single_band(values, sorted_times, kwargs)
        return {"values": values, "no_data_value": fillvalue}

    @staticmethod
    def _merge_meta_by_time(multi, times, kwargs):
        sorted_times = Group._unique_times(times)
        band_of = {t: i for i, t in enumerate(sorted_times)}
        merged = [None] * len(sorted_times)

        for band, source_index, data in Group._band_placements(
            multi, times, band_of
        ):
            merged[band] = data["meta"][source_index]

        merged = Group._cut_single_band(merged, sorted_times, kwargs)
        return {"meta": merged}

    @staticmethod
    def _merge_vals_by_bands(multi, bands, dtype, shape):
        fillvalue = get_dtype_max(dtype)
        values = np.full(shape, fillvalue, dtype=dtype)
        for data, (a, b) in zip(multi, bands):
            index = get_index(data["values"], data["no_data_value"])
            values[a:b][index] = data["values"][index]
        return {"values": values, "no_data_value": fillvalue}

    @staticmethod
    def _merge_meta_by_bands(multi, bands, nbands):
        merged = [""] * nbands
        for data, (a, b) in zip(multi, bands):
            for i, meta in zip(range(a, b), data["meta"]):
                if meta:
                    merged[i] = meta
        return {"meta": merged}

    @staticmethod
    def process(process_kwargs, *args):
        combine_mode = process_kwargs["combine_mode"]
        mode = process_kwargs.get("mode", None)
        if combine_mode == "simple":
            return None

        if combine_mode == "by_time":
            if mode == "time":
                sorted_times = Group._unique_times(args)
                start, stop = process_kwargs["start"], process_kwargs["stop"]
                if stop is None and len(sorted_times) > 1:
                    index = Group._nearest_index(sorted_times, start)
                    sorted_times = sorted_times[index : index + 1]
                return {"time": sorted_times}
            if mode in ("meta", "vals"):
                multi, times = Group._split_by_time_args(args)
                if not multi:
                    return None
                if mode == "vals":
                    return Group._merge_vals_by_time(multi, times, process_kwargs)
                return Group._merge_meta_by_time(multi, times, process_kwargs)

        if combine_mode == "by_bands":
            if mode == "time":
                start = process_kwargs["start"]
                stop = process_kwargs["stop"]
                delta = process_kwargs["timedelta"]
                count = int((stop - start).total_seconds() // delta.total_seconds())
                return {"time": [start + i * delta for i in range(count + 1)]}
            if mode in ("meta", "vals"):
                multi, bands = Group._present_bands(args, process_kwargs["bands"])
                if mode == "vals":
                    return Group._merge_vals_by_bands(
                        multi, bands, process_kwargs["dtype"], process_kwargs["shape"]
                    )
                return Group._merge_meta_by_bands(
                    multi, bands, process_kwargs["nbands"]
                )

        raise ValueError("Unknown combine_mode / mode combination")


# --- the torch twin: the vals merges as masked selects, batch-first ---


def _full_like_batch(first, shape, dtype):
    """A (B, *shape) stack of ``dtype``'s maximum on ``first``'s device."""
    return torch.full(
        (first.shape[0],) + tuple(shape),
        get_dtype_max(dtype),
        dtype=torch_dtype(dtype),
        device=first.device,
    )


def _merge_vals_by_bands_torch(multi, bands, dtype, shape):
    dtype = np.dtype(dtype)
    if not multi:
        raise RuntimeError("no source of the Group answered the request")
    values = _full_like_batch(multi[0]["values"], shape, dtype)
    for data, (a, b) in zip(multi, bands):
        src = data["values"]
        has_data = data_mask(src, data["no_data_value"])
        values[:, a:b] = torch.where(has_data, src.to(values.dtype), values[:, a:b])
    return {"values": values, "no_data_value": get_dtype_max(dtype)}


def _merge_vals_by_time_torch(multi, times, kwargs):
    sorted_times = Group._unique_times(times)
    band_of = {t: i for i, t in enumerate(sorted_times)}
    dtype = np.dtype(kwargs["dtype"])
    first = multi[0]["values"]
    values = _full_like_batch(first, (len(sorted_times),) + tuple(first.shape[2:]), dtype)
    for band, source_index, data in Group._band_placements(multi, times, band_of):
        frame = data["values"][:, source_index]
        values[:, band] = torch.where(
            data_mask(frame, data["no_data_value"]),
            frame.to(values.dtype),
            values[:, band],
        )
    index = Group._single_band(sorted_times, kwargs)
    if index is not None:
        values = values[:, index : index + 1]
    return {"values": values, "no_data_value": get_dtype_max(dtype)}


def _group_torch(process_kwargs, *args):
    """Twin of ``Group.process``: the vals merges on the device; the
    time/meta/simple modes carry no arrays and run the host logic."""
    combine_mode = process_kwargs["combine_mode"]
    mode = process_kwargs.get("mode", None)
    if combine_mode == "by_bands" and mode == "vals":
        multi, bands = Group._present_bands(args, process_kwargs["bands"])
        return _merge_vals_by_bands_torch(
            multi, bands, process_kwargs["dtype"], process_kwargs["shape"]
        )
    if combine_mode == "by_time" and mode == "vals":
        multi, times = Group._split_by_time_args(args)
        if not multi:
            return None
        return _merge_vals_by_time_torch(multi, times, process_kwargs)
    return Group.process(process_kwargs, *args)


register(Group.process, _group_torch)
