#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dask_geomodeling_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: csrc/gaussian_blur.cu and csrc/moving_max.cu with nvcc for
   sm_90a, from this checkout, both at once;
3. kernel checks, on the card against the plain torch versions
   (torch.equal): the Gaussian at the headline path's shape (64, 516, 516)
   and sigma (radius 3), at the stencils path's (64, 524, 524) and sigma
   5/3 (radius 7), at radius 8 and at a zoom-mode radius 40, and one plane
   against scipy.ndimage.gaussian_filter, bitwise; the moving maximum at
   the stencils path's shape (64, 526, 526) float32 size 3, also against
   torch's max_pool2d, at sizes 5, 7 and 15, at sizes 3, 5 and 7 in every
   integer and float width, and with NaN in a plane; each kernel's static
   SASS opcode counts (cuobjdump) are printed after its build;
4. headline path: the view of bench.py (8192^2 EPSG:28992 source) over a
   10240^2 EPSG:3857 request in 512^2 tiles, batches of 64 (of tiles
   whose Smooth sigma agrees), through the port's evaluate_tiled and
   get_data.  The Gaussian launches once per batch (fused), no node runs
   on the host, a view with a node that has
   no twin raises, a 64^2 corner equals compute_host bit for bit, and 16
   tiles spread over the request differ from it in at most 5e-4 of their
   cells;
5. stencils path: HillShade(Smooth(MovingMax(source, 3), 5)) of
   benchmarks/run.py over its 8192^2 float32 EPSG:28992 source, requested
   whole in the same CRS: 256 tiles in 4 batches.  One moving-max and one
   fused Gaussian launch per batch, no node on the host, a 64^2 corner of
   the view below HillShade bitwise equal to compute_host and the full
   view within 1 of it, 16 tiles within 1 of compute_host with at most
   1e-3 of their cells differing, and get_data equal to evaluate_tiled;
6. the raster-algebra paths (build_algebra_paths): elemwise,
   reclassify-chain, combine, place and reproject-bilinear at 8192^2 in
   512^2 tiles, batches of 64.  Every node that returns pixels runs on
   the card; a 64^2 crop and 16 sampled tiles equal compute_host bit for
   bit, but for the cross-CRS bilinear path, whose blends differ in the
   last bits (within BILINEAR_ATOL, and nodata in the same cells);
7. the temporal paths (build_temporal_paths), with the checks of 6 and
   bitwise: temporal-mean (benchmarks/run.py's "temporal+zonal" view over
   8192^2 x 8 hourly frames), temporal-median (MovingMax over 6-hourly
   medians in Amsterdam across the switch to summer time, 4096^2 x 48
   frames; the moving-max kernel launches on it) and temporal-cumulative
   (Snap, Cumulative with a daily reset in Amsterdam, Resample, Shift);
   sources with 5% nodata; and the 90th percentile on a 64^2 crop within
   rtol 1e-6, its differing cells counted.  A zone the system zone
   database lacks fails the run;
8. the tiled geometry paths (build_geometry_paths), with the checks of
   6 and bitwise: rasterize-wkt (Clip of an 8192^2 source by RasterizeWKT
   of a 600-vertex polygon with a hole, both static at 1970-01-01; the
   parity twin timed over one batch) and rasterize (Add(Rasterize(256
   parcels, "code"), 1) at 2048^2: a host node per tile, its results
   stacked into the Add twin);
9. zonal: the zonal half of benchmarks/run.py's temporal+zonal config
   (build_zonal_views: 4096 star-shaped parcels and 16 smaller than a
   cell over the temporal-mean view, MockGeometry's copy as the source):
   AggregateRaster's mean, median, p90 and max, a coarsened sum, the
   threshold variant's count and the mean requested in EPSG:3857, on the
   card against compute_host (count, max, median and p90 bitwise, sum
   and mean within one float32 ulp, the uncovered sets equal; the mean's
   label planes bitwise to the host scanline's), seconds per request,
   the phases of one run, the device plane's CUDA-event times, the idle
   share and the peak memory;
10. the executor fuzz on the card: the 55 random trees of
   tests/test_executor_fuzz.py (random_view, with the port's classes)
   against compute_host; and float64 comparisons, MaskBelow, Step and
   Classify at and beside their thresholds, bitwise;
11. timing, per tiled path: median of 3 evaluate_tiled runs (Mpx/s), the
   numpy host rate on the sampled tiles, one run's seconds per phase, one
   profiled run's device busy time and idle share; per kernel at its
   path's shape, the kernel, its plain version and one PyTorch call of the
   same function (CUDA events), and the least time the card could take;
   the Gaussian is timed at both paths' shapes, one kernel record each.

The views are built with the port's own classes (private copies of
bench.py's and benchmarks/run.py's builders) and checked against the
port's compute_host.  The line before the last is the kernels' JSON
record; the last line is {"ok": true, "device": {...}}.  Without CUDA the
script exits non-zero before printing any result.  It imports nothing of
JAX, pandas or the JAX package, and checks that at the end.
"""
import json
import subprocess
import sys
import threading
import time
from datetime import datetime, timedelta

import numpy as np

HEADLINE_PX = 10240
HEADLINE_SHARE = 5e-4
STENCILS_PX = 8192
STENCILS_SHARE = 1e-3
# the raster-algebra paths: 8192^2 same-CRS (and one EPSG:3857) requests
ALGEBRA_PX = 8192
# the cross-CRS bilinear path interpolates the approximate transformer's
# coarse grid where the host transforms every pixel, so its blends differ
# from the host's in the last bits; its limits are the JAX package's own
# bilinear tolerance (tests/test_warp_bilinear.py) on the largest
# difference, and the headline's share on cells that are nodata in one
# and data in the other
BILINEAR_ATOL = 1e-3
BILINEAR_FILL_SHARE = 5e-4
# the temporal paths: an 8192^2 source of 8 hourly frames, and a 4096^2
# source of 48 hourly frames across the switch to summer time in
# Amsterdam; 5% of their cells hold nodata, and so does a top-left
# 600^2 square (the 64^2 corner and one sampled tile) in the frames of
# the first 4h bin of the one and the first four 6h bins of the other,
# so that those bins hold no data there
TEMPORAL_MEAN_PX = 8192
TEMPORAL_PX = 4096
NODATA_SHARE = 0.05
NODATA_SQUARE = 600
DST_WINDOW = (datetime(2000, 3, 25), datetime(2000, 3, 27))
FUZZ_SEEDS = range(40)
FUZZ_TILED_SEEDS = range(40, 55)
TILE = 512
BATCH = 64
# NVIDIA H100 SXM data sheet: HBM3 rate, and the FP32 and FP64 rates
# outside the tensor cores.  The data sheet's 34 TFLOP/s of FP64 counts a
# fused multiply-add as two operations; the kernels are built with
# -fmad=false, so each multiply and each add is an instruction of its own,
# and 17e12 of them a second is the rate they can reach.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 17e12


# --- the views, with the port's own classes ---


def build_headline_view(source_px=8192):
    """bench.py:build_view: Classify(Reclassify(Classify(Smooth(source + 1))))
    over an 8192^2 float32 EPSG:28992 source."""
    from dask_geomodeling_tpu_torch.raster import Classify, MemorySource, Reclassify, Smooth

    rng = np.random.RandomState(42)
    data = (rng.rand(1, source_px, source_px) * 250).astype(np.float32)
    data[0, :64, :64] = np.float32(np.finfo(np.float32).max)  # nodata patch

    source = MemorySource(
        data=data,
        no_data_value=float(np.finfo(np.float32).max),
        projection="EPSG:28992",
        pixel_size=1.0,
        pixel_origin=(85000, 455000),
        time_first=datetime(2000, 1, 1),
        time_delta=timedelta(hours=1),
    )
    view = Classify(
        Reclassify(
            Classify(Smooth(source + 1, size=3), bins=[50.0, 100.0, 150.0, 200.0]),
            data=[[0, 1], [1, 5], [2, 9], [3, 13], [4, 17]],
        ),
        bins=[4, 8, 12, 16],
    )
    return source, view


def headline_request(source, out_px):
    """bench.py:full_request: the source's extent in EPSG:3857."""
    from dask_geomodeling_tpu_torch.geo import Extent

    bbox = (
        Extent(
            source.geo_transform.get_bbox((0, 0), source.data.shape[1:]),
            source.projection,
        )
        .transformed("EPSG:3857")
        .bbox
    )
    return dict(
        mode="vals",
        bbox=bbox,
        projection="EPSG:3857",
        width=out_px,
        height=out_px,
        start=datetime(2000, 1, 1),
    )


def make_source(px, seed=0, bands=1, time_first=datetime(2000, 1, 1), nodata_share=0.0,
                nodata_block=(0, 0)):
    """benchmarks/run.py:make_source: float32 uniform [0, 200), hourly
    frames when bands > 1.  With ``nodata_share``, that share of the cells,
    drawn by a PCG64 generator of the same seed, holds nodata.  Drawn band
    by band (the same numbers as one (bands, px, px) draw) to keep the
    host's transient memory to one band.  With ``nodata_block`` = (frames,
    size), the first ``frames`` frames hold nodata in the top-left size^2
    square as well."""
    from dask_geomodeling_tpu_torch.raster import MemorySource

    rng = np.random.RandomState(seed)
    nodata = np.finfo(np.float32).max
    data = np.empty((bands, px, px), np.float32)
    for band in range(bands):
        data[band] = rng.rand(px, px) * 200
    if nodata_share:
        cells = np.random.default_rng(seed)
        for band in range(bands):
            data[band][cells.random((px, px), dtype=np.float32) < nodata_share] = nodata
    frames, size = nodata_block
    data[:frames, :size, :size] = nodata
    return MemorySource(
        data=data,
        no_data_value=float(nodata),
        projection="EPSG:28992",
        pixel_size=1.0,
        pixel_origin=(135000.0, 456000.0),
        time_first=time_first,
        time_delta=timedelta(hours=1) if bands > 1 else None,
    )


def vals_request(px):
    """benchmarks/run.py:vals_request: the source's extent at px^2."""
    return dict(
        mode="vals",
        bbox=(135000.0, 456000.0 - px, 135000.0 + px, 456000.0),
        projection="EPSG:28992",
        width=px,
        height=px,
        start=datetime(2000, 1, 1),
        stop=datetime(2000, 1, 2),
    )


def build_stencils_view(px=8192):
    """The "stencils" configuration of benchmarks/run.py."""
    from dask_geomodeling_tpu_torch.raster import HillShade, MovingMax, Smooth

    source = make_source(px)
    return source, HillShade(Smooth(MovingMax(source, 3), 5))


def warp_request(px):
    """benchmarks/run.py's cross-CRS request: vals_request(px)'s bbox in
    EPSG:3857, at px^2."""
    from dask_geomodeling_tpu_torch.geo import Extent

    request = vals_request(px)
    return dict(
        request,
        projection="EPSG:3857",
        bbox=Extent(request["bbox"], "EPSG:28992").transformed("EPSG:3857").bbox,
    )


def build_algebra_paths(px=8192):
    """The raster-algebra paths: {name: (view, request, interpolation,
    corner)} over sources a and b (make_source with seeds 0 and 2), where
    ``corner`` is the top-left point of the 64^2 crop held to compute_host
    (the request's own, but for place the first placement's centre).

    - elemwise and reclassify-chain: benchmarks/run.py's views;
    - combine: Group, Max, Dilate, Clip, FillNoData, Power, Divide, Step
      and a comparison in one view.  Max always holds data, so it is the
      Group's first member and the dilated classes, which hold data only
      where the Clip kept a, show over it;
    - place: a's top-left 256 m square, as a source of its own, placed at
      the 4x4 grid of the request's cell centres with the maximum over
      overlaps.  A store no larger than a tile makes the Place plan its
      warp mode (one fetch of the store, pasted per coordinate); a's
      whole 8192^2 would plan per-coordinate requests, which differ from
      tile to tile;
    - reproject-bilinear: Add(a, 1) over the cross-CRS request, with
      bilinear resampling.
    """
    from dask_geomodeling_tpu_torch.raster import (
        Add, Classify, Clip, Dilate, FillNoData, Greater, Group, Mask, MaskBelow, Max,
        MemorySource, Multiply, Place, Power, Reclassify, Step,
    )

    a = make_source(px, seed=0)
    b = make_source(px, seed=2)
    request = vals_request(px)
    square = MemorySource(
        data=a.data[:, :256, :256],
        no_data_value=a.no_data_value,
        projection=a.projection,
        pixel_size=a.pixel_size,
        pixel_origin=a.pixel_origin,
        time_first=a.time_first,
    )
    x0, y0 = a.pixel_origin
    cell = px / 4
    place = Place(
        square,
        "EPSG:28992",
        anchor=[x0 + 128.0, y0 - 128.0],
        coordinates=[[x0 + cell * (i + 0.5), y0 - cell * (j + 0.5)]
                     for j in range(4) for i in range(4)],
        statistic="max",
    )
    combine = Group(
        Max(FillNoData(MaskBelow(a, 10.0), b), Power(b / 10.0, 2), Step(b, left=0, right=1, value=100.0)),
        Dilate(Classify(Clip(a, Greater(b, 100.0)), bins=[50.0, 100.0, 150.0]), values=[1, 3]),
    )
    bilinear = warp_request(px)
    corner = (request["bbox"][0], request["bbox"][3])
    return {
        "elemwise": (Mask(Multiply(Add(a, 1.0), 2.0), 7.0), request, "nearest", corner),
        "reclassify-chain": (
            Reclassify(
                Classify(MaskBelow(a, 10.0), bins=[50.0, 100.0, 150.0]),
                data=[[0, 1], [1, 5], [2, 9], [3, 13]],
            ),
            request,
            "nearest",
            corner,
        ),
        "combine": (combine, request, "nearest", corner),
        "place": (place, request, "nearest", (x0 + cell / 2 - 32, y0 - cell / 2 + 32)),
        "reproject-bilinear": (
            Add(a, 1.0), bilinear, "bilinear", (bilinear["bbox"][0], bilinear["bbox"][3])),
    }


def build_temporal_paths(mean_px=TEMPORAL_MEAN_PX, px=TEMPORAL_PX, nodata_share=NODATA_SHARE):
    """The temporal paths, as build_algebra_paths gives them, and the
    48-frame source they share; sources from make_source with
    ``nodata_share`` of their cells nodata and, where that is not 0, a
    NODATA_SQUARE square of nodata in the frames of their first bins
    (4 of 8 frames; the 23 frames before local midnight of 2000-03-26).

    - temporal-mean: benchmarks/run.py's "temporal+zonal" view,
      TemporalAggregate(source, "4h", statistic="mean") over 8 hourly
      frames from 2000-01-01 (seed 1), requested from 2000-01-01 to
      2000-01-02: two bands;
    - temporal-median: MovingMax(TemporalAggregate(source, "6h",
      statistic="median", timezone="Europe/Amsterdam"), 3) over 48 hourly
      frames from 2000-03-25 00:00 UTC (seed 4), across the switch to
      summer time of 2000-03-26, requested from 2000-03-25 to 2000-03-27:
      bins of 5 and 6 frames, seven bands;
    - temporal-cumulative: Snap(Cumulative(Resample(Shift(source, 30
      min), "2h", direction="backward"), statistic="sum", frequency="D",
      timezone="Europe/Amsterdam"), Resample(source, "6h")) over the same
      source and window: nine bands.
    """
    from dask_geomodeling_tpu_torch.raster import (
        Cumulative, MovingMax, Resample, Shift, Snap, TemporalAggregate,
    )

    square = NODATA_SQUARE if nodata_share else 0
    hourly8 = make_source(mean_px, seed=1, bands=8, nodata_share=nodata_share,
                          nodata_block=(4, square))
    hourly48 = make_source(px, seed=4, bands=48, time_first=DST_WINDOW[0],
                           nodata_share=nodata_share, nodata_block=(23, square))
    request = dict(vals_request(px), start=DST_WINDOW[0], stop=DST_WINDOW[1])
    corner = (request["bbox"][0], request["bbox"][3])
    median = MovingMax(TemporalAggregate(hourly48, "6h", statistic="median",
                                         timezone="Europe/Amsterdam"), 3)
    cumulative = Snap(
        Cumulative(Resample(Shift(hourly48, 1800000), "2h", direction="backward"),
                   statistic="sum", frequency="D", timezone="Europe/Amsterdam"),
        Resample(hourly48, "6h"),
    )
    paths = {
        "temporal-mean": (TemporalAggregate(hourly8, "4h", statistic="mean"),
                          vals_request(mean_px), "nearest", corner),
        "temporal-median": (median, request, "nearest", corner),
        "temporal-cumulative": (cumulative, request, "nearest", corner),
    }
    return paths, hourly48


def mock_geometry_class():
    """tests/factories.py:MockGeometry with the port's classes: an
    in-memory geometry source that ignores the request's bbox and answers
    in the requested projection.  A class of this module, so that its
    import path resolves (graph keys hash it)."""
    global MockGeometry
    if "MockGeometry" in globals():
        return MockGeometry
    from dask_geomodeling_tpu_torch.geo import get_epsg_or_wkt, shapely_transform
    from dask_geomodeling_tpu_torch.geo.features import GeoDataFrame, GeoSeries
    from dask_geomodeling_tpu_torch.geo.geometry import Polygon
    from dask_geomodeling_tpu_torch.geometry import GeometryBlock

    class MockGeometry(GeometryBlock):
        """An in-memory geometry source: all polygons, whatever the
        request's bbox; the projection of the answer is the request's."""

        def __init__(self, polygons, properties=None, projection="EPSG:3857"):
            super().__init__(polygons, properties, projection)

        @property
        def polygons(self):
            return self.args[0]

        @property
        def properties(self):
            return self.args[1]

        @property
        def projection(self):
            return self.args[2]

        @property
        def columns(self):
            result = {"geometry"}
            if self.properties:
                result |= set(self.properties[0].keys())
            result.discard("id")  # 'id' is reserved for the index
            return result

        def get_sources_and_requests(self, **request):
            return [(self.polygons, None), (self.properties, None),
                    (self.projection, None), (request, None)]

        @staticmethod
        def process(polygons, properties, projection, request):
            if request.get("limit") is not None:
                polygons = polygons[: request["limit"]]
                if properties is not None:
                    properties = properties[: request["limit"]]
            mode = request.get("mode", "intersects")
            geometries = [Polygon(x) for x in polygons]
            if get_epsg_or_wkt(projection) != get_epsg_or_wkt(request["projection"]):
                geometries = [shapely_transform(g, projection, request["projection"])
                              for g in geometries]
            geoseries = GeoSeries(geometries, crs=request["projection"])
            if mode == "extent":
                extent = tuple(geoseries.total_bounds) if len(geoseries) else None
                return {"extent": extent, "projection": request["projection"]}
            if len(geoseries) == 0:
                return {"features": GeoDataFrame([]), "projection": request["projection"]}
            if properties is not None:
                df = GeoDataFrame.from_records(properties)
                df = df.set_geometry(geoseries, crs=request["projection"])
                if "id" in df.columns:
                    df.set_index("id", inplace=True)
            else:
                df = GeoDataFrame(geometry=geoseries, crs=request["projection"])
                df.index.name = "id"
            if mode == "centroid":
                df = df[df.geometry.centroid.within(request["geometry"])]
            elif mode == "intersects":
                df = df[df.geometry.intersects(request["geometry"])]
            return {"features": df, "projection": request["projection"]}

    MockGeometry.__module__ = __name__
    MockGeometry.__qualname__ = "MockGeometry"
    globals()["MockGeometry"] = MockGeometry
    return MockGeometry


# the zonal path: 4096 star-shaped parcels on a 64 x 64 grid of 48 m cells
# (radii 20-30 m, so neighbours' bboxes touch or overlap and bucketize
# makes several groups) and 16 smaller than a cell, centred on cell
# corners (centroid sampling), inside the temporal-mean source
PARCEL_GRID = 64
PARCEL_CELL = 48.0
PARCEL_ORIGIN = (137000.0, 454000.0)  # top-left corner, EPSG:28992
SMALL_PARCELS = 16


def make_parcels(grid=PARCEL_GRID, small=SMALL_PARCELS, seed=5):
    """(polygons, properties): grid^2 star-shaped parcels of 8-64
    vertices, then ``small`` parcels of radius 0.3 m around 1 m cell
    corners; properties id, code (1-99) and threshold (float, 50-150)."""
    rng = np.random.default_rng(seed)
    x0, y0 = PARCEL_ORIGIN
    polygons = []
    for j in range(grid):
        for i in range(grid):
            n = int(rng.integers(8, 65))
            angles = np.sort(rng.uniform(0, 2 * np.pi, n))
            radii = rng.uniform(20.0, 30.0, n)
            cx = x0 + PARCEL_CELL * (i + 0.5) + rng.uniform(-2, 2)
            cy = y0 - PARCEL_CELL * (j + 0.5) + rng.uniform(-2, 2)
            polygons.append([(float(cx + r * np.cos(t)), float(cy + r * np.sin(t)))
                             for t, r in zip(angles, radii)])
    for k in range(small):
        cx = x0 + 100.0 + 150.0 * k
        cy = y0 - 100.0 - 120.0 * k
        polygons.append([(cx - 0.3, cy - 0.3), (cx + 0.3, cy - 0.3), (cx + 0.3, cy + 0.3),
                         (cx - 0.3, cy + 0.3)])
    properties = [{"id": k, "code": int(rng.integers(1, 100)),
                   "threshold": float(rng.uniform(50.0, 150.0))} for k in range(len(polygons))]
    return polygons, properties


def zonal_request(grid=PARCEL_GRID, projection="EPSG:28992"):
    """mode "intersects" over the parcels' box, 2000-01-01 to 2000-01-02."""
    from dask_geomodeling_tpu_torch.geo import Extent
    from dask_geomodeling_tpu_torch.geo.geometry import box

    x0, y0 = PARCEL_ORIGIN
    bbox = (x0, y0 - PARCEL_CELL * grid, x0 + PARCEL_CELL * grid, y0)
    bbox = Extent(bbox, "EPSG:28992").transformed(projection).bbox
    return dict(mode="intersects", geometry=box(*bbox), projection=projection,
                start=datetime(2000, 1, 1), stop=datetime(2000, 1, 2))


def build_zonal_views(raster, grid=PARCEL_GRID, small=SMALL_PARCELS):
    """The zonal half of benchmarks/run.py's temporal+zonal config:
    {name: (view, request)} over the parcels and ``raster``: AggregateRaster
    with mean, median, p90 and max; sum with a 2^22 pixel budget and auto
    coarsening (the cell doubles); AggregateRasterAboveThreshold counting
    cells at or above each parcel's threshold; and the mean requested in
    EPSG:3857."""
    from dask_geomodeling_tpu_torch.geometry import AggregateRaster, AggregateRasterAboveThreshold

    polygons, properties = make_parcels(grid, small)
    parcels = mock_geometry_class()(polygons, properties, projection="EPSG:28992")
    request = zonal_request(grid)
    views = {s: (AggregateRaster(parcels, raster, s), request)
             for s in ("mean", "median", "p90", "max")}
    views["sum"] = (AggregateRaster(parcels, raster, "sum", max_pixels=2**22,
                                    auto_pixel_size=True), request)
    views["count-above"] = (AggregateRasterAboveThreshold(
        parcels, raster, "count", threshold_name="threshold"), request)
    views["mean-3857"] = (views["mean"][0], zonal_request(grid, "EPSG:3857"))
    return views


def wkt_polygon(px, vertices=600, seed=6):
    """A polygon of ``vertices`` vertices with one hole over a px^2 square
    at the source's origin: a star (radius 0.25-0.45 px) around a point
    0.3 px from the west edge, its edges crossing tile borders and the
    request's west edge (so the westmost tiles, which chip_smoke samples,
    hold its boundary), and a 100-vertex hole (radius 0.05-0.1 px) around
    the same point."""
    rng = np.random.default_rng(seed)
    x0, y0 = 135000.0, 456000.0
    cx, cy = x0 + 0.3 * px, y0 - px / 2

    def ring(n, lo, hi):
        angles = np.sort(rng.uniform(0, 2 * np.pi, n))
        radii = rng.uniform(lo, hi, n) * px
        points = ["%r %r" % (float(cx + r * np.cos(t)), float(cy + r * np.sin(t)))
                  for t, r in zip(angles, radii)]
        return "(" + ", ".join(points + points[:1]) + ")"

    return "POLYGON (%s, %s)" % (ring(vertices - 100, 0.25, 0.45), ring(100, 0.05, 0.1))


def build_geometry_paths(px=ALGEBRA_PX, rasterize_px=2048, parcels_grid=16):
    """The tiled geometry paths, as build_algebra_paths gives them:

    - rasterize-wkt: Clip(a, RasterizeWKT(polygon, "EPSG:28992")) with
      wkt_polygon (600 vertices, one hole) at px^2.  RasterizeWKT is static
      at 1970-01-01 (its period) and Clip keeps the frames the two share,
      so a is make_source's source with its one frame at 1970-01-01 and
      the request asks for that instant;
    - rasterize: Add(Rasterize(parcels, column_name="code", dtype="int32"), 1)
      over 256 parcels (a 16 x 16 grid) at rasterize_px^2, from the
      parcels' top-left corner: a host node whose per-tile results are
      stacked into the Add twin.
    """
    from dask_geomodeling_tpu_torch.geo import shapely_from_wkt
    from dask_geomodeling_tpu_torch.raster import Add, Clip, Rasterize, RasterizeWKT

    static = datetime(1970, 1, 1)
    a = make_source(px, seed=0, time_first=static)
    request = dict(vals_request(px), start=static, stop=None)
    wkt = wkt_polygon(px)
    hole_x, hole_y = (round(float(c)) for c in shapely_from_wkt(wkt).holes[0][0])
    polygons, properties = make_parcels(parcels_grid, 0)
    parcels = mock_geometry_class()(polygons, properties, projection="EPSG:28992")
    x0, y0 = PARCEL_ORIGIN
    size = PARCEL_CELL * parcels_grid
    rasterize_request = dict(mode="vals", bbox=(x0, y0 - size, x0 + size, y0),
                             projection="EPSG:28992", width=rasterize_px, height=rasterize_px,
                             start=datetime(2000, 1, 1))
    return {
        # the crop is centred on a vertex of the hole: it holds the hole's
        # boundary, data on one side and nodata on the other
        "rasterize-wkt": (Clip(a, RasterizeWKT(wkt, "EPSG:28992")), request, "nearest",
                          (hole_x - 32, hole_y + 32)),
        "rasterize": (Add(Rasterize(parcels, column_name="code", dtype="int32"), 1),
                      rasterize_request, "nearest", (x0, y0)),
    }


def fuzz_sources():
    """tests/test_executor_fuzz.py's sources, with the port's MemorySource."""
    from dask_geomodeling_tpu_torch.raster import MemorySource

    rng = np.random.RandomState(7)
    common = dict(projection="EPSG:28992", pixel_size=0.5, pixel_origin=(135000, 456000),
                  time_first=datetime(2000, 1, 1), time_delta=timedelta(hours=1))
    uint8 = MemorySource(data=(rng.rand(2, 12, 12) * 250).astype(np.uint8),
                         no_data_value=255, **common)
    f32_data = (rng.rand(2, 12, 12) * 100).astype(np.float32)
    f32_data[0, :3, :3] = np.float32(np.finfo(np.float32).max)  # nodata
    f32 = MemorySource(data=f32_data, no_data_value=float(np.finfo(np.float32).max), **common)
    return [uint8, f32]


def random_view(rng, sources, depth):
    """tests/test_executor_fuzz.py:random_view with the port's classes:
    the same tree for the same random state."""
    from dask_geomodeling_tpu_torch import raster as R

    if depth == 0:
        return sources[rng.randint(len(sources))]

    def sub():
        return random_view(rng, sources, depth - 1)

    choice = rng.randint(16)
    const = float(np.round(rng.rand() * 20 + 1, 2))
    if choice == 0:
        return R.Add(sub(), const)
    if choice == 1:
        return R.Multiply(sub(), const)
    if choice == 2:
        return R.Subtract(sub(), const)
    if choice == 3:
        return R.Add(sub(), sub())
    if choice == 4:
        return R.Greater(sub(), const)
    if choice == 5:
        return R.Mask(sub(), value=int(const))
    if choice == 6:
        return R.MaskBelow(sub(), int(const))
    if choice == 7:
        return R.Classify(sub(), bins=[10.0, 50.0, 120.0])
    if choice == 8:
        return R.FillNoData(sub(), sub())
    if choice == 9:
        return R.Step(sub(), left=1, right=2, value=int(const), at=3)
    if choice == 10:
        return R.Reclassify(R.Classify(sub(), bins=[10.0, 50.0, 120.0]), data=[[1, 7.0], [2, 3.5]])
    if choice == 11:
        return R.Power(sub(), 2)
    if choice == 12:
        inner = sub()
        if inner.dtype == np.dtype("bool"):
            return inner  # IsData/IsNoData reject boolean inputs
        return R.IsData(inner) if rng.rand() < 0.5 else R.IsNoData(inner)
    if choice == 13:
        return R.Max(sub(), sub())
    if choice == 14:
        first, second = sub(), sub()
        if np.result_type(first.dtype, second.dtype) == np.dtype(bool):
            first = R.Add(first, 1)  # promotes to an integer raster
        return R.Group(first, second)
    return R.Clip(sub(), R.Greater(sub(), const))


FUZZ_REQUEST = dict(mode="vals", start=datetime(2000, 1, 1), stop=datetime(2000, 1, 1, 1),
                    width=12, height=12, bbox=(135000, 455994, 135006, 456000),
                    projection="EPSG:28992")


def fuzz_view(seed, sources):
    """The fuzz's tree and request for ``seed`` (seeds from 40 on are its
    tiled ones: shallower, one frame)."""
    rng = np.random.RandomState(seed)
    if seed < 40:
        return random_view(rng, sources, depth=rng.randint(2, 5)), dict(FUZZ_REQUEST)
    view = random_view(rng, sources, depth=rng.randint(2, 4))
    return view, dict(FUZZ_REQUEST, stop=datetime(2000, 1, 1))


def same_as_host(actual, expected):
    """The fuzz's rule: bitwise for integer and boolean values, rtol 1e-6
    for floats; the dtype and no_data_value equal."""
    if expected is None or actual is None:
        return actual is None and expected is None
    a, e = actual["values"], expected["values"]
    if a.dtype != e.dtype or actual["no_data_value"] != expected["no_data_value"]:
        return False
    if e.dtype.kind == "f":
        return bool(np.allclose(a, e, rtol=1e-6, atol=0, equal_nan=True))
    return bool(np.array_equal(a, e))


# --- measurement helpers ---


def check(condition, message):
    if not condition:
        raise RuntimeError("check failed: " + message)


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_busy_ms(run):
    """(wall s, device busy ms) of ``run()`` under torch.profiler: the
    summed time of the kernels and copies on the card; busy ms is None
    when the profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    busy_us = 0.0
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            busy_us += getattr(event, "self_device_time_total", None) or getattr(
                event, "self_cuda_time_total", 0.0)
    return wall_s, (busy_us / 1e3 if busy_us > 0 else None)


def bound(bytes_moved, ops, ops_per_s):
    """(bound ms, "bytes" or "operations"): the least time the card could
    take, the larger of the bytes over HBM's rate and the operations over
    their type's peak."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def card_description():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return proc.stdout.strip().splitlines()[0]


def smooth_sigma(view, request):
    """(sigma_y, sigma_x) of the Smooth node in ``request``'s plan."""
    graph, _ = view.get_compute_graph(**request)
    for value in graph.values():
        if isinstance(value, tuple) and getattr(value[0], "__name__", "") == "_smooth_process":
            size_y, size_x = value[2]["size"]
            return size_y / 3, size_x / 3
    raise RuntimeError("no Smooth node in the plan")


def tile_window(index, nx, height, tile):
    """(row slice, col slice) of full tile ``index`` in the assembled
    output: tiles run from the south-west corner, rows from the north."""
    j, i = divmod(index, nx)
    row_end = height - j * tile
    return slice(row_end - tile, row_end), slice(i * tile, (i + 1) * tile)


def same(a, b):
    """torch.equal, with NaN in the same places counting as equal."""
    import torch

    if a.dtype.is_floating_point:
        nan = torch.isnan(a)
        return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])
    return torch.equal(a, b)


def build_kernels():
    """Build both kernel libraries at once (one nvcc each); prints each
    build's time and ptxas lines."""
    from dask_geomodeling_tpu_torch.ops import _build

    names = ["gaussian_blur", "moving_max"]
    errors = []

    def build(name):
        try:
            _build.load_library(name)
        except Exception as exc:  # reported below, then raised
            errors.append((name, exc))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=build, args=(name,)) for name in names]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    if errors:
        raise RuntimeError("kernel build failed: %s: %s" % errors[0])
    print("build: %s in %.2f s" % (", ".join(n + ".cu" for n in names), time.perf_counter() - t0))
    for name in names:
        log = _build.build_log[name]
        print("build: %s.cu nvcc %.2f s" % (name, log["seconds"]))
        for line in log["log"].splitlines():
            if "Function properties for" in line:
                print("  ptxas: " + kernel_name(line.split()[-1]))
            elif "registers" in line or "spill" in line:
                print("  ptxas:   " + line.replace("ptxas info    :", "").strip())
        print_sass_counts(name)


#: SASS opcodes counted per kernel: conversions, float64 arithmetic, the
#: reciprocal that starts an integer division by a runtime value, shared
#: and global memory traffic, branches and barriers
SASS_COUNTED = ("F2F", "DADD", "DMUL", "DFMA", "I2F", "MUFU", "LDS", "STS", "LDG", "STG",
                "BRA", "BAR")


def kernel_name(mangled):
    """A kernel's mangled name without its namespace: the function and its
    template arguments (f float, d double, a-m the integer types, then any
    integer constant)."""
    import re

    found = re.search(r"\d+((?:blur|moving_max)_\w+?)I(\w*?)E?Ev", mangled)
    if not found:
        return mangled
    args = re.sub(r"L[ib](\d+)E", r",\1", found.group(2))
    return "%s<%s>" % (found.group(1), args)


def print_sass_counts(name):
    """Static SASS opcode counts of each kernel in csrc/<name>.cu's
    library, from cuobjdump where the toolkit has it."""
    import os
    import re
    import shutil

    from dask_geomodeling_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        cuobjdump = shutil.which("cuobjdump")
    if not cuobjdump:
        print("  sass: not measured (no cuobjdump)")
        return
    library = _build.library_path(name)
    proc = subprocess.run([cuobjdump, "-sass", library], capture_output=True, text=True,
                          timeout=120)
    if proc.returncode != 0:
        print("  sass: not measured (cuobjdump exit %d)" % proc.returncode)
        return
    counts = {}
    function = None
    for line in proc.stdout.splitlines():
        found = re.match(r"\s*Function : (\S+)", line)
        if found:
            function = found.group(1)
            counts[function] = {"all": 0}
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if function and op:
            base = op.group(1).split(".")[0]
            tally = counts[function]
            tally["all"] += 1
            if base in SASS_COUNTED:
                tally[base] = tally.get(base, 0) + 1
    for function, tally in counts.items():
        print("  sass: %s %s" % (kernel_name(function), " ".join(
            "%s=%d" % (op, tally.get(op, 0)) for op in ("all",) + SASS_COUNTED)))


def host_values(view, request):
    from dask_geomodeling_tpu_torch import compute_host

    return compute_host(*view.get_compute_graph(**request))["values"]


# --- phases ---


def check_gaussian(device, headline_sigma, stencils_sigma):
    """Phase 3a; returns the kernel records' numbers at the headline
    path's (64, 516, 516) and the stencils path's (64, 524, 524)."""
    import torch
    from scipy import ndimage

    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.ops.stencils import gaussian_blur_reference

    rng = np.random.RandomState(0)
    planes = torch.from_numpy(
        (rng.rand(BATCH, TILE + 4, TILE + 4) * 250).astype(np.float32)
    ).to(device)
    stencil_planes = torch.from_numpy(
        (rng.rand(BATCH, TILE + 12, TILE + 12) * 200).astype(np.float32)
    ).to(device)
    max_abs_err = 0.0
    for label, data, (sy, sx) in [
        ("headline path", planes, headline_sigma),
        ("stencils path", stencil_planes, stencils_sigma),
        ("radius 8", planes, (2.0, 2.0)),
        ("radius 40 (zoom mode)", planes, (10.0, 10.0)),
    ]:
        before = (cuda_stencils.launches, cuda_stencils.fused_launches)
        got = cuda_stencils.gaussian_blur(data, sy, sx, 0)
        fused = cuda_stencils.fused_launches - before[1]
        check(cuda_stencils.launches - before[0] == (1 if fused else 2),
              "launch count of the %s check" % label)
        want = gaussian_blur_reference(data, sy, sx, 0)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        equal = torch.equal(got, want)
        print("kernel check: gaussian_blur %s sigma=(%.6f, %.6f) shape=%s %s launch "
              "equal=%s max_abs_err=%r" % (label, sy, sx, tuple(data.shape),
                                           "fused" if fused else "two-pass", equal, err))
        check(equal, "gaussian_blur differs from its plain version (%s)" % label)
        max_abs_err = max(max_abs_err, err)
    host_plane = planes[0].cpu().numpy()
    scipy_plane = ndimage.gaussian_filter(host_plane, headline_sigma, mode="constant", cval=0)
    kernel_plane = cuda_stencils.gaussian_blur(planes[:1].contiguous(), *headline_sigma, 0)
    check(np.array_equal(kernel_plane[0].cpu().numpy(), scipy_plane),
          "gaussian_blur differs from scipy.ndimage.gaussian_filter")
    print("kernel check: gaussian_blur, one plane bitwise equal to scipy.ndimage.gaussian_filter")
    return [dict(time_gaussian(data, sigma), max_abs_err=max_abs_err, path=path)
            for path, data, sigma in [("headline", planes, headline_sigma),
                                      ("stencils", stencil_planes, stencils_sigma)]]


def time_gaussian(planes, sigma):
    """The kernel, its plain version and the library yardstick on
    ``planes`` (CUDA events), and the bound.  The yardstick is one cuDNN
    convolution with the (2r+1)^2 outer-product weights in full float32
    (not bitwise: it sums in another order)."""
    import torch
    import torch.nn.functional as F

    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.ops.stencils import gaussian_blur_reference, gaussian_weights

    (wy, ry), (wx, rx) = gaussian_weights(sigma[0]), gaussian_weights(sigma[1])
    weights = torch.from_numpy(np.outer(wy, wx).astype(np.float32)).to(planes.device)[None, None]
    images = planes[:, None]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        library_ms = cuda_ms(lambda: F.conv2d(images, weights, padding=(ry, rx)), 20)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    kernel_ms = cuda_ms(lambda: cuda_stencils.gaussian_blur(planes, *sigma, 0), 20)
    plain_ms = cuda_ms(lambda: gaussian_blur_reference(planes, *sigma, 0), 5)
    n_bytes = 2 * planes.numel() * planes.element_size()
    # per output pixel and pass: one multiply, then an add, a multiply and
    # an add per tap pair, each its own float64 instruction (no FMA)
    ops = planes.numel() * ((1 + 3 * ry) + (1 + 3 * rx))
    bound_ms, bound_by = bound(n_bytes, ops, FP64_OPS_PER_S)
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, shape=list(planes.shape), radius=[ry, rx])


def check_moving_max(device):
    """Phase 3b; returns the kernel records' numbers at the stencils
    path's (64, 526, 526) and the temporal-median path's (448, 514, 514):
    64 tiles of 7 bands, a margin of 1, float32 nodata in some cells."""
    import torch
    import torch.nn.functional as F

    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.ops.stencils import moving_max_reference

    rng = np.random.RandomState(1)
    shape = (BATCH, TILE + 14, TILE + 14)
    planes = torch.from_numpy((rng.rand(*shape) * 200).astype(np.float32)).to(device)
    small = rng.rand(8, 301, 277) * 120  # in range of every dtype below
    bands = np.empty((BATCH * 7, TILE + 2, TILE + 2), np.float32)
    for plane in bands:
        plane[...] = rng.rand(TILE + 2, TILE + 2) * 200
        plane[rng.rand(TILE + 2, TILE + 2) < NODATA_SHARE] = np.finfo(np.float32).max
    temporal_planes = torch.from_numpy(bands).to(device)
    del bands
    path_planes = {"stencils": planes, "temporal-median": temporal_planes}
    cases = [("path shape, size 3", planes, 3),
             ("temporal-median path shape, size 3", temporal_planes, 3)]
    cases += [("size %d" % size, planes[:8].contiguous(), size) for size in (5, 7, 15)]
    for dtype in (np.float64, np.float16, np.int8, np.int16, np.int32, np.int64,
                  np.uint8, np.uint16, np.uint32, np.uint64):
        for size in (3, 5, 7):
            cases.append(("%s, size %d" % (np.dtype(dtype).name, size),
                          torch.from_numpy(small.astype(dtype)).to(device), size))
    wide = rng.randint(-2**62, 2**62, size=(2, 97, 89), dtype=np.int64)
    cases.append(("int64 beyond float64's range, size 3", torch.from_numpy(wide).to(device), 3))
    cases.append(("uint64 high bit, size 3",
                  torch.from_numpy(wide.view(np.uint64)).to(device), 3))
    cases.append(("bool, size 3", torch.from_numpy(small[:2] > 100).to(device), 3))
    with_nan = planes[:4].clone()
    with_nan[1, 100:103, 200:240] = float("nan")
    with_nan[2, 0, 0] = float("nan")
    cases.append(("a plane holding NaN, size 3", with_nan, 3))
    max_abs_err = {}
    for label, data, size in cases:
        before = cuda_stencils.moving_max_launches
        got = cuda_stencils.moving_max(data, size)
        check(cuda_stencils.moving_max_launches == before + 1, "moving_max launch count (%s)" % label)
        want = moving_max_reference(data, size)
        torch.cuda.synchronize()
        equal = got.dtype == want.dtype and same(got, want)
        for path, path_data in path_planes.items():
            if data is path_data:
                equal = equal and torch.equal(got, want)
                max_abs_err[path] = float((got - want).abs().max())
        print("kernel check: moving_max %s shape=%s dtype=%s equal=%s"
              % (label, tuple(data.shape), data.dtype, equal))
        check(equal, "moving_max differs from its plain version (%s)" % label)
        del got, want
    nan_out = cuda_stencils.moving_max(with_nan, 3)
    check(bool(torch.isnan(nan_out[1, 99:104, 199:241]).all())
          and not bool(torch.isnan(nan_out[0]).any()), "NaN did not spread over its windows")
    return [dict(time_moving_max(data), max_abs_err=max_abs_err[path], path=path)
            for path, data in path_planes.items()]


def time_moving_max(planes):
    """The kernel at size 3, its plain version and the library yardstick
    (max_pool2d, bitwise equal at size 3) on ``planes`` (CUDA events), and
    the bound."""
    import torch
    import torch.nn.functional as F

    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.ops.stencils import moving_max_reference

    def library():
        return F.max_pool2d(planes[:, None], kernel_size=3, stride=1, padding=1)[:, 0]

    got = cuda_stencils.moving_max(planes, 3)
    pooled = library()
    torch.cuda.synchronize()
    check(torch.equal(got, pooled), "moving_max differs from max_pool2d at size 3")
    print("kernel check: moving_max %s size 3 equal to max_pool2d(3, stride 1, padding 1)"
          % (tuple(planes.shape),))
    del got, pooled
    kernel_ms = cuda_ms(lambda: cuda_stencils.moving_max(planes, 3), 20)
    plain_ms = cuda_ms(lambda: moving_max_reference(planes, 3), 5)
    library_ms = cuda_ms(library, 20)
    n_bytes = 2 * planes.numel() * planes.element_size()
    ops = planes.numel() * 8  # a 3x3 window: 8 comparisons per output
    bound_ms, bound_by = bound(n_bytes, ops, FP32_OPS_PER_S)
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, shape=list(planes.shape))


def no_twin_view(source):
    """A view whose root's process has no torch twin.  The class is bound
    at module level, where its import path (graph keys hash it) resolves."""
    from dask_geomodeling_tpu_torch.raster import BaseSingle

    class NoTwin(BaseSingle):
        @staticmethod
        def process(data):
            return data

    globals()["NoTwin"] = NoTwin
    return NoTwin(source)


def check_headline(device, source, view, request):
    """Phase 4; returns (launches, host Mpx/s)."""
    from dask_geomodeling_tpu_torch import evaluate_tiled, get_data
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.runtime import executor
    from dask_geomodeling_tpu_torch.runtime import tiles as tile_runtime
    from dask_geomodeling_tpu_torch.runtime.tiles import NotLowerable, tile_requests

    tiles, nx = tile_requests(request, TILE)
    host_runs = executor.host_node_runs
    cuda_stencils.reset_launches()
    before = tile_runtime.batches_run
    t0 = time.perf_counter()
    result = evaluate_tiled(view, request, tile_size=TILE, batch=BATCH, device=device)
    first_s = time.perf_counter() - t0
    # batches of tiles whose plans agree (a cross-CRS Smooth's sigma
    # differs between tile rows in its last digits)
    n_batches = tile_runtime.batches_run - before
    launches = {"gaussian_blur": cuda_stencils.launches,
                "gaussian_blur_fused": cuda_stencils.fused_launches,
                "moving_max": cuda_stencils.moving_max_launches}
    values = result["values"]
    print("headline path: evaluate_tiled %s %s in %.2f s (first run), launches %s for %d batches"
          % (values.shape, values.dtype, first_s, launches, n_batches))
    check(launches["gaussian_blur"] == n_batches, "gaussian launches != batches")
    check(launches["gaussian_blur_fused"] == n_batches, "the headline path left the fused launch shape")
    check(values.shape == (1, HEADLINE_PX, HEADLINE_PX), "output shape")
    check(set(np.unique(values).tolist()) <= {0, 1, 2, 3, 4, 255}, "output alphabet")
    check((values != 255).mean() > 0.5, "output is mostly fill")

    cuda_stencils.reset_launches()
    routed = get_data(view, device=device, **request)
    check(cuda_stencils.launches == n_batches, "get_data did not run as tiles")
    check(np.array_equal(routed["values"], values), "get_data differs from evaluate_tiled")
    x1, y1, x2, y2 = request["bbox"]
    sub = dict(request, width=256, height=256, bbox=(
        (x1 + x2) / 2, (y1 + y2) / 2,
        (x1 + x2) / 2 + (x2 - x1) / 40, (y1 + y2) / 2 + (y2 - y1) / 40))
    cuda_stencils.reset_launches()
    sub_port = view.get_data(device=device, **sub)
    check(cuda_stencils.launches == 1, "sub-tile get_data did not launch the kernel")
    check(executor.host_node_runs == host_runs, "a node ran on the host")
    print("headline path: get_data (tiled and a 256^2 sub-tile request) ran every node on the card")
    no_twin = no_twin_view(source)
    for label, req in [("sub-tile", sub), ("tiled", request)]:
        try:
            get_data(no_twin, device=device, **req)
        except NotLowerable as exc:
            print("headline path: a node without a twin, %s request: NotLowerable (%s)" % (label, exc))
        else:
            raise RuntimeError("check failed: a node without a twin did not raise (%s)" % label)
    check(executor.host_node_runs == host_runs, "a node ran on the host")

    crop = dict(request, width=64, height=64, bbox=(
        x1, y2 - (y2 - y1) * 64 / HEADLINE_PX, x1 + (x2 - x1) * 64 / HEADLINE_PX, y2))
    check(np.array_equal(values[:, :64, :64], host_values(view, crop)), "64^2 crop differs")
    sub_host = host_values(view, sub)
    sampled = list(range(0, len(tiles), len(tiles) // 16))[:16]
    t0 = time.perf_counter()
    host_tiles = [host_values(view, tiles[k]) for k in sampled]
    host_s = time.perf_counter() - t0
    differing = 0
    for k, host_tile in zip(sampled, host_tiles):
        rows, cols = tile_window(k, nx, HEADLINE_PX, TILE)
        differing += int(np.count_nonzero(values[:, rows, cols] != host_tile))
    share = differing / (len(sampled) * TILE * TILE)
    sub_share = np.count_nonzero(sub_port["values"] != sub_host) / sub_host.size
    print("headline path: 64^2 crop bitwise equal to compute_host; %d tiles: %d of %d cells "
          "differ (share %r); sub-tile share %r" % (len(sampled), differing,
                                                     len(sampled) * TILE * TILE, share, sub_share))
    check(share <= HEADLINE_SHARE, "differing share above %g" % HEADLINE_SHARE)
    check(sub_share <= HEADLINE_SHARE, "sub-tile differing share above %g" % HEADLINE_SHARE)
    return launches, len(sampled) * TILE * TILE / 1e6 / host_s


def check_stencils(device, view, request):
    """Phase 5; returns (launches, host Mpx/s)."""
    from dask_geomodeling_tpu_torch import evaluate_tiled, get_data
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.runtime import executor
    from dask_geomodeling_tpu_torch.runtime import tiles as tile_runtime
    from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests

    tiles, nx = tile_requests(request, TILE)
    host_runs = executor.host_node_runs
    cuda_stencils.reset_launches()
    before = tile_runtime.batches_run
    t0 = time.perf_counter()
    result = evaluate_tiled(view, request, tile_size=TILE, batch=BATCH, device=device)
    first_s = time.perf_counter() - t0
    # batches of tiles whose plans agree (a cross-CRS Smooth's sigma
    # differs between tile rows in its last digits)
    n_batches = tile_runtime.batches_run - before
    launches = {"gaussian_blur": cuda_stencils.launches,
                "gaussian_blur_fused": cuda_stencils.fused_launches,
                "moving_max": cuda_stencils.moving_max_launches}
    values = result["values"]
    print("stencils path: evaluate_tiled %s %s in %.2f s (first run), launches %s for %d batches"
          % (values.shape, values.dtype, first_s, launches, n_batches))
    check(launches["moving_max"] == n_batches, "moving-max launches != batches")
    check(launches["gaussian_blur"] == n_batches, "gaussian launches != batches")
    check(launches["gaussian_blur_fused"] == n_batches, "the stencils path left the fused launch shape")
    check(executor.host_node_runs == host_runs, "a node ran on the host")
    check(values.shape == (1, STENCILS_PX, STENCILS_PX) and values.dtype == np.uint8, "output")
    check(result["no_data_value"] == 256, "no_data_value")
    check(len(np.unique(values)) > 100, "output is not shaded")

    cuda_stencils.reset_launches()
    routed = get_data(view, device=device, **request)
    check(cuda_stencils.moving_max_launches == n_batches, "get_data did not run as tiles")
    check(np.array_equal(routed["values"], values), "get_data differs from evaluate_tiled")
    print("stencils path: get_data ran as %d batches and equals evaluate_tiled" % n_batches)

    x1, y1, x2, y2 = request["bbox"]
    corner = dict(request, width=64, height=64, bbox=(x1, y2 - 64, x1 + 64, y2))
    below = view.store
    cuda_stencils.reset_launches()
    card = get_data(below, device=device, **corner)["values"]
    check(cuda_stencils.moving_max_launches == 1 and cuda_stencils.launches == 1,
          "the 64^2 request did not launch both kernels")
    check(np.array_equal(card, host_values(below, corner)),
          "64^2 corner of Smooth(MovingMax) differs from compute_host")
    shaded = get_data(view, device=device, **corner)["values"]
    corner_diff = np.abs(shaded.astype(int) - host_values(view, corner).astype(int)).max()
    check(corner_diff <= 1, "64^2 corner of the view differs by more than 1")
    check(executor.host_node_runs == host_runs, "a node ran on the host")
    print("stencils path: 64^2 corner below HillShade bitwise equal to compute_host; "
          "the view's corner within %d" % corner_diff)

    sampled = list(range(0, len(tiles), len(tiles) // 16))[:16]
    t0 = time.perf_counter()
    host_tiles = [host_values(view, tiles[k]) for k in sampled]
    host_s = time.perf_counter() - t0
    differing = 0
    worst = 0
    for k, host_tile in zip(sampled, host_tiles):
        rows, cols = tile_window(k, nx, STENCILS_PX, TILE)
        diff = np.abs(values[:, rows, cols].astype(int) - host_tile.astype(int))
        differing += int(np.count_nonzero(diff))
        worst = max(worst, int(diff.max()))
    share = differing / (len(sampled) * TILE * TILE)
    print("stencils path: %d tiles: %d of %d cells differ from compute_host (share %r), "
          "largest difference %d" % (len(sampled), differing, len(sampled) * TILE * TILE,
                                     share, worst))
    check(worst <= 1, "a sampled cell differs by more than 1")
    check(share <= STENCILS_SHARE, "differing share above %g" % STENCILS_SHARE)
    return launches, len(sampled) * TILE * TILE / 1e6 / host_s


def interpolation_set(interpolation):
    from dask_geomodeling_tpu_torch.config import config

    return config.set({"geomodeling.warp-interpolation": interpolation})


def compare_cells(port, host, no_data_value):
    """(differing cells, largest difference, cells nodata in one and data
    in the other)."""
    differ = port != host
    if port.dtype.kind == "f":
        differ &= ~(np.isnan(port) & np.isnan(host))
    worst = float(np.abs(port[differ].astype(np.float64) - host[differ]).max()) if differ.any() else 0.0
    fill_mismatch = int(np.count_nonzero((port == no_data_value) != (host == no_data_value)))
    return int(np.count_nonzero(differ)), worst, fill_mismatch


def check_algebra_path(label, device, view, request, interpolation, corner, host_nodes=0):
    """One raster-algebra, temporal or tiled geometry path at full size;
    returns host Mpx/s.  Every node that returns pixels runs on the card
    but ``host_nodes`` per tile (Rasterize's, which has no twin): the time
    subrequests of a Group or a temporal block, which return none, run on
    the host while planning; a
    64^2 corner and 16 sampled tiles are held to compute_host: bitwise,
    or for the cross-CRS bilinear path within BILINEAR_ATOL with at most
    BILINEAR_FILL_SHARE of the cells nodata in one and data in the
    other."""
    from dask_geomodeling_tpu_torch import evaluate_tiled, get_data
    from dask_geomodeling_tpu_torch.runtime import executor
    from dask_geomodeling_tpu_torch.runtime import tiles as tile_runtime
    from dask_geomodeling_tpu_torch.runtime.tiles import TileProgram, tile_requests

    exact = interpolation == "nearest"
    tiles, nx = tile_requests(request, TILE)
    px = request["width"]
    with interpolation_set(interpolation):
        program = TileProgram(view, tiles[0], device)
        host_runs = executor.host_node_runs
        batches = tile_runtime.batches_run
        t0 = time.perf_counter()
        result = evaluate_tiled(view, request, tile_size=TILE, batch=BATCH, device=device)
        first_s = time.perf_counter() - t0
        batches = tile_runtime.batches_run - batches
        values = result["values"]
        check(executor.host_node_runs - host_runs == host_nodes * len(tiles),
              "%s: a node ran on the host" % label)
        host_runs = executor.host_node_runs
        check(values.shape[1:] == (px, px), "%s: output shape" % label)
        data_share = float((values != result["no_data_value"]).mean())
        print("%s path: evaluate_tiled %s %s in %.2f s (first run), %d tiles in %d batches; %d "
              "device nodes, %d host nodes; data in %.4f of the cells"
              % (label, values.shape, values.dtype, first_s, len(tiles), batches,
                 program.on_host.count(False), program.on_host.count(True), data_share))
        check(batches == -(-len(tiles) // BATCH), "%s: tiles split into more batches" % label)
        check(data_share > 0.01, "%s: output is all nodata" % label)

        routed = get_data(view, device=device, **request)
        check(np.array_equal(routed["values"], values), "%s: get_data differs from evaluate_tiled" % label)
        x1, y1, x2, y2 = request["bbox"]
        cx, cy = corner
        crop = dict(request, width=64, height=64, bbox=(
            cx, cy - (y2 - y1) * 64 / px, cx + (x2 - x1) * 64 / px, cy))
        host_runs = executor.host_node_runs
        card_crop = get_data(view, device=device, **crop)["values"]
        check(executor.host_node_runs - host_runs == host_nodes,
              "%s: a node ran on the host" % label)
        crop_cells = compare_cells(card_crop, host_values(view, crop), result["no_data_value"])

        sampled = list(range(0, len(tiles), len(tiles) // 16))[:16]
        t0 = time.perf_counter()
        host_tiles = [host_values(view, tiles[k]) for k in sampled]
        host_s = time.perf_counter() - t0
    differing, worst, fill_mismatch, filled = 0, 0.0, 0, 0
    for k, host_tile in zip(sampled, host_tiles):
        rows, cols = tile_window(k, nx, px, TILE)
        d, w, f = compare_cells(values[:, rows, cols], host_tile, result["no_data_value"])
        differing, worst, fill_mismatch = differing + d, max(worst, w), fill_mismatch + f
        filled += int(np.count_nonzero(host_tile == result["no_data_value"]))
    n_cells = len(sampled) * TILE * TILE * values.shape[0]
    print("%s path: 64^2 corner: %d of %d cells differ from compute_host (largest %r, %d "
          "cells nodata on the card); %d tiles: %d of %d cells differ (share %r), largest "
          "difference %r, %d cells nodata in one only, nodata in %r of compute_host's cells"
          % (label, crop_cells[0], card_crop.size, crop_cells[1],
             np.count_nonzero(card_crop == result["no_data_value"]), len(sampled), differing,
             n_cells, differing / n_cells, worst, fill_mismatch, filled / n_cells))
    if exact:
        check(crop_cells[0] == 0, "%s: 64^2 corner differs from compute_host" % label)
        check(differing == 0, "%s: sampled tiles differ from compute_host" % label)
    else:
        check(max(worst, crop_cells[1]) <= BILINEAR_ATOL, "%s: difference above %g" % (label, BILINEAR_ATOL))
        check(fill_mismatch / n_cells <= BILINEAR_FILL_SHARE
              and crop_cells[2] / card_crop.size <= BILINEAR_FILL_SHARE,
              "%s: nodata cells differ in more than %g" % (label, BILINEAR_FILL_SHARE))
    # request pixels, all bands of one counted once, as the port's Mpx/s counts them
    return len(sampled) * TILE * TILE / 1e6 / host_s


def check_temporal_p90(device, source, request):
    """The 90th percentile over the temporal-median path's source, on a
    64^2 crop, on the card against compute_host: numpy's linear method
    with its _lerp, so bitwise; checked within rtol 1e-6, with the
    differing cells counted."""
    from dask_geomodeling_tpu_torch.raster import TemporalAggregate
    from dask_geomodeling_tpu_torch.runtime import executor

    view = TemporalAggregate(source, "6h", statistic="p90", timezone="Europe/Amsterdam")
    x1, _, _, y2 = request["bbox"]
    crop = dict(request, width=64, height=64, bbox=(x1, y2 - 64, x1 + 64, y2))
    host_runs = executor.host_node_runs
    card = view.get_data(device=device, **crop)["values"]
    check(executor.host_node_runs == host_runs, "p90 crop: a node ran on the host")
    t0 = time.perf_counter()
    host = host_values(view, crop)
    host_s = time.perf_counter() - t0
    check(card.dtype == host.dtype and card.shape == host.shape, "p90 crop: dtype or shape")
    differing = int(np.count_nonzero(card != host))
    print("temporal p90: 64^2 crop %s %s on the card, %d of %d cells differ from compute_host "
          "(largest relative %r; host %.2f s)" % (
              card.shape, card.dtype, differing, card.size,
              float(np.max(np.abs(card.astype(np.float64) - host) / np.maximum(np.abs(host), 1e-30))),
              host_s))
    check(np.allclose(card, host, rtol=1e-6, atol=0), "p90 crop beyond rtol 1e-6")
    return differing


def agg_matrix(frame, column="agg"):
    """A frame's aggregate column as a (features, frames) float64 array
    (multiband cells are one list each)."""
    cells = frame[column].tolist()
    return np.array([np.asarray(c[0] if isinstance(c, list) else [c], np.float64)
                     for c in cells]).reshape(len(cells), -1)


#: zonal statistics held bitwise to compute_host; sum and mean accumulate
#: in float64 with atomics on the card, so they stay within one float32
#: ulp of the host's sequential sums after the rounding to float32
ZONAL_EXACT = ("median", "p90", "max", "count-above")
ZONAL_HOST_BUDGET_S = 90.0


def compare_zonal(name, port, host):
    """(cells differing, cells beyond one float32 ulp, cells): the port's
    features against compute_host's, index and columns equal."""
    p, h = port["features"], host["features"]
    check(len(p) == len(h) and np.array_equal(p.index.values, h.index.values),
          "zonal %s: features differ" % name)
    check(sorted(p.columns) == sorted(h.columns), "zonal %s: columns differ" % name)
    a, b = agg_matrix(p), agg_matrix(h)
    differ = ~((a == b) | (np.isnan(a) & np.isnan(b)))
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32)).astype(np.float64)
    beyond = differ & ~(np.abs(a - b) <= ulp)
    return int(differ.sum()), int(beyond.sum()), a.size


def _keep_on_device(data):
    """A node that takes its input as the device tensor it is and hands
    it to check_zonal (compute_torch drops the batch axis)."""
    _kept.append(data)
    return None


_keep_on_device.torch_accepts_device_tensors = True
_kept = []


def zonal_phases(view, request, device):
    """One zonal request split into its phases (synchronised): the host
    planning and features, the raster run on the card, the host work of
    the features (to_crs, bucketize), the label planes and the
    statistics; returns (seconds per phase, label planes, covered, grid
    shape, features, groups)."""
    import torch

    from dask_geomodeling_tpu_torch import compute_host, compute_torch
    from dask_geomodeling_tpu_torch.geo import parse_percentile_statistic
    from dask_geomodeling_tpu_torch.geometry.aggregate import _device_labels, bucketize
    from dask_geomodeling_tpu_torch.ops.segment import labeled_statistics

    seconds = {}
    t0 = time.perf_counter()

    def lap(phase):
        nonlocal t0
        torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[phase] = seconds.get(phase, 0.0) + now - t0
        t0 = now

    graph, name = view.get_compute_graph(**request)
    _, source_key, raster_key, plan = graph[name]
    features = compute_host(graph, source_key)["features"]
    lap("host planning and features")
    graph = dict(graph, kept=(_keep_on_device, raster_key))
    _kept.clear()
    compute_torch(graph, "kept", device=device)
    raster = _kept.pop()
    values = raster["values"]
    lap("raster run")
    geometry = features.geometry
    geometry.crs = plan["req_srs"]
    agg_geometries = geometry.to_crs(plan["agg_srs"])
    groups = bucketize(agg_geometries.bounds.values)
    lap("host work (to_crs, bucketize)")
    depth, height, width = values.shape
    fill = int(np.iinfo(np.int32).max)
    labels = _device_labels(agg_geometries, groups, plan["agg_bbox"], plan["agg_srs"],
                            height, width, fill, values.device)
    lap("label rasterization")
    statistic, percentile = parse_percentile_statistic(plan["statistic"])
    q = 50.0 if statistic == "median" or percentile is None else float(percentile)
    _, covered = labeled_statistics(values, labels, fill, raster["no_data_value"], None,
                                    len(agg_geometries), statistic, q)
    lap("statistics")
    return seconds, labels, covered.cpu().numpy(), values.shape, agg_geometries, groups, plan, raster


def time_zonal_plane(labels, raster, geometries, groups, plan):
    """CUDA-event ms of the zonal device plane at the path's shapes: the
    label planes from the groups' edges, and the statistics of mean,
    median and p90 over them."""
    from dask_geomodeling_tpu_torch.geometry.aggregate import _device_labels
    from dask_geomodeling_tpu_torch.ops.segment import labeled_statistics

    values, nodata = raster["values"], raster["no_data_value"]
    _, height, width = values.shape
    fill = int(np.iinfo(np.int32).max)
    n = len(geometries)
    plane_ms = {"label planes": cuda_ms(lambda: _device_labels(
        geometries, groups, plan["agg_bbox"], plan["agg_srs"], height, width, fill,
        values.device), 3)}
    for name, statistic, q in [("mean", "mean", 50.0), ("median", "median", 50.0),
                               ("p90", "percentile", 90.0)]:
        plane_ms["statistics " + name] = cuda_ms(lambda: labeled_statistics(
            values, labels, fill, nodata, None, n, statistic, q), 5)
    return plane_ms


def time_rasterize_wkt(device, view, request):
    """CUDA-event ms of RasterizeWKT's twin over the first batch of the
    rasterize-wkt path's tiles (the Clip's second source)."""
    import torch

    from dask_geomodeling_tpu_torch.raster.misc import _rasterize_wkt_torch
    from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests

    wkt_view = view.args[1]
    tiles, _ = tile_requests(request, TILE)
    bbox = torch.tensor([t["bbox"] for t in tiles[:BATCH]], dtype=torch.float64, device=device)
    data = {"wkt": wkt_view.wkt, "projection": wkt_view.projection}
    return cuda_ms(lambda: _rasterize_wkt_torch(data, dict(tiles[0], bbox=bbox)), 5)


def check_zonal(device, card, raster):
    """The zonal phase: build_zonal_views over ``raster`` on the card,
    each request against compute_host (count, max, median and p90
    bitwise, sum and mean within one float32 ulp), the label planes of
    the mean request bitwise to the host scanline's and its covered set
    equal; seconds per request, the phases of one run, the device's busy
    time and idle share and the peak memory.  Returns the numbers."""
    import torch

    from dask_geomodeling_tpu_torch import compute_host
    from dask_geomodeling_tpu_torch.geo import rasterize_geoseries
    from dask_geomodeling_tpu_torch.runtime import executor

    views = build_zonal_views(raster)
    numbers = {}
    port = {}
    host_runs = executor.host_node_runs
    for name, (view, request) in views.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        port[name] = view.get_data(device=device, **request)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        numbers[name] = dict(first_s=seconds, peak_gib=peak)
        print("zonal %s: %d features on the card in %.3f s (first run), peak memory %.3f GiB"
              % (name, len(port[name]["features"]), seconds, peak))
    check(executor.host_node_runs == host_runs, "zonal: a node returning pixels ran on the host")

    # the phases, the label planes and the covered set of the mean request
    view, request = views["mean"]
    phases, labels, covered, shape, geometries, groups, plan, raster = zonal_phases(
        view, request, device)
    depth, height, width = shape
    t0 = time.perf_counter()
    host_covered = np.zeros(len(geometries), bool)
    differing_labels = 0
    for plane, group in enumerate(groups):
        burned = rasterize_geoseries(geometries.iloc[group], plan["agg_bbox"], plan["agg_srs"],
                                     height, width, values=np.asarray(group, dtype=np.int32))
        host_labels = burned["values"][0]
        differing_labels += int(np.count_nonzero(labels[plane].cpu().numpy() != host_labels))
        host_covered[np.unique(host_labels[host_labels != burned["no_data_value"]])] = True
    label_host_s = time.perf_counter() - t0
    print("zonal mean: grid %dx%d x %d frames (%.3f Mpx), %d groups; label planes: %d cells "
          "differ from the host scanline's (host %.2f s); covered %d of %d features, "
          "uncovered sets equal: %s"
          % (width, height, depth, width * height / 1e6, len(groups), differing_labels,
             label_host_s, int(covered.sum()), len(covered),
             bool(np.array_equal(covered, host_covered))))
    check(differing_labels == 0, "zonal: label planes differ from the host scanline's")
    check(np.array_equal(covered, host_covered), "zonal: covered sets differ")
    print("zonal mean: phases of one run (synchronised): %s"
          % ", ".join("%s %.4f s" % kv for kv in phases.items()))
    plane_ms = time_zonal_plane(labels, raster, geometries, groups, plan)
    print("timing [%s] zonal device plane (CUDA events, %d planes of %dx%d, %d frames): %s"
          % (card, len(groups), width, height, depth,
             ", ".join("%s %.4f ms" % kv for kv in plane_ms.items())))
    del raster, labels

    # against compute_host: the whole request for mean and median, the
    # others whole while the host's time allows, else over a sub-area
    host_s = {}
    spent = 0.0
    for name in ["mean", "median", "p90", "max", "sum", "count-above", "mean-3857"]:
        view, request = views[name]
        sub = spent > ZONAL_HOST_BUDGET_S / 3 and name not in ("mean", "median")
        if sub:
            request = zonal_request(16, request["projection"])  # 16 x 16 cells, top left
            port_result = view.get_data(device=device, **request)
        else:
            port_result = port[name]
        t0 = time.perf_counter()
        host = compute_host(*view.get_compute_graph(**request))
        host_s[name] = time.perf_counter() - t0
        spent += host_s[name]
        differing, beyond, cells = compare_zonal(name, port_result, host)
        exact = name in ZONAL_EXACT
        print("zonal %s: %s%d features x frames: %d differ from compute_host, %d beyond one "
              "float32 ulp (%s; host %.2f s)"
              % (name, "sub-area of 16 x 16 cells, " if sub else "whole request, ", cells,
                 differing, beyond, "bitwise" if exact else "within one float32 ulp",
                 host_s[name]))
        check(beyond == 0 and (differing == 0 or not exact),
              "zonal %s differs from compute_host" % name)

    # timing: median of 3 runs of mean and median, device busy time
    for name in ("mean", "median"):
        view, request = views[name]
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            view.get_data(device=device, **request)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        median_s = sorted(runs)[1]
        profiled_s, busy_ms = device_busy_ms(lambda: view.get_data(device=device, **request))
        idle = None if busy_ms is None else 1 - busy_ms / 1e3 / profiled_s
        rate = width * height * depth / 1e6 / median_s
        host_rate = width * height * depth / 1e6 / host_s[name]
        numbers[name].update(runs_s=runs, s_per_request=median_s, mpx_frames_per_s=rate,
                             host_s=host_s[name], host_mpx_frames_per_s=host_rate,
                             device_busy_ms=busy_ms, idle_share=idle)
        print("timing [%s] zonal %s: %.4f s per request (median of 3: %s), %.3f Mpx x frames/s; "
              "compute_host %.3f s, %.3f Mpx x frames/s; profiled run %.4f s, device busy %s, "
              "idle share %s"
              % (card, name, median_s, ", ".join("%.4f" % r for r in runs), rate, host_s[name],
                 host_rate, profiled_s,
                 "not measured" if busy_ms is None else "%.3f ms" % busy_ms,
                 "not measured" if idle is None else "%.4f" % idle))
    numbers["phases_s"] = phases
    numbers["device_plane_ms"] = plane_ms
    numbers["grid"] = [width, height, depth]
    return numbers


def check_fuzz(device):
    """The executor fuzz on the card: the reference's random trees (seeds
    0-39 at 12^2, 40-54 as 6^2 tiles in batches of 2) against compute_host
    with the fuzz's rule; returns the number of trees checked."""
    from dask_geomodeling_tpu_torch import compute_host, evaluate_tiled
    from dask_geomodeling_tpu_torch.runtime import executor

    sources = fuzz_sources()
    host_runs = executor.host_node_runs
    failed = []
    exact_floats = 0
    for seed in list(FUZZ_SEEDS) + list(FUZZ_TILED_SEEDS):
        view, request = fuzz_view(seed, sources)
        expected = compute_host(*view.get_compute_graph(**request))
        if seed in FUZZ_TILED_SEEDS:
            actual = evaluate_tiled(view, request, tile_size=6, batch=2, device=device)
            actual = dict(actual, no_data_value=expected["no_data_value"])
        else:
            actual = view.get_data(device=device, **request)
        if not same_as_host(actual, expected):
            failed.append(seed)
        elif expected is not None and expected["values"].dtype.kind == "f":
            exact_floats += int(np.array_equal(actual["values"], expected["values"]))
    check(executor.host_node_runs == host_runs, "fuzz: a node ran on the host")
    n = len(FUZZ_SEEDS) + len(FUZZ_TILED_SEEDS)
    print("fuzz: %d random trees on the card against compute_host, %d failed %s; %d float "
          "results bitwise" % (n, len(failed), failed, exact_floats))
    check(not failed, "fuzz: seeds %s differ from compute_host" % failed)
    return n


def check_f64_discrete(device):
    """The float64 discrete ops on the card, bitwise against compute_host:
    comparisons, MaskBelow, Step and Classify on a float64 source whose
    values sit on and one float64 step beside each threshold."""
    from dask_geomodeling_tpu_torch import compute_host
    from dask_geomodeling_tpu_torch import raster as R

    thresholds = [0.1, 1 / 3, 12.34, 100.0, 2.0 ** 40 + 0.5, -7.7]
    near = np.array([np.nextafter(t, d) for t in thresholds for d in (-np.inf, 0.0, np.inf)]
                    + [t for t in thresholds])
    rng = np.random.RandomState(3)
    values = rng.choice(near, size=(64, 64))
    source = R.MemorySource(data=values, no_data_value=-9999.0, projection="EPSG:28992",
                            pixel_size=1.0, pixel_origin=(0.0, 64.0))
    request = dict(mode="vals", bbox=(0.0, 0.0, 64.0, 64.0), projection="EPSG:28992",
                   width=64, height=64, start=datetime(1970, 1, 1))
    views = []
    for t in thresholds:
        views += [cls(source, t) for cls in (R.Greater, R.GreaterEqual, R.Less, R.LessEqual,
                                             R.Equal, R.NotEqual, R.MaskBelow)]
        views.append(R.Step(source, left=0, right=2, value=t, at=1))
    views.append(R.Classify(source, bins=sorted(thresholds)))
    differing = [repr(v)[:40] for v in views
                 if not np.array_equal(v.get_data(device=device, **request)["values"],
                                       compute_host(*v.get_compute_graph(**request))["values"])]
    print("f64 discrete: %d float64 views (comparisons, MaskBelow, Step, Classify) at and "
          "beside %d thresholds: %d differ from compute_host" % (len(views), len(thresholds),
                                                                  len(differing)))
    check(not differing, "f64 discrete ops differ: %s" % differing[:3])
    return len(views)


def time_path(label, card, view, request, device, host_rate):
    """Phase 9 for one path; returns its numbers."""
    import torch

    from dask_geomodeling_tpu_torch import evaluate_tiled

    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate_tiled(view, request, tile_size=TILE, batch=BATCH, device=device)
        runs.append(time.perf_counter() - t0)
    mpx = request["width"] * request["height"] / 1e6
    rate = mpx / sorted(runs)[1]
    phases = {}
    t0 = time.perf_counter()
    evaluate_tiled(view, request, tile_size=TILE, batch=BATCH, device=device,
                   phase_seconds=phases)
    phased_s = time.perf_counter() - t0
    profiled_s, busy_ms = device_busy_ms(lambda: evaluate_tiled(
        view, request, tile_size=TILE, batch=BATCH, device=device))
    idle = None if busy_ms is None else 1 - busy_ms / 1e3 / profiled_s
    print("timing [%s] %s: port %.3f Mpx/s (median of 3: %s s); numpy host %.3f Mpx/s on 16 tiles"
          % (card, label, rate, ", ".join("%.3f" % r for r in runs), host_rate))
    print("timing [%s] %s: phases of one run (synchronised, %.4f s in all): %s"
          % (card, label, phased_s, ", ".join("%s %.4f s" % kv for kv in phases.items())))
    print("timing [%s] %s: profiled run %.4f s, device busy %s, idle share %s"
          % (card, label, profiled_s,
             "not measured" if busy_ms is None else "%.3f ms" % busy_ms,
             "not measured" if idle is None else "%.4f" % idle))
    return dict(mpx_per_s=rate, runs_s=runs, host_mpx_per_s=host_rate, phases_s=phases,
                device_busy_ms=busy_ms, idle_share=idle)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests

    started = time.perf_counter()

    def mark(phase):
        print("elapsed: %.1f s after %s" % (time.perf_counter() - started, phase))

    # 1. device
    card = card_description()
    device = torch.device("cuda", 0)
    print(card)
    print("device: torch %s, CUDA %s, %d card(s)" % (
        torch.__version__, torch.version.cuda, torch.cuda.device_count()))

    # 2. build
    build_kernels()
    mark("the build")

    # 3. kernel checks, at the sigmas of the paths' first tiles
    headline_source, headline_view = build_headline_view()
    headline_req = headline_request(headline_source, HEADLINE_PX)
    _, stencils_view = build_stencils_view(STENCILS_PX)
    stencils_req = vals_request(STENCILS_PX)
    sigmas = [smooth_sigma(view, tile_requests(req, TILE)[0][0])
              for view, req in [(headline_view, headline_req), (stencils_view, stencils_req)]]
    gaussian = check_gaussian(device, *sigmas)
    moving = check_moving_max(device)
    mark("the kernel checks")

    # 4. to 8. the paths, the fuzz and the float64 discrete ops
    headline_launches, headline_host = check_headline(
        device, headline_source, headline_view, headline_req)
    stencils_launches, stencils_host = check_stencils(device, stencils_view, stencils_req)
    launches = {"headline": headline_launches, "stencils": stencils_launches}
    mark("the headline and stencils paths")
    algebra = build_algebra_paths(ALGEBRA_PX)
    algebra_host = {}
    for label, (view, request, interpolation, corner) in algebra.items():
        cuda_stencils.reset_launches()
        algebra_host[label] = check_algebra_path(
            label, device, view, request, interpolation, corner)
        launches[label] = {"gaussian_blur": cuda_stencils.launches,
                           "moving_max": cuda_stencils.moving_max_launches}
    mark("the algebra paths")
    temporal, hourly48 = build_temporal_paths()
    mark("building the temporal sources")
    for label, (view, request, interpolation, corner) in temporal.items():
        cuda_stencils.reset_launches()
        algebra_host[label] = check_algebra_path(
            label, device, view, request, interpolation, corner)
        launches[label] = {"gaussian_blur": cuda_stencils.launches,
                           "moving_max": cuda_stencils.moving_max_launches}
    check(launches["temporal-median"]["moving_max"] > 0,
          "temporal-median: the moving-max kernel did not launch")
    check_temporal_p90(device, hourly48, temporal["temporal-median"][1])
    mark("the temporal paths")
    geometry = build_geometry_paths()
    for label, (view, request, interpolation, corner) in geometry.items():
        cuda_stencils.reset_launches()
        algebra_host[label] = check_algebra_path(
            label, device, view, request, interpolation, corner,
            host_nodes=1 if label == "rasterize" else 0)
        launches[label] = {"gaussian_blur": cuda_stencils.launches,
                           "moving_max": cuda_stencils.moving_max_launches}
    view, request, _, _ = geometry["rasterize-wkt"]
    wkt_ms = time_rasterize_wkt(device, view, request)
    print("timing [%s] rasterize-wkt: the parity twin over one batch of %d 512^2 tiles "
          "(CUDA events): %.4f ms" % (card, BATCH, wkt_ms))
    mark("the tiled geometry paths")
    cuda_stencils.reset_launches()
    zonal = check_zonal(device, card, temporal["temporal-mean"][0])
    launches["zonal"] = {"gaussian_blur": cuda_stencils.launches,
                         "moving_max": cuda_stencils.moving_max_launches}
    mark("the zonal path")
    check_fuzz(device)
    check_f64_discrete(device)
    mark("the fuzz and the float64 discrete ops")

    # 9. timing
    timings = {
        "headline": time_path("headline", card, headline_view, headline_req, device, headline_host),
        "stencils": time_path("stencils", card, stencils_view, stencils_req, device, stencils_host),
    }
    for label, (view, request, interpolation, _) in (
            list(algebra.items()) + list(temporal.items()) + list(geometry.items())):
        with interpolation_set(interpolation):
            timings[label] = time_path(label, card, view, request, device, algebra_host[label])
    for name, numbers in [("gaussian_blur", g) for g in gaussian] + [("moving_max", m) for m in moving]:
        print("timing [%s]: %s %s kernel %.4f ms, plain torch %.4f ms, library call %.4f ms, "
              "bound %.4f ms (%s)" % (card, name, tuple(numbers["shape"]), numbers["ms"],
                                      numbers["plain_ms"], numbers["library_ms"],
                                      numbers["bound_ms"], numbers["bound_by"]))

    mark("the timing")
    leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                    or m == "dask_geomodeling_tpu" or m.startswith("dask_geomodeling_tpu.")
                    or m == "pandas" or m.startswith("pandas."))
    check(not leaked, "modules of JAX, pandas or the JAX package were imported: %s" % leaked[:5])
    print("imports: no module of JAX, pandas or the JAX package was loaded")
    timings["zonal"] = zonal
    timings["rasterize-wkt"]["parity_twin_ms"] = wkt_ms
    print("paths: %s" % json.dumps(timings))

    def record(name, source, replaces, numbers, kernel):
        per_path = {label: counts[kernel] for label, counts in launches.items()}
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(per_path.values()),
            "launches_per_path": per_path,
            "max_abs_err": numbers["max_abs_err"],
            "ms": numbers["ms"],
            "plain_ms": numbers["plain_ms"],
            "bound_ms": numbers["bound_ms"],
            "bound_by": numbers["bound_by"],
            "library_ms": numbers["library_ms"],
            "shape": numbers["shape"],
            "timed_at": numbers["path"],
        }

    print(json.dumps({"kernels": [
        record("gaussian_blur", "dask_geomodeling_tpu_torch/csrc/gaussian_blur.cu",
               "dask_geomodeling_tpu/ops/pallas_stencils.py:55", numbers, "gaussian_blur")
        for numbers in gaussian
    ] + [
        record("moving_max", "dask_geomodeling_tpu_torch/csrc/moving_max.cu",
               "dask_geomodeling_tpu/ops/pallas_stencils.py:136", numbers, "moving_max")
        for numbers in moving
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
