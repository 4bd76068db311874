#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dask_geomodeling_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: csrc/gaussian_blur.cu and csrc/moving_max.cu with nvcc for
   sm_90a, from this checkout, both at once; then the elevation sheet of
   the file paths (write_sheet: one AHN sheet, 10000 x 12500 float32 at
   0.5 m in EPSG:28992, written with the port's GeoTIFF writer into a
   temporary folder);
3. kernel checks, on the card against the plain torch versions
   (torch.equal): the Gaussian at the headline path's shape (64, 516, 516)
   and sigma (radius 3), at the stencils path's (64, 524, 524) and sigma
   5/3 (radius 7), at the file-read path's (64, 524, 524) and sigma 2
   (radius 8), at radius 8 and at a zoom-mode radius 40, and one plane
   against scipy.ndimage.gaussian_filter, bitwise; the integer frames'
   entry (float64 storage truncated toward zero between the passes) on
   every integer width from int8 to uint64 and on a uint8 (64, 524, 524)
   batch; the moving maximum at
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
10. the file paths (build_file_paths), Smooth(RasterFileSource(sheet), 3):
   file-read (the whole sheet at its grid, 500 tiles read window by
   window: at most 8 batches, the Gaussian once per batch, bitwise with
   the checks of 6, the crop and a sampled tile at the nodata block, an
   edge tile sampled) and file-reproject (a 4096^2 sub-area in EPSG:3857,
   at most 5e-4 of the cells differing, as the headline); then
   file-export (check_file_export): to_file in 2048^2 tiles (35 files, a
   Gaussian launch each), the VRT read back window by window equal to the
   files and to file-read but within the Gaussian's reach of a 512^2 tile
   border, two files equal to compute_host, and to_cog of a 4096^2
   sub-area with overviews (2, 4, 8), read at overview level 2 with
   geomodeling.use-overviews, equal to compute_host;
10b. building-heights (check_buildings): 20,000 synthetic building
   footprints over the sheet (write_buildings: a GeoPackage, layer
   "pand", with its R-tree), the mean and 90th percentile of the file-read
   view per building (AggregateRaster), Round, Classify of their
   difference, Area (build_buildings_view), exported by to_file in
   1000 m tiles (GeometryTiler over GeometryFileSink GeoPackages, merged):
   every building whose centroid lies strictly inside a tile, each once;
   two tiles equal to compute_host (h_mean within one float32 ulp before
   rounding); the export again through the GeoPackage's R-tree; a 1000 m
   sub-area exported untiled as GeoJSON and as a Shapefile equal to the
   host's export; one Gaussian launch per tile, the phases, the device
   busy time and idle share;
10c. wms-serving (check_wms_serving): the port's WSGI WMS server
   (ipyleaflet_plugin.wms_app on wsgiref at 127.0.0.1, a background
   thread) over two registered layers of the sheet, ahn-smooth (the
   file-read view, style terrain, 0-10) and ahn-hillshade
   (HillShade(RasterFileSource), gray, 0-255); a slippy map's GetMap
   traffic (every 256^2 EPSG:3857 XYZ tile of zooms 14 and 15 over the
   sheet and the middle 9 of zoom 16's 18 rows, PNG) through urllib in
   four passes: cold (read caches cleared, no
   result cache), warm, fill (the 256 MiB result cache of wms_serve) and
   hit (byte-identical PNGs, no Gaussian launch); p50/p99/max latency a
   layer and pass; 32 sampled tiles a layer against compute_host (at
   most 5e-4 of the warped source cells differing, outside their reach
   ahn-smooth bitwise and ahn-hillshade within 1 in at most 1e-3 of the
   cells, every pixel whose value agrees coloured as the host's render
   colours it), each timed in-process on the card (render_wms_tile) and
   on the numpy host alike; 16 GetFeatureInfo answers against the host's values,
   GetLegendGraphic, GetCoverage read back, GetCapabilities, a layer
   naming the JAX package's classes answered 400; four threads rendering
   64 tiles as the serial render does, one Gaussian launch per
   ahn-smooth tile; a phase split of the sampled tiles and a profiled
   warm pass, apart from the timed ones;
10d. auto-routing (check_auto_routing): geomodeling.executor "auto" over
   the two WMS layers at the sheet's grid and the headline view at its
   request's cell in EPSG:3857: 8 requests of each edge 64, 128, 256,
   512, 1024 and 2048 px a view, at windows drawn from a seed, in one
   seeded, interleaved order, the router exploring from an empty table
   whose state file lives in the temporary folder; every card-routed
   answer against compute_host (tile by tile above one 512^2 tile, as
   the card runs it; the file-read view bitwise, HillShade
   within 1 in at most 1e-3 of its cells, the headline at most 5e-4 of
   its cells differing); per view and edge the routes taken, the
   Gaussian launches on each route (none on host routes), the final
   host and card Mpx/s and the settled route; after save and a reseeded
   reset, one request per key takes its settled route;
   status.snapshot(); a 2048^2 request under the Profiler and
   torch_trace (a non-empty Chrome trace);
10e. building-rings (check_building_rings): the building-heights
   footprints inside a 1400 m square of the sheet (about 1,250, cut from
   the sheet's 20,000: the host buffer costs tens of ms a footprint),
   written with a beschrijving of key=value lines; the view
   (build_rings_view) buffers each by 10 m, subtracts the footprint,
   simplifies, takes the mean and p10 of the file-read view over the
   ring (the Gaussian and the device zonal plane), merges (left) the
   footprint's own mean, parses two keys, takes a field difference and
   clips each ring to its tile (Intersection); exported by to_file in
   1000 m tiles, timed under a phase clock (buffer, difference, vector
   read, zonal, sink); one tile against compute_host and a 300 m
   sub-area exported as GeoJSON byte-identical to the host's export;
11. the executor fuzz on the card: the 55 random trees of
   tests/test_executor_fuzz.py (random_view, with the port's classes)
   against compute_host; and float64 comparisons, MaskBelow, Step and
   Classify at and beside their thresholds, bitwise;
12. timing, per tiled path: median of 3 evaluate_tiled runs (Mpx/s), the
   numpy host rate on the sampled tiles, one run's seconds per phase, one
   profiled run's device busy time and idle share; per kernel at its
   path's shape, the kernel, its plain version and one PyTorch call of the
   same function (CUDA events), and the least time the card could take;
   the Gaussian is timed at three paths' shapes, on a uint8 batch (the
   integer entry) and at the building-heights and wms-serving paths'
   single planes, one kernel record each.

The views are built with the port's own classes (private copies of
bench.py's and benchmarks/run.py's builders) and checked against the
port's compute_host.  The line before the last is the kernels' JSON
record; the last line is {"ok": true, "device": {...}}.  Without CUDA the
script exits non-zero before printing any result.  It imports nothing of
JAX, pandas, matplotlib, Pillow or the JAX package, and checks that at
the end.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
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


#: the file paths: one sheet of the Dutch national elevation model (AHN)
#: at 0.5 m, 5 km x 6.25 km: 10000 x 12500 float32 in EPSG:28992, its NW
#: corner on the sheet grid; above the 64 Mi px windowed-read limit
SHEET_WIDTH, SHEET_HEIGHT = 10000, 12500
SHEET_ORIGIN = (120000.0, 487500.0)
SHEET_CELL = 0.5
SHEET_NODATA = float(np.finfo(np.float32).max)
SHEET_NODATA_SHARE = 0.05
SHEET_BLOCK = 600
# to_file's tiles (35 over the sheet), the reprojected and exported
# sub-area, and the COG's overview factors
EXPORT_TILE = 2048
FILE_SUB_PX = 4096
COG_OVERVIEWS = [2, 4, 8]


def sheet_block_at(width, height):
    """(row, col) of the nodata block's north-west corner: inside the
    sampled tile 465 of a full-size file-read run."""
    return int(height * 0.012), int(width * 0.24)


def write_sheet(folder, width=SHEET_WIDTH, height=SHEET_HEIGHT, block=SHEET_BLOCK, seed=11):
    """Write the synthetic elevation sheet with the port's own writer
    (deflate, 512^2 tiles) to ``folder``/sheet.tif; returns its path.
    Smooth terrain of a few metres plus 1 cm noise from ``seed``, heights
    to the millimetre, nodata (float32's maximum) in SHEET_NODATA_SHARE of
    the cells and in a block^2 square.  Made row band by row band to keep the host's
    transient memory small."""
    from dask_geomodeling_tpu_torch.io.geotiff import write_geotiff

    rng = np.random.default_rng(seed)
    x = np.arange(width) * SHEET_CELL
    y = np.arange(height) * SHEET_CELL
    across = 2.5 * np.sin(x / 270.0)
    slope = 0.0008 * x
    data = np.empty((1, height, width), np.float32)
    for row0 in range(0, height, 1024):
        row1 = min(height, row0 + 1024)
        rows = np.round(1000.0 * (3.0 + across[None, :] * np.cos(y[row0:row1] / 365.0)[:, None]
                                  + slope[None, :] + 0.01 * rng.standard_normal((row1 - row0, width))
                                  )) / 1000.0
        rows[rng.random((row1 - row0, width)) < SHEET_NODATA_SHARE] = SHEET_NODATA
        data[0, row0:row1] = rows
    row, col = sheet_block_at(width, height)
    data[0, row : row + block, col : col + block] = SHEET_NODATA
    path = os.path.join(folder, "sheet.tif")
    write_geotiff(path, data, (SHEET_ORIGIN[0], SHEET_CELL, 0.0, SHEET_ORIGIN[1], 0.0, -SHEET_CELL),
                  "EPSG:28992", SHEET_NODATA, compress="deflate", tiled=True, tile_size=512)
    return path


def sheet_request(source):
    """The whole sheet at its native grid."""
    return dict(mode="vals", bbox=source.footprint.bbox, projection="EPSG:28992",
                width=source.info.width, height=source.info.height)


def sheet_sub_area(request, px, offset=(2048, 4096)):
    """The bbox of a px^2 sub-area of the sheet request: its south-west
    corner ``offset`` (col, row from the bottom) pixels into the sheet, or
    less on a small sheet, on the file-read path's TILE^2 grid."""
    x1, y1, _, _ = request["bbox"]
    col = min(offset[0], (request["width"] - px) // TILE * TILE)
    row = min(offset[1], (request["height"] - px) // TILE * TILE)
    return (x1 + col * SHEET_CELL, y1 + row * SHEET_CELL,
            x1 + (col + px) * SHEET_CELL, y1 + (row + px) * SHEET_CELL)


def build_file_paths(sheet, reproject_px=FILE_SUB_PX):
    """The file paths over the sheet at ``sheet``, as build_algebra_paths
    gives them, both Smooth(RasterFileSource(sheet), 3) (a 6 px margin, sigma 2 px):

    - file-read: the whole sheet at its native grid (500 tiles, read
      window by window), the crop straddling the nodata block's corner;
    - file-reproject: a reproject_px^2 sub-area requested in EPSG:3857
      (its densified extent and cross-CRS windows).
    """
    from dask_geomodeling_tpu_torch.geo import Extent
    from dask_geomodeling_tpu_torch.raster import RasterFileSource, Smooth

    source = RasterFileSource(sheet)
    view = Smooth(source, 3)
    request = sheet_request(source)
    x1, _, _, y2 = request["bbox"]
    row, col = sheet_block_at(request["width"], request["height"])
    sub = Extent(sheet_sub_area(request, reproject_px), "EPSG:28992").transformed("EPSG:3857").bbox
    reproject = dict(request, projection="EPSG:3857", bbox=sub, width=reproject_px,
                     height=reproject_px)
    return {
        "file-read": (view, request, "nearest",
                      (x1 + (col - 32) * SHEET_CELL, y2 - (row - 32) * SHEET_CELL)),
        "file-reproject": (view, reproject, "nearest", (sub[0], sub[3])),
    }


#: the building-heights path: synthetic BAG-like building footprints
#: ("panden") over the sheet at a Dutch suburban density, 640 a km^2
#: (20,000 over the sheet's 31.25 km^2), one to a grid cell, exported in
#: tiles of 1000 m
BUILDINGS = 20000
BUILDING_TILE = 1000.0
BUILDING_STATUS = ("Pand in gebruik", "Pand in gebruik (niet ingemeten)", "Verbouwing pand")
BUILDING_STATUS_P = (0.93, 0.05, 0.02)


def building_footprint(rng, cx, cy, radius):
    """One footprint around (cx, cy) inside a circle of ``radius``: a
    rectangle or an L-shape of 40-400 m^2 (less where the circle is
    small), aspect up to 1.8, rotated at random, with up to six extra
    vertices on its edges (4-12 vertices, as BAG outlines carry), to the
    millimetre."""
    l_shape = rng.random() < 0.5
    notch = (rng.uniform(0.3, 0.5), rng.uniform(0.3, 0.5)) if l_shape else (0.0, 0.0)
    aspect = rng.uniform(1.0, 1.8)
    # the largest area whose bounding rectangle fits the circle
    fit = (2 * radius) ** 2 * aspect / (1 + aspect**2) * (1 - notch[0] * notch[1])
    area = rng.uniform(min(40.0, 0.5 * fit), min(400.0, fit))
    rect = area / (1 - notch[0] * notch[1])
    w = np.sqrt(rect * aspect)
    h = rect / w
    nw, nh = notch[0] * w, notch[1] * h
    if l_shape:
        ring = [(0, 0), (w, 0), (w, h - nh), (w - nw, h - nh), (w - nw, h), (0, h)]
    else:
        ring = [(0, 0), (w, 0), (w, h), (0, h)]
    for _ in range(rng.integers(0, 12 - len(ring) + 1) if len(ring) < 12 else 0):
        k = int(rng.integers(len(ring)))
        (x0, y0), (x1, y1) = ring[k], ring[(k + 1) % len(ring)]
        t = rng.uniform(0.2, 0.8)
        ring.insert(k + 1, (x0 + t * (x1 - x0), y0 + t * (y1 - y0)))
    pts = np.array(ring) - (w / 2, h / 2)
    angle = rng.uniform(0, np.pi)
    rot = np.array([[np.cos(angle), -np.sin(angle)], [np.sin(angle), np.cos(angle)]])
    return np.round(pts @ rot.T + (cx, cy), 3)


def building_frame(bbox, count=BUILDINGS, seed=13):
    """``count`` synthetic building footprints over ``bbox`` (EPSG:28992)
    as a frame: one building to a cell of a near-square grid over the
    bbox, each inside the circle of its cell (none overlap), with a
    16-digit ``identificatie``, an integer ``bouwjaar`` and a ``status``;
    fids 1..count."""
    from dask_geomodeling_tpu_torch.geo.features import GeoDataFrame, Index
    from dask_geomodeling_tpu_torch.geo.geometry import Polygon

    rng = np.random.default_rng(seed)
    x1, y1, x2, y2 = bbox
    ny = max(1, int(round(np.sqrt(count * (y2 - y1) / (x2 - x1)))))
    nx = -(-count // ny)
    cw, ch = (x2 - x1) / nx, (y2 - y1) / ny
    radius = min(cw, ch) / 2 * 0.95
    polygons = []
    for k in range(count):
        row, col = divmod(k, nx)
        polygons.append(Polygon(building_footprint(
            rng, x1 + (col + 0.5) * cw, y2 - (row + 0.5) * ch, radius)))
    return GeoDataFrame({
        "identificatie": ["0599100000%06d" % (k + 1) for k in range(count)],
        "bouwjaar": rng.integers(1850, 2024, size=count),
        "status": list(rng.choice(BUILDING_STATUS, size=count, p=BUILDING_STATUS_P)),
    }, geometry=polygons, crs="EPSG:28992", index=Index(np.arange(1, count + 1), name="fid"))


def write_buildings(folder, bbox, count=BUILDINGS, seed=13):
    """Write building_frame(bbox, count, seed) into
    ``folder``/buildings.gpkg, layer "pand", with its gpkg_rtree_index.
    Returns the path."""
    from dask_geomodeling_tpu_torch.io.vectorfile import write_vector

    path = os.path.join(folder, "buildings.gpkg")
    write_vector(building_frame(bbox, count, seed), path, layer="pand")
    return path


def build_buildings_view(buildings, sheet):
    """The building-heights view: per building the mean and 90th
    percentile of the smoothed elevation sheet (rounded mean), their
    difference classified into relief classes, and the area."""
    from dask_geomodeling_tpu_torch.geometry import (
        AggregateRaster,
        Area,
        Classify,
        GeometryFileSource,
        Round,
    )
    from dask_geomodeling_tpu_torch.raster import RasterFileSource, Smooth

    source = GeometryFileSource(buildings, layer="pand")
    dem = Smooth(RasterFileSource(sheet), 3)
    mean = AggregateRaster(source, dem, "mean")["agg"]
    p90 = AggregateRaster(source, dem, "p90")["agg"]
    return source.set(
        "h_mean", Round(mean, 2),
        "h_p90", p90,
        "relief", Classify(p90 - mean, [0.25, 1.0], ["flat", "sloped", "steep"]),
        "area", Area(source, "EPSG:28992"),
    )


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


def tile_cells(index, nx, width, height, tile):
    """((row slice, col slice) in the assembled output, (the same in the
    tile)) of tile ``index``'s cells inside the request: an edge tile
    reaches past the request's top and right edges."""
    j, i = divmod(index, nx)
    vw, vh = min(tile, width - i * tile), min(tile, height - j * tile)
    row_end = height - j * tile
    return ((slice(row_end - vh, row_end), slice(i * tile, i * tile + vw)),
            (slice(tile - vh, tile), slice(0, vw)))


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


def check_gaussian(device, headline_sigma, stencils_sigma, file_sigma):
    """Phase 3a; returns the kernel records' numbers at the headline
    path's (64, 516, 516), the stencils path's (64, 524, 524) and the
    file-read path's (64, 524, 524; radius 8)."""
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
    # the file-read path's planes: 512^2 tiles and Smooth's margin of
    # 3 sigma on each side, elevations of a few metres
    margin = int(round(3 * file_sigma[0]))
    file_planes = torch.from_numpy(
        (rng.rand(BATCH, TILE + 2 * margin, TILE + 2 * margin) * 8).astype(np.float32)
    ).to(device)
    max_abs_err = {}
    for label, data, (sy, sx) in [
        ("headline", planes, headline_sigma),
        ("stencils", stencil_planes, stencils_sigma),
        ("file-read", file_planes, file_sigma),
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
        max_abs_err[label] = err
    host_plane = planes[0].cpu().numpy()
    scipy_plane = ndimage.gaussian_filter(host_plane, headline_sigma, mode="constant", cval=0)
    kernel_plane = cuda_stencils.gaussian_blur(planes[:1].contiguous(), *headline_sigma, 0)
    check(np.array_equal(kernel_plane[0].cpu().numpy(), scipy_plane),
          "gaussian_blur differs from scipy.ndimage.gaussian_filter")
    print("kernel check: gaussian_blur, one plane bitwise equal to scipy.ndimage.gaussian_filter")
    # the integer frames' entry (float64 storage truncated toward zero):
    # each integer width, fused and two-pass radii, values beyond 2**53
    integer_planes = torch.from_numpy(
        rng.randint(0, 256, size=(BATCH, TILE + 12, TILE + 12)).astype(np.uint8)).to(device)
    for dtype, low, high in [(np.uint8, 0, 255), (np.int8, -128, 127), (np.int16, -30000, 30000),
                             (np.uint16, 0, 65535), (np.int32, -2**31, 2**31 - 1),
                             (np.uint32, 0, 2**32 - 1), (np.int64, -2**62, 2**62),
                             (np.uint64, 0, 2**63)]:
        data = torch.from_numpy(rng.randint(low, high, size=(4, 131, 75), dtype=dtype)).to(device)
        for sy, sx in [(5 / 3, 5 / 3), (0.759, 0.760), (1.5, 0.1), (10.0, 10.0)]:
            before = cuda_stencils.launches
            got = cuda_stencils.gaussian_blur(data, sy, sx, 3)
            want = gaussian_blur_reference(data, sy, sx, 3)
            torch.cuda.synchronize()
            check(cuda_stencils.launches > before and got.dtype == data.dtype and
                  torch.equal(got, want), "gaussian_blur's integer entry differs from its plain "
                  "version (%s, sigma %s)" % (np.dtype(dtype).name, (sy, sx)))
    got = cuda_stencils.gaussian_blur(integer_planes, *stencils_sigma, 0)
    want = gaussian_blur_reference(integer_planes, *stencils_sigma, 0)
    equal = torch.equal(got, want)
    label = "integer storage (uint8)"
    max_abs_err[label] = float((got.double() - want.double()).abs().max())
    print("kernel check: gaussian_blur integer storage (truncated between the passes) on "
          "int8-int64 and uint8-uint64 (4, 131, 75) at radii 3, 7 and 40 and a radius of 0, and "
          "uint8 %s at the stencils path's sigma: equal=%s max_abs_err=%r"
          % (tuple(integer_planes.shape), equal, max_abs_err[label]))
    check(equal, "gaussian_blur's integer entry differs from its plain version (uint8)")
    del got, want
    return [dict(time_gaussian(data, sigma), max_abs_err=max_abs_err[path], path=path)
            for path, data, sigma in [("headline", planes, headline_sigma),
                                      ("stencils", stencil_planes, stencils_sigma),
                                      ("file-read", file_planes, file_sigma),
                                      ("integer storage (uint8)", integer_planes,
                                       stencils_sigma)]]


def time_gaussian(planes, sigma):
    """The kernel, its plain version and the library yardstick on
    ``planes`` (CUDA events), and the bound.  The yardstick is one cuDNN
    convolution with the (2r+1)^2 outer-product weights in full float32
    (not bitwise: it sums in another order; an integer batch is convolved
    as its float32 copy).  The bytes are the input read and the output
    written once in the planes' dtype."""
    import torch
    import torch.nn.functional as F

    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.ops.stencils import gaussian_blur_reference, gaussian_weights

    (wy, ry), (wx, rx) = gaussian_weights(sigma[0]), gaussian_weights(sigma[1])
    weights = torch.from_numpy(np.outer(wy, wx).astype(np.float32)).to(planes.device)[None, None]
    images = planes[:, None].float()  # an integer batch: its float32 copy
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


def check_algebra_path(label, device, view, request, interpolation, corner, host_nodes=0,
                       share=0.0, sigma_groups=False):
    """One raster-algebra, temporal, tiled geometry or file path at full
    size; returns (host Mpx/s, the evaluate_tiled values).  Every node that returns pixels runs on the
    card but ``host_nodes`` per tile (Rasterize's, which has no twin): the
    time subrequests of a Group or a temporal block, which return none, run
    on the host while planning; the tiles run in as many batches as a
    MemorySource's would (more where a cross-CRS Smooth's sigma differs
    between tile rows, ``sigma_groups``), the Gaussian launched once per
    batch; a 64^2 corner and 16 sampled tiles are held to compute_host:
    bitwise (at most ``share`` of the cells differing, the headline's rule
    for a cross-CRS nearest warp), or for the cross-CRS bilinear path
    within BILINEAR_ATOL with at most BILINEAR_FILL_SHARE of the cells
    nodata in one and data in the other."""
    from dask_geomodeling_tpu_torch import evaluate_tiled, get_data
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.runtime import executor
    from dask_geomodeling_tpu_torch.runtime import tiles as tile_runtime
    from dask_geomodeling_tpu_torch.runtime.tiles import TileProgram, tile_requests

    exact = interpolation == "nearest"
    tiles, nx = tile_requests(request, TILE)
    width, height = request["width"], request["height"]
    with interpolation_set(interpolation):
        program = TileProgram(view, tiles[0], device)
        host_runs = executor.host_node_runs
        batches = tile_runtime.batches_run
        gaussians = cuda_stencils.launches
        t0 = time.perf_counter()
        result = evaluate_tiled(view, request, tile_size=TILE, batch=BATCH, device=device)
        first_s = time.perf_counter() - t0
        batches = tile_runtime.batches_run - batches
        gaussians = cuda_stencils.launches - gaussians
        values = result["values"]
        check(executor.host_node_runs - host_runs == host_nodes * len(tiles),
              "%s: a node ran on the host" % label)
        host_runs = executor.host_node_runs
        check(values.shape[1:] == (height, width), "%s: output shape" % label)
        data_share = float((values != result["no_data_value"]).mean())
        print("%s path: evaluate_tiled %s %s in %.2f s (first run), %d tiles in %d batches; %d "
              "device nodes, %d host nodes; data in %.4f of the cells"
              % (label, values.shape, values.dtype, first_s, len(tiles), batches,
                 program.on_host.count(False), program.on_host.count(True), data_share))
        check(batches == -(-len(tiles) // BATCH) or (sigma_groups and batches <= len(tiles) // 8),
              "%s: tiles split into more batches" % label)
        check(gaussians in (0, batches), "%s: %d Gaussian launches for %d batches"
              % (label, gaussians, batches))
        check(data_share > 0.01, "%s: output is all nodata" % label)

        routed = get_data(view, device=device, **request)
        check(np.array_equal(routed["values"], values), "%s: get_data differs from evaluate_tiled" % label)
        x1, y1, x2, y2 = request["bbox"]
        cx, cy = corner
        crop = dict(request, width=64, height=64, bbox=(
            cx, cy - (y2 - y1) * 64 / height, cx + (x2 - x1) * 64 / width, cy))
        host_runs = executor.host_node_runs
        card_crop = get_data(view, device=device, **crop)["values"]
        check(executor.host_node_runs - host_runs == host_nodes,
              "%s: a node ran on the host" % label)
        crop_cells = compare_cells(card_crop, host_values(view, crop), result["no_data_value"])

        sampled = list(range(0, len(tiles), len(tiles) // 16))[:16]
        t0 = time.perf_counter()
        host_tiles = [host_values(view, tiles[k]) for k in sampled]
        host_s = time.perf_counter() - t0
    differing, worst, fill_mismatch, filled, n_cells = 0, 0.0, 0, 0, 0
    for k, host_tile in zip(sampled, host_tiles):
        (rows, cols), (host_rows, host_cols) = tile_cells(k, nx, width, height, TILE)
        host_tile = host_tile[:, host_rows, host_cols]
        d, w, f = compare_cells(values[:, rows, cols], host_tile, result["no_data_value"])
        differing, worst, fill_mismatch = differing + d, max(worst, w), fill_mismatch + f
        filled += int(np.count_nonzero(host_tile == result["no_data_value"]))
        n_cells += host_tile.size
    print("%s path: 64^2 corner: %d of %d cells differ from compute_host (largest %r, %d "
          "cells nodata on the card); %d tiles: %d of %d cells differ (share %r), largest "
          "difference %r, %d cells nodata in one only, nodata in %r of compute_host's cells"
          % (label, crop_cells[0], card_crop.size, crop_cells[1],
             np.count_nonzero(card_crop == result["no_data_value"]), len(sampled), differing,
             n_cells, differing / n_cells, worst, fill_mismatch, filled / n_cells))
    if exact:
        check(crop_cells[0] <= share * card_crop.size,
              "%s: 64^2 corner differs from compute_host" % label)
        check(differing <= share * n_cells, "%s: sampled tiles differ from compute_host" % label)
    else:
        check(max(worst, crop_cells[1]) <= BILINEAR_ATOL, "%s: difference above %g" % (label, BILINEAR_ATOL))
        check(fill_mismatch / n_cells <= BILINEAR_FILL_SHARE
              and crop_cells[2] / card_crop.size <= BILINEAR_FILL_SHARE,
              "%s: nodata cells differ in more than %g" % (label, BILINEAR_FILL_SHARE))
    # request pixels, all bands of one counted once, as the port's Mpx/s counts them
    return len(sampled) * TILE * TILE / 1e6 / host_s, values


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


def border_band(length, tile, export_tile, reach):
    """Cells of one axis (counted from the request's south-west corner)
    within ``reach`` of a ``tile`` border that is not an ``export_tile``
    border: where a Smooth tile of one grid sees the constant fill past its
    margin and a tile of the other sees data."""
    band = np.zeros(length, bool)
    for edge in range(tile, length, tile):
        if edge % export_tile:
            band[max(0, edge - reach) : edge + reach] = True
    return band


def check_file_export(card, device, view, request, folder, read_values):
    """The file-export phase: to_file of the file-read view over the whole
    sheet in EXPORT_TILE tiles, its mosaic read back, two tile files
    against compute_host, and to_cog of a FILE_SUB_PX^2 sub-area read at
    overview level 2; returns the numbers."""
    from dask_geomodeling_tpu_torch import get_data
    from dask_geomodeling_tpu_torch.config import config
    from dask_geomodeling_tpu_torch.core.tokens import tokenize
    from dask_geomodeling_tpu_torch.io.geotiff import read_geotiff, read_geotiff_overviews
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.ops.stencils import gaussian_weights
    from dask_geomodeling_tpu_torch.raster import RasterFileSource, RasterTiler, to_cog
    from dask_geomodeling_tpu_torch.runtime import executor
    from dask_geomodeling_tpu_torch.runtime import tiles as tile_runtime

    width, height = request["width"], request["height"]
    x1, y1, _, y2 = request["bbox"]
    target = os.path.join(folder, "export", "out.vrt")
    tiles_dir = os.path.join(folder, "export", "tiles")
    subrequests = [r for _, _, r in RasterTiler(view, EXPORT_TILE)._plan_tiles(request)]
    host_runs = executor.host_node_runs
    cuda_stencils.reset_launches()
    # one profiled run: the profiler's cost is small beside the export's
    # host work (35 subrequests, a few kernels each)
    export_s, busy_ms = device_busy_ms(
        lambda: view.to_file(target, tile_size=EXPORT_TILE, device=device))
    idle = None if busy_ms is None else 1 - busy_ms / 1e3 / export_s
    launches = {"gaussian_blur": cuda_stencils.launches,
                "moving_max": cuda_stencils.moving_max_launches}
    names = sorted(os.listdir(tiles_dir))
    print("file-export: to_file %dx%d in %d^2 tiles (%d subrequests through compute_torch, no "
          "tile batches): %d files, %d Gaussian launches, %.3f s, %.3f Mpx/s, device busy %s, "
          "idle share %s [%s]" % (
              width, height, EXPORT_TILE, len(subrequests), len(names), launches["gaussian_blur"],
              export_s, width * height / 1e6 / export_s,
              "not measured" if busy_ms is None else "%.3f ms" % busy_ms,
              "not measured" if idle is None else "%.4f" % idle, card))
    check(len(names) == len(subrequests), "file-export: one file per subrequest")
    check(launches["gaussian_blur"] == len(subrequests),
          "file-export: one Gaussian launch per subrequest")
    check(executor.host_node_runs == host_runs, "file-export: a node returning pixels ran on "
          "the host")  # the sinks return None

    # the mosaic, read back window by window through RasterFileSource
    mosaic_source = RasterFileSource(target)
    check(mosaic_source._file_read_plan(request) is not None, "file-export: the VRT read is "
          "not windowed")
    before = tile_runtime.batches_run
    t0 = time.perf_counter()
    mosaic = get_data(mosaic_source, device=device, **request)["values"]
    read_s = time.perf_counter() - t0
    batches = tile_runtime.batches_run - before
    n_tiles = len(tile_runtime.tile_requests(request, TILE)[0])
    check(batches == -(-n_tiles // BATCH), "file-export: the mosaic read ran %d batches" % batches)
    written = np.full_like(mosaic, SHEET_NODATA)
    for name in names:
        data = read_geotiff(os.path.join(tiles_dir, name))
        col = int(round((data.geo_transform[0] - x1) / SHEET_CELL))
        row = int(round((y2 - data.geo_transform[3]) / SHEET_CELL))
        written[:, row : row + data.array.shape[1], col : col + data.array.shape[2]] = data.array
    check(np.array_equal(mosaic, written), "file-export: the mosaic differs from its files")
    # against the file-read run: equal but where a 512^2 tile of that run
    # saw the constant fill past Smooth's margin and a 2048^2 one data
    sigma = smooth_sigma(view, tile_runtime.tile_requests(request, TILE)[0][0])[0]
    reach = max(0, gaussian_weights(sigma)[1] - int(round(3 * sigma)))
    band = (border_band(height, TILE, EXPORT_TILE, reach)[::-1][:, None]
            | border_band(width, TILE, EXPORT_TILE, reach)[None, :])
    differ = mosaic[0] != read_values[0]
    print("file-export: mosaic read back in %d batches, %.3f s, equal to the written files; "
          "against file-read: %d cells differ, all within %d px of a 512^2 tile border "
          "(%d cells there): %s" % (batches, read_s, int(differ.sum()), reach, int(band.sum()),
                                    not (differ & ~band).any()))
    check(not (differ & ~band).any(), "file-export: the mosaic differs from file-read away "
          "from the tile borders")
    host_s, host_px = 0.0, 0
    for sub in (subrequests[0], subrequests[len(subrequests) // 2]):
        data = read_geotiff(os.path.join(tiles_dir, tokenize(sub)[:7] + ".tif"))
        t0 = time.perf_counter()
        host = host_values(view, sub)
        host_s += time.perf_counter() - t0
        host_px += host.size
        check(np.array_equal(data.array, host), "file-export: a tile file differs from "
              "compute_host")
    print("file-export: two tile files bitwise equal to compute_host of their subrequests "
          "(numpy host %.3f Mpx/s) [%s]" % (host_px / 1e6 / host_s, card))

    # to_cog of a sub-area on the file-read tile grid, read at overview level 2
    sub = sheet_sub_area(request, FILE_SUB_PX)
    cog = os.path.join(folder, "sub.cog.tif")
    cuda_stencils.reset_launches()
    t0 = time.perf_counter()
    to_cog(view, cog, overviews=COG_OVERVIEWS, bbox=sub, width=FILE_SUB_PX, height=FILE_SUB_PX,
           projection="EPSG:28992", device=device)
    cog_s = time.perf_counter() - t0
    launches["gaussian_blur"] += cuda_stencils.launches
    row = int(round((y2 - sub[3]) / SHEET_CELL))
    col = int(round((sub[0] - x1) / SHEET_CELL))
    check(np.array_equal(read_geotiff(cog).array, read_values[:, row : row + FILE_SUB_PX,
                                                              col : col + FILE_SUB_PX]),
          "file-export: the COG differs from file-read")
    check(read_geotiff_overviews(cog) == [(FILE_SUB_PX // f, FILE_SUB_PX // f)
                                          for f in COG_OVERVIEWS], "file-export: COG overviews")
    coarse = dict(mode="vals", bbox=sub, projection="EPSG:28992", width=FILE_SUB_PX // 4,
                  height=FILE_SUB_PX // 4)
    cog_source = RasterFileSource(cog)
    with config.set({"geomodeling.use-overviews": True}):
        level = cog_source._file_read_plan(coarse)[0]
        card_coarse = cog_source.get_data(device=device, **coarse)["values"]
        check(level == 2 and np.array_equal(card_coarse, host_values(cog_source, coarse)),
              "file-export: the overview read")
    print("file-export: to_cog %d^2 with overviews %s in %.3f s (%.3f Mpx/s) [%s], level 0 "
          "bitwise equal to file-read; a %d^2 request read overview level %d, bitwise equal to "
          "compute_host" % (FILE_SUB_PX, COG_OVERVIEWS, cog_s, FILE_SUB_PX**2 / 1e6 / cog_s, card,
                            FILE_SUB_PX // 4, level))
    return launches, dict(export_s=export_s, export_mpx_per_s=width * height / 1e6 / export_s,
                          device_busy_ms=busy_ms, idle_share=idle,
                          host_mpx_per_s=host_px / 1e6 / host_s, files=len(names),
                          mosaic_read_s=read_s, mosaic_batches=batches, cog_s=cog_s,
                          border_cells_differing=int(differ.sum()))


class PhaseClock:
    """Seconds spent inside chosen functions while it is installed: each
    (owner, attribute) is replaced by a wrapper that adds its wall time
    to its phase (a call nested in a call of the same phase counts once).
    It never synchronises the card: a phase whose result reaches the host
    waits for the card there, as it does without the clock."""

    def __init__(self, patches):
        self.patches = patches
        self.seconds = {phase: 0.0 for _, _, phase in patches}
        self.calls = {phase: 0 for _, _, phase in patches}
        self._depth = {phase: 0 for _, _, phase in patches}
        self._saved = []

    def _wrap(self, func, phase):
        import functools

        @functools.wraps(func)
        def timed(*args, **kwargs):
            self._depth[phase] += 1
            t0 = time.perf_counter()
            try:
                return func(*args, **kwargs)
            finally:
                self._depth[phase] -= 1
                if self._depth[phase] == 0:
                    self.seconds[phase] += time.perf_counter() - t0
                    self.calls[phase] += 1

        return timed

    def __enter__(self):
        for owner, attribute, phase in self.patches:
            raw = owner.__dict__[attribute] if isinstance(owner, type) else getattr(owner, attribute)
            self._saved.append((owner, attribute, raw))
            if isinstance(raw, staticmethod):
                setattr(owner, attribute, staticmethod(self._wrap(raw.__func__, phase)))
            else:
                setattr(owner, attribute, self._wrap(raw, phase))
        return self

    def __exit__(self, *exc):
        for owner, attribute, raw in reversed(self._saved):
            setattr(owner, attribute, raw)
        self._saved = []
        return False


def export_clock():
    """A PhaseClock over the phases of a geometry export: the vector file
    reads (whole-file parses and R-tree reads, cache hits included), the
    raster window reads, the compute_torch run, AggregateRaster's device
    plane (label planes and statistics, ending in their copy to the
    host), the sinks' writes and the merge.  Planning is the export's time outside the run and the
    merge; it holds the extent requests and the raster window reads."""
    from dask_geomodeling_tpu_torch.geometry import aggregate
    from dask_geomodeling_tpu_torch.geometry.sinks import GeometryFileSink
    from dask_geomodeling_tpu_torch.io import vectorfile
    from dask_geomodeling_tpu_torch.runtime import executor, pipeline

    return PhaseClock([
        (pipeline, "read_vector_cached", "vector read"),
        (vectorfile, "_read_gpkg", "vector read"),
        (pipeline, "read_geotiff_window_cached", "raster reads"),
        (pipeline, "read_geotiff_cached", "raster reads"),
        (executor, "compute_torch", "run"),
        (aggregate, "_aggregate_on_device", "device plane"),
        (GeometryFileSink, "process", "sink writes"),
        (GeometryFileSink, "merge_files", "merge"),
    ])


def frame_rows(frame):
    """{fid: {column: cell}} of a frame read back from a file, the
    geometry as WKB."""
    rows = {}
    for fid, row in frame.iterrows():
        rows[fid] = {k: (v.wkb if k == "geometry" and v is not None else v)
                     for k, v in row.items()}
    return rows


def compare_heights(label, port_rows, host_rows, mean_ulps=None, rounded=("h_mean",)):
    """The export's rows against the host's: the same fids, every column
    bitwise but the ``rounded`` ones (rounded means, and what is derived
    from them), where a row may differ only if its unrounded means are
    within one float32 ulp (``mean_ulps(fids)`` gives them); returns the
    differing rows' fids."""
    check(sorted(port_rows) == sorted(host_rows), "%s: the fids differ from the host's" % label)
    differ = []
    for fid, host in host_rows.items():
        port = port_rows[fid]
        check(sorted(port) == sorted(host), "%s: the columns differ" % label)
        for column, value in host.items():
            if repr(port[column]) == repr(value):
                continue
            check(column in rounded, "%s: fid %s %s %r differs from the host's %r"
                  % (label, fid, column, port[column], value))
            if fid not in differ:
                differ.append(fid)
    if differ:
        ulps = mean_ulps(differ)
        check(max(ulps) <= 1, "%s: a mean of %d rows differs by more than one float32 ulp "
              "before rounding" % (label, len(differ)))
    return differ


def mean_ulps(mean_views, request, device):
    """``ulps(fids)``: the float32 ulps between the card's and the host's
    unrounded means of ``fids``, over each AggregateRaster of
    ``mean_views`` that holds the fid, on ``request``."""
    from dask_geomodeling_tpu_torch import compute_host

    def ulps(fids):
        means = [(mean_view.get_data(device=device, **request)["features"],
                  compute_host(*mean_view.get_compute_graph(**request))["features"])
                 for mean_view in mean_views]
        out = []
        for fid in fids:
            found = False
            for card_mean, host_mean in means:
                at = card_mean.index.values == fid
                host_at = host_mean.index.values == fid
                check(at.any() == host_at.any(), "fid %s has a mean on one of the card and the "
                      "host only" % fid)
                if at.any():
                    found = True
                    a = np.float32(card_mean["agg"].values[at][0])
                    b = np.float32(host_mean["agg"].values[host_at][0])
                    out.append(abs(int(a.view(np.int32)) - int(b.view(np.int32))))
            check(found, "fid %s differs from the host's, and no mean holds it" % fid)
        return out
    return ulps


def geojson_equal(ours, theirs, differ, rounded):
    """Whether the GeoJSON file ``ours`` is byte-identical to ``theirs``
    once the ``rounded`` properties of the features ``differ`` (the rows
    compare_heights found within one ulp) take their values from
    ``theirs``: every other byte must be the same."""
    with open(theirs, "rb") as f:
        host_bytes = f.read()
    with open(ours, "rb") as f:
        port_bytes = f.read()
    if not differ:
        return port_bytes == host_bytes
    ids = {fid.item() if hasattr(fid, "item") else fid for fid in differ}
    host = {feature["id"]: feature for feature in json.loads(host_bytes)["features"]}
    port = json.loads(port_bytes)
    for feature in port["features"]:
        if feature["id"] in ids:
            for column in rounded:
                feature["properties"][column] = host[feature["id"]]["properties"][column]
    return json.dumps(port).encode() == host_bytes


def check_buildings(card, device, folder, sheet, count=BUILDINGS, tile=BUILDING_TILE,
                    sub_size=BUILDING_TILE):
    """The building-heights phase: per-building height statistics of the
    smoothed sheet, exported in tiles to a GeoPackage (to_file), checked
    against compute_host and repeated through the GeoPackage's R-tree;
    a sub-area exported untiled as GeoJSON and as a Shapefile against the
    host's export of it.  The first export is timed under the phase
    clock alone; the device busy time and idle share come from the R-tree
    export, run under torch.profiler.  Returns ({kernel: launches of the
    first export}, the numbers)."""
    import torch

    from dask_geomodeling_tpu_torch import compute_host
    from dask_geomodeling_tpu_torch.config import config
    from dask_geomodeling_tpu_torch.core.tokens import tokenize
    from dask_geomodeling_tpu_torch.geo.geometry import box
    from dask_geomodeling_tpu_torch.geometry import GeometryFileSink, GeometryTiler
    from dask_geomodeling_tpu_torch.geometry.sinks import to_file
    from dask_geomodeling_tpu_torch.io import vectorfile
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.raster import RasterFileSource
    from dask_geomodeling_tpu_torch.runtime import pipeline

    started = time.perf_counter()
    sheet_bbox = RasterFileSource(sheet).footprint.bbox
    t0 = time.perf_counter()
    buildings = write_buildings(folder, sheet_bbox, count)
    write_s = time.perf_counter() - t0
    size = os.path.getsize(buildings)
    check(vectorfile.gpkg_rtree_name(buildings, "pand") == "rtree_pand_geom",
          "building-heights: the GeoPackage has no R-tree index")
    print("building-heights: %d footprints written to a GeoPackage (layer pand, EPSG:28992, "
          "with its gpkg_rtree_index) in %.2f s, %d bytes" % (count, write_s, size))
    view = build_buildings_view(buildings, sheet)
    source = view.args[0]
    mean_view = view.args[2].args[0].source  # Round(mean) -> GetSeriesBlock -> AggregateRaster
    projection = "EPSG:28992"
    pipeline.clear_read_cache()

    def synchronize():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    def export(target, profiled):
        def run():
            to_file(view, target, tile_size=tile, projection=projection, mode="centroid",
                    device=device)

        cuda_stencils.reset_launches()
        with export_clock() as clock:
            if profiled:
                seconds, busy = device_busy_ms(run)
            else:
                synchronize()
                t0 = time.perf_counter()
                run()
                synchronize()
                seconds, busy = time.perf_counter() - t0, None
        launches = {"gaussian_blur": cuda_stencils.launches,
                    "moving_max": cuda_stencils.moving_max_launches}
        return seconds, busy, launches, clock

    target = os.path.join(folder, "heights.gpkg")
    export_s, _, launches, clock = export(target, profiled=False)
    extent = source.get_data(mode="extent", projection=projection)["extent"]
    pieces = GeometryTiler(source, tile, projection).get_sources_and_requests(
        mode="centroid", geometry=box(*extent), projection=projection)
    subrequests = [request for _, request in pieces]
    merged = vectorfile.read_vector(target)
    phases = dict(clock.seconds)
    phases["planning"] = export_s - phases["run"] - phases["merge"]
    print("building-heights: to_file of %d buildings in %d tiles of %g m: %.3f s, %.1f "
          "buildings/s, %d in the merged file [%s]" % (
              count, len(subrequests), tile, export_s, count / export_s, len(merged), card))
    print("building-heights: phases (s; planning holds the extent requests and the raster "
          "window reads, the run holds the device plane and the sink writes; vector reads "
          "fall in both; %d timed calls): %s" % (
              sum(clock.calls.values()), json.dumps({k: round(v, 4) for k, v in phases.items()})))
    print("building-heights: %d Gaussian launches in one export: one per tile subrequest "
          "(%d), the mean's and the p90's AggregateRaster asking their tile's raster alike, "
          "so the two share one Smooth node; %d moving-max launches"
          % (launches["gaussian_blur"], len(subrequests), launches["moving_max"]))
    check(launches["gaussian_blur"] == len(subrequests),
          "building-heights: %d Gaussian launches for %d tiles"
          % (launches["gaussian_blur"], len(subrequests)))

    # every building whose centroid lies strictly inside a tile, each once
    everything = vectorfile.read_vector(buildings, layer="pand")
    centroids = np.array([g.centroid.coords[0] for g in everything.geometry.values])
    inside = np.zeros(len(centroids), bool)
    for request in subrequests:
        x1, y1, x2, y2 = request["geometry"].bounds
        inside |= ((centroids[:, 0] > x1) & (centroids[:, 0] < x2)
                   & (centroids[:, 1] > y1) & (centroids[:, 1] < y2))
    fids = merged.index.values.tolist()
    check(len(fids) == len(set(fids)), "building-heights: a fid is in the merged file twice")
    check(sorted(fids) == sorted(everything.index.values[inside].tolist()),
          "building-heights: the merged file does not hold every building whose centroid "
          "lies strictly inside a tile")
    names = {"identificatie", "bouwjaar", "status", "h_mean", "h_p90", "relief", "area",
             "geometry"}
    check(set(merged.columns) == names, "building-heights: the fields are %s"
          % sorted(merged.columns))
    print("building-heights: the merged file holds all %d buildings whose centroid lies "
          "strictly inside a tile (of %d), each fid once, fields %s"
          % (len(fids), count, sorted(names - {"geometry"})))

    # two tiles against compute_host: the host's partial file of the same
    # subrequest against the export's rows of those fids
    host_s = 0.0
    merged_rows = frame_rows(merged)
    host_dir = os.path.join(folder, "host_partials")
    differing = 0
    for request in (subrequests[0], subrequests[len(subrequests) // 2]):
        sink = GeometryFileSink(view, host_dir, extension="gpkg")
        t0 = time.perf_counter()
        compute_host(*sink.get_compute_graph(**request))
        host_s += time.perf_counter() - t0
        host_rows = frame_rows(vectorfile.read_vector(
            os.path.join(host_dir, tokenize(request)[:7] + ".gpkg")))
        differing += len(compare_heights(
            "building-heights tile", {fid: merged_rows[fid] for fid in host_rows if
                                      fid in merged_rows}, host_rows, mean_ulps([mean_view], request, device)))
    print("building-heights: two tiles' rows equal compute_host of their subrequests: "
          "geometry, area, h_p90 and relief bitwise, h_mean differing in %d rows (within one "
          "float32 ulp before rounding) [%s]" % (differing, card))

    # again through the GeoPackage's R-tree
    # 1 MiB, below the 16 MiB default and the file (a smaller file: half its size)
    limit = min(1024 * 1024, size // 2)
    with config.set({"geomodeling.vector-windowed-read-limit": limit}):
        pipeline.clear_read_cache()
        rtree_target = os.path.join(folder, "heights_rtree.gpkg")
        rtree_s, busy_ms, rtree_launches, rtree_clock = export(rtree_target, profiled=True)
    idle = None if busy_ms is None else 1 - busy_ms / 1e3 / rtree_s
    rtree_rows = frame_rows(vectorfile.read_vector(rtree_target))
    check(sorted(rtree_rows) == sorted(merged_rows), "building-heights: the R-tree export "
          "holds other features")
    rounding = 0
    for fid, row in merged_rows.items():
        for column, value in row.items():
            if column == "h_mean" and repr(rtree_rows[fid][column]) != repr(value):
                rounding += 1
                check(abs(rtree_rows[fid][column] - value) <= 0.0100001,
                      "building-heights: h_mean of the R-tree export")
            elif column != "h_mean":
                check(repr(rtree_rows[fid][column]) == repr(value),
                      "building-heights: the R-tree export differs in %s" % column)
    check(rtree_clock.calls["vector read"] >= len(subrequests),
          "building-heights: the R-tree export read the file %d times"
          % rtree_clock.calls["vector read"])
    print("building-heights: through the R-tree (geomodeling.vector-windowed-read-limit "
          "%d bytes): %d vector reads, the same %d features, h_mean differing in %d rows; "
          "%.3f s under torch.profiler, %d Gaussian launches; device busy %s, idle share %s "
          "[%s]" % (limit, rtree_clock.calls["vector read"], len(rtree_rows), rounding, rtree_s,
                    rtree_launches["gaussian_blur"],
                    "not measured" if busy_ms is None else "%.3f ms" % busy_ms,
                    "not measured" if idle is None else "%.4f" % idle, card))

    # a sub-area exported untiled as GeoJSON and as a Shapefile
    x1, y1, x2, y2 = extent
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    sub = box(cx - sub_size / 2, cy - sub_size / 2, cx + sub_size / 2, cy + sub_size / 2)
    sub_request = dict(mode="centroid", geometry=sub, projection=projection)
    for ext in ("geojson", "shp"):
        ours = os.path.join(folder, "sub." + ext)
        to_file(view, ours, device=device, **sub_request)
        host_target = os.path.join(folder, "host_sub." + ext)
        sink_dir = os.path.join(folder, "host_sub_" + ext)
        t0 = time.perf_counter()
        compute_host(*GeometryFileSink(view, sink_dir, extension=ext).get_compute_graph(
            **sub_request))
        GeometryFileSink.merge_files(sink_dir, host_target)
        host_s += time.perf_counter() - t0
        port_rows = frame_rows(vectorfile.read_vector(ours))
        differ = compare_heights("building-heights sub-area " + ext, port_rows,
                                 frame_rows(vectorfile.read_vector(host_target)),
                                 mean_ulps([mean_view], sub_request, device))
        if ext == "geojson":
            check(geojson_equal(ours, host_target, differ, ("h_mean",)),
                  "building-heights: the GeoJSON differs from the host's beyond h_mean of "
                  "%d rows" % len(differ))
        print("building-heights: a %g m sub-area exported untiled as %s: %d buildings, equal "
              "to the host's export (h_mean differing in %d rows)"
              % (sub_size, ext, len(port_rows), len(differ)))
    # the Gaussian's plane on this path: the first tile's raster request
    # and Smooth's margin
    raster_request = mean_view.get_sources_and_requests(**subrequests[0])[1][1]
    sigma = smooth_sigma(mean_view.raster, raster_request)
    margin = int(round(3 * sigma[0]))
    plane = (1, raster_request["height"] + 2 * margin, raster_request["width"] + 2 * margin)
    total_s = time.perf_counter() - started
    print("building-heights: host ground truth %.3f s (two tiles and two sub-area exports); "
          "the phase %.1f s; the Gaussian's plane %s at sigma %s [%s]"
          % (host_s, total_s, plane, sigma, card))
    return launches, dict(
        plane=plane, sigma=sigma,
        buildings=count, tiles=len(subrequests), export_s=export_s,
        buildings_per_s=count / export_s, rtree_device_busy_ms=busy_ms, rtree_idle_share=idle,
        phases=phases, rtree_export_s=rtree_s, host_s=host_s, phase_s=total_s,
        h_mean_rows_differing=differing, write_s=write_s, gpkg_bytes=size)


# --- the wms-serving phase ---

#: a slippy-map client's traffic over the sheet: WMS 1.1.1 GetMap,
#: image/png, EPSG:3857, 256^2 tiles, every XYZ tile of these zooms that
#: touches the sheet's EPSG:3857 box, row-major within each zoom
WMS_ZOOMS = (14, 15, 16)
WMS_TILE = 256
WMS_ORIGIN = 20037508.342789244  # half the web Mercator world's width
#: the last zoom is cut to this many of its tile rows, the middle ones
#: (the phase's time budget: all 18 rows took 129.5 s on an NVIDIA H100
#: 80GB HBM3 at 700 W, PERF.md section 4)
WMS_LAST_ZOOM_ROWS = 9
#: wms_serve.main's result cache
WMS_CACHE_BYTES = 256 * 2**20
#: tiles a layer held to compute_host, spread over the zooms
WMS_SAMPLE = 32
WMS_FEATURE_INFO = 16
WMS_THREADS = 4
WMS_CONCURRENT_TILES = 64


def wms_layers(sheet):
    """{name: (view, style, vmin, vmax)}: the layers the phase serves,
    the file-read path's view and a HillShade of the sheet."""
    from dask_geomodeling_tpu_torch.raster import HillShade, RasterFileSource, Smooth

    return {
        "ahn-smooth": (Smooth(RasterFileSource(sheet), 3), "terrain", 0.0, 10.0),
        "ahn-hillshade": (HillShade(RasterFileSource(sheet)), "gray", 0.0, 255.0),
    }


def xyz_tiles(bbox, zooms=WMS_ZOOMS, last_zoom_rows=None):
    """Every XYZ tile (z, x, y) of ``zooms`` that touches ``bbox``
    (EPSG:3857), row-major within each zoom; with ``last_zoom_rows``, only
    that many of the last zoom's rows, the middle ones."""
    tiles = []
    for z in zooms:
        size = 2 * WMS_ORIGIN / 2**z
        x0 = int(np.floor((bbox[0] + WMS_ORIGIN) / size))
        x1 = int(np.ceil((bbox[2] + WMS_ORIGIN) / size))
        y0 = int(np.floor((WMS_ORIGIN - bbox[3]) / size))
        y1 = int(np.ceil((WMS_ORIGIN - bbox[1]) / size))
        if z == zooms[-1] and last_zoom_rows is not None and last_zoom_rows < y1 - y0:
            y0 += (y1 - y0 - last_zoom_rows) // 2
            y1 = y0 + last_zoom_rows
        tiles += [(z, x, y) for y in range(y0, y1) for x in range(x0, x1)]
    return tiles


def xyz_bbox(z, x, y):
    """The EPSG:3857 box of XYZ tile (z, x, y)."""
    size = 2 * WMS_ORIGIN / 2**z
    return (x * size - WMS_ORIGIN, WMS_ORIGIN - (y + 1) * size,
            (x + 1) * size - WMS_ORIGIN, WMS_ORIGIN - y * size)


def getmap_params(layer, style, vmin, vmax, tile):
    """A slippy-map client's GetMap query of ``tile``."""
    return {"SERVICE": "WMS", "VERSION": "1.1.1", "REQUEST": "GetMap", "LAYERS": layer,
            "STYLES": style, "VMIN": repr(vmin), "VMAX": repr(vmax), "FORMAT": "image/png",
            "SRS": "EPSG:3857", "BBOX": "%r,%r,%r,%r" % xyz_bbox(*tile),
            "WIDTH": str(WMS_TILE), "HEIGHT": str(WMS_TILE)}


def tile_request(tile):
    """The get_data request a GetMap of ``tile`` makes."""
    return dict(mode="vals", bbox=xyz_bbox(*tile), height=WMS_TILE, width=WMS_TILE,
                projection="EPSG:3857", start=None)


class WMSClient:
    """The port's wms_app on wsgiref at 127.0.0.1 (a free port), served
    from a background thread; ``get`` asks from the calling thread."""

    def __init__(self):
        from wsgiref.simple_server import WSGIRequestHandler, make_server

        from dask_geomodeling_tpu_torch.ipyleaflet_plugin import wms_app

        class Quiet(WSGIRequestHandler):
            def log_message(self, *args):
                pass

        self.httpd = make_server("127.0.0.1", 0, wms_app, handler_class=Quiet)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.url = "http://127.0.0.1:%d/wms?" % self.httpd.server_address[1]

    def get(self, params):
        """(status, content type, body, seconds) of one GET."""
        import urllib.error
        import urllib.request
        from urllib.parse import urlencode

        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(self.url + urlencode(params), timeout=120) as response:
                body = response.read()
                status, content_type = response.status, response.headers["Content-Type"]
        except urllib.error.HTTPError as e:
            body, status, content_type = e.read(), e.code, e.headers["Content-Type"]
        return status, content_type, body, time.perf_counter() - t0

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)


def latency_numbers(seconds):
    """Tiles, p50, p99 and max ms, and tiles a second, of per-tile seconds."""
    ms = np.asarray(seconds) * 1e3
    p50, p99 = np.percentile(ms, [50, 99])
    return dict(tiles=int(ms.size), p50_ms=float(p50), p99_ms=float(p99), max_ms=float(ms.max()),
                tiles_per_s=float(ms.size / (ms.sum() / 1e3)))


def wms_pass(client, layers, tiles, label, card):
    """One pass over every tile of every layer through HTTP, layer by
    layer; returns ({layer: (PNG bytes per tile, latency numbers)},
    {kernel: its launches in the pass})."""
    from dask_geomodeling_tpu_torch.ops import cuda_stencils

    cuda_stencils.reset_launches()
    out = {}
    for name, (_, style, vmin, vmax) in layers.items():
        bodies, seconds = [], []
        for tile in tiles:
            status, content_type, body, s = client.get(getmap_params(name, style, vmin, vmax, tile))
            check(status == 200 and content_type == "image/png" and body[:4] == b"\x89PNG",
                  "wms-serving %s: %s tile %s answered %s %r" % (label, name, tile, status, body[:200]))
            bodies.append(body)
            seconds.append(s)
        numbers = latency_numbers(seconds)
        out[name] = (bodies, numbers)
        print("wms-serving [%s] %s %s: %d tiles, p50 %.3f ms, p99 %.3f ms, max %.3f ms, "
              "%.1f tiles/s" % (card, label, name, numbers["tiles"], numbers["p50_ms"],
                                numbers["p99_ms"], numbers["max_ms"], numbers["tiles_per_s"]))
    return out, {"gaussian_blur": cuda_stencils.launches,
                  "moving_max": cuda_stencils.moving_max_launches}


def wms_source_reach(view, request, device):
    """The output cells of ``request`` within reach of a cell where the
    view's warped source on the card differs from compute_host's (the
    cross-CRS nearest warp's residual), and the share of source cells that
    differ.  The reach is the view's own: HillShade's 3x3 window, Smooth's
    Gaussian radius; both requests' sources are grown evenly about the
    output."""
    from scipy import ndimage

    from dask_geomodeling_tpu_torch import compute_host, compute_torch
    from dask_geomodeling_tpu_torch.ops.stencils import gaussian_weights

    graph, name = view.get_compute_graph(**request)
    node = graph[name]
    host = compute_host(graph, node[1])["values"][0]
    _kept.clear()
    compute_torch(dict(graph, kept=(_keep_on_device, node[1])), "kept", device=device)
    card = _kept.pop()["values"][0].cpu().numpy()
    differ = card != host
    if host.dtype.kind == "f":
        differ &= ~(np.isnan(card) & np.isnan(host))
    if getattr(node[0], "__name__", "") == "_smooth_process":
        reach = [gaussian_weights(size / 3)[1] for size in node[2]["size"]]
    else:
        reach = [1, 1]
    if differ.any():
        differ = ndimage.binary_dilation(differ, np.ones([2 * r + 1 for r in reach], bool))
    height, width = request["height"], request["width"]
    my, mx = (differ.shape[0] - height) // 2, (differ.shape[1] - width) // 2
    return differ[my:my + height, mx:mx + width], float(np.mean(card != host))


def wms_within_limits(name, port, host, reach):
    """Whether a tile's card values meet the limits of PERF.md section 2
    beside compute_host's: outside the reach of a differing warped source
    cell, ahn-smooth bitwise and ahn-hillshade within 1 in at most 1e-3 of
    the cells; returns (ok, differing cells, differing cells outside the
    reach)."""
    differ, worst, _ = compare_cells(port, host, None)
    differ_mask = port != host
    if host.dtype.kind == "f":
        differ_mask &= ~(np.isnan(port) & np.isnan(host))
    outside = differ_mask & ~reach
    if name == "ahn-hillshade":
        off = np.abs(port.astype(np.int64) - host.astype(np.int64))
        ok = not (outside & (off > 1)).any() and outside.mean() <= STENCILS_SHARE
    else:
        ok = not outside.any()
    return ok, differ, int(np.count_nonzero(outside))


def wms_ground_truth(card, device, layers, tiles, picks, served):
    """The sampled tiles on the card against compute_host, and the served
    PNGs against the host's render of the host's values: at most 5e-4 of
    the warped source cells differ (the cross-CRS nearest warp's limit),
    the values within each view's own limit outside their reach
    (wms_within_limits), and every pixel whose value agrees coloured
    alike.  Each sampled tile is also timed in-process on both sides, the
    same way (no HTTP on either): the card's render_wms_tile of the GetMap
    (its PNG equal to the served one) and the numpy host's planning,
    compute_host, render and PNG encode, the two in turns, which one goes
    first alternating by tile.  Returns {layer: the card's and the host's
    latency numbers, the pixels and cells that differ}."""
    from dask_geomodeling_tpu_torch import compute_host
    from dask_geomodeling_tpu_torch.io.png import decode_png_bytes
    from dask_geomodeling_tpu_torch.ipyleaflet_plugin import (
        encode_tile, render_wms_tile, tile_values)

    out = {}
    for name, (view, style, vmin, vmax) in layers.items():
        card_s, host_s, pixels_off, cells_off, worst_source = [], [], 0, 0, 0.0
        for turn, index in enumerate(picks):
            request = tile_request(tiles[index])
            params = {k.lower(): v for k, v in
                      getmap_params(name, style, vmin, vmax, tiles[index]).items()}
            for side in ("card", "host") if turn % 2 == 0 else ("host", "card"):
                t0 = time.perf_counter()
                if side == "card":
                    card_png = render_wms_tile(params)
                    card_s.append(time.perf_counter() - t0)
                else:
                    host = compute_host(*view.get_compute_graph(**request))
                    host_png = encode_tile(tile_values(host, WMS_TILE, WMS_TILE), style, vmin,
                                           vmax)
                    host_s.append(time.perf_counter() - t0)
            check(card_png == served[name][0][index], "wms-serving: %s tile %s rendered "
                  "in-process differs from the served one" % (name, tiles[index]))
            port = view.get_data(**request)
            check(port["values"].dtype == host["values"].dtype
                  and port["no_data_value"] == host["no_data_value"],
                  "wms-serving: %s tile %s: dtype or nodata" % (name, tiles[index]))
            a, b = port["values"][0], host["values"][0]
            reach, source_share = wms_source_reach(view, request, device)
            worst_source = max(worst_source, source_share)
            ok, differ, outside = wms_within_limits(name, a, b, reach)
            cells_off += differ
            check(source_share <= HEADLINE_SHARE and ok,
                  "wms-serving: %s tile %s: %.3g of the warped source cells differ; %d cells "
                  "differ, %d beyond the view's limit" % (name, tiles[index], source_share,
                                                         differ, outside))
            agree = (a == b) | ((a != a) & (b != b))
            pixels = (decode_png_bytes(served[name][0][index])[0]
                      != decode_png_bytes(host_png)[0]).any(axis=0)
            pixels_off += int(np.count_nonzero(pixels))
            check(not (pixels & agree).any(), "wms-serving: %s tile %s: a pixel whose value "
                  "agrees with the host's is coloured otherwise" % (name, tiles[index]))
        paired = {"card": latency_numbers(card_s), "host": latency_numbers(host_s)}
        print("wms-serving [%s] %s in-process on %d sampled tiles (planning, values, render and "
              "PNG, no HTTP): card p50 %.3f ms, p99 %.3f ms, max %.3f ms; numpy host p50 %.3f "
              "ms, p99 %.3f ms, max %.3f ms" % (
                  card, name, len(picks), paired["card"]["p50_ms"], paired["card"]["p99_ms"],
                  paired["card"]["max_ms"], paired["host"]["p50_ms"], paired["host"]["p99_ms"],
                  paired["host"]["max_ms"]))
        print("wms-serving: %s on the card: at most %.3g of a tile's warped source cells "
              "differ, %d cells and %d pixels differ in all, none beyond the limits or where "
              "the values agree" % (name, worst_source, cells_off, pixels_off))
        out[name] = dict(paired, differing_pixels=pixels_off, differing_cells=cells_off,
                         largest_source_share=worst_source)
    return out


def wms_other_requests(client, device, layers, tiles, picks, folder):
    """GetFeatureInfo at WMS_FEATURE_INFO pixels against compute_host,
    GetLegendGraphic of each style, GetCoverage of a tile of the last
    zoom against the tile's values, GetCapabilities' layers and WGS84
    boxes, and a layer JSON naming the JAX package's classes refused with
    400 without loading any module of it."""
    from xml.etree import ElementTree

    from dask_geomodeling_tpu_torch import compute_host
    from dask_geomodeling_tpu_torch.geo.crs import transform_extent
    from dask_geomodeling_tpu_torch.io.geotiff import read_geotiff
    from dask_geomodeling_tpu_torch.io.png import decode_png_bytes
    from dask_geomodeling_tpu_torch.render import colormaps

    rng = np.random.RandomState(17)
    names = list(layers)
    explained = 0
    for k in range(WMS_FEATURE_INFO):
        name = names[k % len(names)]
        view, style, vmin, vmax = layers[name]
        col, row = rng.randint(0, WMS_TILE, 2)
        status, _, body, _ = client.get(dict(
            getmap_params(name, style, vmin, vmax, tiles[picks[k % len(picks)]]),
            REQUEST="GetFeatureInfo", QUERY_LAYERS=name, X=str(col), Y=str(row)))
        check(status == 200, "wms-serving: GetFeatureInfo answered %s %r" % (status, body[:200]))
        payload = json.loads(body)
        point = (payload["x"], payload["y"], payload["x"], payload["y"])
        host = compute_host(*view.get_compute_graph(
            mode="vals", bbox=point, width=1, height=1, projection="EPSG:3857", start=None))
        raw = host["values"][0, 0, 0]
        want = None if raw == host["no_data_value"] or not np.isfinite(raw) else raw.item()
        got = payload["value"]
        if got != want:
            reach, _ = wms_source_reach(view, dict(
                mode="vals", bbox=point, width=1, height=1, projection="EPSG:3857", start=None),
                device)
            near = name == "ahn-hillshade" and None not in (got, want) and abs(got - want) <= 1
            check(near or reach.any(), "wms-serving: GetFeatureInfo of %s at %s gave %r, the "
                  "host %r" % (name, point, got, want))
            explained += 1
    styles = sorted({style for _, style, _, _ in layers.values()})
    ramp = np.linspace(1.0, 0.0, 160)[:, None].repeat(24, axis=1)
    for style in styles:
        status, content_type, body, _ = client.get({"REQUEST": "GetLegendGraphic", "STYLES": style})
        check(status == 200 and content_type == "image/png" and np.array_equal(
            decode_png_bytes(body)[0], colormaps.apply(style, ramp).transpose(2, 0, 1)),
            "wms-serving: GetLegendGraphic of %s" % style)
    view, style, vmin, vmax = layers["ahn-smooth"]
    tile = next(t for t in tiles if t[0] == max(t[0] for t in tiles))
    status, content_type, body, _ = client.get(dict(
        getmap_params("ahn-smooth", style, vmin, vmax, tile), REQUEST="GetCoverage",
        COVERAGE="ahn-smooth", FORMAT="GeoTIFF"))
    check(status == 200 and content_type == "image/tiff", "wms-serving: GetCoverage %s" % status)
    path = os.path.join(folder, "coverage.tif")
    with open(path, "wb") as f:
        f.write(body)
    coverage = read_geotiff(path)
    expected = view.get_data(**tile_request(tile))
    check(np.array_equal(coverage.array, expected["values"])
          and coverage.no_data_value == expected["no_data_value"],
          "wms-serving: GetCoverage differs from the tile's values")
    status, _, body, _ = client.get({"SERVICE": "WMS", "REQUEST": "GetCapabilities"})
    listed = {}
    for element in ElementTree.fromstring(body).iter("Layer"):
        box = element.find("LatLonBoundingBox")
        if element.findtext("Name") is not None and box is not None:
            listed[element.findtext("Name")] = tuple(
                float(box.get(k)) for k in ("minx", "miny", "maxx", "maxy"))
    for name, (layer_view, _, _, _) in layers.items():
        want = tuple(float("%.9g" % v) for v in transform_extent(
            layer_view.footprint.bbox, layer_view.projection, "EPSG:4326"))
        check(listed.get(name) == want,
              "wms-serving: GetCapabilities lists %s as %s" % (name, listed.get(name)))
    foreign = view.to_json().replace("dask_geomodeling_tpu_torch.", "dask_geomodeling_tpu.")
    loaded = set(sys.modules)
    status, _, body, _ = client.get(getmap_params(foreign, style, vmin, vmax, tiles[0]))
    leaked = [m for m in set(sys.modules) - loaded if m.split(".")[0] in (
        "jax", "dask_geomodeling_tpu")]
    check(status == 400 and b"is outside" in body and not leaked,
          "wms-serving: a JAX-package layer answered %s %r (loaded %s)" % (status, body[:120], leaked))
    print("wms-serving: %d GetFeatureInfo answers equal the host's values (%d within the "
          "limits only); GetLegendGraphic of %s, GetCoverage of tile %s and GetCapabilities (%s "
          "with their WGS84 boxes) checked; a layer naming the JAX package's classes answered "
          "400 and loaded none of its modules"
          % (WMS_FEATURE_INFO - explained, explained, ", ".join(styles), tile,
             ", ".join(sorted(listed))))


def wms_threaded(layers, tiles):
    """WMS_THREADS threads call render_wms_tile on WMS_CONCURRENT_TILES
    distinct tiles (the last ones, half of each layer): each PNG equals
    the serial render, and the Gaussian launches once per ahn-smooth
    tile.  Returns (tiles, Gaussian launches)."""
    from concurrent.futures import ThreadPoolExecutor

    from dask_geomodeling_tpu_torch.ipyleaflet_plugin import render_wms_tile
    from dask_geomodeling_tpu_torch.ops import cuda_stencils

    jobs = [{k.lower(): v for k, v in getmap_params(name, style, vmin, vmax, tile).items()}
            for name, (_, style, vmin, vmax) in layers.items()
            for tile in tiles[-(WMS_CONCURRENT_TILES // len(layers)):]]
    serial = [render_wms_tile(p) for p in jobs]
    cuda_stencils.reset_launches()
    with ThreadPoolExecutor(max_workers=WMS_THREADS) as pool:
        threaded = list(pool.map(render_wms_tile, jobs))
    launched, moving_max = cuda_stencils.launches, cuda_stencils.moving_max_launches
    smooth_jobs = sum(1 for p in jobs if p["layers"] == "ahn-smooth")
    check(threaded == serial, "wms-serving: the threaded renders differ from the serial ones")
    check(launched == smooth_jobs and moving_max == 0, "wms-serving: %d Gaussian and %d "
          "moving-max launches from %d threaded ahn-smooth renders"
          % (launched, moving_max, smooth_jobs))
    print("wms-serving: %d threads rendered %d distinct tiles equal to the serial renders, %d "
          "Gaussian launches for %d ahn-smooth tiles" % (WMS_THREADS, len(jobs), launched,
                                                         smooth_jobs))
    return len(jobs), launched


def wms_tile_phases(view, request, device, seconds):
    """One GetMap tile's values, split into phases (synchronised) added
    to ``seconds``: the file window reads, the rest of the planning, the
    run on the card (its per-tile host staging included) and the copy to
    the host.  Returns (the answer, the Smooth input's plane shape or
    None, the clock at the end)."""
    import torch

    from dask_geomodeling_tpu_torch import compute_torch
    from dask_geomodeling_tpu_torch.io import geotiff

    read = geotiff.read_geotiff_window
    reads = [0.0]

    def timed_read(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return read(*args, **kwargs)
        finally:
            reads[0] += time.perf_counter() - t0

    def lap(phase, since):
        torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[phase] = seconds.get(phase, 0.0) + now - since
        return now

    t0 = time.perf_counter()
    geotiff.read_geotiff_window = timed_read
    try:
        graph, name = view.get_compute_graph(**request)
    finally:
        geotiff.read_geotiff_window = read
    t1 = lap("planning", t0)
    seconds["planning"] -= reads[0]
    seconds["file window reads"] = seconds.get("file window reads", 0.0) + reads[0]
    plane = None
    if getattr(graph[name][0], "__name__", "") == "_smooth_process":
        _kept.clear()
        compute_torch(dict(graph, kept=(_keep_on_device, graph[name][1])), "kept", device=device)
        plane = (1,) + tuple(_kept.pop()["values"].shape[-2:])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    _kept.clear()
    compute_torch(dict(graph, kept=(_keep_on_device, name)), "kept", device=device)
    data = _kept.pop()
    t2 = lap("device run", t1)
    data = dict(data, values=data["values"].cpu().numpy())
    return data, plane, lap("copy to the host", t2)


def wms_split(card, layers, tiles, picks, device, served):
    """The phases of the sampled tiles, read caches cleared first (an
    unmeasured pass): the planning's, the device's and the copy's
    (wms_tile_phases), the colour render and the PNG encode; each PNG is
    the one served.  Returns ({layer: mean ms a phase}, the Smooth plane)."""
    from dask_geomodeling_tpu_torch.io.png import write_png_bytes
    from dask_geomodeling_tpu_torch.ipyleaflet_plugin import tile_values
    from dask_geomodeling_tpu_torch.render import colormaps
    from dask_geomodeling_tpu_torch.runtime import pipeline

    pipeline.clear_read_cache()
    split, plane = {}, None
    for name, (view, style, vmin, vmax) in layers.items():
        seconds = {}
        for index in picks:
            data, tile_plane, t0 = wms_tile_phases(view, tile_request(tiles[index]), device, seconds)
            plane = tile_plane or plane  # the last zoom's
            normalized = colormaps.normalize(tile_values(data, WMS_TILE, WMS_TILE), vmin, vmax)
            rgba = colormaps.apply(style, normalized)
            rgba[np.ma.getmaskarray(normalized), 3] = 0
            t1 = time.perf_counter()
            seconds["render"] = seconds.get("render", 0.0) + t1 - t0
            png = write_png_bytes(rgba.transpose(2, 0, 1))
            seconds["PNG encode"] = seconds.get("PNG encode", 0.0) + time.perf_counter() - t1
            check(png == served[name][0][index], "wms-serving: the split %s tile %s differs from "
                  "the served one" % (name, tiles[index]))
        split[name] = {k: v / len(picks) * 1e3 for k, v in seconds.items()}
        print("wms-serving [%s] %s phases a tile (ms, mean of %d tiles, read caches cleared, "
              "synchronised): %s" % (card, name, len(picks),
                                     ", ".join("%s %.3f" % kv for kv in split[name].items())))
    return split, plane


def check_wms_serving(card, device, sheet, zooms=WMS_ZOOMS, sample=WMS_SAMPLE,
                      last_zoom_rows=WMS_LAST_ZOOM_ROWS):
    """The wms-serving phase: the port's WSGI server over two layers of
    the sheet (wms_layers), a slippy map's GetMap traffic (xyz_tiles) in
    four passes: cold (read caches cleared, no result cache), warm, fill
    (wms_serve's 256 MiB result cache) and hit; the host's ground truth on
    sampled tiles; GetFeatureInfo, GetLegendGraphic, GetCoverage,
    GetCapabilities and a JAX-package layer refused; a four-thread
    render; then, apart from the timed passes, a phase split and a warm
    pass under torch.profiler.  Returns ({kernel: launches of the cold
    pass, as counted}, the numbers)."""
    from dask_geomodeling_tpu_torch.config import config
    from dask_geomodeling_tpu_torch.geo import Extent
    from dask_geomodeling_tpu_torch.ipyleaflet_plugin import register_layer, unregister_layers
    from dask_geomodeling_tpu_torch.runtime import pipeline, results

    started = time.perf_counter()
    layers = wms_layers(sheet)
    smooth_view = layers["ahn-smooth"][0]
    bbox = Extent(smooth_view.footprint.bbox, "EPSG:28992").transformed("EPSG:3857").bbox
    every = len(xyz_tiles(bbox, zooms))
    tiles = xyz_tiles(bbox, zooms, last_zoom_rows)
    per_zoom = {z: sum(1 for t in tiles if t[0] == z) for z in zooms}
    print("wms-serving: %d of the %d XYZ tiles a layer over the sheet (%s; zoom %d cut to %s "
          "rows), %d layers, %d GetMaps a pass"
          % (len(tiles), every, ", ".join("zoom %d: %d" % kv for kv in per_zoom.items()),
             zooms[-1], last_zoom_rows, len(layers), len(tiles) * len(layers)))
    numbers = {"tiles_per_layer": len(tiles), "tiles_per_zoom": per_zoom}
    for name, (view, _, _, _) in layers.items():
        register_layer(name, view)
    client = WMSClient()
    try:
        with config.set({"geomodeling.block-import-paths": ["dask_geomodeling_tpu_torch"],
                         "geomodeling.wms-json-layers": True,
                         "geomodeling.result-cache-size": 0}):
            pipeline.clear_read_cache()
            cold, cold_launches = wms_pass(client, layers, tiles, "cold", card)
            warm, warm_launches = wms_pass(client, layers, tiles, "warm", card)
            results.clear()
            with config.set({"geomodeling.result-cache-size": WMS_CACHE_BYTES}):
                fill, fill_launches = wms_pass(client, layers, tiles, "fill", card)
                hit, hit_launches = wms_pass(client, layers, tiles, "hit", card)
            stats = results.stats()
            results.clear()
            passes = {"cold": cold_launches, "warm": warm_launches, "fill": fill_launches,
                      "hit": hit_launches}
            launches = {label: counts["gaussian_blur"] for label, counts in passes.items()}
            moving_max = {label: counts["moving_max"] for label, counts in passes.items()}
            print("wms-serving: Gaussian launches per pass %s for %d ahn-smooth tiles, moving-max "
                  "launches per pass %s; the result cache after the hit pass: %s"
                  % (json.dumps(launches), len(tiles), json.dumps(moving_max), stats))
            check(launches["cold"] == launches["warm"] == launches["fill"] == len(tiles),
                  "wms-serving: the cold, warm and fill passes launched %s Gaussians for %d tiles"
                  % (launches, len(tiles)))
            check(launches["hit"] == 0, "wms-serving: the hit pass launched %d Gaussians"
                  % launches["hit"])
            check(not any(moving_max.values()),
                  "wms-serving: a pass launched moving-max kernels: %s" % moving_max)
            check(stats["hits"] == len(tiles) * len(layers) and stats["evictions"] == 0,
                  "wms-serving: the hit pass was not served from the cache: %s" % stats)
            for name in layers:
                check(warm[name][0] == cold[name][0] and fill[name][0] == cold[name][0],
                      "wms-serving: %s: the warm or fill PNGs differ from the cold ones" % name)
                check(hit[name][0] == fill[name][0],
                      "wms-serving: %s: the hit PNGs differ from the fill ones" % name)
            numbers.update(
                passes={label: {name: p[name][1] for name in layers} for label, p in
                        (("cold", cold), ("warm", warm), ("fill", fill), ("hit", hit))},
                gaussian_launches=launches, moving_max_launches=moving_max, result_cache=stats)
            picks = np.linspace(0, len(tiles) - 1, sample).round().astype(int)
            numbers["in_process"] = wms_ground_truth(card, device, layers, tiles, picks, cold)
            wms_other_requests(client, device, layers, tiles, picks, os.path.dirname(sheet))
            numbers["threaded"] = wms_threaded(layers, tiles)
            numbers["phases_ms"], plane = wms_split(card, layers, tiles, picks, device, cold)
            profiled_s, busy_ms = device_busy_ms(
                lambda: wms_pass(client, layers, tiles, "profiled warm", card))
    finally:
        client.close()
        unregister_layers()
    idle = None if busy_ms is None else 1 - busy_ms / 1e3 / profiled_s
    print("wms-serving [%s]: profiled warm pass %.4f s, device busy %s, idle share %s"
          % (card, profiled_s, "not measured" if busy_ms is None else "%.3f ms" % busy_ms,
             "not measured" if idle is None else "%.4f" % idle))
    last = next(t for t in tiles if t[0] == zooms[-1])
    numbers.update(profiled_s=profiled_s, device_busy_ms=busy_ms, idle_share=idle,
                   plane=list(plane), sigma=list(smooth_sigma(smooth_view, tile_request(last))),
                   seconds=time.perf_counter() - started)
    return cold_launches, numbers


# --- the auto-routing phase ---

#: request edges (px) of the auto-routing phase, and requests a view and edge
AUTO_EDGES = (64, 128, 256, 512, 1024, 2048)
AUTO_PER_EDGE = 8


def auto_views(sheet, headline_view, headline_req):
    """{name: (view, request template, the limits' kind)}: the sheet's two
    WMS layers at the sheet's grid in EPSG:28992, and the headline view
    at its request's cell in EPSG:3857."""
    from dask_geomodeling_tpu_torch.raster import RasterFileSource

    layers = wms_layers(sheet)
    x1, y1, x2, y2 = RasterFileSource(sheet).footprint.bbox
    sheet_box = dict(mode="vals", projection="EPSG:28992", start=None,
                     bbox=(x1, y1, x2, y2), cell=SHEET_CELL)
    hx1, hy1, hx2, hy2 = headline_req["bbox"]
    head_box = dict(headline_req, cell=(hx2 - hx1) / headline_req["width"])
    del head_box["width"], head_box["height"]
    return {
        "ahn-smooth": (layers["ahn-smooth"][0], sheet_box, "bitwise"),
        "ahn-hillshade": (layers["ahn-hillshade"][0], sheet_box, "within-1"),
        "headline": (headline_view, head_box, "share"),
    }


def auto_requests(views, edges=AUTO_EDGES, per_edge=AUTO_PER_EDGE, seed=17):
    """[(view name, edge, request)]: ``per_edge`` requests a view and
    edge, each an edge^2 window at the view's cell, on the cell grid, at
    a position drawn from ``seed``, in one seeded, interleaved order."""
    rng = np.random.default_rng(seed)
    items = []
    for name, (_, template, _) in views.items():
        x1, y1, x2, y2 = template["bbox"]
        cell = template["cell"]
        cols, rows = int(round((x2 - x1) / cell)), int(round((y2 - y1) / cell))
        for edge in edges:
            for _ in range(per_edge):
                col = int(rng.integers(0, cols - edge + 1))
                row = int(rng.integers(0, rows - edge + 1))
                bbox = (x1 + col * cell, y2 - (row + edge) * cell,
                        x1 + (col + edge) * cell, y2 - row * cell)
                request = {k: v for k, v in template.items() if k != "cell"}
                request.update(bbox=bbox, width=edge, height=edge)
                items.append((name, edge, request))
    return [items[i] for i in rng.permutation(len(items))]


def routed_within_limits(kind, port, host, label):
    """(differing cells, cells) of a card-routed answer beside the host's
    (host_answer); raises where the limits of its path are broken:
    bitwise (the file-read view), within 1 (HillShade's float32
    transcendentals, the share held over all its answers by the caller),
    or only the share of differing cells (the headline's cross-CRS warp)."""
    a, e = port["values"], host["values"]
    check(a.shape == e.shape and a.dtype == e.dtype, "auto-routing: %s: shape or dtype differs"
          % label)
    differ, worst, _ = compare_cells(a, e, host["no_data_value"])
    if kind == "bitwise":
        check(differ == 0, "auto-routing: a card-routed %s answer differs from compute_host "
              "in %d cells" % (label, differ))
    elif kind == "within-1":
        check(worst <= 1, "auto-routing: a card-routed %s answer is %r off" % (label, worst))
    return differ, e.size


def host_answer(view, request, tile=TILE):
    """compute_host of ``request`` as the card's route runs it: whole up
    to one tile, else tile by tile (tile_requests), assembled as
    evaluate_tiled assembles the card's tiles; a Smooth's values near a
    tile border depend on the tile grid (the Gaussian reaches past its
    margin), so a tiled answer is held to its own tiles."""
    from dask_geomodeling_tpu_torch import compute_host
    from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests

    width, height = request["width"], request["height"]
    if max(width, height) <= tile:
        return compute_host(*view.get_compute_graph(**request))
    tiles, nx = tile_requests(request, tile)
    out = None
    for index, tile_request in enumerate(tiles):
        host = compute_host(*view.get_compute_graph(**tile_request))
        if out is None:
            out = np.empty((host["values"].shape[0], height, width), host["values"].dtype)
        (rows, cols), (tile_rows, tile_cols) = tile_cells(index, nx, width, height, tile)
        out[:, rows, cols] = host["values"][:, tile_rows, tile_cols]
    return {"values": out, "no_data_value": host["no_data_value"]}


def check_auto_routing(card, device, folder, sheet, headline_view, headline_req,
                       edges=AUTO_EDGES, per_edge=AUTO_PER_EDGE):
    """The auto-routing phase: geomodeling.executor "auto" over three views
    (auto_views) and ``per_edge`` requests of each edge (auto_requests:
    144 at the defaults), the router
    exploring from an empty table whose state file lives in ``folder``;
    every route taken, the Gaussian launches per route, each card-routed
    answer against compute_host; the table's final rates and settled
    routes per view and edge; after save and a reseeded reset, one
    request per key takes its settled route; status.snapshot(), and a
    request of the largest edge under the Profiler and torch_trace.  Returns
    ({kernel: launches in the routed requests}, the numbers)."""
    from dask_geomodeling_tpu_torch.config import config
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.runtime import pipeline, router, status
    from dask_geomodeling_tpu_torch.runtime.profile import Profiler, torch_trace

    started = time.perf_counter()
    views = auto_views(sheet, headline_view, headline_req)
    items = auto_requests(views, edges, per_edge)
    state = os.path.join(folder, "router-state.json")
    routes = []
    real_choose = router.choose

    def choosing(view, request, eligible):
        routes.append(real_choose(view, request, eligible))
        return routes[-1]

    settings = {"geomodeling.executor": "auto", "geomodeling.router-state": state,
                "geomodeling.auto-min-device-px": 0, "geomodeling.result-cache-size": 0,
                "geomodeling.torch-device": str(device)}
    table = {}
    share = {name: [0, 0] for name in views}
    launches = {"gaussian_blur": 0, "moving_max": 0}
    host_s = 0.0
    router.choose = choosing
    try:
        with config.set(settings):
            router.reset(reseed=False)
            pipeline.clear_read_cache()
            for name, edge, request in items:
                view, _, kind = views[name]
                cuda_stencils.reset_launches()
                t0 = time.perf_counter()
                out = view.get_data(**request)
                seconds = time.perf_counter() - t0
                route = routes[-1]
                entry = table.setdefault((name, edge), {"numpy": 0, "torch": 0, "gaussian": {
                    "numpy": 0, "torch": 0}, "seconds": {"numpy": [], "torch": []}})
                entry[route] += 1
                entry["gaussian"][route] += cuda_stencils.launches
                entry["seconds"][route].append(seconds)
                launches["gaussian_blur"] += cuda_stencils.launches
                launches["moving_max"] += cuda_stencils.moving_max_launches
                if route == "torch":
                    t0 = time.perf_counter()
                    host = host_answer(view, request, config.get("geomodeling.tile-size"))
                    host_s += time.perf_counter() - t0
                    differ, cells = routed_within_limits(kind, out, host, "%s %d^2" % (name, edge))
                    share[name][0] += differ
                    share[name][1] += cells
            keys = {}
            for (name, edge), entry in sorted(table.items(), key=lambda kv: (kv[0][0], kv[0][1])):
                view = views[name][0]
                request = next(r for n, e, r in items if n == name and e == edge)
                # the route the router takes next for this key
                settled = router.route_of(view, request)
                s = router.state_of(view, request)
                keys[(name, edge)] = settled
                entry.update(host_mpx_s=s["numpy"], card_mpx_s=s["torch"], settled=settled,
                             torch_runs=s["torch_runs"])
                print("auto-routing [%s] %s %d^2: routes numpy %d, torch %d; Gaussian launches "
                      "on host routes %d, on card routes %d; final host %s Mpx/s, card %s Mpx/s; "
                      "settled %s" % (card, name, edge, entry["numpy"], entry["torch"],
                                      entry["gaussian"]["numpy"], entry["gaussian"]["torch"],
                                      s["numpy"], s["torch"], settled))
            for (name, edge), entry in table.items():
                check(entry["gaussian"]["numpy"] == 0, "auto-routing: %s %d^2: host routes "
                      "launched %d Gaussians" % (name, edge, entry["gaussian"]["numpy"]))
                if name == "ahn-smooth" and entry["torch"]:
                    check(entry["gaussian"]["torch"] >= entry["torch"], "auto-routing: %s %d^2: "
                          "%d card routes launched %d Gaussians" % (
                              name, edge, entry["torch"], entry["gaussian"]["torch"]))
            taken = {r: routes.count(r) for r in ("numpy", "torch")}
            check(taken["numpy"] > 0 and taken["torch"] > 0,
                  "auto-routing: only one route was taken: %s" % taken)
            for name, (differ, cells) in share.items():
                limit = {"ahn-smooth": 0.0, "ahn-hillshade": STENCILS_SHARE,
                         "headline": HEADLINE_SHARE}[name]
                check(differ <= limit * cells, "auto-routing: %s: %d of %d card-routed cells "
                      "differ from compute_host" % (name, differ, cells))
                print("auto-routing: %s: %d of %d card-routed cells differ from compute_host "
                      "(limit share %r)" % (name, differ, cells, limit))
            # the settled routes survive a save and a reseeded reset
            router.save()
            router.reset(reseed=True)
            del routes[:]
            for (name, edge), settled in keys.items():
                request = next(r for n, e, r in items if n == name and e == edge)
                views[name][0].get_data(**request)
                check(routes[-1] == settled, "auto-routing: %s %d^2 took %s after the reseed, "
                      "settled %s" % (name, edge, routes[-1], settled))
            print("auto-routing: after save and reset(reseed=True) from %s, one request per key "
                  "took its settled route (%d keys, %d to the card)"
                  % (os.path.basename(state), len(keys), sum(v == "torch" for v in keys.values())))
            snapshot = status.snapshot()
            print("auto-routing: status.snapshot() %s" % json.dumps(snapshot))
            # one request of the largest edge of the file-read view under the
            # Profiler and torch_trace
            name, edge, request = next(i for i in items
                                       if i[0] == "ahn-smooth" and i[1] == max(edges))
            trace_dir = os.path.join(folder, "trace")
            with config.set({"geomodeling.executor": "torch"}):
                with torch_trace(trace_dir), Profiler() as prof:
                    views[name][0].get_data(**request)
            trace_bytes = os.path.getsize(os.path.join(trace_dir, "trace.json"))
            check(trace_bytes > 0, "auto-routing: torch_trace wrote an empty trace")
            print("auto-routing: Profiler summary of one %s %d^2 request on the card (torch_trace "
                  "wrote %d bytes):\n%s" % (name, edge, trace_bytes, prof.summary()))
    finally:
        router.choose = real_choose
        with config.set({"geomodeling.router-state": None}):
            router.reset(reseed=False)  # nothing left for the exit's autosave
    # per view, the smallest edge from which the card settles at every
    # larger edge (None: the host at the largest)
    crossover = {name: next((e for e in edges if all(
        keys[(name, f)] == "torch" for f in edges if f >= e)), None) for name in views}
    print("auto-routing [%s]: %d requests, routes taken %s, the smallest edge from which the card "
          "settles at every larger edge: %s; host ground truth %.3f s; the phase %.1f s"
          % (card, len(items), json.dumps(taken), json.dumps(crossover), host_s,
             time.perf_counter() - started))
    numbers = dict(
        requests=len(items), routes=taken, crossover_edge=crossover, host_s=host_s,
        table={"%s %d" % key: {k: v for k, v in entry.items() if k != "seconds"}
               for key, entry in table.items()},
        snapshot=snapshot, trace_bytes=trace_bytes, seconds=time.perf_counter() - started)
    return launches, numbers


# --- the building-rings phase ---

#: the building-rings path: the building-heights footprints inside a
#: RINGS_SIDE^2 (about 2 km^2) sub-area of the sheet, buffered by
#: RINGS_DISTANCE m, minus the footprint, simplified at RINGS_SIMPLIFY m
RINGS_SIDE = 1400.0
RINGS_DISTANCE = 10.0
RINGS_SIMPLIFY = 0.25
RINGS_SUB = 300.0
RINGS_FIELDS = ("identificatie", "bouwjaar", "ring_mean", "ring_p10", "h_mean", "peil",
                "kelder", "drempel")
#: the fields that may differ from the host's where an unrounded mean is
#: one float32 ulp off (float64 atomics): the rounded means, and the
#: floor level above the ring's
RINGS_ROUNDED = ("ring_mean", "h_mean", "drempel")


def rings_area(bbox, side=RINGS_SIDE):
    """The rings' sub-area: a side^2 box in the middle of ``bbox``."""
    cx, cy = (bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2
    half = min(side, bbox[2] - bbox[0], bbox[3] - bbox[1]) / 2
    return (cx - half, cy - half, cx + half, cy + half)


def description(rng):
    """A ``beschrijving``: key=value lines as a water board's building
    register carries them, a floor level (vloerpeil, m NAP) missing in one
    of ten and null in one of twenty, a basement flag and a source."""
    lines = ["bron=BAG"]
    draw = rng.random()
    if draw >= 0.15:
        lines.append("vloerpeil=%.2f" % rng.uniform(2.0, 9.0))
    elif draw >= 0.10:
        lines.append("vloerpeil=null")
    lines.append("kelder=%s" % ("true" if rng.random() < 0.2 else "false"))
    lines.append("opmerking=peil ingemeten %d" % rng.integers(1995, 2024))
    return "\n".join(lines)


def write_rings_buildings(folder, sheet_bbox, area, count=BUILDINGS, seed=13):
    """Write the footprints of write_buildings(sheet_bbox, count, seed)
    whose every vertex lies inside ``area`` into ``folder``/rings.gpkg,
    layer "pand", with a ``beschrijving`` of key=value lines (seeded);
    returns (its path, the number written)."""
    from dask_geomodeling_tpu_torch.io.vectorfile import write_vector

    frame = building_frame(sheet_bbox, count, seed)
    x1, y1, x2, y2 = area
    keep = np.array([x1 < g.bounds[0] and g.bounds[2] < x2 and y1 < g.bounds[1]
                     and g.bounds[3] < y2 for g in frame.geometry.values])
    frame = frame.iloc[np.flatnonzero(keep)]
    rng = np.random.default_rng(seed + 1)
    frame["beschrijving"] = [description(rng) for _ in range(len(frame))]
    path = os.path.join(folder, "rings.gpkg")
    write_vector(frame, path, layer="pand")
    return path, len(frame)


def rings_blocks(buildings, sheet):
    """The building-rings view's blocks: {"view", "ring_mean", "own_mean"}
    (the two unrounded means' AggregateRaster blocks).  The view: a 10 m
    ring around each footprint (Buffer, Difference with the footprint,
    Simplify), the mean and 10th percentile of the smoothed sheet over
    the ring, merged (left) with the footprint's own mean height, the
    floor level and basement flag parsed from the description, the floor
    level above the ring's mean ground, and each ring clipped to the
    request's geometry (Intersection)."""
    from dask_geomodeling_tpu_torch.geometry import (
        AggregateRaster,
        Buffer,
        Difference,
        GeometryFileSource,
        Intersection,
        MergeGeometryBlocks,
        ParseTextColumn,
        Round,
        Simplify,
    )
    from dask_geomodeling_tpu_torch.raster import RasterFileSource, Smooth

    footprints = GeometryFileSource(buildings, layer="pand")
    rings = Simplify(Difference(Buffer(footprints, RINGS_DISTANCE, "EPSG:28992"), footprints),
                     RINGS_SIMPLIFY)
    dem = Smooth(RasterFileSource(sheet), 3)
    ring_mean = AggregateRaster(rings, dem, "mean")
    own_mean = AggregateRaster(footprints, dem, "mean")
    stats = rings.set("ring_mean", Round(ring_mean["agg"], 2),
                      "ring_p10", AggregateRaster(rings, dem, "p10")["agg"])
    own = footprints.set("h_mean", Round(own_mean["agg"], 2))
    merged = MergeGeometryBlocks(stats, own, how="left")
    parsed = ParseTextColumn(merged, "beschrijving", {"vloerpeil": "peil", "kelder": "kelder"})
    view = Intersection(parsed.set("drempel", parsed["peil"] - parsed["ring_mean"]))
    return {"view": view, "ring_mean": ring_mean, "own_mean": own_mean}


def build_rings_view(buildings, sheet):
    """The building-rings view (rings_blocks)."""
    return rings_blocks(buildings, sheet)["view"]


def rings_clock():
    """A PhaseClock over the building-rings export: the buffers (the
    distance fields and their contours), the differences, the vector
    file reads, the zonal statistics' device plane and the sinks' writes
    and merge."""
    from dask_geomodeling_tpu_torch.geo import _buffer
    from dask_geomodeling_tpu_torch.geo.features import GeoSeries
    from dask_geomodeling_tpu_torch.geometry import aggregate
    from dask_geomodeling_tpu_torch.geometry.sinks import GeometryFileSink
    from dask_geomodeling_tpu_torch.io import vectorfile
    from dask_geomodeling_tpu_torch.runtime import pipeline

    return PhaseClock([
        (_buffer, "buffer", "buffer"),
        (GeoSeries, "difference", "difference"),
        (pipeline, "read_vector_cached", "vector read"),
        (vectorfile, "_read_gpkg", "vector read"),
        (aggregate, "_aggregate_on_device", "zonal"),
        (GeometryFileSink, "process", "sink"),
        (GeometryFileSink, "merge_files", "sink"),
    ])


def check_building_rings(card, device, folder, sheet, side=RINGS_SIDE, tile=BUILDING_TILE,
                         sub_size=RINGS_SUB, count=BUILDINGS):
    """The building-rings phase: the rings view (build_rings_view) over
    the footprints inside a side^2 sub-area of the sheet, exported by
    to_file in tiles of ``tile`` m (GeometryTiler over GeometryFileSink
    GeoPackages, merged) under the phase clock; one tile against
    compute_host; a sub_size^2 sub-area exported untiled as GeoJSON
    byte-identical to the host's export.  Returns ({kernel: launches of
    the export}, the numbers)."""
    from dask_geomodeling_tpu_torch import compute_host
    from dask_geomodeling_tpu_torch.core.tokens import tokenize
    from dask_geomodeling_tpu_torch.geo.geometry import box
    from dask_geomodeling_tpu_torch.geometry import GeometryFileSink, GeometryTiler
    from dask_geomodeling_tpu_torch.geometry.sinks import to_file
    from dask_geomodeling_tpu_torch.io import vectorfile
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.raster import RasterFileSource
    from dask_geomodeling_tpu_torch.runtime import pipeline

    started = time.perf_counter()
    sheet_bbox = RasterFileSource(sheet).footprint.bbox
    area = rings_area(sheet_bbox, side)
    t0 = time.perf_counter()
    buildings, count = write_rings_buildings(folder, sheet_bbox, area, count)
    write_s = time.perf_counter() - t0
    print("building-rings: %d of the building-heights footprints inside a %g m square "
          "(%.3f km^2) written with a beschrijving to a GeoPackage in %.2f s"
          % (count, area[2] - area[0], (area[2] - area[0]) * (area[3] - area[1]) / 1e6, write_s))
    blocks = rings_blocks(buildings, sheet)
    view = blocks["view"]
    fields = {name: name for name in RINGS_FIELDS}
    projection = "EPSG:28992"
    pipeline.clear_read_cache()
    target = os.path.join(folder, "rings_export.gpkg")
    # the request names its geometry: an Intersection answers no extent
    # request without one (in the JAX package too), and to_file asks for
    # the extent when the request has none
    export_request = dict(mode="centroid", geometry=box(*area), projection=projection)
    cuda_stencils.reset_launches()
    with rings_clock() as clock:
        t0 = time.perf_counter()
        to_file(view, target, fields=fields, tile_size=tile, device=device, **export_request)
        export_s = time.perf_counter() - t0
    launches = {"gaussian_blur": cuda_stencils.launches,
                "moving_max": cuda_stencils.moving_max_launches}
    pieces = GeometryTiler(view, tile, projection).get_sources_and_requests(**export_request)
    subrequests = [request for _, request in pieces]
    merged = vectorfile.read_vector(target)
    phases = dict(clock.seconds)
    phases["other"] = export_s - sum(phases.values())
    print("building-rings: to_file of %d buildings in %d tiles of %g m: %.3f s, %.1f "
          "buildings/s, %d rings in the merged file [%s]" % (
              count, len(subrequests), tile, export_s, count / export_s, len(merged), card))
    print("building-rings: phases (s; the buffers and the differences run on the host, the "
          "zonal statistics' device plane on the card; %d timed calls): %s" % (
              sum(clock.calls.values()), json.dumps({k: round(v, 4) for k, v in phases.items()})))
    print("building-rings: %d Gaussian launches (two a tile: the rings' and the footprints' "
          "AggregateRaster read the sheet over different boxes), %d moving-max launches"
          % (launches["gaussian_blur"], launches["moving_max"]))
    check(launches["gaussian_blur"] == 2 * len(subrequests),
          "building-rings: %d Gaussian launches for %d tiles" % (launches["gaussian_blur"],
                                                                 len(subrequests)))
    check(set(merged.columns) == set(RINGS_FIELDS) | {"geometry"},
          "building-rings: the fields are %s" % sorted(merged.columns))
    check(len(merged) == count, "building-rings: %d rings exported for %d buildings"
          % (len(merged), count))
    check(all(g is not None and not g.is_empty and g.area > 0 for g in merged.geometry.values),
          "building-rings: an empty ring was exported")
    peil = merged["peil"].values.astype(float)
    print("building-rings: %d rings; floor level parsed in %d, missing or null in %d; "
          "kelder %s; ring areas %.1f-%.1f m^2" % (
              len(merged), np.isfinite(peil).sum(), (~np.isfinite(peil)).sum(),
              sorted(set(merged["kelder"].tolist()), key=repr),
              min(g.area for g in merged.geometry.values),
              max(g.area for g in merged.geometry.values)))

    mean_views = [blocks["ring_mean"], blocks["own_mean"]]

    # one tile against compute_host: the host's partial file of the same
    # subrequest against the export's rows of those fids
    host_s = 0.0
    merged_rows = frame_rows(merged)
    host_dir = os.path.join(folder, "rings_host")
    # the tile with the fewest rings (the host's buffers cost tens of ms each)
    request = min((r for r in subrequests if any(r["geometry"].intersects(g.centroid)
                                                 for g in merged.geometry.values)),
                  key=lambda r: sum(r["geometry"].intersects(g.centroid)
                                    for g in merged.geometry.values))
    sink = GeometryFileSink(view, host_dir, extension="gpkg", fields=fields)
    t0 = time.perf_counter()
    compute_host(*sink.get_compute_graph(**request))
    host_s += time.perf_counter() - t0
    host_rows = frame_rows(vectorfile.read_vector(
        os.path.join(host_dir, tokenize(request)[:7] + ".gpkg")))
    check(len(host_rows) > 0, "building-rings: the host's tile is empty")
    differing = compare_heights("building-rings tile", {fid: merged_rows[fid] for fid in host_rows
                                                        if fid in merged_rows}, host_rows,
                                mean_ulps(mean_views, request, device), RINGS_ROUNDED)
    print("building-rings: one tile's %d rows equal compute_host of its subrequest (%.3f s on the "
          "host): geometry, ring_p10, peil and kelder bitwise, the rounded means differing in "
          "%d rows [%s]" % (len(host_rows), host_s, len(differing), card))

    # a sub-area exported untiled as GeoJSON, against the host's export
    x1, y1, x2, y2 = area
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    sub = box(cx - sub_size / 2, cy - sub_size / 2, cx + sub_size / 2, cy + sub_size / 2)
    sub_request = dict(mode="centroid", geometry=sub, projection=projection)
    ours = os.path.join(folder, "rings_sub.geojson")
    to_file(view, ours, fields=fields, device=device, **sub_request)
    host_target = os.path.join(folder, "rings_host_sub.geojson")
    sink_dir = os.path.join(folder, "rings_host_sub")
    t0 = time.perf_counter()
    compute_host(*GeometryFileSink(view, sink_dir, extension="geojson", fields=fields)
                 .get_compute_graph(**sub_request))
    GeometryFileSink.merge_files(sink_dir, host_target)
    host_s += time.perf_counter() - t0
    port_rows = frame_rows(vectorfile.read_vector(ours))
    differ = compare_heights("building-rings sub-area", port_rows,
                             frame_rows(vectorfile.read_vector(host_target)),
                             mean_ulps(mean_views, sub_request, device), RINGS_ROUNDED)
    identical = geojson_equal(ours, host_target, [], RINGS_ROUNDED)
    check(geojson_equal(ours, host_target, differ, RINGS_ROUNDED),
          "building-rings: the GeoJSON differs from the host's beyond the rounded means of "
          "%d rows" % len(differ))
    check(len(port_rows) > 5, "building-rings: the sub-area holds %d rings" % len(port_rows))
    print("building-rings: a %g m sub-area exported untiled as GeoJSON: %d rings clipped to it, "
          "byte-identical to the host's export: %s (rounded means differing in %d rows)"
          % (sub_size, len(port_rows), identical, len(differ)))
    total_s = time.perf_counter() - started
    print("building-rings: host ground truth %.3f s; the phase %.1f s [%s]"
          % (host_s, total_s, card))
    return launches, dict(
        buildings=count, area_km2=(area[2] - area[0]) * (area[3] - area[1]) / 1e6,
        tiles=len(subrequests), export_s=export_s, buildings_per_s=count / export_s,
        phases=phases, host_s=host_s, phase_s=total_s, rows_differing=len(differing) + len(differ),
        geojson_identical=identical, write_s=write_s)


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
    folder = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return run_phases(card, device, folder, mark)
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def run_phases(card, device, folder, mark):
    """Phases 3 to 12; ``folder`` holds the sheet and the exports."""
    import torch

    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.ops.stencils import gaussian_blur_reference
    from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests

    t0 = time.perf_counter()
    sheet = write_sheet(folder)
    print("file paths: the %dx%d float32 sheet written (deflate, 512^2 tiles) in %.2f s, %d MB"
          % (SHEET_WIDTH, SHEET_HEIGHT, time.perf_counter() - t0,
             os.path.getsize(sheet) // 10**6))
    files = build_file_paths(sheet)
    mark("writing the sheet")

    # 3. kernel checks, at the sigmas of the paths' first tiles
    headline_source, headline_view = build_headline_view()
    headline_req = headline_request(headline_source, HEADLINE_PX)
    _, stencils_view = build_stencils_view(STENCILS_PX)
    stencils_req = vals_request(STENCILS_PX)
    sigmas = [smooth_sigma(view, tile_requests(req, TILE)[0][0])
              for view, req in [(headline_view, headline_req), (stencils_view, stencils_req),
                                files["file-read"][:2]]]
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
        algebra_host[label], _ = check_algebra_path(
            label, device, view, request, interpolation, corner)
        launches[label] = {"gaussian_blur": cuda_stencils.launches,
                           "moving_max": cuda_stencils.moving_max_launches}
    mark("the algebra paths")
    temporal, hourly48 = build_temporal_paths()
    mark("building the temporal sources")
    for label, (view, request, interpolation, corner) in temporal.items():
        cuda_stencils.reset_launches()
        algebra_host[label], _ = check_algebra_path(
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
        algebra_host[label], _ = check_algebra_path(
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
    file_host = {}
    for label, (view, request, interpolation, corner) in files.items():
        cuda_stencils.reset_launches()
        file_host[label], values = check_algebra_path(
            label, device, view, request, interpolation, corner,
            share=0.0 if label == "file-read" else HEADLINE_SHARE,
            sigma_groups=label == "file-reproject")
        launches[label] = {"gaussian_blur": cuda_stencils.launches,
                           "moving_max": cuda_stencils.moving_max_launches}
        if label == "file-read":
            read_values = values
        del values
    mark("the file-read and file-reproject paths")
    view, request, _, _ = files["file-read"]
    launches["file-export"], export = check_file_export(card, device, view, request, folder,
                                                        read_values)
    del read_values
    mark("the file-export path")
    launches["building-heights"], buildings = check_buildings(card, device, folder, sheet)
    rng = np.random.RandomState(1)
    building_planes = torch.from_numpy(
        (3 + rng.rand(*buildings["plane"]) * 5).astype(np.float32)).to(device)
    got = cuda_stencils.gaussian_blur(building_planes, *buildings["sigma"], 0)
    want = gaussian_blur_reference(building_planes, *buildings["sigma"], 0)
    check(torch.equal(got, want),
          "gaussian_blur differs from its plain version at the building-heights plane")
    err = float((got - want).abs().max())
    print("kernel check: gaussian_blur building-heights plane %s equal=True max_abs_err=%r"
          % (tuple(building_planes.shape), err))
    gaussian.append(dict(time_gaussian(building_planes, buildings["sigma"]),
                         max_abs_err=err, path="building-heights"))
    del building_planes, got, want
    mark("the building-heights path")
    launches["wms-serving"], wms = check_wms_serving(card, device, sheet)
    wms_planes = torch.from_numpy(
        (3 + rng.rand(*wms["plane"]) * 5).astype(np.float32)).to(device)
    got = cuda_stencils.gaussian_blur(wms_planes, *wms["sigma"], 0)
    want = gaussian_blur_reference(wms_planes, *wms["sigma"], 0)
    check(torch.equal(got, want), "gaussian_blur differs from its plain version at the WMS plane")
    err = float((got - want).abs().max())
    print("kernel check: gaussian_blur wms-serving plane %s equal=True max_abs_err=%r"
          % (tuple(wms_planes.shape), err))
    gaussian.append(dict(time_gaussian(wms_planes, wms["sigma"]), max_abs_err=err,
                         path="wms-serving"))
    del wms_planes, got, want
    mark("the wms-serving path")
    launches["auto-routing"], auto = check_auto_routing(card, device, folder, sheet,
                                                        headline_view, headline_req)
    mark("the auto-routing path")
    launches["building-rings"], rings = check_building_rings(card, device, folder, sheet)
    mark("the building-rings path")
    check_fuzz(device)
    check_f64_discrete(device)
    mark("the fuzz and the float64 discrete ops")

    # 9. timing
    timings = {
        "headline": time_path("headline", card, headline_view, headline_req, device, headline_host),
        "stencils": time_path("stencils", card, stencils_view, stencils_req, device, stencils_host),
    }
    algebra_host.update(file_host)
    for label, (view, request, interpolation, _) in (
            list(algebra.items()) + list(temporal.items()) + list(geometry.items())
            + list(files.items())):
        with interpolation_set(interpolation):
            timings[label] = time_path(label, card, view, request, device, algebra_host[label])
    timings["file-export"] = export
    timings["building-heights"] = buildings
    timings["wms-serving"] = wms
    timings["auto-routing"] = auto
    timings["building-rings"] = rings
    for name, numbers in [("gaussian_blur", g) for g in gaussian] + [("moving_max", m) for m in moving]:
        print("timing [%s]: %s %s kernel %.4f ms, plain torch %.4f ms, library call %.4f ms, "
              "bound %.4f ms (%s)" % (card, name, tuple(numbers["shape"]), numbers["ms"],
                                      numbers["plain_ms"], numbers["library_ms"],
                                      numbers["bound_ms"], numbers["bound_by"]))

    mark("the timing")
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "dask_geomodeling_tpu", "pandas", "matplotlib", "PIL"))
    check(not leaked, "modules of JAX, pandas, matplotlib, Pillow or the JAX package were "
          "imported: %s" % leaked[:5])
    print("imports: no module of JAX, pandas, matplotlib, Pillow or the JAX package was loaded")
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
