"""Zonal statistics: AggregateRaster and AggregateRasterAboveThreshold.

Counterpart of dask_geomodeling_tpu/geometry/aggregate.py: a pre-flight
extent request scopes the raster read; a pixel budget is enforced
(optionally coarsening the cell by an integer factor); the aggregation grid
snaps to (0, 0); features rasterize in mutually disjoint groups
(``bucketize``) so overlapping features don't clobber each other's labels;
features covering no cell center fall back to centroid sampling; extensive
statistics (sum/count) rescale by the squared coarsening factor.

The host path (scipy.ndimage per group and frame) is the ground truth and
is what ``compute_host`` reaches.  When the raster arrives as a tensor
(``compute_torch`` hands AggregateRaster its device inputs as they are:
``torch_accepts_device_tensors``), every statistic runs on the device
plane instead (ops/segment.py): the groups' label planes rasterize there
from their polygon edges, the statistics of every (frame, feature)
reduce in one pass, and only the (t, n) matrix and the ``covered``
vector come back to the host; the centroid samples of uncovered features
are gathered there too.  There is no size threshold and no setting.
The JAX package's ``geomodeling.aggregate-device`` keys and its float32
device statistics are not ported.
"""
from collections import defaultdict
from functools import partial
from math import ceil, floor, log, sqrt

import numpy as np
import torch
from scipy import ndimage

from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.core import arg, expect_instance
from dask_geomodeling_tpu_torch.device import compare
from dask_geomodeling_tpu_torch.geo import (
    Extent,
    GeoTransform,
    measurements,
    parse_percentile_statistic,
    rasterize_geoseries,
)
from dask_geomodeling_tpu_torch.geo.features import GeoDataFrame
from dask_geomodeling_tpu_torch.geometry.base import GeometryBlock
from dask_geomodeling_tpu_torch.raster.base import RasterBlock

__all__ = [
    "AggregateRaster",
    "AggregateRasterAboveThreshold",
    "bucketize",
    "plan_aggregation_grid",
]

# per-statistic host reducer + whether the result scales with cell area.
# std/var extend the reference's set (they fall out of the same labeled
# machinery on both the host and device paths).
STATISTIC_REGISTRY = {
    "sum": (ndimage.sum, True),
    "count": (ndimage.sum, True),
    "min": (ndimage.minimum, False),
    "max": (ndimage.maximum, False),
    "mean": (ndimage.mean, False),
    "median": (ndimage.median, False),
    "std": (ndimage.standard_deviation, False),
    "var": (ndimage.variance, False),
    "percentile": (measurements.percentile, False),
}


def _footprint(bbox):
    """(level, cells): the power-of-two shelf a bbox belongs to and the
    <=4 grid cells it may touch at that shelf's cell size.

    Degenerate (zero-extent) bboxes — points, vertical/horizontal lines —
    get a tiny but finite span so they shelve instead of hitting
    ``log(0)``."""
    x1, y1, x2, y2 = bbox
    extent = max(x2 - x1, y2 - y1, 1e-9)
    level = -ceil(log(extent, 2))
    span = 0.5**level
    columns = {floor(x1 / span), floor(x2 / span)}
    rows = {floor(y1 / span), floor(y2 / span)}
    return level, {(r, c) for r in rows for c in columns}


def bucketize(bboxes):
    """Partition bbox indices into groups of mutually disjoint bboxes.

    Single-pass first-fit shelf packing: features are shelved by
    power-of-two size level; within a shelf, a feature joins the first
    group whose occupied grid cells it does not touch.  Conservative (cell
    contact counts as overlap) and fast (no pairwise bbox intersections).
    """
    shelves = defaultdict(list)  # level -> [(occupied_cells, indices), ...]
    for index, bbox in enumerate(bboxes):
        level, cells = _footprint(bbox)
        for occupied, members in shelves[level]:
            if occupied.isdisjoint(cells):
                occupied |= cells
                members.append(index)
                break
        else:
            shelves[level].append((set(cells), [index]))
    return [members for shelf in shelves.values() for _, members in shelf]


def plan_aggregation_grid(bbox, cell, budget, allow_coarsen):
    """Fit a (0, 0)-anchored pixel grid of size ``cell`` over ``bbox``.

    When the grid would exceed ``budget`` pixels, the cell coarsens by the
    smallest sufficient integer factor (``allow_coarsen``) or the request
    is refused.  Returns ``(actual_cell, snapped_bbox, width, height)``.
    """
    x1, y1, x2, y2 = bbox
    demand = int((x2 - x1) * (y2 - y1) / cell**2)
    if demand > budget:
        if not allow_coarsen:
            raise RuntimeError(
                "The required raster size for the aggregation exceeded "
                "the maximum ({} > {})".format(demand, budget)
            )
        cell *= ceil(sqrt(demand / budget))
    snapped = (
        floor(x1 / cell) * cell,
        floor(y1 / cell) * cell,
        ceil(x2 / cell) * cell,
        ceil(y2 / cell) * cell,
    )
    width = max(int((snapped[2] - snapped[0]) / cell), 1)
    height = max(int((snapped[3] - snapped[1]) / cell), 1)
    return cell, snapped, width, height


def _masked_frame(frame, no_data_value, labels, label_fill, thresholds):
    """Boolean mask of cells participating in this frame's statistics."""
    active = frame != no_data_value
    if thresholds is not None:
        valid = ~np.isnan(thresholds)
        active[~valid] = False
        active[valid] &= frame[valid] >= thresholds[valid]
    active &= labels != label_fill
    return active


def _device_labels(geometries, groups, agg_bbox, agg_srs, height, width, label_fill, device):
    """(groups, h, w) int32 label planes on ``device``: the polygonal groups
    burned there (ops/segment.py:rasterize_labels), a group holding a line
    or a point burned by the host scanline and copied up."""
    from dask_geomodeling_tpu_torch.ops.segment import polygon_edges, rasterize_labels

    gt = GeoTransform.from_bbox(agg_bbox, height, width)
    starts, ends, owners, planes, host_planes = [], [], [], [], []
    for plane, group in enumerate(groups):
        edges = polygon_edges(geometries.iloc[group])
        if edges is None:
            host_planes.append(plane)
            continue
        starts.append(edges[0])
        ends.append(edges[1])
        owners.append(np.asarray(group, np.int64)[edges[2]])
        planes.append(np.full(len(edges[2]), plane, np.int64))
    labels = rasterize_labels(
        np.concatenate(starts) if starts else np.zeros((0, 2)),
        np.concatenate(ends) if ends else np.zeros((0, 2)),
        np.concatenate(owners) if owners else np.zeros(0, np.int64),
        np.concatenate(planes) if planes else np.zeros(0, np.int64),
        len(groups), gt, height, width, label_fill, device,
    )
    for plane in host_planes:
        group = groups[plane]
        burned = rasterize_geoseries(
            geometries.iloc[group], agg_bbox, agg_srs, height, width,
            values=np.asarray(group, dtype=np.int32),
        )
        labels[plane] = torch.from_numpy(burned["values"][0]).to(device)
    return labels


def _aggregate_on_device(geometries, values, no_data_value, agg_bbox, agg_srs,
                         threshold_values, statistic, percentile):
    """aggregate_polygons for a (t, h, w) tensor: the label planes and the
    statistics on its device; returns (agg, uncovered) on the host."""
    from dask_geomodeling_tpu_torch.ops.segment import labeled_statistics

    depth, height, width = values.shape
    n = len(geometries)
    groups = bucketize(geometries.bounds.values)
    # the host path's label fill: rasterize_geoseries burns int32 labels
    label_fill = int(np.iinfo(np.int32).max)
    labels = _device_labels(
        geometries, groups, agg_bbox, agg_srs, height, width, label_fill, values.device
    )
    q = 50.0 if statistic == "median" or percentile is None else float(percentile)
    agg, covered = labeled_statistics(
        values, labels, label_fill, no_data_value, threshold_values, n, statistic, q
    )
    covered = covered.cpu().numpy()
    return agg.cpu().numpy(), [i for i in range(n) if not covered[i]]


def aggregate_polygons(
    geometries,
    values,
    no_data_value,
    agg_bbox,
    agg_srs,
    threshold_values,
    statistic,
    percentile,
):
    """Aggregate the raster inside each geometry (pixel-center coverage).

    Returns (agg array of shape (t, n_geometries), indices covering no cell).
    """
    reducer = STATISTIC_REGISTRY[statistic][0]
    if statistic == "percentile":
        reducer = partial(reducer, qval=percentile)
    if threshold_values is not None:
        # appending NaN lets np.take(..., mode="clip") mark unlabeled cells
        threshold_values = np.append(threshold_values, np.nan).astype(
            threshold_values.dtype
        )

    if isinstance(values, torch.Tensor):
        return _aggregate_on_device(
            geometries, values, no_data_value, agg_bbox, agg_srs, threshold_values,
            statistic, percentile,
        )

    depth, height, width = values.shape
    n = len(geometries)
    uncovered = set()
    agg = np.full((depth, n), np.nan, dtype="f4")

    for group in bucketize(geometries.bounds.values):
        burned = rasterize_geoseries(
            geometries.iloc[group],
            agg_bbox,
            agg_srs,
            height,
            width,
            values=np.asarray(group, dtype=np.int32),
        )
        labels = burned["values"][0]
        label_fill = burned["no_data_value"]
        covered = set(np.unique(labels[labels != label_fill]).tolist())
        uncovered |= set(group) - covered
        if not covered:
            continue

        thresholds = (
            np.take(threshold_values, labels, mode="clip")
            if threshold_values is not None
            else None
        )

        for frame_no, frame in enumerate(values):
            active = _masked_frame(
                frame, no_data_value, labels, label_fill, thresholds
            )
            if not active.any():
                continue

            active_labels = labels[active]
            hit = list(set(np.unique(active_labels)) & set(group))
            if hit:
                # ndimage's std/var warn on internal empty divisions even
                # though every hit label has cells; the results are exact
                with np.errstate(invalid="ignore", divide="ignore"):
                    agg[frame_no][hit] = reducer(
                        1 if statistic == "count" else frame[active],
                        labels=active_labels,
                        index=hit,
                    )

    return agg, list(uncovered)


def aggregate_points(
    points, values, no_data_value, agg_bbox, threshold_values, statistic
):
    """Aggregate by sampling the raster at point coordinates; a tensor's
    (t, n_points) sample is gathered on its device and copied alone."""
    _, height, width = values.shape
    gt = GeoTransform.from_bbox(agg_bbox, height, width)
    i_y, i_x = gt.get_indices(np.array([points.x.values, points.y.values]).T)
    i_y, i_x = np.clip(i_y, 0, height - 1), np.clip(i_x, 0, width - 1)
    if isinstance(values, torch.Tensor):
        sampled = values[:, torch.from_numpy(i_y).to(values.device),
                         torch.from_numpy(i_x).to(values.device)].cpu().numpy()
    else:
        sampled = values[:, i_y, i_x]

    active = sampled != no_data_value
    if threshold_values is not None:
        per_point = np.broadcast_to(threshold_values[np.newaxis, :], sampled.shape)
        with np.errstate(invalid="ignore"):
            active &= ~np.isnan(per_point) & (sampled >= per_point)

    agg = sampled.astype("f4")
    agg[~active] = np.nan
    if statistic == "count":
        agg[active] = 1.0
    return agg


class AggregateRaster(GeometryBlock):
    """Compute a per-feature statistic of a raster (zonal statistics).

    Args:
      source (GeometryBlock): features to aggregate in
      raster (RasterBlock): raster to sample
      statistic (str): sum count min max mean median p<percentile>
      projection (str): aggregation projection (default: raster native)
      pixel_size (float): aggregation cell size (default: raster native)
      max_pixels (int): pixel budget (default the config's
        ``geomodeling.raster-limit``, 12 Mpx)
      column_name (str): output column (default "agg")
      auto_pixel_size (bool): coarsen automatically when over budget
    """

    # kept for API parity with the reference's class attribute
    STATISTICS = {
        name: {"func": func, "extensive": extensive}
        for name, (func, extensive) in STATISTIC_REGISTRY.items()
    }

    def __init__(
        self,
        source,
        raster,
        statistic="sum",
        projection=None,
        pixel_size=None,
        max_pixels=None,
        column_name="agg",
        auto_pixel_size=False,
        *args
    ):
        expect_instance(source, GeometryBlock, "source")
        expect_instance(raster, RasterBlock, "raster")
        expect_instance(statistic, str, "statistic")
        statistic, percentile = parse_percentile_statistic(statistic.lower())
        if percentile is not None:
            statistic = "p{0}".format(percentile)
        elif statistic not in STATISTIC_REGISTRY or statistic == "percentile":
            raise ValueError("Unknown statistic '{}'".format(statistic))

        if projection is None:
            projection = raster.projection
        expect_instance(projection, str, "projection")

        pixel_size = self._resolve_pixel_size(pixel_size, raster)

        if max_pixels is not None:
            max_pixels = int(max_pixels)
        expect_instance(auto_pixel_size, bool, "auto_pixel_size")

        super().__init__(
            source,
            raster,
            statistic,
            projection,
            pixel_size,
            max_pixels,
            column_name,
            auto_pixel_size,
            *args
        )

    @staticmethod
    def _resolve_pixel_size(pixel_size, raster):
        if pixel_size is None:
            geo_transform = raster.geo_transform
            if geo_transform is None:
                raise ValueError(
                    "Cannot get the pixel_size from the source "
                    "raster. Please provide a pixel_size."
                )
            return min(abs(float(geo_transform[1])), abs(float(geo_transform[5])))
        pixel_size = abs(float(pixel_size))
        if pixel_size == 0.0:
            raise ValueError("Pixel size cannot be 0")
        return pixel_size

    source = arg(0)
    raster = arg(1)
    statistic = arg(2)
    projection = arg(3, "projection the aggregation grid lives in")
    pixel_size = arg(4, "requested aggregation cell size")
    max_pixels = arg(5)
    column_name = arg(6)
    auto_pixel_size = arg(7)

    @property
    def columns(self):
        return self.source.columns | {self.column_name}

    def get_sources_and_requests(self, **request):
        if request.get("mode") == "extent":
            return [(self.source, request), (None, None), ({"mode": "extent"}, None)]

        req_srs = request["projection"]
        agg_srs = self.projection

        # pre-flight: the features' extent scopes the raster read
        extent = self.source.get_data(**{**request, "mode": "extent"})["extent"]
        if extent is None:
            empty = {"empty": True, "projection": req_srs}
            return [(None, None), (None, None), (empty, None)]

        budget = self.max_pixels
        if budget is None:
            budget = config.get("geomodeling.raster-limit")
        cell, agg_bbox, width, height = plan_aggregation_grid(
            Extent(extent, req_srs).transformed(agg_srs).bbox,
            self.pixel_size,
            budget,
            self.auto_pixel_size,
        )

        raster_request = self._raster_request(
            request, agg_srs, agg_bbox, width, height
        )
        plan = {
            "mode": request.get("mode", "intersects"),
            "pixel_size": self.pixel_size,
            "agg_srs": agg_srs,
            "req_srs": req_srs,
            "actual_pixel_size": cell,
            "statistic": self.statistic,
            "result_column": self.column_name,
            "agg_bbox": agg_bbox,
        }
        return [(self.source, request), (self.raster, raster_request), (plan, None)]

    @staticmethod
    def _raster_request(request, agg_srs, agg_bbox, width, height):
        if width == 1 and height == 1:
            # single-cell grids become true point requests (no edge effects)
            x1, y1, x2, y2 = agg_bbox
            bbox = ((x1 + x2) / 2, (y1 + y2) / 2) * 2
        else:
            bbox = agg_bbox
        raster_request = {
            "mode": "vals",
            "projection": agg_srs,
            "start": request.get("start"),
            "stop": request.get("stop"),
            "bbox": bbox,
            "width": width,
            "height": height,
        }
        if "time_resolution" in request:
            raster_request["time_resolution"] = request["time_resolution"]
        return raster_request

    @staticmethod
    def process(geom_data, raster_data, plan):
        if plan.get("empty"):
            return {
                "features": GeoDataFrame([]),
                "projection": plan["projection"],
            }
        if plan["mode"] == "extent":
            return geom_data

        features = geom_data["features"]
        if len(features) == 0:
            return geom_data
        result = features.copy()

        statistic, percentile = parse_percentile_statistic(plan["statistic"])
        extensive = STATISTIC_REGISTRY[statistic][1]
        column = plan["result_column"]

        threshold_column = plan.get("threshold_name")
        thresholds = (
            features[threshold_column].values.astype("f4")
            if threshold_column
            else None
        )

        values = raster_data["values"] if raster_data is not None else None
        no_data_value = (
            raster_data["no_data_value"] if raster_data is not None else None
        )
        # a tensor's test runs on its device (one scalar comes back), in
        # numpy's promoted dtype
        if values is None or _all_nodata(values, no_data_value):
            result[column] = 0 if extensive else np.nan
            return {"features": result, "projection": plan["req_srs"]}

        geometry = features.geometry
        geometry.crs = plan["req_srs"]
        agg_geometries = geometry.to_crs(plan["agg_srs"])

        agg, uncovered = aggregate_polygons(
            agg_geometries,
            values,
            no_data_value,
            plan["agg_bbox"],
            plan["agg_srs"],
            thresholds,
            statistic,
            percentile,
        )
        if uncovered:
            # features without any covered cell center: centroid sampling
            agg[:, uncovered] = aggregate_points(
                agg_geometries.iloc[uncovered].centroid,
                values,
                no_data_value,
                plan["agg_bbox"],
                None if thresholds is None else thresholds[uncovered],
                statistic,
            )

        if extensive:
            agg[~np.isfinite(agg)] = 0
            # sum/count scale with the cell area under auto coarsening
            scale = plan["actual_pixel_size"] / plan["pixel_size"]
            if scale != 1:
                agg *= scale**2
        else:
            agg[~np.isfinite(agg)] = np.nan

        if values.shape[0] == 1:
            result[column] = agg[0]
        else:
            # multiband: store the per-feature time series as a list cell
            result[column] = [[x] for x in agg.T]
        return {"features": result, "projection": plan["req_srs"]}


def _all_nodata(values, no_data_value):
    if isinstance(values, torch.Tensor):
        return bool(compare("equal", values, no_data_value).all())
    return bool((values == no_data_value).all())


# compute_torch hands AggregateRaster its raster as the device tensor it
# is: aggregate_polygons masks and reduces it there, and no frame crosses
# to the host
AggregateRaster.process.torch_accepts_device_tensors = True


class AggregateRasterAboveThreshold(AggregateRaster):
    """AggregateRaster with a per-feature threshold column: only raster
    values >= the feature's threshold are aggregated."""

    def __init__(
        self,
        source,
        raster,
        statistic="sum",
        projection=None,
        pixel_size=None,
        max_pixels=None,
        column_name="agg",
        auto_pixel_size=False,
        threshold_name=None,
    ):
        expect_instance(threshold_name, str, "threshold_name")
        if threshold_name not in source.columns:
            raise KeyError("Column '{}' is not available".format(threshold_name))
        super().__init__(
            source,
            raster,
            statistic,
            projection,
            pixel_size,
            max_pixels,
            column_name,
            auto_pixel_size,
            threshold_name,
        )

    threshold_name = arg(8)

    def get_sources_and_requests(self, **request):
        plan_sources = super().get_sources_and_requests(**request)
        plan_sources[2][0]["threshold_name"] = self.threshold_name
        return plan_sources
