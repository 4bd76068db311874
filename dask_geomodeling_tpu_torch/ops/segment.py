"""The device plane of the geometry side: polygon rasterization by
crossing parity, and labeled (zonal) statistics.

Counterpart of dask_geomodeling_tpu/ops/segment.py and of the JAX twin
of RasterizeWKT (``_rasterize_wkt_jax``, raster/misc.py there), which are
plain jnp; these are plain torch, held to the host's numpy ground truth
rather than to the JAX twins:

- ``rasterize_parity`` (RasterizeWKT's twin): for each grid row the
  crossings of every edge with the row's centre line, computed in
  float64 in the host scanline's order of operations
  (geo/rasterize.py:_burn_polygon_rows), -inf where an edge misses the
  row; each row's crossings sorted; ``E - searchsorted(row, x, right)``
  counts the crossings strictly right of a centre, and its parity is the
  mask.  Memory grows as rows x edges + rows x columns, in chunks of rows
  (``CHUNK_ELEMENTS``), not as the JAX twin's edges x rows x columns.
- ``rasterize_labels`` (AggregateRaster's label planes): one plane per
  ``bucketize`` group, whose members' bboxes are disjoint with cell
  contact counted as overlap.  So one even-odd pass over a plane's edges
  decides whether a centre is inside, and the owner of the first crossing
  strictly right of a centre inside is the geometry that holds it.  Each
  edge is expanded over the rows it crosses, the crossings are sorted by
  (row, x) with two stable sorts and padded per row, and one searchsorted
  gives every pixel's parity and owner.  Memory grows with the crossings
  plus rows x columns per plane; there is no loop over geometries.  The
  JAX package's ``rasterize_labels_scan`` writes a full plane per
  geometry instead.
- ``labeled_statistics``: every statistic of AggregateRaster over
  (frames x labels), held to scipy.ndimage as the host path calls it
  (geometry/aggregate.py): count by integer bincount; min and max in the
  value dtype (NaN sorts last: min skips it, max is NaN where one is
  present); sum and mean in float64 (bincount's accumulation); std and
  var with ndimage's centred second pass in float64; median by ndimage's
  ``_select`` (the two middle values added and halved in the input dtype
  for floats, in float64 for integers); ``p<q>`` by
  geo/measurements.py's linear rule, after one (label, value) sort made
  of two stable sorts.  The JAX device path casts the frames to float32
  first; this one does not.

Every arithmetic step is one torch elementwise op, so nothing is fused
into an FMA.  Float64 ``index_add_`` on CUDA accumulates with atomics, so
sums, means, variances and deviations may differ from the host's
sequential sums in their last float64 bits (at most one float32 ulp after
the rounding to float32); on the CPU it accumulates in order and matches.
"""
import numpy as np
import torch

from dask_geomodeling_tpu_torch.device import compare, divide

__all__ = [
    "polygon_edges",
    "rasterize_parity",
    "rasterize_labels",
    "labeled_statistics",
    "CHUNK_ELEMENTS",
]

#: float64 elements of one chunk of rows x edges (rasterize_parity) or of
#: rows x columns (rasterize_labels): 128 MiB, a memory cap of the card's,
#: not a limit on the number of vertices
CHUNK_ELEMENTS = 2**24


def polygon_edges(geometries):
    """Host work: the float64 (E, 2) starts and ends of every ring edge of
    the polygonal ``geometries``, and the (E,) position of the geometry
    each edge belongs to; None when one is not polygonal (lines and
    points keep the host scanline).  Empty geometries give no edges."""
    from dask_geomodeling_tpu_torch.geo.geometry import _polygonize

    starts, ends, owners = [], [], []
    for position, geom in enumerate(geometries):
        if geom is None or geom.is_empty:
            continue
        polys = _polygonize(geom)
        if not polys:
            return None
        for poly in polys:
            for ring in poly._rings():
                ring = np.asarray(ring, np.float64)
                starts.append(ring[:-1])
                ends.append(ring[1:])
                owners.append(np.full(len(ring) - 1, position, np.int64))
    if not starts:
        empty = np.zeros((0, 2), np.float64)
        return empty, empty, np.zeros(0, np.int64)
    return np.concatenate(starts), np.concatenate(ends), np.concatenate(owners)


def _crossing(x1, y1, x2, y2, yc):
    """x of an edge's crossing with the centre line y = yc, in the host
    scanline's order: x1 + ((yc - y1) * (x2 - x1)) / (y2 - y1)."""
    return x1 + ((yc - y1) * (x2 - x1)) / (y2 - y1)


def centres(origin, step, count, device):
    """Pixel-centre coordinates ``origin + step * (i + 0.5)`` as the host
    computes them (GeoTransform.from_bbox, geo/rasterize.py): float64,
    ``origin`` and ``step`` scalars or (B,) tensors (one row each)."""
    i = torch.arange(count, dtype=torch.float64, device=device) + 0.5
    if isinstance(origin, torch.Tensor):
        return origin[:, None] + step[:, None] * i[None, :]
    return origin + step * i


def rasterize_parity(starts, ends, y_centres, x_centres):
    """(R, w) bool: whether each pixel centre is inside the rings (even-odd
    over all edges), for R rows with centre lines ``y_centres`` (R,) and
    column centres ``x_centres`` (R, w), float64 tensors on one device.
    ``starts``/``ends`` are (E, 2) float64 tensors there."""
    rows, width = x_centres.shape
    inside = torch.zeros((rows, width), dtype=torch.bool, device=x_centres.device)
    n_edges = starts.shape[0]
    if n_edges == 0 or rows == 0:
        return inside
    x1, y1 = starts[:, 0], starts[:, 1]
    x2, y2 = ends[:, 0], ends[:, 1]
    chunk = max(1, CHUNK_ELEMENTS // max(n_edges, width))
    for lo in range(0, rows, chunk):
        yc = y_centres[lo : lo + chunk, None]  # (r, 1)
        crosses = (y1 > yc) != (y2 > yc)  # (r, E)
        xint = torch.where(crosses, _crossing(x1, y1, x2, y2, yc), -torch.inf)
        xint = torch.sort(xint, dim=1).values
        right = n_edges - torch.searchsorted(
            xint, x_centres[lo : lo + chunk].contiguous(), right=True
        )
        inside[lo : lo + chunk] = (right % 2) == 1
    return inside


def rasterize_labels(starts, ends, owners, planes, n_planes, gt, height, width, fill, device):
    """(n_planes, height, width) int32 label planes on ``device``.

    ``starts``/``ends`` (E, 2) float64, ``owners`` (E,) the label each edge
    burns and ``planes`` (E,) its plane, numpy arrays; ``gt`` the grid's
    geotransform; ``fill`` the label of pixels no geometry holds.  Within
    a plane the geometries must have disjoint bboxes (``bucketize``)."""
    p, a, _, q, _, d = (float(v) for v in gt)
    labels = torch.full((n_planes, height, width), fill, dtype=torch.int32, device=device)
    keep = starts[:, 1] != ends[:, 1]  # horizontal edges never cross a centre line
    if not keep.any():
        return labels
    f64 = dict(dtype=torch.float64, device=device)
    x1 = torch.as_tensor(starts[keep, 0], **f64)
    y1 = torch.as_tensor(starts[keep, 1], **f64)
    x2 = torch.as_tensor(ends[keep, 0], **f64)
    y2 = torch.as_tensor(ends[keep, 1], **f64)
    owner = torch.as_tensor(owners[keep], dtype=torch.int32, device=device)
    plane = torch.as_tensor(planes[keep], dtype=torch.int64, device=device)

    # the rows whose centre line an edge may cross: min(y) <= yc < max(y)
    # with yc = q + d * (row + 0.5), widened by the rounding of the
    # inversion; the exact test below decides
    r1 = divide(torch.minimum(y1, y2) - q, d) - 0.5
    r2 = divide(torch.maximum(y1, y2) - q, d) - 0.5
    first = torch.floor(torch.minimum(r1, r2)).clamp(0, height).to(torch.int64)
    last = torch.ceil(torch.maximum(r1, r2)).clamp(-1, height - 1).to(torch.int64)
    count = (last - first + 1).clamp(min=0)
    edge = torch.repeat_interleave(torch.arange(len(count), device=device), count)
    start_of = torch.repeat_interleave(torch.cumsum(count, 0) - count, count)
    row = first[edge] + (torch.arange(len(edge), device=device) - start_of)
    yc = q + d * (row.to(torch.float64) + 0.5)
    ey1, ey2 = y1[edge], y2[edge]
    crosses = (ey1 > yc) != (ey2 > yc)
    edge, row, yc = edge[crosses], row[crosses], yc[crosses]
    xint = _crossing(x1[edge], y1[edge], x2[edge], y2[edge], yc)
    line = plane[edge] * height + row  # one centre line per (plane, row)

    # sort by (line, x): x first, then line, both stable
    order = torch.sort(xint, stable=True).indices
    order = order[torch.sort(line[order], stable=True).indices]
    xint, line, owner = xint[order], line[order], owner[edge[order]]
    per_line = torch.bincount(line, minlength=n_planes * height)
    cmax = int(per_line.max()) if len(line) else 0
    if cmax == 0:
        return labels
    slot = torch.arange(len(line), device=device) - (torch.cumsum(per_line, 0) - per_line)[line]
    padded = torch.full((n_planes * height, cmax), torch.inf, **f64)
    padded[line, slot] = xint
    owners_padded = torch.full((n_planes * height, cmax), fill, dtype=torch.int32, device=device)
    owners_padded[line, slot] = owner

    x_centres = centres(p, a, width, device)
    flat = labels.view(n_planes * height, width)
    chunk = max(1, CHUNK_ELEMENTS // width)
    for lo in range(0, n_planes * height, chunk):
        hi = min(lo + chunk, n_planes * height)
        below = torch.searchsorted(
            padded[lo:hi], x_centres.expand(hi - lo, width).contiguous(), right=True
        )
        inside = ((per_line[lo:hi, None] - below) % 2) == 1
        owned = owners_padded[lo:hi].gather(1, below.clamp(max=cmax - 1))
        flat[lo:hi] = torch.where(inside, owned, fill)
    return labels


def _participating(values, no_data_value, thresholds):
    """(t, K) bool: the cells that take part, as geometry/aggregate.py's
    _masked_frame decides, in numpy's promoted dtypes: not nodata and, with
    per-cell float32 ``thresholds`` (K,) (NaN where none), at or above the
    threshold."""
    active = compare("not_equal", values, no_data_value)
    if thresholds is not None:
        active &= ~torch.isnan(thresholds)[None, :]
        active &= compare("greater_equal", values, thresholds[None, :].expand_as(values))
    return active


def labeled_statistics(values, labels, label_fill, no_data_value, thresholds, num_labels,
                       statistic, q=50.0):
    """(t, num_labels) float32 statistics of (t, h, w) ``values`` over the
    (planes, h, w) int32 ``labels`` (``label_fill`` where unlabeled), NaN
    for labels without participating cells; and the (num_labels,) bool
    ``covered``: labels holding at least one cell.

    ``thresholds`` (num_labels + 1,) float32 with NaN last, or None (the
    threshold variant).  ``statistic`` is sum count min max mean median std
    var or percentile (with ``q``).  Every label lies in one plane, so all
    planes reduce in one pass."""
    device = values.device
    frames = values.shape[0]
    flat_labels = labels.reshape(labels.shape[0], -1)
    plane, pixel = torch.nonzero(flat_labels != label_fill, as_tuple=True)
    label = flat_labels[plane, pixel].to(torch.int64)
    covered = torch.bincount(label, minlength=num_labels)[:num_labels] > 0
    cells = values.reshape(frames, -1)[:, pixel]  # (t, K), row-major per plane
    per_cell = None
    if thresholds is not None:
        table = torch.as_tensor(np.asarray(thresholds, np.float32), device=device)
        per_cell = table[label.clamp(max=len(table) - 1)]
    active = _participating(cells, no_data_value, per_cell)
    frame = torch.arange(frames, device=device)[:, None].expand_as(active)
    segment = (frame * num_labels + label[None, :])[active]
    data = cells[active]
    n_segments = frames * num_labels
    counts = torch.bincount(segment, minlength=n_segments)
    present = counts > 0
    result = _reduce(data, segment, counts, n_segments, statistic, q)
    result = torch.where(present, result.to(torch.float32), torch.nan)
    return result.view(frames, num_labels), covered


def _reduce(data, segment, counts, n_segments, statistic, q):
    """One value per segment (any dtype; rubbish where counts is 0)."""
    device = data.device
    if statistic == "count":
        return counts.to(torch.float64)
    if statistic in ("sum", "mean", "std", "var"):
        wide = data.to(torch.float64)
        sums = torch.zeros(n_segments, dtype=torch.float64, device=device)
        sums.index_add_(0, segment, wide)
        if statistic == "sum":
            return sums
        mean = sums / counts.to(torch.float64)
        if statistic == "mean":
            return mean
        centred = wide - mean[segment]
        squares = torch.zeros(n_segments, dtype=torch.float64, device=device)
        squares.index_add_(0, segment, centred * centred)
        variance = squares / counts.to(torch.float64)
        return variance if statistic == "var" else torch.sqrt(variance)
    if statistic in ("min", "max"):
        out = torch.zeros(n_segments, dtype=data.dtype, device=device)
        if data.dtype.is_floating_point:
            nan = torch.isnan(data)
            values = data[~nan]
            out.scatter_reduce_(0, segment[~nan], values, "a" + statistic, include_self=False)
            if statistic == "max":  # NaN sorts last: the maximum is NaN
                has_nan = torch.bincount(segment[nan], minlength=n_segments) > 0
                out = torch.where(has_nan, torch.nan, out)
            else:  # NaN only where every value is
                has_value = torch.bincount(segment[~nan], minlength=n_segments) > 0
                out = torch.where(has_value, out, torch.nan)
            return out
        return out.scatter_reduce_(0, segment, data, "a" + statistic, include_self=False)
    # median and percentile: sort by (segment, value), NaN last
    order = torch.sort(data, stable=True).indices
    order = order[torch.sort(segment[order], stable=True).indices]
    ordered = data[order]
    start = torch.cumsum(counts, 0) - counts
    size = counts.clamp(min=1)
    last = len(ordered) - 1
    if statistic == "median":  # ndimage's _select
        step = (size - 1) // 2
        lo = (start + step).clamp(0, last)
        hi = (start + size - 1 - step).clamp(0, last)
        if data.dtype.is_floating_point:
            return (ordered[lo] + ordered[hi]) / 2.0
        return (ordered[lo].to(torch.float64) + ordered[hi].to(torch.float64)) / 2.0
    # geo/measurements.py:percentile's linear rule
    frac = (size - 1).to(torch.float64) * (q / 100.0)
    lower = (start + torch.floor(frac).to(torch.int64)).clamp(0, last)
    upper = (start + torch.ceil(frac).to(torch.int64)).clamp(0, last)
    part = torch.fmod(frac, 1.0)
    low = ordered[lower].to(torch.float64)
    return low + part * (ordered[upper].to(torch.float64) - low)
