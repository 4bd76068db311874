"""Labeled-region percentile (scipy.ndimage-style).

Same contract as the reference's measurements.percentile
(dask_geomodeling/measurements.py:18-137): compute a percentile of ``data``
over each region of ``labels`` selected by ``index``, with linear
interpolation matching ``np.percentile``.  Implemented via a single lexsort
and per-group boundary search.  Copied from
dask_geomodeling_tpu/geo/measurements.py; ops/segment.py holds the device
counterpart that AggregateRaster's device plane uses.
"""
import numpy as np

__all__ = ["percentile"]


def percentile(data, qval, labels=None, index=None):
    """Percentile of array values over labeled regions.

    - labels None: percentile over the full array (float)
    - index None: percentile over all cells where labels > 0 (float)
    - index scalar: percentile over cells with that label (float)
    - index array: list of percentiles, one per requested label; labels
      absent from the data yield interpolation over an empty group and are
      returned as the value at the first position of the sorted array
      (matching the reference's behavior for not-found labels).
    """
    data = np.asanyarray(data)

    if labels is None:
        return np.percentile(data, qval)

    data, labels = np.broadcast_arrays(data, labels)

    if index is None:
        return np.percentile(data[labels > 0], qval)

    if np.isscalar(index):
        return np.percentile(data[labels == index], qval)

    index = np.asanyarray(index)

    # sort once: primary key label, secondary key value
    flat_data = data.ravel()
    flat_labels = labels.ravel()
    order = np.lexsort((flat_data, flat_labels))
    sorted_data = flat_data[order]
    sorted_labels = flat_labels[order]

    # group boundaries per requested label
    lo = np.searchsorted(sorted_labels, index, side="left")
    hi = np.searchsorted(sorted_labels, index, side="right")
    found = hi > lo
    size = np.where(found, hi - lo, 1)

    # linear interpolation at fractional rank (np.percentile 'linear' rule)
    frac = (size - 1) * (qval / 100.0)
    lower = lo + np.floor(frac).astype(np.int64)
    upper = lo + np.ceil(frac).astype(np.int64)
    lower = np.clip(lower, 0, sorted_data.size - 1)
    upper = np.clip(upper, 0, sorted_data.size - 1)
    part = frac % 1

    values = sorted_data[lower] + part * (
        sorted_data[upper].astype(float) - sorted_data[lower]
    )
    # not-found labels: mirror the reference (index out of data: position 0)
    values = np.where(found, values, sorted_data[0])
    return values.tolist()
