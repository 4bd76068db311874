"""Group: its two merge plans carried across from the JAX package and held
on the CPU against its numpy executor (``compute_host``, and the torch
twin through ``get_data`` and ``evaluate_tiled``, bitwise), and where
noted against its jax executor too.

``by_bands`` merges sources that tick on one clock (band slices of the
result stack); ``by_time`` merges the others through mode='time'
subrequests, which run on the host (their answers hold no pixels) while
the vals merge runs on the device.
"""
from datetime import datetime, timedelta

import numpy as np
import pytest

from dask_geomodeling_tpu import raster as R
from dask_geomodeling_tpu_torch import compute_host, from_reference
from tests.test_torch_elemwise import REQUEST, assert_views_agree, source


def _shifted(dtype, seed, hours, bands=3, step=1):
    """A source like ``source`` whose first frame is ``hours`` after
    2000-01-01, ``step`` hours apart."""
    base = source(dtype, seed=seed, bands=bands)
    return R.MemorySource(
        data=base.data,
        no_data_value=base.no_data_value,
        projection="EPSG:28992",
        pixel_size=1.0,
        pixel_origin=(135000.0, 456000.0),
        time_first=datetime(2000, 1, 1) + timedelta(hours=hours),
        time_delta=timedelta(hours=step),
    )


WINDOW = dict(REQUEST, start=datetime(2000, 1, 1), stop=datetime(2000, 1, 1, 6))


@pytest.mark.parametrize("dtypes", [("float32", "float32"), ("uint8", "float32"), ("int16", "uint8")])
def test_by_bands(dtypes):
    """Aligned hourly sources, the second starting two hours later."""
    view = R.Group(_shifted(dtypes[0], 0, 0), _shifted(dtypes[1], 1, 2))
    result = assert_views_agree(view, WINDOW, jax_twin=dtypes == ("float32", "float32"))
    assert result["values"].shape[0] == 5  # hours 0-4


@pytest.mark.parametrize("dtypes", [("float32", "float32"), ("uint8", "float64")])
def test_by_time(dtypes):
    """Unaligned clocks (hourly and every two hours, shifted): the time
    axis is the union of both sources' frames."""
    view = R.Group(_shifted(dtypes[0], 0, 0), _shifted(dtypes[1], 1, 1, step=2))
    result = assert_views_agree(view, WINDOW, jax_twin=dtypes == ("float32", "float32"))
    assert result["values"].shape[0] == 5  # hours 0, 1, 2, 3, 5


def test_by_time_single_frame_sources():
    """Sources without a time axis merge by time, last source winning."""
    view = R.Group(source("float32", bands=1), R.MaskBelow(source("float32", seed=1, bands=1), 15.0))
    request = dict(REQUEST, stop=None)
    result = assert_views_agree(view, request, jax_twin=True)
    assert result["values"].shape[0] == 1


@pytest.mark.parametrize("start", [datetime(2000, 1, 1, 3), datetime(1999, 12, 31), None])
def test_requests_without_stop_take_one_band(start):
    for view in (R.Group(_shifted("float32", 0, 0), _shifted("float32", 1, 2)),
                 R.Group(_shifted("float32", 0, 0), _shifted("uint8", 1, 1, step=2))):
        request = dict(REQUEST, start=start, stop=None)
        result = assert_views_agree(view, request)
        assert result["values"].shape[0] == 1


def test_group_of_booleans_and_integers():
    flags = R.Greater(source("float32"), 15.0)
    assert_views_agree(R.Group(R.Add(flags, 1), source("uint8", seed=1)))


def test_no_overlap_is_empty():
    view = R.Group(_shifted("float32", 0, 0), _shifted("float32", 1, 2))
    request = dict(REQUEST, start=datetime(2001, 1, 1), stop=datetime(2001, 1, 2))
    assert assert_views_agree(view, request) is None


@pytest.mark.parametrize("mode", ["time", "meta"])
def test_time_and_meta_requests(mode):
    views = [R.Group(_shifted("float32", 0, 0), _shifted("float32", 1, 2))]
    if mode == "time":  # (a by_time meta request of sources without metadata fails in numpy)
        views.append(R.Group(_shifted("float32", 0, 0), _shifted("uint8", 1, 1, step=2)))
    for view in views:
        request = dict(WINDOW, mode=mode)
        port_view = from_reference(view.serialize())
        expected = view.get_data(**request)
        assert compute_host(*port_view.get_compute_graph(**request)) == expected
        assert port_view.get_data(device="cpu", **request) == expected
        assert port_view.period == view.period and port_view.timedelta == view.timedelta
        np.testing.assert_allclose(port_view.extent, view.extent)
