"""Clip, Mask, MaskBelow and Step, carried across from the JAX package and
held on the CPU against its numpy executor (``compute_host`` and the torch
twins through ``get_data`` and ``evaluate_tiled``, all bitwise), and where
noted against its jax executor too.

One difference from the JAX twin is kept on purpose: an all-nodata store
clipped by a source that returns nothing comes back as it is from the
numpy process (and the port), where the JAX twin returns None.
"""
from datetime import datetime

import numpy as np
import pytest

from dask_geomodeling_tpu import raster as R
from dask_geomodeling_tpu.raster.misc import _clip_jax
from dask_geomodeling_tpu.raster.misc import _clip_process as jax_clip_process
from dask_geomodeling_tpu_torch.raster import misc
from dask_geomodeling_tpu_torch.runtime.executor import compute_torch
from tests.test_torch_elemwise import REQUEST, assert_views_agree, source


def _flags(seed, threshold=15.0):
    return R.Greater(source("float32", seed=seed), threshold)


@pytest.mark.parametrize("dtype", ["uint8", "int16", "float32", "float64"])
@pytest.mark.parametrize("mask", ["data", "bool"])
def test_clip(dtype, mask):
    clipper = R.MaskBelow(source("float32", seed=1), 15.0) if mask == "data" else _flags(1)
    result = assert_views_agree(R.Clip(source(dtype), clipper), jax_twin=dtype == "float32")
    assert (result["values"] == result["no_data_value"]).mean() > 0.05


def test_clip_of_a_boolean_store():
    assert_views_agree(R.Clip(_flags(0), _flags(1, threshold=5.0)))


def test_clip_outside_the_common_period_is_empty():
    request = dict(REQUEST, start=datetime(2001, 1, 1), stop=datetime(2001, 1, 2))
    assert assert_views_agree(R.Clip(source("uint8"), source("uint8", seed=1)), request) is None


def test_clip_all_nodata_without_a_source_follows_numpy():
    """The numpy process returns an all-nodata store unchanged even when
    the clip source gave nothing; the JAX twin returns None; the port's
    twin returns the store, as numpy does."""
    values = np.full((2, 5, 6), 255, np.uint8)
    data = {"values": values, "no_data_value": 255}
    expected = jax_clip_process(dict(data), None)
    assert expected["values"] is values
    assert _clip_jax(dict(data), None) is None
    graph = {"store": dict(data), "out": (misc._clip_process, "store", None)}
    actual = compute_torch(graph, "out", device="cpu")
    np.testing.assert_array_equal(actual["values"], values)
    assert actual["no_data_value"] == 255
    # with data in the store and no source, both give None
    data["values"] = values.copy()
    data["values"][0, 0, 0] = 1
    graph["store"] = data
    assert compute_torch(graph, "out", device="cpu") is None
    assert jax_clip_process(dict(data), None) is None


@pytest.mark.parametrize("dtype", ["uint8", "int16", "float32", "float64"])
@pytest.mark.parametrize("value", [7, 0, -3, 300, 7.5])
def test_mask(dtype, value):
    result = assert_views_agree(R.Mask(source(dtype), value), jax_twin=dtype == "float32" and value == 7)
    assert set(np.unique(result["values"]).tolist()) == {value, 1 if value == 0 else 0}


def test_mask_of_booleans():
    # a boolean store has no nodata: every cell becomes the value
    result = assert_views_agree(R.Mask(_flags(0), 5))
    assert (result["values"] == 5).all()


@pytest.mark.parametrize("dtype", ["uint8", "int16", "float32", "float64"])
@pytest.mark.parametrize("threshold", [3, 12.34, 2.5, -20, 1e9])
def test_mask_below(dtype, threshold):
    assert_views_agree(R.MaskBelow(source(dtype), threshold),
                       jax_twin=dtype == "float64" and threshold == 3)


@pytest.mark.parametrize("dtype", ["uint8", "int16", "float32", "float64"])
@pytest.mark.parametrize(
    "kwargs",
    [dict(left=1, right=2, value=3, at=5), dict(value=12.34), dict(left=1.5, right=9, value=2.5)],
)
def test_step(dtype, kwargs):
    assert_views_agree(R.Step(source(dtype), **kwargs), jax_twin=dtype == "int16")


def test_float64_thresholds_compare_in_float64():
    """A float64 raster against thresholds one step away in float64:
    MaskBelow, Step and the comparisons are bitwise on the CPU."""
    thresholds = [0.1, 1 / 3, 12.34]
    near = [np.nextafter(t, d) for t in thresholds for d in (-np.inf, np.inf)] + thresholds
    data = np.random.RandomState(0).choice(near, size=(1, 16, 20))
    store = R.MemorySource(data, -9999.0, "EPSG:28992", 1.0, (135000.0, 456000.0),
                           time_first=datetime(2000, 1, 1))
    request = dict(REQUEST, stop=None)
    for t in thresholds:
        for view in (R.MaskBelow(store, t), R.Step(store, value=t), R.Greater(store, t),
                     R.LessEqual(store, t), R.Equal(store, t)):
            assert_views_agree(view, request)
