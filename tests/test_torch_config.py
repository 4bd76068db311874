"""The port's configuration and warp constants against the JAX package's.

The port's ``Config`` behaves as the JAX package's on the same sequence of
``set``/``get`` calls; its defaults hold only the keys the port reads, at
the JAX package's values; the coarse warp stride is the JAX package's
default; and ``geomodeling.warp-interpolation`` selects nearest or
bilinear resampling, while any other value raises.
"""
import importlib

import numpy as np
import pytest

from datetime import datetime

from dask_geomodeling_tpu.ops.warp import warp_numpy as jax_warp_numpy
from dask_geomodeling_tpu_torch.ops.warp import APPROX_STRIDE, warp_numpy
from dask_geomodeling_tpu_torch.raster import MemorySource

# the modules, not the ``config`` instances the packages may export
jax_config_module = importlib.import_module("dask_geomodeling_tpu.config")
port_config_module = importlib.import_module("dask_geomodeling_tpu_torch.config")

START = {"geomodeling.tile-size": 512, "geomodeling.tile-batch": 64}

# (positional dict, keyword overrides) handed to set()
SETS = {
    "dict": ({"geomodeling.tile-size": 256}, {}),
    "keywords": (None, {"geomodeling__tile_batch": 4}),
    "new-key": ({"geomodeling.not-a-key": 1}, {}),
    "both": ({"geomodeling.tile-size": 128}, {"geomodeling__tile-batch": 2}),
}


def _run(config_cls, positional, keywords):
    """The values seen inside and after a ``set`` block, and on a miss."""
    cfg = config_cls(START)
    keys = sorted(set(START) | set(positional or {})
                  | {k.replace("__", ".") for k in keywords})
    with cfg.set(positional, **keywords) as inside:
        assert inside is cfg
        during = {k: cfg.get(k, None) for k in keys}
    after = {k: cfg.get(k, None) for k in keys}
    with pytest.raises(KeyError):
        cfg.get("geomodeling.not-a-key")
    return during, after


@pytest.mark.parametrize("case", sorted(SETS))
def test_set_and_restore_as_the_jax_package(case):
    positional, keywords = SETS[case]
    port = _run(port_config_module.Config, positional, keywords)
    jax = _run(jax_config_module.Config, positional, keywords)
    assert port == jax
    during, after = port
    assert after == {k: START.get(k) for k in after}
    assert during != after


def test_defaults_are_the_keys_the_port_reads():
    defaults = port_config_module.defaults
    assert set(defaults) == {
        "geomodeling.torch-device",
        "geomodeling.tile-size",
        "geomodeling.tile-batch",
        "geomodeling.warp-interpolation",
    }
    assert defaults["geomodeling.torch-device"] == "cuda"
    for key in (
        "geomodeling.tile-size",
        "geomodeling.tile-batch",
        "geomodeling.warp-interpolation",
    ):
        assert defaults[key] == jax_config_module.defaults[key], key


def test_approx_stride_is_the_jax_default():
    assert APPROX_STRIDE == jax_config_module.defaults["geomodeling.warp-approx-stride"]


def test_warp_numpy_refuses_other_resampling():
    """Nearest and bilinear are both selected (each equal to the JAX
    package's warp_numpy, and different from each other on a half-pixel
    shift); any other resampling raises, in warp_numpy and through the
    config key."""
    values = np.arange(16, dtype=np.float32).reshape(1, 4, 4) * 3
    args = (values, (0.0, 1.0, 0.0, 4.0, 0.0, -1.0), "EPSG:28992", -1.0,
            (0.5, 0.0, 3.5, 3.0), "EPSG:28992", 3, 3)
    results = {}
    for interpolation in ("nearest", "bilinear"):
        results[interpolation] = warp_numpy(*args, interpolation=interpolation)
        np.testing.assert_array_equal(
            results[interpolation], jax_warp_numpy(*args, interpolation=interpolation)
        )
    assert not np.array_equal(results["nearest"], results["bilinear"])
    with pytest.raises(ValueError, match="cubic"):
        warp_numpy(*args, interpolation="cubic")

    source = MemorySource(values, -1.0, "EPSG:28992", 1.0, (0.0, 4.0))
    request = dict(mode="vals", bbox=args[4], projection="EPSG:28992", width=3,
                   height=3, start=datetime(1970, 1, 1))
    for interpolation, expected in results.items():
        with port_config_module.config.set({"geomodeling.warp-interpolation": interpolation}):
            out = source.get_data(device="cpu", **request)
        np.testing.assert_array_equal(out["values"], expected)
    with port_config_module.config.set({"geomodeling.warp-interpolation": "cubic"}):
        with pytest.raises(ValueError, match="cubic"):
            source.get_data(device="cpu", **request)
