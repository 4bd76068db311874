"""The port's configuration and warp constants against the JAX package's.

The port's ``Config`` behaves as the JAX package's on the same sequence of
``set``/``get`` calls; its defaults hold only the keys the port reads, at
the JAX package's values; the coarse warp stride is the JAX package's
default; and a resampling other than nearest raises.
"""
import importlib

import numpy as np
import pytest

from dask_geomodeling_tpu_torch.ops.warp import APPROX_STRIDE, warp_numpy

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
    }
    assert defaults["geomodeling.torch-device"] == "cuda"
    for key in ("geomodeling.tile-size", "geomodeling.tile-batch"):
        assert defaults[key] == jax_config_module.defaults[key], key


def test_approx_stride_is_the_jax_default():
    assert APPROX_STRIDE == jax_config_module.defaults["geomodeling.warp-approx-stride"]


def test_warp_numpy_refuses_other_resampling():
    values = np.arange(16, dtype=np.float32).reshape(1, 4, 4)
    args = (values, (0.0, 1.0, 0.0, 4.0, 0.0, -1.0), "EPSG:28992", -1.0,
            (0.0, 0.0, 4.0, 4.0), "EPSG:28992", 4, 4)
    np.testing.assert_array_equal(warp_numpy(*args), values)
    with pytest.raises(NotImplementedError, match="bilinear"):
        warp_numpy(*args, interpolation="bilinear")
