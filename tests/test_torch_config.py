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
    } | set(FILE_KEYS) | set(VECTOR_KEYS) | set(SERVING_KEYS) | set(ROUTING_KEYS) \
        | set(SCHEDULER_KEYS) | set(CRS_KEYS) | set(GEOMETRY_KEYS)
    assert defaults["geomodeling.torch-device"] == "cuda"
    for key in (
        "geomodeling.tile-size",
        "geomodeling.tile-batch",
        "geomodeling.warp-interpolation",
    ) + FILE_KEYS + VECTOR_KEYS + CRS_KEYS + GEOMETRY_KEYS:
        assert defaults[key] == jax_config_module.defaults[key], key


#: the file layer's keys: the sandbox, the windowed reads, the overviews
FILE_KEYS = (
    "geomodeling.root",
    "geomodeling.strict-file-paths",
    "geomodeling.windowed-read-limit",
    "geomodeling.use-overviews",
)


#: the vector file layer's keys: the geometry limit, the R-tree reads,
#: the partial files of a geometry export
VECTOR_KEYS = (
    "geomodeling.geometry-limit",
    "geomodeling.vector-windowed-read-limit",
    "temporary_directory",
)


#: the serving keys: the result cache, raw view JSON in WMS layers, the
#: import guard (the JAX package reads the last with a default of None
#: and lists it in no defaults)
SERVING_KEYS = (
    "geomodeling.result-cache-size",
    "geomodeling.wms-json-layers",
    "geomodeling.block-import-paths",
)


#: the router's keys: the executor switch, its size gate and margin
#: (measured on the card, chip_smoke.py's auto-routing phase), and its
#: state file
ROUTING_KEYS = (
    "geomodeling.executor",
    "geomodeling.auto-min-device-px",
    "geomodeling.auto-margin",
    "geomodeling.router-state",
)

#: the host schedulers' keys
SCHEDULER_KEYS = ("scheduler", "geomodeling.scheduler-memory-limit")

#: the CRS layer's key: NTv2 grids per datum (geo/ntv2.py)
CRS_KEYS = ("geomodeling.ntv2-grids",)

#: the geometry blocks' key: AggregateRaster's pixel budget
GEOMETRY_KEYS = ("geomodeling.raster-limit",)


def test_routing_keys_default_to_the_card_and_a_state_file_of_the_port():
    """The port runs on the card unless asked otherwise (the JAX package
    defaults to "auto"), and its router never reads the JAX package's
    measured rates."""
    defaults = port_config_module.defaults
    assert defaults["geomodeling.executor"] == "torch"
    assert jax_config_module.defaults["geomodeling.executor"] == "auto"
    state = defaults["geomodeling.router-state"]
    assert "dask_geomodeling_tpu_torch" in state
    assert state != jax_config_module.defaults["geomodeling.router-state"]
    assert defaults["geomodeling.auto-min-device-px"] > 0
    assert defaults["geomodeling.auto-margin"] >= 1.0


@pytest.mark.parametrize("key", SCHEDULER_KEYS)
def test_scheduler_keys_have_the_jax_defaults(key):
    assert port_config_module.defaults[key] == jax_config_module.defaults[key]


@pytest.mark.parametrize("key", FILE_KEYS + VECTOR_KEYS)
def test_file_keys_have_the_jax_defaults(key):
    assert port_config_module.defaults[key] == jax_config_module.defaults[key]
    assert port_config_module.config.get(key) == jax_config_module.config.get(key)


@pytest.mark.parametrize("key", SERVING_KEYS)
def test_serving_keys_have_the_jax_defaults(key):
    # the JAX package's live value is not read: tests/test_wms.py leaves
    # geomodeling.block-import-paths set in its config, which a later file
    # on the same worker sees
    assert port_config_module.defaults[key] == jax_config_module.defaults.get(key)
    assert port_config_module.config.get(key) == jax_config_module.defaults.get(key)


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


#: environ dicts for ``_env_overrides``: the JAX package's own case, and
#: the edges of its convention (nesting, literals, plain strings, an empty
#: name, other DASK_ variables)
ENVIRONS = {
    "jax-case": {
        "DASK_GEOMODELING__RASTER_LIMIT": "123",
        "DASK_GEOMODELING__USE_OVERVIEWS": "True",
        "DASK_GEOMODELING__ROOT": "/data",
        "DASK_SCHEDULER": "threads",
        "UNRELATED": "1",
    },
    "nested-and-literals": {
        "DASK_GEOMODELING__NTV2_GRIDS": "{'NZGD49': '/grids/nz.gsb'}",
        "DASK_GEOMODELING__WARP__APPROX_STRIDE": "(8, 8)",
        "DASK_GEOMODELING__AUTO_MARGIN": "1.5e0",
        "DASK_GEOMODELING__EXECUTOR": "numpy",
        "DASK_GEOMODELING__ROUTER_STATE": "None",
        "DASK_GEOMODELING__TILE_SIZE": "not a literal (",
    },
    "ignored": {
        "DASK_GEOMODELING__": "1",
        "DASK_DISTRIBUTED__WORKERS": "4",
        "dask_geomodeling__raster_limit": "5",
        "DASK_SCHEDULER_ADDRESS": "tcp://x",
    },
    "empty": {},
}


@pytest.mark.parametrize("case", sorted(ENVIRONS))
def test_env_overrides_as_the_jax_package(case):
    environ = ENVIRONS[case]
    port = port_config_module._env_overrides(environ)
    assert port == jax_config_module._env_overrides(environ)
    assert all(key == "scheduler" or key.startswith("geomodeling.") for key in port)


def test_env_overrides_seed_the_config_in_a_subprocess():
    """The variables apply when the module loads, as in the JAX package,
    without importing it or jax."""
    import json
    import os
    import subprocess
    import sys

    env = dict(os.environ, DASK_GEOMODELING__RASTER_LIMIT="77", DASK_SCHEDULER="threads")
    out = subprocess.run(
        [sys.executable, "-c",
         "import json, sys; from dask_geomodeling_tpu_torch.config import config; "
         "print(json.dumps([config.get('geomodeling.raster-limit'), config.get('scheduler'), "
         "sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'dask_geomodeling_tpu'))]))"],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [77, "threads", []]
