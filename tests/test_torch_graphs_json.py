"""A view as JSON (core/graphs.py): ``to_json`` and ``from_json`` against
the JAX package's, the version warning, and the import guard.

- the args encoder writes what the JAX package's writes;
- a view carried across by ``from_reference`` and sent through the port's
  JSON answers the JAX numpy executor's data;
- a graph of a newer JSON version logs the JAX package's warning;
- ``geomodeling.block-import-paths`` is checked before any import, by
  package and not by leading string, and the port never imports outside
  its own package whatever the setting (the prefix cases are in
  tests/test_torch_wms.py::test_import_guard_prefixes).
"""
import json
import logging
import sys
from datetime import datetime, timedelta

import numpy as np
import pytest

from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu.core.graphs import _BlockArgsEncoder as JaxEncoder
from dask_geomodeling_tpu.raster import MemorySource as JaxMemorySource
from dask_geomodeling_tpu.raster import Smooth as JaxSmooth
from dask_geomodeling_tpu.raster import TemporalAggregate as JaxTemporalAggregate
from dask_geomodeling_tpu_torch import compute_host, from_reference
from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.core import Block
from dask_geomodeling_tpu_torch.core.graphs import _BlockArgsEncoder


@pytest.mark.parametrize("value", [
    np.arange(6, dtype="u2").reshape(2, 3),
    np.float32(1.5),
    np.int64(-3),
    datetime(2000, 3, 26, 1, 30),
    timedelta(hours=6, seconds=1),
    {"nested": [np.float64(0.1), (1, 2), None, "x"]},
])
def test_encoder_writes_what_the_jax_encoder_writes(value):
    assert json.dumps(value, cls=_BlockArgsEncoder) == json.dumps(value, cls=JaxEncoder)


def test_encoder_refuses_what_it_cannot_write():
    for encoder in (_BlockArgsEncoder, JaxEncoder):
        with pytest.raises(TypeError):
            json.dumps(object(), cls=encoder)


def views():
    rng = np.random.RandomState(0)
    data = (rng.rand(4, 16, 16) * 10).astype("f4")
    data[:, 2:5, 3:7] = -1.0
    source = JaxMemorySource(data=data, no_data_value=-1.0, projection="EPSG:28992",
                             pixel_size=0.5, pixel_origin=(135000.0, 456008.0),
                             time_first=datetime(2000, 1, 1), time_delta=timedelta(hours=1))
    return {
        "source": source,
        "smooth": JaxSmooth(source, 1.5),
        "temporal": JaxTemporalAggregate(source, frequency="2h", statistic="max"),
    }


REQUEST = dict(mode="vals", bbox=(135000.0, 456000.0, 135008.0, 456008.0),
               projection="EPSG:28992", width=16, height=16,
               start=datetime(2000, 1, 1), stop=datetime(2000, 1, 1, 3))


@pytest.mark.parametrize("name", sorted(views()))
def test_json_round_trip_answers_the_numpy_executor(name):
    """Both packages widen float32 data to float64 lists on the way (the
    constructors coerce them again): the port's JSON view answers what the
    JAX package's JSON view answers, and a second round trip is stable."""
    from dask_geomodeling_tpu.core import Block as JaxBlock

    view = views()[name]
    text = from_reference(view.serialize()).to_json()
    assert json.loads(text)["version"] == Block.JSON_VERSION == type(view).JSON_VERSION
    again = Block.from_json(text)
    assert type(again).__name__ == type(view).__name__
    assert Block.from_json(again.to_json()).token == again.token
    with jax_config.set({"geomodeling.executor": "numpy"}):
        expected = JaxBlock.from_json(view.to_json()).get_data(**REQUEST)
    actual = again.get_data(device="cpu", **REQUEST)
    np.testing.assert_array_equal(actual["values"], expected["values"])
    assert actual["values"].dtype == expected["values"].dtype
    assert actual["no_data_value"] == expected["no_data_value"]


def test_the_port_json_names_the_port_classes():
    graph = json.loads(from_reference(views()["smooth"].serialize()).to_json())["graph"]
    paths = sorted(value[0] for value in graph.values())
    assert paths == ["dask_geomodeling_tpu_torch.raster.sources.MemorySource",
                     "dask_geomodeling_tpu_torch.raster.spatial.Smooth"]


def test_newer_version_warns(caplog):
    serialized = from_reference(views()["source"].serialize()).serialize()
    serialized["version"] = Block.JSON_VERSION + 1
    with caplog.at_level(logging.WARNING, logger="dask_geomodeling_tpu_torch.core.graphs"):
        Block.deserialize(serialized)
    assert "Deserializing a version 3 graph with a version 2 runtime" in caplog.text


def test_the_guard_runs_before_the_import(monkeypatch):
    """A path outside the allowed prefixes is refused without importing
    its module (one that does not even exist is refused the same way)."""
    import builtins

    imported = []
    original = builtins.__import__

    def recording(name, *args, **kwargs):
        if name not in sys.modules:
            imported.append(name)
        return original(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", recording)
    with config.set({"geomodeling.block-import-paths": ["dask_geomodeling_tpu_torch.raster"]}):
        for path in ("dask_geomodeling_tpu_torch.geometry.base.GeometryBlock",
                     "dask_geomodeling_tpu_torch_extra.Block",
                     "json.JSONDecoder"):
            with pytest.raises(TypeError, match="outside"):
                Block.from_import_path(path)
    assert not imported


def test_construct_refuses_a_non_block():
    with pytest.raises(TypeError, match="not a valid Block"):
        Block.from_import_path("dask_geomodeling_tpu_torch.core.graphs.construct")


@pytest.mark.parametrize("dtype", ["u1", "i2", "i8"])
def test_integer_json_source_answers_int64_with_the_jax_token(dtype):
    """An integer MemorySource + 1 sent through JSON: both packages load
    it without validation, so the integer list stays int64 (an int64
    source was coerced to int32 when it was built), the answer is int64
    and each loaded view keeps the token its JSON names; the port's and
    the JAX package's loads of the same JSON agree in token and dtype."""
    from dask_geomodeling_tpu.core import Block as JaxBlock

    data = (np.arange(256).reshape(1, 16, 16) % 9).astype(dtype)
    jax_view = JaxMemorySource(data=data, no_data_value=8, projection="EPSG:28992",
                               pixel_size=0.5, pixel_origin=(135000.0, 456008.0)) + 1
    port_view = from_reference(jax_view.serialize())
    text = port_view.to_json()
    loaded = Block.from_json(text)
    jax_loaded = JaxBlock.from_json(text.replace("dask_geomodeling_tpu_torch.",
                                                 "dask_geomodeling_tpu."))
    assert loaded.token == jax_loaded.token == port_view.token
    assert JaxBlock.from_json(jax_view.to_json()).token == jax_view.token
    request = dict(REQUEST, start=datetime(1970, 1, 1), stop=None)
    with jax_config.set({"geomodeling.executor": "numpy"}):
        expected = jax_loaded.get_data(**request)
    for actual in (loaded.get_data(device="cpu", **request),
                   compute_host(*loaded.get_compute_graph(**request))):
        assert actual["values"].dtype == expected["values"].dtype == np.int64
        np.testing.assert_array_equal(actual["values"], expected["values"])
        assert actual["no_data_value"] == expected["no_data_value"]
