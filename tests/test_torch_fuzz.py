"""The executor fuzz, ported: random view trees of the JAX package, carried
across with ``from_reference``, evaluated by the port on the CPU.

The trees are the reference's own (tests/test_executor_fuzz.py:
``random_view`` with its sources, seeds 0-39 whole and 40-54 as 6^2 tiles
in batches of 2).  Each is held against the JAX package's numpy executor
and against the port's ``compute_host``: bitwise for integer and boolean
results, ``rtol=1e-6`` for floats (``Power`` runs through torch's ``pow``,
which may round differently from libm's).  ``compute_host`` itself equals
the numpy executor bit for bit.  Every seed lowers: no node is left to
the host.
"""
from datetime import datetime

import numpy as np
import pytest

from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu_torch import compute_host, evaluate_tiled, from_reference
from dask_geomodeling_tpu_torch.runtime import executor
from tests.test_executor_fuzz import (  # noqa: F401 (fixtures)
    assert_values_match,
    random_view,
    request_full,
    sources,
)


def _numpy_executor(view, request):
    with jax_config.set({"geomodeling.executor": "numpy"}):
        return view.get_data(**request)


def _assert_same(actual, expected, exact=False):
    if expected is None:
        assert actual is None
        return
    assert actual["values"].dtype == expected["values"].dtype
    assert actual["no_data_value"] == expected["no_data_value"]
    if exact:
        np.testing.assert_array_equal(actual["values"], expected["values"])
    else:
        assert_values_match(actual["values"], expected["values"])


@pytest.mark.parametrize("seed", range(40))
def test_random_view_equivalence(sources, request_full, seed):  # noqa: F811
    rng = np.random.RandomState(seed)
    jax_view = random_view(rng, sources, depth=rng.randint(2, 5))
    expected = _numpy_executor(jax_view, request_full)
    view = from_reference(jax_view.serialize())
    host = compute_host(*view.get_compute_graph(**request_full))
    _assert_same(host, expected, exact=True)
    host_runs = executor.host_node_runs
    actual = view.get_data(device="cpu", **request_full)
    assert executor.host_node_runs == host_runs  # every node had a twin
    _assert_same(actual, expected)


@pytest.mark.parametrize("seed", range(40, 55))
def test_random_view_tiled_equivalence(sources, seed):  # noqa: F811
    rng = np.random.RandomState(seed)
    jax_view = random_view(rng, sources, depth=rng.randint(2, 4))
    request = dict(
        mode="vals",
        start=datetime(2000, 1, 1),
        stop=datetime(2000, 1, 1),
        width=12,
        height=12,
        bbox=(135000, 455994, 135006, 456000),
        projection="EPSG:28992",
    )
    expected = _numpy_executor(jax_view, request)
    view = from_reference(jax_view.serialize())
    _assert_same(compute_host(*view.get_compute_graph(**request)), expected, exact=True)
    actual = evaluate_tiled(view, request, tile_size=6, batch=2, device="cpu")
    assert_values_match(actual["values"], expected["values"])


@pytest.mark.parametrize("seed", range(55))
def test_chip_smokes_trees_are_the_references(sources, seed):  # noqa: F811
    """chip_smoke.py's copy of random_view (the port's classes, for the
    card, where JAX is not installed) builds the reference's trees."""
    import chip_smoke

    rng = np.random.RandomState(seed)
    depth = rng.randint(2, 5 if seed < 40 else 4)
    jax_view = random_view(rng, sources, depth=depth)
    view, request = chip_smoke.fuzz_view(seed, chip_smoke.fuzz_sources())
    assert from_reference(jax_view.serialize()).token == view.token
    assert request["stop"] == (datetime(2000, 1, 1, 1) if seed < 40 else datetime(2000, 1, 1))
