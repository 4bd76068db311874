"""The raster-algebra paths and the executor fuzz on the card.

Card-only (``cuda``-marked; they skip without a card): chip_smoke.py's
five raster-algebra paths at 1024^2 in 256^2 tiles, on the card against
the same run on the CPU (bitwise, or within the bilinear path's
tolerance) and against compute_host on sampled tiles; the fuzz's trees on
the card against compute_host; the float64 discrete ops.  This file
imports nothing of JAX, so it runs where JAX is not installed.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from dask_geomodeling_tpu_torch import compute_host, evaluate_tiled
from dask_geomodeling_tpu_torch.config import config

PATHS = ["elemwise", "reclassify-chain", "combine", "place", "reproject-bilinear"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def paths():
    return chip_smoke.build_algebra_paths(1024)


@pytest.mark.cuda
@pytest.mark.parametrize("label", PATHS)
def test_path_on_card_equals_cpu_and_host(paths, label):
    device = _card()
    view, request, interpolation, _ = paths[label]
    with config.set({"geomodeling.warp-interpolation": interpolation}):
        card = evaluate_tiled(view, request, tile_size=256, batch=4, device=device)["values"]
        cpu = evaluate_tiled(view, request, tile_size=256, batch=4, device="cpu")["values"]
        tile = dict(request, width=256, height=256, bbox=(
            request["bbox"][0], request["bbox"][3] - (request["bbox"][3] - request["bbox"][1]) / 4,
            request["bbox"][0] + (request["bbox"][2] - request["bbox"][0]) / 4, request["bbox"][3]))
        host = compute_host(*view.get_compute_graph(**tile))["values"]
    if interpolation == "nearest":
        np.testing.assert_array_equal(card, cpu)
        np.testing.assert_array_equal(card[:, :256, :256], host)
    else:
        np.testing.assert_allclose(card, cpu, rtol=0, atol=chip_smoke.BILINEAR_ATOL)
        np.testing.assert_allclose(card[:, :256, :256], host, rtol=0, atol=chip_smoke.BILINEAR_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", list(chip_smoke.FUZZ_SEEDS) + list(chip_smoke.FUZZ_TILED_SEEDS))
def test_fuzz_on_card(seed):
    device = _card()
    view, request = chip_smoke.fuzz_view(seed, chip_smoke.fuzz_sources())
    expected = compute_host(*view.get_compute_graph(**request))
    if seed in chip_smoke.FUZZ_TILED_SEEDS:
        actual = evaluate_tiled(view, request, tile_size=6, batch=2, device=device)
        actual["no_data_value"] = expected["no_data_value"]
    else:
        actual = view.get_data(device=device, **request)
    assert chip_smoke.same_as_host(actual, expected)


@pytest.mark.cuda
def test_float64_discrete_ops_on_card():
    assert chip_smoke.check_f64_discrete(_card()) > 40
