"""encode_torch against the JAX package's FetchCodec.encode, bitwise, and
the round trip through the host FetchCodec.decode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dask_geomodeling_tpu.runtime.executor import _ensure_x64
from dask_geomodeling_tpu.runtime.fetchcodec import codec_from_values, derive_codec
from dask_geomodeling_tpu_torch.runtime.fetchcodec import encode_torch

import bench


@pytest.fixture(scope="module", autouse=True)
def x64():
    _ensure_x64()


def _main_path_codec():
    _, view = bench.build_view(64)
    return derive_codec(view.dtype, view.fillvalue, None, [], view=view)


CASES = {
    # the bench view's root: Classify(5 bins) -> uint8 {0..4, 255}
    "main-path": (_main_path_codec, [0, 1, 2, 3, 4, 255], np.uint8),
    # a float alphabet of 40 values: one uint8 code per pixel
    "group-1-uint8": (
        lambda: codec_from_values(
            [v * 0.5 for v in range(40)], float(np.finfo(np.float32).max), np.float32
        ),
        [v * 0.5 for v in range(40)] + [float(np.finfo(np.float32).max)],
        np.float32,
    ),
    # 300 int values in int32: one uint16 code per pixel
    "group-1-uint16": (
        lambda: codec_from_values(list(range(0, 600, 2)), -1, np.int32),
        list(range(0, 600, 2)) + [-1],
        np.int32,
    ),
    # a contiguous range with an out-of-range fill code
    "range-fill-code": (
        lambda: codec_from_values([3, 4, 5, 6], 99, np.int64),
        [3, 4, 5, 6, 99],
        np.int64,
    ),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_encode_matches_jax_and_round_trips(case):
    make, alphabet, dtype = CASES[case]
    codec = make()
    assert codec is not None
    if case == "main-path":
        assert (codec.symbols, codec.group, codec.palette is not None) == (6, 3, True)
    if case.startswith("group-1"):
        assert codec.group == 1
    rng = np.random.RandomState(11)
    # 31 x 29 pixels: the packed length needs padding for group 3
    values = np.asarray(alphabet, dtype)[rng.randint(0, len(alphabet), (3, 2, 31, 29))]
    expected = np.asarray(jax.jit(jax.vmap(codec.encode))(jnp.asarray(values)))
    actual = encode_torch(codec, torch.from_numpy(values)).numpy()
    assert actual.dtype == expected.dtype == codec.code_dtype
    np.testing.assert_array_equal(actual, expected)
    np.testing.assert_array_equal(codec.decode(actual, 31, 29), values)
