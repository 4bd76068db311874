"""warp_torch against the JAX package's warp_jax and the host warp_numpy.

Cross-CRS, the port interpolates a float64 coarse index grid where
warp_jax interpolates the same grid rounded to float32 (the JAX package's
``host_coarse_grid``): the port matches the host's exact per-pixel warp
bit for bit on these tiles, and where it differs from warp_jax the two
took neighbouring source pixels.  Same-CRS
all three agree bit for bit.  The inputs hold a nodata patch, NaN source
cells, cells outside the source and out-of-domain tiles (NaN and
far-away coarse grids).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dask_geomodeling_tpu.geo import Extent
from dask_geomodeling_tpu.ops.warp import host_coarse_grid, warp_jax, warp_numpy
from dask_geomodeling_tpu.runtime.executor import _ensure_x64
from dask_geomodeling_tpu_torch.ops import warp as port_warp
from dask_geomodeling_tpu_torch.ops.warp import coarse_index_grid, warp_torch

SRC_GT = (85000.0, 1.0, 0, 455000.0, 0, -1.0)
SRC_SRS = "EPSG:28992"
SRC_SHAPE = (96, 112)
WIDTH, HEIGHT = 56, 40


@pytest.fixture(scope="module", autouse=True)
def x64():
    _ensure_x64()  # what the JAX executors do before tracing


def _source(dtype):
    rng = np.random.RandomState(7)
    values = (rng.rand(2, *SRC_SHAPE) * 250).astype(dtype)
    if np.dtype(dtype).kind == "f":
        nodata = float(np.finfo(dtype).max)
        values[0, 3:9, 4:12] = np.nan
    else:
        nodata = -9999
    values[:, 20:30, 40:52] = nodata
    return values, nodata


def _fill(dtype):
    return float(np.finfo(dtype).max) if np.dtype(dtype).kind == "f" else -1


def _cross_tiles():
    """Tiles in EPSG:3857 over and past the source, and their float64
    coarse index grids; tiles 0, 4 and 5 are (partly) out of the domain."""
    # the source spans about x 486026..486210, y 6814238..6814397 here
    x0, y0 = 485990.0, 6814210.0
    cell = 1.6
    bboxes = []
    for i, j in [(0, 0), (1, 0), (0, 2), (1, 2), (1, 1), (2, 1)]:
        bx = x0 + i * WIDTH * cell
        by = y0 + j * HEIGHT * cell
        bboxes.append((bx, by, bx + WIDTH * cell, by + HEIGHT * cell))
    grids = np.stack(
        [
            coarse_index_grid(SRC_GT, SRC_SRS, bbox, "EPSG:3857", WIDTH, HEIGHT, 8)
            for bbox in bboxes
        ]
    )
    grids[0, :, 1:3, 2:5] = np.nan  # partly out of the transform's domain
    grids[4] = np.nan  # wholly out of the domain
    grids[5] = 1e30  # far outside the source, beyond the int32 range
    return np.asarray(bboxes), grids


def _jax_batched(values, nodata, dtype, projection, bboxes, grids):
    def one(bbox, grid):
        return warp_jax(
            jnp.asarray(values), SRC_GT, SRC_SRS, nodata, bbox, projection,
            WIDTH, HEIGHT, np.dtype(dtype), _fill(dtype), coarse_grid=grid,
        )

    if grids is None:
        return np.asarray(jax.jit(jax.vmap(lambda b: one(b, None)))(bboxes))
    return np.asarray(jax.jit(jax.vmap(one))(bboxes, grids.astype(np.float32)))


def _torch_batched(values, nodata, dtype, projection, bboxes, grids):
    return warp_torch(
        torch.from_numpy(values), SRC_GT, SRC_SRS, nodata,
        torch.from_numpy(bboxes), projection, WIDTH, HEIGHT, np.dtype(dtype),
        _fill(dtype), coarse_grid=None if grids is None else torch.from_numpy(grids),
    ).numpy()


def test_float64_grid_rounds_to_the_jax_packages():
    bboxes, grids = _cross_tiles()
    for tile in (1, 2, 3):
        expected = host_coarse_grid(
            SRC_GT, SRC_SRS, tuple(bboxes[tile]), "EPSG:3857", WIDTH, HEIGHT, 8
        )
        np.testing.assert_array_equal(grids[tile].astype(np.float32), expected)


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_cross_crs_matches_host_warp(dtype):
    values, nodata = _source(dtype)
    bboxes, grids = _cross_tiles()
    actual = _torch_batched(values, nodata, dtype, "EPSG:3857", bboxes, grids)
    fill = _fill(dtype)
    for tile in (1, 2, 3):  # grids as the transform gives them
        host = warp_numpy(
            values, SRC_GT, SRC_SRS, nodata, tuple(bboxes[tile]), "EPSG:3857",
            WIDTH, HEIGHT, dtype=dtype, fillvalue=fill,
        )
        np.testing.assert_array_equal(actual[tile], host)
        assert (actual[tile] == fill).any() and (actual[tile] != fill).any()
    # out-of-domain cells, and tiles far outside, are fill; so is warp_jax
    expected = _jax_batched(values, nodata, dtype, "EPSG:3857", bboxes, grids)
    assert (actual[4] == fill).all() and (actual[5] == fill).all()
    nan_cells = np.isnan(
        grids[0, 0, :, :]
    ).repeat(8, axis=0).repeat(8, axis=1)[:HEIGHT, :WIDTH]
    assert (actual[0][:, nan_cells] == fill).all()
    np.testing.assert_array_equal(actual[4:], expected[4:])


def test_wide_source_host_exact_where_warp_jax_is_not():
    """At column indices near 8000, float32 resolves about 1/1000 of a
    pixel: warp_jax's float32 grid moves a few cells to a neighbouring
    source pixel, the port's float64 grid reproduces the host.  Each source
    pixel holds its own flat index, so a cell tells which pixel it took."""
    height, width = 64, 8192
    values = np.arange(height * width, dtype=np.int32).reshape(1, height, width)
    x0, y0, _, _ = Extent(
        (85000 + 7900, 455000 - height, 85000 + width, 455000), SRC_SRS
    ).transformed("EPSG:3857").bbox
    w, h, cell = 128, 96, 1.5
    bboxes = np.asarray(
        [(x0 + i * w * cell, y0 - 20, x0 + (i + 1) * w * cell, y0 + h * cell - 20)
         for i in range(3)]
    )
    grids = np.stack(
        [coarse_index_grid(SRC_GT, SRC_SRS, tuple(b), "EPSG:3857", w, h, 8) for b in bboxes]
    )
    actual = warp_torch(
        torch.from_numpy(values), SRC_GT, SRC_SRS, None, torch.from_numpy(bboxes),
        "EPSG:3857", w, h, np.int32, -1, coarse_grid=torch.from_numpy(grids),
    ).numpy()
    jax_out = np.asarray(
        jax.jit(
            jax.vmap(
                lambda b, g: warp_jax(
                    jnp.asarray(values), SRC_GT, SRC_SRS, None, b, "EPSG:3857",
                    w, h, np.dtype(np.int32), -1, coarse_grid=g,
                )
            )
        )(bboxes, grids.astype(np.float32))
    )
    host = np.stack(
        [
            warp_numpy(values, SRC_GT, SRC_SRS, None, tuple(b), "EPSG:3857", w, h,
                       dtype=np.int32, fillvalue=-1)
            for b in bboxes
        ]
    )
    np.testing.assert_array_equal(actual, host)
    assert (actual != -1).mean() > 0.5
    differ = actual != jax_out
    # measured: 6 of 36864 cells, each at a pixel edge
    assert 0 < differ.sum() <= 40
    for a, b in zip(actual[differ], jax_out[differ]):
        if a == -1 or b == -1:  # inside for one warp, just outside for the other
            row, col = divmod(int(max(a, b)), width)
            assert row in (0, height - 1) or col in (0, width - 1)
        else:
            (ra, ca), (rb, cb) = divmod(int(a), width), divmod(int(b), width)
            assert abs(ra - rb) <= 1 and abs(ca - cb) <= 1


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_same_crs_matches_warp_jax_and_host(dtype):
    values, nodata = _source(dtype)
    cell = 0.7
    bboxes = np.asarray(
        [
            (85000.3 + i * 30.0, 454900.1 + j * 25.0,
             85000.3 + i * 30.0 + WIDTH * cell, 454900.1 + j * 25.0 + HEIGHT * cell)
            for i, j in [(0, 0), (1, 2), (3, 3), (-1, -1)]
        ]
    )
    expected = _jax_batched(values, nodata, dtype, SRC_SRS, bboxes, None)
    actual = _torch_batched(values, nodata, dtype, SRC_SRS, bboxes, None)
    np.testing.assert_array_equal(actual, expected)
    for bbox, tile in zip(bboxes, actual):
        host = warp_numpy(
            values, SRC_GT, SRC_SRS, nodata, tuple(bbox), SRC_SRS, WIDTH, HEIGHT,
            dtype=dtype, fillvalue=_fill(dtype),
        )
        np.testing.assert_array_equal(tile, host)


def test_cross_crs_needs_the_grid():
    values, nodata = _source(np.float32)
    bboxes, _ = _cross_tiles()
    with pytest.raises(ValueError):
        _torch_batched(values, nodata, np.float32, "EPSG:3857", bboxes, None)


def test_bilinear_not_ported_yet():
    """Bilinear is ported: the cross-CRS bilinear warp runs on the coarse
    grid and its cells inside the source lie within the source's range,
    while an unknown resampling raises."""
    values, nodata = _source(np.float32)
    bboxes, grids = _cross_tiles()
    out = warp_torch(
        torch.from_numpy(values), SRC_GT, SRC_SRS, nodata,
        torch.from_numpy(bboxes), "EPSG:3857", WIDTH, HEIGHT, np.float32, 0.0,
        interpolation="bilinear", coarse_grid=torch.from_numpy(grids),
    ).numpy()
    assert (out[4:] == 0.0).all()
    data = out[1:4][(out[1:4] != 0.0) & np.isfinite(out[1:4])]
    assert data.size and (data >= 0).all() and (data < 250).all()
    with pytest.raises(ValueError):
        warp_torch(
            torch.from_numpy(values), SRC_GT, SRC_SRS, nodata,
            torch.from_numpy(bboxes), "EPSG:3857", WIDTH, HEIGHT, np.float32, 0.0,
            interpolation="cubic", coarse_grid=torch.from_numpy(grids),
        )


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
@pytest.mark.parametrize("projection", ["EPSG:3857", SRC_SRS])
def test_port_warp_numpy_is_the_jax_packages(dtype, projection):
    values, nodata = _source(dtype)
    if projection == SRC_SRS:
        bboxes = [(85000.3, 454900.1, 85000.3 + WIDTH * 0.7, 454900.1 + HEIGHT * 0.7)]
    else:
        bboxes = [tuple(b) for b in _cross_tiles()[0]]
    for bbox in bboxes:
        args = (values, SRC_GT, SRC_SRS, nodata, bbox, projection, WIDTH, HEIGHT)
        kwargs = dict(dtype=dtype, fillvalue=_fill(dtype))
        np.testing.assert_array_equal(
            port_warp.warp_numpy(*args, **kwargs), warp_numpy(*args, **kwargs)
        )


# --- bilinear (the cases of tests/test_warp_bilinear.py, and the twin) ---

BILINEAR_GT = (135000.0, 2.0, 0.0, 456000.0, 0.0, -2.0)


def _bilinear_source(bands=1, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return (rng.rand(bands, 30, 30) * 200).astype(dtype)


def _bilinear_kwargs(**overrides):
    kwargs = dict(
        src_gt=BILINEAR_GT, src_srs="EPSG:28992", no_data_value=None,
        bbox=(135010.0, 455930.0, 135050.0, 455990.0), projection="EPSG:28992",
        width=20, height=30, dtype=np.float32, fillvalue=-9999.0,
    )
    kwargs.update(overrides)
    return kwargs


def _bilinear_torch(values, bboxes, coarse_grid=None, **kwargs):
    kwargs = dict(kwargs)
    kwargs.pop("bbox", None)
    return warp_torch(
        torch.from_numpy(values), kwargs.pop("src_gt"), kwargs.pop("src_srs"),
        kwargs.pop("no_data_value"), torch.from_numpy(np.asarray(bboxes, np.float64)),
        kwargs.pop("projection"), kwargs.pop("width"), kwargs.pop("height"),
        np.dtype(kwargs.pop("dtype")), kwargs.pop("fillvalue"), interpolation="bilinear",
        coarse_grid=None if coarse_grid is None else torch.from_numpy(coarse_grid),
    ).numpy()


def test_bilinear_matches_scipy_affine():
    """Same-CRS bilinear equals scipy's map_coordinates(order=1) inside
    the source, on the host and on the device."""
    from scipy import ndimage

    values = _bilinear_source()
    kwargs = _bilinear_kwargs(bbox=(135010.0, 455945.0, 135050.0, 455985.0), height=20)
    host = port_warp.warp_numpy(values, interpolation="bilinear", **kwargs)
    x1, y1, x2, y2 = kwargs["bbox"]
    tx, ty = np.meshgrid(x1 + (np.arange(20) + 0.5) * (x2 - x1) / 20,
                         y2 - (np.arange(20) + 0.5) * (y2 - y1) / 20)
    fc = (tx - BILINEAR_GT[0]) / BILINEAR_GT[1] - 0.5
    fr = (ty - BILINEAR_GT[3]) / BILINEAR_GT[5] - 0.5
    expected = ndimage.map_coordinates(values[0].astype(np.float64), [fr, fc], order=1,
                                       mode="nearest").astype(np.float32)
    np.testing.assert_allclose(host[0], expected, rtol=1e-6)
    np.testing.assert_array_equal(_bilinear_torch(values, [kwargs["bbox"]], **kwargs)[0], host)


@pytest.mark.parametrize("dtype, fill", [(np.float32, -9999.0), (np.int16, -1), (np.uint8, 255)])
def test_bilinear_same_crs_device_is_the_hosts_bitwise(dtype, fill):
    """Several tiles, partly outside the source, with a nodata patch: the
    device's float64 blend, rounding and nodata test are the host's."""
    values = _bilinear_source(bands=2, seed=1, dtype=dtype)
    values[0, :5, :5] = 250
    bboxes = [(135010.3 + 7 * i, 455930.1 - 5 * i, 135050.3 + 7 * i, 455990.1 - 5 * i)
              for i in range(-2, 4)]
    kwargs = _bilinear_kwargs(no_data_value=250, dtype=dtype, fillvalue=fill)
    actual = _bilinear_torch(values, bboxes, **kwargs)
    for bbox, tile in zip(bboxes, actual):
        host = port_warp.warp_numpy(values, interpolation="bilinear", **dict(kwargs, bbox=bbox))
        np.testing.assert_array_equal(
            host, warp_numpy(values, interpolation="bilinear", **dict(kwargs, bbox=bbox)))
        np.testing.assert_array_equal(tile, host)
        assert (tile == fill).any() and (tile != fill).any()


def test_bilinear_cross_crs_against_the_host():
    """Cross-CRS the device interpolates the coarse transformer grid, the
    host transforms every pixel: the blends agree within the JAX
    package's bilinear tolerance (atol 1e-3), and the nodata cells are
    the same."""
    values, nodata = _source(np.float32)
    values = np.where(np.isnan(values), 7.0, values).astype(np.float32)
    bboxes, grids = _cross_tiles()
    actual = _bilinear_torch(values, bboxes, grids, **dict(
        src_gt=SRC_GT, src_srs=SRC_SRS, no_data_value=nodata, projection="EPSG:3857",
        width=WIDTH, height=HEIGHT, dtype=np.float32, fillvalue=nodata))
    for tile in (1, 2, 3):
        host = warp_numpy(values, SRC_GT, SRC_SRS, nodata, tuple(bboxes[tile]), "EPSG:3857",
                          WIDTH, HEIGHT, dtype=np.float32, fillvalue=nodata,
                          interpolation="bilinear")
        np.testing.assert_array_equal(actual[tile] == nodata, host == nodata)
        np.testing.assert_allclose(actual[tile], host, rtol=0, atol=1e-3)
    # out-of-domain and far-away tiles are all fill
    assert (actual[4] == nodata).all() and (actual[5] == nodata).all()


def test_bilinear_nodata_never_interpolated():
    values = _bilinear_source()
    values[0, 10:15, 10:15] = 255.0
    kwargs = _bilinear_kwargs(no_data_value=255.0)
    result = _bilinear_torch(values, [kwargs["bbox"]], **kwargs)[0]
    assert ((result == -9999.0) | (result < 250.0)).all()
    assert (result == -9999.0).any()


def test_bilinear_source_config_knob():
    """geomodeling.warp-interpolation routes MemorySource reads through
    the bilinear warp on the device, bitwise to compute_host."""
    from datetime import datetime

    from dask_geomodeling_tpu_torch import compute_host
    from dask_geomodeling_tpu_torch.config import config
    from dask_geomodeling_tpu_torch.raster import MemorySource

    source = MemorySource(_bilinear_source(seed=2), float(np.finfo(np.float32).max),
                          "EPSG:28992", 2.0, (135000, 456000))
    request = dict(mode="vals", bbox=(135001.0, 455941.0, 135041.0, 455981.0),
                   projection="EPSG:28992", width=40, height=40, start=datetime(1970, 1, 1))
    nearest = source.get_data(device="cpu", **request)
    with config.set({"geomodeling.warp-interpolation": "bilinear"}):
        host = compute_host(*source.get_compute_graph(**request))
        device = source.get_data(device="cpu", **request)
    assert not np.array_equal(host["values"], nearest["values"])
    np.testing.assert_array_equal(device["values"], host["values"])


def test_bilinear_integer_rounds():
    values = np.arange(100, dtype=np.uint8).reshape(1, 10, 10) * 2
    kwargs = _bilinear_kwargs(src_gt=(0.0, 1.0, 0.0, 10.0, 0.0, -1.0), bbox=(0.5, 0.5, 8.5, 8.5),
                              width=8, height=8, dtype=np.uint8, fillvalue=255)
    host = port_warp.warp_numpy(values, interpolation="bilinear", **kwargs)
    assert host.dtype == np.uint8
    np.testing.assert_array_equal(_bilinear_torch(values, [kwargs["bbox"]], **kwargs)[0], host)
