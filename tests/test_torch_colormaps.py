"""The port's colour maps (render/colormaps.py) against matplotlib.

- the stored tables are matplotlib's for every name in
  ``matplotlib.colormaps`` (the reversed ones included), and
  ``write_tables`` writes them again from the installed matplotlib;
- ``normalize`` is ``Normalize(vmin, vmax, clip=True)`` bit for bit,
  dtype included, and ``apply`` is the colormap's call followed by
  ``(rgba * 255).astype(np.uint8)``, drawn with hypothesis over uint8,
  int16, int32, float32 and float64 data with values at and beyond vmin
  and vmax, NaN, +-inf, masked cells, and vmin = vmax;
- the legend ramp of GetLegendGraphic, for every map.
"""
import matplotlib
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from matplotlib.colors import Normalize

from dask_geomodeling_tpu_torch.render import colormaps

NAMES = sorted(matplotlib.colormaps)
DTYPES = ["uint8", "int16", "int32", "float32", "float64"]


def matplotlib_rgba(name, values):
    return (matplotlib.colormaps[name](values) * 255).astype(np.uint8)


def test_the_tables_hold_every_name():
    assert len(NAMES) == 180  # matplotlib 3.10.8
    assert colormaps.names() == NAMES
    assert {colormaps.lookup_table(n).shape[0] - 3 for n in NAMES} >= {8, 10, 20, 256, 510}


@pytest.mark.parametrize("name", NAMES)
def test_stored_table_is_matplotlibs(name):
    colormap = matplotlib.colormaps[name]
    colormap._init()
    table = colormaps.lookup_table(name)
    assert table.dtype == np.uint8 and table.shape == (colormap.N + 3, 4)
    np.testing.assert_array_equal(table, (colormap._lut * 255).astype(np.uint8))


def test_write_tables_regenerates_the_file(tmp_path):
    path = tmp_path / "colormaps.npz"
    colormaps.write_tables(str(path), matplotlib.colormaps)
    with np.load(path, allow_pickle=False) as fresh:
        assert sorted(fresh.files) == NAMES
        for name in NAMES:
            np.testing.assert_array_equal(fresh[name], colormaps.lookup_table(name))


def test_unknown_name_is_a_key_error():
    with pytest.raises(KeyError):
        colormaps.lookup_table("nope-123")
    with pytest.raises(KeyError):
        colormaps.apply("nope-123", np.zeros((2, 2)))


@st.composite
def rasters(draw):
    """(masked values, vmin, vmax): a small raster of one of DTYPES whose
    values sit at, between and beyond the limits, with NaN and +-inf in
    the float ones, and a nodata value masked as GetMap masks it."""
    dtype = np.dtype(draw(st.sampled_from(DTYPES)))
    if dtype.kind == "f":
        vmin = draw(st.floats(-1e3, 1e3, allow_nan=False, width=32))
        span = draw(st.sampled_from([0.0, 1e-3, 1.0, 10.0, 255.0, 1e5]))
    else:
        info = np.iinfo(dtype)
        vmin = float(draw(st.integers(max(info.min, -300), min(info.max, 300))))
        span = draw(st.sampled_from([0.0, 0.5, 1.0, 10.0, 255.0, 1000.0]))
        vmin += draw(st.sampled_from([0.0, 0.25, 0.5]))
    vmax = vmin + span
    specials = [vmin, vmax, vmin - 1, vmax + 1, (vmin + vmax) / 2, 0.0]
    if dtype.kind == "f":
        specials += [np.nan, np.inf, -np.inf, np.nextafter(vmax, np.inf), np.nextafter(vmin, -np.inf)]
    shape = (draw(st.integers(1, 6)), draw(st.integers(1, 6)))
    picks = draw(st.lists(
        st.one_of(st.sampled_from(specials),
                  st.floats(vmin - 2 * span - 1, vmax + 2 * span + 1, allow_nan=False)),
        min_size=shape[0] * shape[1], max_size=shape[0] * shape[1]))
    with np.errstate(invalid="ignore", over="ignore"):
        if dtype.kind == "f":
            values = np.array(picks, np.float64).astype(dtype)
        else:
            info = np.iinfo(dtype)
            values = np.clip(np.nan_to_num(np.array(picks, np.float64)), info.min, info.max)
            values = values.astype(dtype)
    values = values.reshape(shape)
    masking = draw(st.sampled_from(["first value", "none", "all"]))
    if masking == "first value":
        masked = np.ma.masked_equal(values, values.flat[0])
    elif masking == "all":
        masked = np.ma.masked_all(shape)
    else:
        masked = np.ma.masked_array(values, mask=np.zeros(shape, bool))
    return masked, vmin, vmax


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(rasters(), st.sampled_from(NAMES))
def test_normalize_and_apply_are_matplotlibs(raster, name):
    values, vmin, vmax = raster
    expected = Normalize(vmin=vmin, vmax=vmax, clip=True)(values)
    actual = colormaps.normalize(values, vmin, vmax)
    assert actual.dtype == expected.dtype
    np.testing.assert_array_equal(np.ma.getmaskarray(actual), np.ma.getmaskarray(expected))
    np.testing.assert_array_equal(actual.data, expected.data)  # NaN where matplotlib's is
    want = matplotlib_rgba(name, expected)
    got = colormaps.apply(name, actual)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_normalize_promotes_as_matplotlib(dtype):
    values = np.ma.masked_array(np.arange(12, dtype=dtype).reshape(3, 4), mask=False)
    for vmin, vmax in [(0.0, 10.0), (0.1, 0.7), (3.0, 3.0)]:
        expected = Normalize(vmin=vmin, vmax=vmax, clip=True)(values)
        actual = colormaps.normalize(values, vmin, vmax)
        assert actual.dtype == expected.dtype
        np.testing.assert_array_equal(actual.data, expected.data)


def test_normalize_refuses_vmin_above_vmax():
    with pytest.raises(ValueError, match="minvalue"):
        colormaps.normalize(np.ma.masked_array(np.zeros(3)), 2.0, 1.0)


@pytest.mark.parametrize("name", NAMES)
def test_legend_ramp(name):
    """GetLegendGraphic's ramp, 1 at the top to 0 at the bottom."""
    ramp = np.linspace(1.0, 0.0, 160)[:, None].repeat(3, axis=1)
    np.testing.assert_array_equal(colormaps.apply(name, ramp), matplotlib_rgba(name, ramp))


def test_apply_reads_big_endian_data():
    values = np.linspace(-0.5, 1.5, 33).astype(">f8").reshape(3, 11)
    np.testing.assert_array_equal(colormaps.apply("viridis", values),
                                  matplotlib_rgba("viridis", values))
