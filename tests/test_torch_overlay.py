"""The port's planar overlay (geo/_overlay.py) bitwise to the JAX
package's, on hypothesis-drawn polygons: star-shaped polygons (some with
a hole), axis-aligned boxes and the tiles GeometryTiler cuts, each pair
through intersection, union and difference.  The same geometry (WKB), or
the same exception, from both.
"""
import numpy as np
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dask_geomodeling_tpu.geo import geometry as jax_geometry
from dask_geomodeling_tpu_torch.geo import geometry

OPERATIONS = ("intersection", "union", "difference")


@st.composite
def star(draw):
    """A simple star-shaped polygon around a drawn centre (vertices at
    increasing angles), on a grid of 1/8 units or at arbitrary floats, and
    sometimes a hole near its centre."""
    n = draw(st.integers(3, 9))
    cx, cy = draw(st.tuples(st.integers(-20, 20), st.integers(-20, 20)))
    grid = draw(st.booleans())
    radii = draw(st.lists(st.integers(8, 80) if grid else st.floats(1.0, 10.0),
                          min_size=n, max_size=n))
    angles = np.sort(draw(st.lists(st.floats(0, 2 * np.pi - 1e-3), min_size=n, max_size=n,
                                   unique=True)))
    scale = 0.125 if grid else 1.0
    shell = [(cx + r * scale * np.cos(a), cy + r * scale * np.sin(a))
             for r, a in zip(radii, angles)]
    if grid:
        shell = [(round(x * 8) / 8, round(y * 8) / 8) for x, y in shell]
    holes = []
    if draw(st.booleans()) and min(radii) * scale > 2:
        hole = 0.5
        holes = [[(cx - hole, cy - hole), (cx + hole, cy - hole), (cx + hole, cy + hole),
                  (cx - hole, cy + hole)]]
    return shell, holes


@st.composite
def boxes(draw):
    x, y = draw(st.integers(-25, 20)), draw(st.integers(-25, 20))
    w, h = draw(st.integers(1, 30)), draw(st.integers(1, 30))
    return [(x, y), (x + w, y), (x + w, y + h), (x, y + h)], []


def _pair(shape):
    shell, holes = shape
    return geometry.Polygon(shell, holes), jax_geometry.Polygon(shell, holes)


def _same(port_op, jax_op):
    try:
        expected = jax_op()
    except Exception as error:  # the port must fail alike
        try:
            port_op()
        except type(error):
            return
        raise AssertionError("the port did not raise %r" % error)
    result = port_op()
    assert type(result).__name__ == type(expected).__name__
    assert result.wkb == expected.wkb


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(a=st.one_of(star(), boxes()), b=st.one_of(star(), boxes()))
def test_overlay_bitwise_to_the_jax_package(a, b):
    (pa, ja), (pb, jb) = _pair(a), _pair(b)
    if not (ja.is_valid and jb.is_valid):
        return  # GEOS semantics are undefined for invalid input, in both
    for operation in OPERATIONS:
        _same(lambda: getattr(pa, operation)(pb), lambda: getattr(ja, operation)(jb))


@settings(max_examples=30, deadline=None)
@given(shape=star(), size=st.sampled_from([2.0, 3.5, 7.0]))
def test_tiles_cut_from_a_polygon(shape, size):
    """GeometryTiler's cut: each box of the grid over a polygon's bounds
    intersected with it."""
    port, ref = _pair(shape)
    if not ref.is_valid:
        return
    x1, y1, x2, y2 = ref.bounds
    for x in np.arange(x1, x2, size):
        for y in np.arange(y1, y2, size):
            _same(lambda: geometry.box(x, y, x + size, y + size).intersection(port),
                  lambda: jax_geometry.box(x, y, x + size, y + size).intersection(ref))
