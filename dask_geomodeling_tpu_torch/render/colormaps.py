"""Colour maps without matplotlib.

The JAX package's WMS render (dask_geomodeling_tpu/ipyleaflet_plugin.py:
``render_wms_tile``, ``render_legend_graphic``) asks matplotlib for three
things: ``Normalize(vmin, vmax, clip=True)`` over a masked array, a named
``Colormap`` called on the result, and ``(rgba * 255).astype(np.uint8)``.
This module gives the same bytes with numpy alone:

- ``normalize`` follows ``matplotlib.colors.Normalize.__call__`` of
  matplotlib 3.10.8 step by step, with its promotions: float data keeps
  its dtype, bool and integers of up to two bytes become float32 and wider
  integers float64 (``np.promote_types(dtype, float32)``); the clip runs
  against float64 limits, and the in-place subtraction and division follow
  numpy's casting rules, not plain float32 arithmetic;
- ``apply`` follows ``Colormap._get_rgba_and_mask``: float data times
  ``N``, ``N`` itself mapped to ``N - 1``, below 0 to the under row, from
  ``N`` up to the over row, and the bad row for masked cells (or, in an
  array without a masked cell, for NaN);
- the tables: each map's lookup table as matplotlib holds it, ``N`` rows
  and its under, over and bad rows, stored as ``(lut * 255).astype(uint8)``
  in ``colormaps.npz`` beside this file (every name in
  ``matplotlib.colormaps``, the reversed ones included).  ``write_tables``
  writes that file from a matplotlib registry handed to it.
"""
import os

import numpy as np

__all__ = ["names", "lookup_table", "normalize", "apply", "write_tables", "TABLES"]

#: the stored lookup tables, one uint8 (N + 3, 4) array per name
TABLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "colormaps.npz")

with np.load(TABLES, allow_pickle=False) as _stored:
    _TABLES = {name: _stored[name] for name in _stored.files}


def names():
    """The names of the stored colour maps, sorted."""
    return sorted(_TABLES)


def lookup_table(name):
    """The uint8 (N + 3, 4) table of the map ``name``: its N colours, then
    the under, over and bad rows.  KeyError for an unknown name."""
    return _TABLES[name]


def _process_value(value):
    """``Normalize.process_value``: a masked copy of ``value`` in the
    dtype matplotlib normalizes it in, and whether it was a scalar."""
    is_scalar = not np.iterable(value)
    if is_scalar:
        value = [value]
    dtype = np.min_scalar_type(value)
    if np.issubdtype(dtype, np.integer) or dtype.type is np.bool_:
        dtype = np.promote_types(dtype, np.float32)
    mask = np.ma.getmask(value)
    data = np.asarray(value)
    return np.ma.array(data, mask=mask, dtype=dtype, copy=True), is_scalar


def normalize(values, vmin, vmax):
    """``Normalize(vmin=vmin, vmax=vmax, clip=True)(values)`` for an array
    (plain or masked): a masked array in [0, 1], masked where ``values``
    is.  Raises ValueError when vmin > vmax, as matplotlib does."""
    result, _ = _process_value(values)
    (vmin,), _ = _process_value(vmin)
    (vmax,), _ = _process_value(vmax)
    if vmin == vmax:
        result.fill(0)
    elif vmin > vmax:
        raise ValueError("minvalue must be less than or equal to maxvalue")
    else:
        mask = np.ma.getmask(result)
        result = np.ma.array(np.clip(result.filled(vmax), vmin, vmax), mask=mask)
        resdat = result.data
        resdat -= vmin
        resdat /= vmax - vmin
        result = np.ma.array(resdat, mask=result.mask, copy=False)
    return result


def apply(name, values):
    """``(matplotlib.colormaps[name](values) * 255).astype(np.uint8)``: a
    uint8 array of shape ``values.shape + (4,)``.  KeyError for an
    unknown name."""
    lut = lookup_table(name)
    n = lut.shape[0] - 3
    xa = np.array(values, copy=True)
    if not xa.dtype.isnative:
        xa = xa.byteswap().view(xa.dtype.newbyteorder())
    if xa.dtype.kind == "f":
        xa *= n
        xa[xa == n] = n - 1
    # the masks are taken before the cast, which truncates and wraps
    mask_under = xa < 0
    mask_over = xa >= n
    mask_bad = values.mask if np.ma.is_masked(values) else np.isnan(xa)
    with np.errstate(invalid="ignore"):
        xa = xa.astype(int)
    xa[mask_under] = n
    xa[mask_over] = n + 1
    xa[mask_bad] = n + 2
    return lut.take(xa, axis=0, mode="clip")


def write_tables(path, registry):
    """Write every colour map of ``registry`` (a mapping of names to
    matplotlib Colormaps, such as ``matplotlib.colormaps``) to ``path`` as
    this module stores them: for each name, ``(lut * 255).astype(uint8)``
    of the map's (N + 3, 4) lookup table."""
    tables = {}
    for name in registry:
        colormap = registry[name]
        lut = np.vstack([colormap(np.arange(colormap.N)), colormap.get_under(),
                         colormap.get_over(), colormap.get_bad()])
        tables[name] = (lut * 255).astype(np.uint8)
    np.savez_compressed(path, **tables)
