"""NTv2 grid-shift datum transformations (.gsb files).

Counterpart of dask_geomodeling_tpu/geo/ntv2.py, as host numpy (the JAX
package's ``xp`` parameter is left out).  It parses the NTv2 binary
format and applies bilinearly interpolated shifts, upgrading the
Helmert-only (~0.5 m) datum accuracy to the grid's (cm-level) wherever
a user registers a grid:

    config.set({"geomodeling.ntv2-grids": {"NZGD49": "/path/nzgd2kgrid.gsb"}})

Shifts follow the NTv2 conventions: values in arc-seconds, longitudes
positive WEST, sub-grid rows south to north and columns east to west.
"""
import os
import struct
from functools import lru_cache

import numpy as np

__all__ = ["NTv2Grid", "read_ntv2", "grid_for_datum"]


def _records(raw, start, count):
    """(name, bytes) pairs of 16-byte NTv2 header records."""
    out = {}
    for k in range(count):
        offset = start + 16 * k
        name = raw[offset : offset + 8].decode("ascii", "replace").strip()
        out[name] = raw[offset + 8 : offset + 16]
    return out, start + 16 * count


class _SubGrid:
    def __init__(self, name, s_lat, n_lat, e_long, w_long, lat_inc,
                 long_inc, shifts):
        self.name = name
        self.s_lat = s_lat
        self.n_lat = n_lat
        self.e_long = e_long  # positive west, EASTERN edge (smaller value)
        self.w_long = w_long
        self.lat_inc = lat_inc
        self.long_inc = long_inc
        self.n_cols = int(round((w_long - e_long) / long_inc)) + 1
        self.n_rows = int(round((n_lat - s_lat) / lat_inc)) + 1
        # (rows, cols, 2): [lat shift, lon shift] in seconds
        self.shifts = shifts.reshape(self.n_rows, self.n_cols, 2)

    def contains(self, lon_deg, lat_deg):
        lat = np.asarray(lat_deg) * 3600.0
        lon_west = -np.asarray(lon_deg) * 3600.0
        return (
            (lat >= self.s_lat)
            & (lat <= self.n_lat)
            & (lon_west >= self.e_long)
            & (lon_west <= self.w_long)
        )


class NTv2Grid:
    """A parsed NTv2 file: bilinear shift interpolation over sub-grids."""

    def __init__(self, subgrids, from_name="", to_name=""):
        self.subgrids = subgrids
        self.from_name = from_name
        self.to_name = to_name

    def _interpolate(self, grid, lon_deg, lat_deg):
        lat = np.asarray(lat_deg, dtype=float) * 3600.0
        lon_west = -np.asarray(lon_deg, dtype=float) * 3600.0
        fy = (lat - grid.s_lat) / grid.lat_inc
        fx = (lon_west - grid.e_long) / grid.long_inc
        y0 = np.clip(np.floor(fy).astype(int), 0, grid.n_rows - 2)
        x0 = np.clip(np.floor(fx).astype(int), 0, grid.n_cols - 2)
        wy = np.clip(fy - y0, 0.0, 1.0)
        wx = np.clip(fx - x0, 0.0, 1.0)
        table = np.asarray(grid.shifts)
        v00 = table[y0, x0]
        v01 = table[y0, x0 + 1]
        v10 = table[y0 + 1, x0]
        v11 = table[y0 + 1, x0 + 1]
        w00 = ((1 - wy) * (1 - wx))[..., None]
        w01 = ((1 - wy) * wx)[..., None]
        w10 = (wy * (1 - wx))[..., None]
        w11 = (wy * wx)[..., None]
        shift = v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11
        return shift[..., 0], shift[..., 1]  # lat sec, lon sec (west+)

    def _pick(self, lon_deg, lat_deg):
        """The densest sub-grid containing most points (host decision —
        static per request window, like the rest of the warp planning)."""
        best = None
        best_score = -1.0
        for grid in self.subgrids:
            inside = np.mean(
                np.asarray(grid.contains(lon_deg, lat_deg), dtype=float)
            )
            if inside > 0 and (
                best is None
                or inside > best_score
                or (inside == best_score and grid.lat_inc < best.lat_inc)
            ):
                best, best_score = grid, inside
            elif best is None:
                best = grid
        return best or self.subgrids[0]

    def coverage(self, lon, lat):
        """Boolean mask: which points any sub-grid covers (out-of-
        coverage points must NOT receive extrapolated edge shifts)."""
        lat_sec = np.asarray(lat, dtype=float) * 3600.0
        lon_west = -np.asarray(lon, dtype=float) * 3600.0
        inside = None
        for grid in self.subgrids:
            this = (
                (lat_sec >= grid.s_lat)
                & (lat_sec <= grid.n_lat)
                & (lon_west >= grid.e_long)
                & (lon_west <= grid.w_long)
            )
            inside = this if inside is None else (inside | this)
        return inside

    def forward(self, lon, lat):
        """Source-datum lon/lat -> target-datum lon/lat (degrees)."""
        probe_lon = np.asarray(lon, dtype=float)
        probe_lat = np.asarray(lat, dtype=float)
        grid = self._pick(
            probe_lon if probe_lon.size else np.zeros(1),
            probe_lat if probe_lat.size else np.zeros(1),
        )
        dlat, dlon_west = self._interpolate(grid, lon, lat)
        return (
            np.asarray(lon, dtype=float) - dlon_west / 3600.0,
            np.asarray(lat, dtype=float) + dlat / 3600.0,
        )

    def inverse(self, lon, lat, iterations=4):
        """Target-datum lon/lat -> source-datum lon/lat (fixed-point
        iteration on the forward shift, PROJ's approach)."""
        src_lon = np.asarray(lon, dtype=float)
        src_lat = np.asarray(lat, dtype=float)
        for _ in range(iterations):
            out_lon, out_lat = self.forward(src_lon, src_lat)
            src_lon = src_lon - (out_lon - np.asarray(lon, dtype=float))
            src_lat = src_lat - (out_lat - np.asarray(lat, dtype=float))
        return src_lon, src_lat


def read_ntv2(path):
    """Parse an NTv2 .gsb file into an :class:`NTv2Grid`."""
    with open(path, "rb") as stream:
        raw = stream.read()
    if raw[:8].decode("ascii", "replace").strip() != "NUM_OREC":
        raise IOError("Not an NTv2 grid file: '%s'" % path)
    # endianness from the NUM_OREC int (always 11)
    for endian in ("<", ">"):
        (num_orec,) = struct.unpack_from(endian + "i", raw, 8)
        if num_orec == 11:
            break
    else:
        raise IOError("Unrecognized NTv2 header in '%s'" % path)

    overview, pos = _records(raw, 0, 11)

    def value_int(rec):
        return struct.unpack(endian + "i", rec[:4])[0]

    def value_float(rec):
        return struct.unpack(endian + "d", rec)[0]

    num_files = value_int(overview["NUM_FILE"])
    from_name = overview.get("SYSTEM_F", b"").decode("ascii", "replace").strip()
    to_name = overview.get("SYSTEM_T", b"").decode("ascii", "replace").strip()

    subgrids = []
    for _ in range(num_files):
        header, pos = _records(raw, pos, 11)
        count = value_int(header["GS_COUNT"])
        shifts = np.frombuffer(
            raw, endian + "f4", count * 4, pos
        ).reshape(count, 4)[:, :2]
        pos += count * 16
        subgrids.append(
            _SubGrid(
                header.get("SUB_NAME", b"").decode("ascii", "replace").strip(),
                value_float(header["S_LAT"]),
                value_float(header["N_LAT"]),
                value_float(header["E_LONG"]),
                value_float(header["W_LONG"]),
                value_float(header["LAT_INC"]),
                value_float(header["LONG_INC"]),
                np.ascontiguousarray(shifts.astype(np.float64)),
            )
        )
    if not subgrids:
        raise IOError("NTv2 file has no sub-grids: '%s'" % path)
    return NTv2Grid(subgrids, from_name, to_name)


@lru_cache(maxsize=16)
def _read_cached(path, mtime):
    return read_ntv2(path)


def grid_for_datum(datum):
    """The registered NTv2 grid for a datum name, or None.

    Grids register via ``config.set({"geomodeling.ntv2-grids":
    {datum: path}})`` and upgrade that datum's WGS84 transformation from
    Helmert to grid interpolation.
    """
    from dask_geomodeling_tpu_torch.config import config

    grids = config.get("geomodeling.ntv2-grids", None) or {}
    path = grids.get(datum)
    if path is None:
        return None
    return _read_cached(os.path.abspath(path), os.path.getmtime(path))
