"""MBTiles raster tile pyramids (SQLite, Web Mercator TMS tiles).

Counterpart of dask_geomodeling_tpu/io/mbtiles.py, copied: the same
RasterData payload as the JAX reader, and the JAX writer's files.  An
MBTiles file is a SQLite database with a ``metadata`` name/value table
and a ``tiles`` table of ``zoom_level / tile_column / tile_row /
tile_data`` image blobs on the global Web Mercator grid; unlike
GeoPackage, the row axis is TMS (row 0 at the SOUTH edge) and the grid
anchor is fixed: tile (0, 0) at zoom 0 covers the whole world from
(-20037508.34..., -20037508.34...).

Reading assembles the highest zoom level present into one EPSG:3857
mosaic cropped to the envelope of tiles that actually exist (sparse
pyramids, as ``io/gpkg_raster.py`` does); tiles decode through
``io/gpkg_raster.py:_decode_tile`` (PNG, JPEG and still WebP in the
port; an animated WebP raises).
``write_mbtiles`` emits a single-zoom PNG pyramid readable by
GDAL/QGIS/tile servers; the input grid must sit on the Web Mercator tile
grid's resolution ladder.
"""
import math
import os
import sqlite3

import numpy as np

from dask_geomodeling_tpu_torch.io import gpkg_raster

__all__ = ["read_mbtiles", "write_mbtiles"]

#: half the Web Mercator world span (meters)
_ORIGIN = 20037508.342789244
_MERCATOR = "EPSG:3857"


def _resolution(zoom, tile_size):
    return 2.0 * _ORIGIN / (tile_size * (1 << zoom))


def read_mbtiles(path):
    """Read an MBTiles raster pyramid into a RasterData payload."""
    from dask_geomodeling_tpu_torch.raster.sources import RasterData

    con = sqlite3.connect(path)
    con.row_factory = sqlite3.Row
    try:
        try:
            meta = dict(
                con.execute("SELECT name, value FROM metadata").fetchall()
            )
        except sqlite3.Error:
            meta = {}
        if meta.get("format") == "pbf":
            raise IOError(
                "'%s' holds Mapbox vector tiles (pbf), not raster data"
                % path
            )
        try:
            (zoom,) = con.execute(
                "SELECT MAX(zoom_level) FROM tiles"
            ).fetchone()
        except sqlite3.Error:
            raise IOError("Not an MBTiles file (no tiles table): '%s'" % path)
        if zoom is None:
            raise IOError("MBTiles file holds no tiles: '%s'" % path)
        tiles = con.execute(
            "SELECT tile_column, tile_row, tile_data FROM tiles "
            "WHERE zoom_level = ?",
            (zoom,),
        ).fetchall()
    finally:
        con.close()

    columns = [t["tile_column"] for t in tiles]
    rows = [t["tile_row"] for t in tiles]
    col0, row_max = min(columns), max(rows)
    n_cols = max(columns) - col0 + 1
    n_rows = row_max - min(rows) + 1

    # decode first: real pyramids mix grayscale and RGB(A) tiles
    decoded = [
        (tile["tile_column"], tile["tile_row"], gpkg_raster._decode_tile(tile["tile_data"]))
        for tile in tiles
    ]
    tile_size = decoded[0][2].shape[2]
    # TMS rows count from the south: the highest row is the top strip
    mosaic = gpkg_raster._mosaic(
        decoded, n_rows, n_cols, decoded[0][2].shape[1], tile_size,
        lambda column, row, array: ((row_max - row) * array.shape[1], (column - col0) * tile_size))

    res = _resolution(zoom, tile_size)
    origin_x = -_ORIGIN + col0 * tile_size * res
    origin_y = -_ORIGIN + (row_max + 1) * tile_size * res
    return RasterData(
        array=np.ascontiguousarray(mosaic),
        projection=_MERCATOR,
        geo_transform=(origin_x, res, 0.0, origin_y, 0.0, -res),
        no_data_value=None,
        metadata=[meta.get("name", "")] * mosaic.shape[0],
    )


def write_mbtiles(path, array, geo_transform, projection=None,
                  name="raster", tile_size=256):
    """Write (bands, h, w) uint8 data as a single-zoom PNG MBTiles file.

    The input must be in Web Mercator with a pixel size on the tile
    grid's resolution ladder (2 * 20037508.34... / (tile_size * 2**z));
    the array is padded with zeros out to tile boundaries.
    """
    array = np.asarray(array)
    if array.ndim == 2:
        array = array[None]
    if projection not in (None, _MERCATOR, "EPSG:900913"):
        raise ValueError(
            "MBTiles are Web Mercator (EPSG:3857); got %r" % (projection,)
        )
    ox, px, _, oy, _, py = (float(v) for v in geo_transform)
    if py > 0:
        raise NotImplementedError("MBTiles input must be north-up (dy < 0)")
    zoom = round(math.log2(2.0 * _ORIGIN / (tile_size * px)))
    if zoom < 0 or abs(_resolution(zoom, tile_size) - px) > 1e-6 * px:
        raise ValueError(
            "Pixel size %r is not on the Web Mercator zoom ladder for "
            "%d-px tiles" % (px, tile_size)
        )
    res = _resolution(zoom, tile_size)
    span = tile_size * res

    bands, height, width = array.shape
    col0 = math.floor((ox + _ORIGIN) / span + 1e-9)
    row_top = math.floor((_ORIGIN - oy) / span + 1e-9)  # XYZ row of top strip
    pad_left = int(round((ox - (-_ORIGIN + col0 * span)) / res))
    pad_top = int(round((oy - (_ORIGIN - row_top * span)) / -res))
    padded = np.zeros(
        (
            bands,
            math.ceil((pad_top + height) / tile_size) * tile_size,
            math.ceil((pad_left + width) / tile_size) * tile_size,
        ),
        dtype=array.dtype,
    )
    padded[:, pad_top : pad_top + height, pad_left : pad_left + width] = array
    max_row_tms = (1 << zoom) - 1 - row_top  # top strip in TMS rows

    # bounds metadata is WGS84 (lon/lat) per the MBTiles spec
    def _lon(x):
        return x / _ORIGIN * 180.0

    def _lat(y):
        return math.degrees(
            2.0 * math.atan(math.exp(y / _ORIGIN * math.pi)) - math.pi / 2.0
        )

    bounds = "%.9f,%.9f,%.9f,%.9f" % (
        _lon(ox), _lat(oy + height * py), _lon(ox + width * px), _lat(oy),
    )

    if os.path.exists(path):
        os.remove(path)
    con = sqlite3.connect(path)
    try:
        con.execute("CREATE TABLE metadata (name TEXT, value TEXT)")
        con.executemany(
            "INSERT INTO metadata VALUES (?, ?)",
            [
                ("name", name),
                ("type", "baselayer"),
                ("version", "1.1"),
                ("format", "png"),
                ("bounds", bounds),
                ("minzoom", str(zoom)),
                ("maxzoom", str(zoom)),
            ],
        )
        con.execute(
            "CREATE TABLE tiles (zoom_level INTEGER, tile_column INTEGER, "
            "tile_row INTEGER, tile_data BLOB)"
        )
        con.execute(
            "CREATE UNIQUE INDEX tile_index ON tiles "
            "(zoom_level, tile_column, tile_row)"
        )
        for row, col, blob in gpkg_raster._png_tiles(padded, tile_size):
            con.execute(
                "INSERT INTO tiles VALUES (?,?,?,?)",
                (zoom, col0 + col, max_row_tms - row, blob),
            )
        con.commit()
    finally:
        con.close()
