"""GeoPackage raster tile pyramids (.gpkg with ``data_type = 'tiles'``).

Counterpart of dask_geomodeling_tpu/io/gpkg_raster.py, copied: the same
RasterData payload as the JAX reader, and the JAX writer's files.  A
tiles layer stores image blobs in a ``zoom_level / tile_column /
tile_row`` table; ``gpkg_tile_matrix_set`` anchors the grid in CRS space
and ``gpkg_tile_matrix`` gives per-zoom pixel sizes.  Reading assembles
the highest-resolution zoom level present into one mosaic, cropped to
the rows/columns that actually hold tiles (GDAL reports the full
tile-matrix-set extent; for sparse pyramids the present-tile envelope is
the useful dataset).

PNG tiles decode through the port's ``io/png.py``, JPEG tiles through
its ``io/jpeg.py`` and WebP tiles (lossy or lossless) through
``native/webpcodec.cpp`` (the native codecs), where the JAX package calls
Pillow; an animated WebP tile raises NotImplementedError.

``write_gpkg_raster`` emits a single-zoom PNG tile pyramid readable by
GDAL/QGIS, its tiles encoded on the GeoTIFF codec's thread pool.
"""
import math
import os
import sqlite3

import numpy as np

__all__ = ["read_gpkg_raster", "write_gpkg_raster", "is_raster_gpkg"]

def is_raster_gpkg(path):
    """True when the GeoPackage's first content layer is a tile pyramid."""
    try:
        con = sqlite3.connect(path)
        try:
            rows = con.execute(
                "SELECT data_type FROM gpkg_contents"
            ).fetchall()
        finally:
            con.close()
    except sqlite3.Error:
        return False
    return bool(rows) and all(r[0] == "tiles" for r in rows)


def _decode_tile(blob):
    """A tile blob as (bands, h, w): PNG with io/png.py, WebP (lossy or
    lossless) with the native codec, JPEG (and BMP or GIF) with
    io/jpeg.py, converted to L or RGB as the JAX package's Pillow
    conversion does (an RGBA WebP keeps RGB); an animated WebP raises
    NotImplementedError."""
    from dask_geomodeling_tpu_torch.io.jpeg import decode_image, to_pillow_bands
    from dask_geomodeling_tpu_torch.io.png import _SIGNATURE, decode_png_bytes

    if blob[:8] == _SIGNATURE:
        array, _ = decode_png_bytes(blob)
        return array
    if blob[:4] == b"RIFF" and blob[8:12] == b"WEBP":
        from dask_geomodeling_tpu_torch.native import webp_decode_native

        pixels = webp_decode_native(blob)
        return to_pillow_bands({"mode": "RGB" if pixels.shape[2] == 3 else "RGBA",
                                "pixels": pixels})
    return to_pillow_bands(decode_image(blob))


def _mosaic(decoded, n_rows, n_cols, tile_h, tile_w, place):
    """The (bands, n_rows * tile_h, n_cols * tile_w) mosaic of the
    ``(column, row, array)`` tiles, each at ``place(column, row)`` (its
    top-left cell); the band count is the largest of any tile, a gray
    tile broadcast to it."""
    n_bands = max(array.shape[0] for _, _, array in decoded)
    mosaic = np.zeros(
        (n_bands, n_rows * tile_h, n_cols * tile_w),
        dtype=decoded[0][2].dtype,
    )
    for column, row, array in decoded:
        if array.shape[0] < n_bands:
            reps = [array[0]] * (n_bands - array.shape[0] + 1)
            array = np.concatenate([np.stack(reps), array[1:]])[:n_bands]
        r, c = place(column, row, array)
        mosaic[:, r : r + array.shape[1], c : c + array.shape[2]] = (
            array[:n_bands]
        )
    return mosaic


def _png_tiles(padded, tile_size):
    """``(row, column, PNG bytes)`` of every tile of ``padded`` (bands,
    rows, columns of whole tiles), row by row: the writers' order.  The
    tiles encode on the GeoTIFF codec's thread pool."""
    from dask_geomodeling_tpu_torch.io.geotiff import _map_chunks
    from dask_geomodeling_tpu_torch.io.png import write_png_bytes

    cells = [(row, col) for row in range(padded.shape[1] // tile_size)
             for col in range(padded.shape[2] // tile_size)]
    blobs = _map_chunks(
        lambda cell: write_png_bytes(padded[
            :,
            cell[0] * tile_size : (cell[0] + 1) * tile_size,
            cell[1] * tile_size : (cell[1] + 1) * tile_size,
        ]),
        cells,
    )
    return [(row, col, blob) for (row, col), blob in zip(cells, blobs)]


def read_gpkg_raster(path, layer=None):
    """Read a GeoPackage tile layer into a RasterData payload."""
    from dask_geomodeling_tpu_torch.raster.sources import RasterData

    con = sqlite3.connect(path)
    con.row_factory = sqlite3.Row
    try:
        layers = con.execute(
            "SELECT table_name, srs_id FROM gpkg_contents "
            "WHERE data_type = 'tiles'"
        ).fetchall()
        if not layers:
            raise IOError("No tile layers in '%s'" % path)
        if layer is None:
            chosen = layers[0]
        else:
            matching = [l for l in layers if l["table_name"] == layer]
            if not matching:
                raise IOError("Tile layer '%s' not found in '%s'" % (layer, path))
            chosen = matching[0]
        table, srs_id = chosen["table_name"], chosen["srs_id"]

        matrix_set = con.execute(
            "SELECT min_x, min_y, max_x, max_y FROM gpkg_tile_matrix_set "
            "WHERE table_name = ?",
            (table,),
        ).fetchone()
        if matrix_set is None:
            raise IOError("No gpkg_tile_matrix_set row for '%s'" % table)

        (zoom,) = con.execute(
            'SELECT MAX(zoom_level) FROM "{}"'.format(table)
        ).fetchone()
        if zoom is None:
            raise IOError("Tile layer '%s' holds no tiles" % table)
        matrix = con.execute(
            "SELECT tile_width, tile_height, pixel_x_size, pixel_y_size "
            "FROM gpkg_tile_matrix WHERE table_name = ? AND zoom_level = ?",
            (table, zoom),
        ).fetchone()
        if matrix is None:
            raise IOError(
                "No gpkg_tile_matrix row for '%s' zoom %d" % (table, zoom)
            )
        tile_w, tile_h = matrix["tile_width"], matrix["tile_height"]
        px, py = matrix["pixel_x_size"], matrix["pixel_y_size"]

        tiles = con.execute(
            'SELECT tile_column, tile_row, tile_data FROM "{}" '
            "WHERE zoom_level = ?".format(table),
            (zoom,),
        ).fetchall()
    finally:
        con.close()

    columns = [t["tile_column"] for t in tiles]
    rows = [t["tile_row"] for t in tiles]
    col0, row0 = min(columns), min(rows)
    n_cols = max(columns) - col0 + 1
    n_rows = max(rows) - row0 + 1

    # decode first: pyramids may mix grayscale and RGB(A) tiles
    decoded = [
        (tile["tile_column"], tile["tile_row"], _decode_tile(tile["tile_data"]))
        for tile in tiles
    ]
    mosaic = _mosaic(decoded, n_rows, n_cols, tile_h, tile_w,
                     lambda column, row, _: ((row - row0) * tile_h, (column - col0) * tile_w))

    # grid anchor: tile (0, 0) sits at (min_x, max_y) of the matrix set
    origin_x = matrix_set["min_x"] + col0 * tile_w * px
    origin_y = matrix_set["max_y"] - row0 * tile_h * py

    return RasterData(
        array=np.ascontiguousarray(mosaic),
        projection="EPSG:%d" % srs_id if srs_id else None,
        geo_transform=(origin_x, px, 0.0, origin_y, 0.0, -py),
        no_data_value=None,
        metadata=[""] * mosaic.shape[0],
    )


def write_gpkg_raster(path, array, geo_transform, projection=None,
                      layer="tiles", tile_size=256):
    """Write (bands, h, w) uint8/uint16 data as a single-zoom PNG tile
    pyramid GeoPackage."""
    array = np.asarray(array)
    if array.ndim == 2:
        array = array[None]
    bands, height, width = array.shape
    ox, px, _, oy, _, py = (float(v) for v in geo_transform)
    if py > 0:
        raise NotImplementedError("GeoPackage tiles are north-up (dy < 0)")

    srs_id = 0
    if projection:
        text = str(projection).upper()
        if text.startswith("EPSG:"):
            srs_id = int(text.split(":")[1])

    n_cols = math.ceil(width / tile_size)
    n_rows = math.ceil(height / tile_size)

    if os.path.exists(path):
        os.remove(path)
    con = sqlite3.connect(path)
    try:
        con.execute("PRAGMA application_id = 0x47504B47")  # 'GPKG'
        con.execute(
            "CREATE TABLE gpkg_spatial_ref_sys (srs_name TEXT, srs_id "
            "INTEGER PRIMARY KEY, organization TEXT, "
            "organization_coordsys_id INTEGER, definition TEXT, "
            "description TEXT)"
        )
        if srs_id:
            from dask_geomodeling_tpu_torch.geo.crs import get_sr

            con.execute(
                "INSERT INTO gpkg_spatial_ref_sys VALUES (?,?,?,?,?,NULL)",
                (
                    "EPSG:%d" % srs_id,
                    srs_id,
                    "EPSG",
                    srs_id,
                    get_sr("EPSG:%d" % srs_id).ExportToWkt(),
                ),
            )
        max_x = ox + n_cols * tile_size * px
        min_y = oy + n_rows * tile_size * py
        con.execute(
            "CREATE TABLE gpkg_contents (table_name TEXT PRIMARY KEY, "
            "data_type TEXT, identifier TEXT, min_x DOUBLE, min_y DOUBLE, "
            "max_x DOUBLE, max_y DOUBLE, srs_id INTEGER)"
        )
        con.execute(
            "INSERT INTO gpkg_contents VALUES (?,?,?,?,?,?,?,?)",
            (layer, "tiles", layer, ox, min_y, max_x, oy, srs_id),
        )
        con.execute(
            "CREATE TABLE gpkg_tile_matrix_set (table_name TEXT PRIMARY "
            "KEY, srs_id INTEGER, min_x DOUBLE, min_y DOUBLE, "
            "max_x DOUBLE, max_y DOUBLE)"
        )
        con.execute(
            "INSERT INTO gpkg_tile_matrix_set VALUES (?,?,?,?,?,?)",
            (layer, srs_id, ox, min_y, max_x, oy),
        )
        con.execute(
            "CREATE TABLE gpkg_tile_matrix (table_name TEXT, zoom_level "
            "INTEGER, matrix_width INTEGER, matrix_height INTEGER, "
            "tile_width INTEGER, tile_height INTEGER, pixel_x_size "
            "DOUBLE, pixel_y_size DOUBLE)"
        )
        con.execute(
            "INSERT INTO gpkg_tile_matrix VALUES (?,?,?,?,?,?,?,?)",
            (layer, 0, n_cols, n_rows, tile_size, tile_size, px, -py),
        )
        con.execute(
            'CREATE TABLE "{}" (id INTEGER PRIMARY KEY, zoom_level '
            "INTEGER, tile_column INTEGER, tile_row INTEGER, "
            "tile_data BLOB)".format(layer)
        )
        # the array padded with zeros to whole tiles, as each tile's
        # window is in the JAX writer
        padded = np.zeros((bands, n_rows * tile_size, n_cols * tile_size), dtype=array.dtype)
        padded[:, :height, :width] = array
        for row, col, blob in _png_tiles(padded, tile_size):
            con.execute(
                'INSERT INTO "{}" (zoom_level, tile_column, tile_row,'
                " tile_data) VALUES (?,?,?,?)".format(layer),
                (0, col, row, blob),
            )
        con.commit()
    finally:
        con.close()
