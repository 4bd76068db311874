"""Zarr v2 raster stores (directory layout, xarray conventions).

Counterpart of dask_geomodeling_tpu/io/zarr.py, copied: the same
RasterData payloads, the same header-only info, and the JAX writer's
bytes.  It decodes v2 directory stores:

- root array stores (``.zarray`` at the top) and group stores
  (``.zgroup`` + one subdirectory per array), with or without
  consolidated metadata (``.zmetadata``)
- chunk grids in C order, ``.``- or ``/``-separated chunk keys, missing
  chunks backed by ``fill_value``, edge chunks trimmed
- numcodecs compressors with stdlib counterparts: ``zlib``, ``gzip``,
  ``bz2``, ``lzma`` and uncompressed (``null``); ``blosc``/``zstd``
  chunks raise a clear error
- georeferencing via the xarray ``_ARRAY_DIMENSIONS`` convention:
  1-D coordinate arrays named after the data array's trailing (y, x)
  dimensions give cell centers; CRS from CF ``grid_mapping``/
  ``spatial_ref``/``crs_wkt`` attributes (io/netcdf.py
  _assemble_raster/_crs_from_atts)

``read_zarr_window`` decodes only the chunks a pixel window touches;
``read_zarr_info`` reads the grid from the metadata and the 1-D
coordinate arrays without decoding a data chunk.  ``write_zarr`` emits a
consolidated, zlib-compressed group store, one chunk an array (one data
variable + x/y coordinates + CF crs).
"""
import json
import os
import zlib

import numpy as np

__all__ = ["read_zarr", "read_zarr_info", "read_zarr_window", "write_zarr"]


def _decompress(raw, compressor):
    if compressor is None:
        return raw
    cid = compressor.get("id")
    if cid in ("zlib", "gzip"):
        # numcodecs GZip frames with the gzip header; Zlib is bare
        import gzip as _gzip

        return _gzip.decompress(raw) if cid == "gzip" else zlib.decompress(raw)
    if cid == "bz2":
        import bz2

        return bz2.decompress(raw)
    if cid == "lzma":
        import lzma

        return lzma.decompress(raw)
    raise NotImplementedError(
        "Zarr compressor %r is not available in this environment "
        "(supported: zlib, gzip, bz2, lzma, null)" % cid
    )


def _load_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except OSError:
        return None


def _find_arrays(root):
    """{name: (dirpath, .zarray meta, .zattrs)} for a v2 store."""
    consolidated = _load_json(os.path.join(root, ".zmetadata"))
    arrays = {}
    if consolidated is not None:
        meta = consolidated.get("metadata", {})
        for key, value in meta.items():
            if key.endswith("/.zarray"):
                name = key[: -len("/.zarray")]
                arrays[name] = (
                    os.path.join(root, name),
                    value,
                    meta.get(name + "/.zattrs", {}),
                )
        if ".zarray" in meta:
            arrays[""] = (root, meta[".zarray"], meta.get(".zattrs", {}))
        return arrays
    top = _load_json(os.path.join(root, ".zarray"))
    if top is not None:
        return {"": (root, top, _load_json(os.path.join(root, ".zattrs")) or {})}
    for entry in sorted(os.listdir(root)):
        sub = os.path.join(root, entry)
        meta = _load_json(os.path.join(sub, ".zarray"))
        if meta is not None:
            arrays[entry] = (
                sub, meta, _load_json(os.path.join(sub, ".zattrs")) or {}
            )
    return arrays


def _read_array(dirpath, meta, window=None):
    """Assemble a zarr v2 array from its chunk files.

    ``window`` restricts the LAST TWO dimensions to ``((r0, r1),
    (c0, c1))``: only the chunks that window touches are opened and
    decompressed (on the GeoTIFF codec's thread pool, as its block-level
    window reader decodes its blocks) — the chunked-store counterpart of
    io/geotiff.py read_geotiff_window."""
    import itertools

    from dask_geomodeling_tpu_torch.io.geotiff import _map_chunks

    if meta.get("zarr_format") != 2:
        raise NotImplementedError(
            "Only Zarr format 2 is supported (got %r)"
            % meta.get("zarr_format")
        )
    if meta.get("filters"):
        raise NotImplementedError("Zarr filters are not supported")
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    dtype = np.dtype(meta["dtype"])
    order = meta.get("order", "C")
    sep = meta.get("dimension_separator", ".")
    compressor = meta.get("compressor")
    fill = meta.get("fill_value")
    if fill in ("NaN", "Infinity", "-Infinity"):
        fill = float(fill.replace("Infinity", "inf"))

    bounds = [(0, s) for s in shape]
    if window is not None:
        if len(shape) < 2:
            raise ValueError("windowed reads need a >= 2-D array")
        bounds[-2] = (int(window[0][0]), int(window[0][1]))
        bounds[-1] = (int(window[1][0]), int(window[1][1]))
    out = np.full(
        [b1 - b0 for b0, b1 in bounds], 0 if fill is None else fill,
        dtype=dtype.newbyteorder("="),
    )
    ranges = [
        range(b0 // c, max(-(-b1 // c), b0 // c))
        for (b0, b1), c in zip(bounds, chunks)
    ]

    def load(index):
        key = sep.join(str(i) for i in index) or "0"
        path = os.path.join(dirpath, *key.split("/")) if sep == "/" else (
            os.path.join(dirpath, key)
        )
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            return  # missing chunk: fill_value background
        buf = _decompress(raw, compressor)
        chunk = np.frombuffer(buf, dtype=dtype, count=int(np.prod(chunks)))
        chunk = chunk.reshape(chunks, order=order)
        src = []
        dst = []
        for i, c, s, (b0, b1) in zip(index, chunks, shape, bounds):
            lo = max(i * c, b0)
            hi = min((i + 1) * c, b1, s)
            src.append(slice(lo - i * c, hi - i * c))
            dst.append(slice(lo - b0, hi - b0))
        out[tuple(dst)] = chunk[tuple(src)]

    # each chunk fills its own cells of ``out``, on the codec's pool
    _map_chunks(load, list(itertools.product(*ranges)))
    return out


def _open_store(path, variable=None):
    """(loaded arrays, data-array name, root attrs) for a v2 store."""
    arrays = _find_arrays(path)
    if not arrays:
        raise IOError("Not a Zarr v2 store (no .zarray found): '%s'" % path)

    loaded = {
        name: (dirpath, meta, atts or {})
        for name, (dirpath, meta, atts) in arrays.items()
    }
    # candidate data arrays: >= 2 dims, not 1-D coordinates
    candidates = {
        name: entry
        for name, entry in loaded.items()
        if len(entry[1]["shape"]) >= 2
    }
    if variable is not None:
        candidates = {k: v for k, v in candidates.items() if k == variable}
    if not candidates:
        raise IOError("No 2-D data array in Zarr store '%s'" % path)
    name = max(
        candidates, key=lambda n: int(np.prod(candidates[n][1]["shape"]))
    )
    gatts = _load_json(os.path.join(path, ".zattrs")) or {}
    return loaded, name, gatts


def _grid_centers(loaded, atts, height, width):
    """Cell-center coordinate vectors (storage order) along (y, x)."""
    dims = atts.get("_ARRAY_DIMENSIONS") or []

    def centers(dim, length, descending=False):
        entry = loaded.get(dim)
        if entry is None or len(entry[1]["shape"]) != 1:
            # no coordinate array: row 0 is the top (image convention)
            default = np.arange(length, dtype=float) + 0.5
            return default[::-1] if descending else default
        return np.asarray(_read_array(entry[0], entry[1]), dtype=float)

    xs = centers(dims[-1] if len(dims) >= 1 else None, width)
    ys = centers(dims[-2] if len(dims) >= 2 else None, height,
                 descending=True)
    return xs, ys


def _assemble(loaded, name, gatts, array, xs, ys, spacing=None):
    from dask_geomodeling_tpu_torch.io.netcdf import _assemble_raster

    variables = [
        {"name": var_name, "atts": entry[2]}
        for var_name, entry in loaded.items()
    ]
    data_var = {"name": name or "data", "atts": loaded[name][2]}
    return _assemble_raster(
        gatts, variables, data_var, array, xs, ys, spacing=spacing
    )


def read_zarr(path, variable=None):
    """Read a Zarr v2 store into RasterData (xarray conventions)."""
    loaded, name, gatts = _open_store(path, variable)
    dirpath, meta, atts = loaded[name]
    array = _read_array(dirpath, meta)
    xs, ys = _grid_centers(loaded, atts, *array.shape[-2:])
    return _assemble(loaded, name, gatts, array, xs, ys)


def read_zarr_info(path, variable=None):
    """Header-only info (GeoTIFFInfo shape) — grid, dtype, CRS and fill
    derived from store metadata and the small 1-D coordinate arrays,
    without touching any data chunk."""
    from dask_geomodeling_tpu_torch.io.geotiff import GeoTIFFInfo
    from dask_geomodeling_tpu_torch.io.netcdf import _crs_from_atts

    loaded, name, gatts = _open_store(path, variable)
    _, meta, atts = loaded[name]
    shape = tuple(meta["shape"])
    height, width = shape[-2:]
    bands = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    xs, ys = _grid_centers(loaded, atts, height, width)

    # mirror _assemble_raster's orientation/grid rules
    dx = float(xs[1] - xs[0]) if len(xs) > 1 else 1.0
    dy = float(ys[1] - ys[0]) if len(ys) > 1 else -1.0
    y_top = float(ys[-1]) if dy > 0 else float(ys[0])
    if dy > 0:
        dy = -dy
    geo_transform = (
        float(xs[0]) - dx / 2, dx, 0.0, y_top - dy / 2, 0.0, dy,
    )

    dtype = np.dtype(meta["dtype"]).newbyteorder("=")
    fill = atts.get("_FillValue", atts.get("missing_value"))
    if fill is not None:
        # array-valued attributes occur in the wild ("_FillValue": [-9999])
        arr = np.asarray(fill)
        fill = float(arr.ravel()[0]) if arr.size else None
    if "scale_factor" in atts or "add_offset" in atts:
        dtype = np.dtype(np.float32)
        if fill is not None:
            fill = float(np.finfo(np.float32).max)
    if fill is None:
        from dask_geomodeling_tpu_torch.geo.dtypes import get_dtype_max

        fill = float(get_dtype_max(dtype))
    variables = [
        {"name": var_name, "atts": entry[2]}
        for var_name, entry in loaded.items()
    ]
    label = atts.get("long_name") or atts.get("units") or (name or "data")
    return GeoTIFFInfo(
        width=width,
        height=height,
        bands=bands,
        dtype=str(dtype),
        projection=_crs_from_atts(
            gatts, variables, {"name": name or "data", "atts": atts}
        ),
        geo_transform=geo_transform,
        no_data_value=float(fill),
        metadata=[str(label)] * bands,
    )


def read_zarr_window(path, row0, row1, col0, col1, variable=None):
    """Read one north-up pixel window of a Zarr store, decoding only the
    chunks the window touches."""
    loaded, name, gatts = _open_store(path, variable)
    dirpath, meta, atts = loaded[name]
    height, width = tuple(meta["shape"])[-2:]
    row0 = max(0, min(int(row0), height))
    row1 = max(row0, min(int(row1), height)) or 1
    col0 = max(0, min(int(col0), width))
    col1 = max(col0, min(int(col1), width)) or 1
    if row1 == row0:
        row1 = min(row0 + 1, height)
        row0 = row1 - 1
    if col1 == col0:
        col1 = min(col0 + 1, width)
        col0 = col1 - 1
    xs, ys = _grid_centers(loaded, atts, height, width)
    ascending = len(ys) > 1 and ys[1] > ys[0]
    if ascending:  # south-up storage: window flips into storage rows
        s0, s1 = height - row1, height - row0
    else:
        s0, s1 = row0, row1
    # full-grid spacing survives 1-px coordinate slices
    spacing = (
        float(xs[1] - xs[0]) if len(xs) > 1 else 1.0,
        float(ys[1] - ys[0]) if len(ys) > 1 else -1.0,
    )
    array = _read_array(dirpath, meta, window=((s0, s1), (col0, col1)))
    return _assemble(
        loaded, name, gatts, array, xs[col0:col1], ys[s0:s1],
        spacing=spacing,
    )


def _write_array(root, name, array, attrs, compress=True):
    dirpath = os.path.join(root, name)
    os.makedirs(dirpath, exist_ok=True)
    array = np.ascontiguousarray(array)
    meta = {
        "zarr_format": 2,
        "shape": list(array.shape),
        "chunks": list(array.shape),  # single-chunk arrays
        "dtype": array.dtype.newbyteorder("<").str,
        "compressor": {"id": "zlib", "level": 6} if compress else None,
        "fill_value": None,
        "order": "C",
        "filters": None,
    }
    with open(os.path.join(dirpath, ".zarray"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(dirpath, ".zattrs"), "w") as f:
        json.dump(attrs, f)
    payload = array.astype(array.dtype.newbyteorder("<")).tobytes()
    if compress:
        payload = zlib.compress(payload, 6)
    key = ".".join("0" for _ in array.shape) or "0"
    with open(os.path.join(dirpath, key), "wb") as f:
        f.write(payload)
    return meta


def write_zarr(path, values, geo_transform, projection=None,
               no_data_value=None, variable="data"):
    """Write (bands, h, w) data as a consolidated Zarr v2 group store."""
    values = np.asarray(values)
    if values.ndim == 2:
        values = values[None]
    bands, height, width = values.shape
    p, a, _, q, _, d = (float(v) for v in geo_transform)
    xs = p + a * (np.arange(width) + 0.5)
    ys = q + d * (np.arange(height) + 0.5)

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, ".zgroup"), "w") as f:
        json.dump({"zarr_format": 2}, f)
    with open(os.path.join(path, ".zattrs"), "w") as f:
        json.dump({}, f)

    data_attrs = {"_ARRAY_DIMENSIONS": ["band", "y", "x"]}
    if no_data_value is not None:
        data_attrs["_FillValue"] = (
            float(no_data_value)
            if values.dtype.kind == "f"
            else int(no_data_value)
        )
    crs_attrs = None
    if projection is not None:
        from dask_geomodeling_tpu_torch.geo.crs import get_sr

        data_attrs["grid_mapping"] = "spatial_ref"
        crs_attrs = {
            "_ARRAY_DIMENSIONS": [],
            "spatial_ref": get_sr(projection).ExportToWkt(),
        }

    metas = {
        variable: (_write_array(path, variable, values, data_attrs),
                   data_attrs),
        "x": (_write_array(path, "x", xs, {"_ARRAY_DIMENSIONS": ["x"]}),
              {"_ARRAY_DIMENSIONS": ["x"]}),
        "y": (_write_array(path, "y", ys, {"_ARRAY_DIMENSIONS": ["y"]}),
              {"_ARRAY_DIMENSIONS": ["y"]}),
    }
    if crs_attrs is not None:
        metas["spatial_ref"] = (
            _write_array(
                path, "spatial_ref", np.zeros((), dtype="i4"), crs_attrs,
                compress=False,
            ),
            crs_attrs,
        )

    metadata = {".zgroup": {"zarr_format": 2}, ".zattrs": {}}
    for name, (meta, attrs) in metas.items():
        metadata[name + "/.zarray"] = meta
        metadata[name + "/.zattrs"] = attrs
    with open(os.path.join(path, ".zmetadata"), "w") as f:
        json.dump({"metadata": metadata, "zarr_consolidated_format": 1}, f)
