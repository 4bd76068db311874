"""The host read caches of raster and vector files.

Counterpart of dask_geomodeling_tpu/runtime/pipeline.py, for GeoTIFF,
VRT, PNG, the plain-grid formats (SRTM and DTED, Esri ASCII and XYZ,
Surfer, SAGA, Idrisi, ENVI), the tile pyramids (MBTiles and the
GeoPackage tile layers: a ``.gpkg`` given to a raster reader is always
read as tiles), ERDAS Imagine (HFA) ``.img`` files, GRIB editions 1 and
2 (``.grib``, ``.grib2``, ``.grb``, ``.grb2``, ``.gb2``), NITF
(``.ntf``, ``.nitf``), Zarr v2
stores, HDF4 and netCDF (classic, and netCDF-4/HDF5 where h5py is
importable): ``read_geotiff_cached`` decodes a whole file or store into an
mtime-validated LRU, choosing the reader
by suffix in the JAX package's order (an ``.hdf``, ``.h4`` or ``.hdf4``
by its magic: HDF4 with its magic, netCDF otherwise), and
``read_geotiff_window_cached`` one pixel window of a large GeoTIFF, VRT,
Zarr store, HDF4 or netCDF file (block- or chunk-wise, a GeoTIFF
optionally of an overview level; a classic netCDF file's window is a
slice of its cached whole decode) into another.  Both are keyed by ``(path,
variable)`` plus the window, on lookup and on store alike, so every tile
of a request that reads one unchanged file gets the same decoded array
(the JAX package looks the whole-file entry up by the path and stores it
by ``(path, variable)``, so its lookups never hit); ``variable`` selects
a Zarr store's or a netCDF file's data variable.  A rewrite of the file
changes its stamp (mtime and size) and is decoded again; an ENVI pair's
stamp holds both files', so a rewrite of the header alone is seen too,
and a Zarr store's a walk of its entries (``_zarr_stamp``), so a chunk
rewritten in a subdirectory is.

``read_vector_cached`` parses a whole vector file into a third LRU, keyed
by ``(path, layer)`` on lookup and store and validated by the same stamp;
callers treat the frame it returns as read-only.

The other raster formats of the JAX package's reader raise
NotImplementedError naming the JAX module that reads them.  Its
``TilePrefetcher`` is not ported.
"""
import os
import threading
from collections import OrderedDict
from functools import partial

__all__ = [
    "read_geotiff_cached",
    "read_geotiff_window_cached",
    "read_vector_cached",
    "clear_read_cache",
    "check_ported_format",
    "is_hdf4",
    "is_netcdf",
    "whole_file_reader",
]

_CACHE_LOCK = threading.Lock()
_READ_CACHE = OrderedDict()
_READ_CACHE_SIZE = 8
_WINDOW_CACHE = OrderedDict()
_WINDOW_CACHE_SIZE = 64
_VECTOR_CACHE = OrderedDict()
_VECTOR_CACHE_SIZE = 16

#: file suffixes of the raster formats the port does not read, and the
#: JAX module that reads each; the port reads GeoTIFF, VRT, Zarr stores,
#: HDF4, netCDF and the formats of ``whole_file_reader``, the tile
#: pyramids (an animated WebP tile in them raises, naming
#: io/gpkg_raster.py), GRIB
#: (a JPEG 2000 field raises, naming io/grib.py), NITF (a JPEG 2000
#: segment raises, naming io/nitf.py) and JPEG, BMP and GIF among them
_UNPORTED_FORMATS = {
    (".jp2", ".j2k", ".jpx"): "io/jp2.py",
}
_NETCDF_SUFFIXES = (".nc", ".cdf", ".nc3", ".nc4", ".h5", ".hdf5")
#: HDF4 by its magic, HDF5 (read as netCDF-4) otherwise
_HDF_SUFFIXES = (".hdf", ".h4", ".hdf4")
_HFA_MAGIC = b"EHFA_HEADER_TAG\x00"
_HDF4_MAGIC = b"\x0e\x03\x13\x01"


def _has_magic(path, magic):
    try:
        with open(path, "rb") as stream:
            return stream.read(len(magic)) == magic
    except OSError:
        return False


def check_ported_format(path):
    """Raise NotImplementedError when ``path`` names a raster format the
    port does not read."""
    lower = path.lower()
    module = next((m for suffixes, m in _UNPORTED_FORMATS.items() if lower.endswith(suffixes)),
                  None)
    if module is not None:
        raise NotImplementedError(
            "reading %s is not ported: dask_geomodeling_tpu/%s reads it"
            % (os.path.basename(path), module)
        )


def is_hdf4(path):
    """Whether ``path`` is read as HDF4: an ``.hdf``, ``.h4`` or ``.hdf4``
    with HDF4's magic."""
    return path.lower().endswith(_HDF_SUFFIXES) and _has_magic(path, _HDF4_MAGIC)


def is_netcdf(path):
    """Whether ``path`` is read as netCDF: by its suffix, an ``.hdf``,
    ``.h4`` or ``.hdf4`` only without HDF4's magic."""
    lower = path.lower()
    return lower.endswith(_NETCDF_SUFFIXES) or (lower.endswith(_HDF_SUFFIXES)
                                                and not is_hdf4(path))


def whole_file_reader(path):
    """The reader of a format that decodes whole, chosen by suffix in the
    JAX package's order (an ``.img`` is HFA by its magic; ``.img``,
    ``.dat`` and ``.raw`` are ENVI when a header sits beside them), or
    None for GeoTIFF and VRT."""
    from dask_geomodeling_tpu_torch.io import (
        asciigrid, dem, envi, gpkg_raster, grib, hfa, jpeg, mbtiles, nitf, png, simplegrids,
    )

    lower = path.lower()
    for suffixes, reader in (
        ((".asc", ".agr"), asciigrid.read_ascii_grid),
        ((".xyz",), asciigrid.read_xyz),
        ((".png",), png.read_png),
        ((".jpg", ".jpeg", ".bmp", ".gif"), jpeg.read_jpeg),
        ((".ntf", ".nitf"), nitf.read_nitf),
        ((".hgt",), dem.read_hgt),
        ((".dt0", ".dt1", ".dt2"), dem.read_dted),
        ((".grib", ".grib2", ".grb", ".grb2", ".gb2"), grib.read_grib),
        ((".grd",), simplegrids.read_surfer),
        ((".sgrd", ".sdat"), simplegrids.read_saga),
        ((".rst",), simplegrids.read_idrisi),
        ((".mbtiles",), mbtiles.read_mbtiles),
        ((".gpkg",), gpkg_raster.read_gpkg_raster),
        ((".hdr", ".bsq", ".bil", ".bip", ".envi"), envi.read_envi),
    ):
        if lower.endswith(suffixes):
            return reader
    if lower.endswith(".img") and _has_magic(path, _HFA_MAGIC):
        return hfa.read_hfa
    if lower.endswith((".img", ".dat", ".raw")) and envi.has_envi_header(path):
        return envi.read_envi
    return None


def _file_stamp(path):
    # (mtime_ns, size): plain mtime has 1 s granularity on some filesystems,
    # so a rewrite within the same tick would serve the stale decode
    st = os.stat(path)
    return (st.st_mtime_ns, st.st_size)


def _cached(cache, size, key, stamp, read):
    """``cache[key]`` if its stamp is ``stamp``, else ``read()`` stored."""
    with _CACHE_LOCK:
        entry = cache.get(key)
        if entry is not None and entry[0] == stamp:
            cache.move_to_end(key)
            return entry[1]
    data = read()
    with _CACHE_LOCK:
        cache[key] = (stamp, data)
        cache.move_to_end(key)
        while len(cache) > size:
            cache.popitem(last=False)
    return data


def _envi_stamp(path):
    """The stamps of both files of the ENVI pair that ``path`` is half of."""
    from dask_geomodeling_tpu_torch.io.envi import _paths_of

    return tuple(_file_stamp(p) for p in _paths_of(path))


#: entry budget for the zarr stamp walk; stores with more files fold a
#: coarse per-directory stamp instead of per-entry mtimes
_ZARR_STAMP_LIMIT = 8192


def _zarr_stamp(root):
    """(count, newest mtime_ns, total size) over the store's files.

    A bounded walk: chunk rewrites inside subdirectories bump neither the
    root directory's mtime nor any metadata document.  Enormous chunk
    trees stop at the entry budget and return a coarse directory-level
    stamp: creations and deletions are still detected there; only
    in-place chunk rewrites beyond the budget can go unseen.  The JAX
    package's walk, entry for entry, but each entry is stat-ed relative
    to its directory's descriptor (``fstatat``), not by its whole path:
    the walk runs on every cache lookup, and a lookup by path is costly
    on network and 9p file systems.
    """
    count = 0
    newest = 0
    total = 0
    stack = [root]
    while stack:
        directory = stack.pop()
        try:
            fd = os.open(directory, os.O_RDONLY | os.O_DIRECTORY)
        except OSError:
            continue
        try:
            with os.scandir(fd) as entries:
                for entry in entries:
                    count += 1
                    if count > _ZARR_STAMP_LIMIT:
                        return ("coarse", count, newest, total)
                    try:
                        st = entry.stat(follow_symlinks=False)
                    except OSError:
                        continue
                    newest = max(newest, st.st_mtime_ns)
                    total += st.st_size
                    if entry.is_dir(follow_symlinks=False):
                        stack.append(os.path.join(directory, entry.name))
        except OSError:
            continue
        finally:
            os.close(fd)
    return (count, newest, total)


def _store_stamp(path):
    """A ``.zarr`` directory's stamp: its own and the walk of its entries
    (a ``.zarr`` file's own stamp), as the JAX package's ``_raster_stamp``
    gives it."""
    stamp = _file_stamp(path)
    return (stamp, _zarr_stamp(path)) if os.path.isdir(path) else stamp


def read_geotiff_cached(path, variable=None):
    """Read a whole raster file (GeoTIFF, VRT mosaic, Zarr store, HDF4 or
    netCDF file or a format of ``whole_file_reader``) through an
    mtime-validated LRU keyed by ``(path, variable)``; ``variable`` selects
    a Zarr store's
    or a netCDF file's data variable and is kept in the key for every
    format, as the JAX package keeps it."""
    from dask_geomodeling_tpu_torch.io.envi import read_envi
    from dask_geomodeling_tpu_torch.io.geotiff import read_geotiff
    from dask_geomodeling_tpu_torch.io.hdf4 import read_hdf4
    from dask_geomodeling_tpu_torch.io.netcdf import read_netcdf
    from dask_geomodeling_tpu_torch.io.vrt import read_vrt
    from dask_geomodeling_tpu_torch.io.zarr import read_zarr

    path = os.path.abspath(path)
    check_ported_format(path)
    key = (path, variable)
    if path.lower().endswith(".zarr"):
        return _cached(_READ_CACHE, _READ_CACHE_SIZE, key, _store_stamp(path),
                       partial(read_zarr, path, variable))
    if is_hdf4(path):
        return _cached(_READ_CACHE, _READ_CACHE_SIZE, key, _file_stamp(path),
                       partial(read_hdf4, path))
    if is_netcdf(path):
        return _cached(_READ_CACHE, _READ_CACHE_SIZE, key, _file_stamp(path),
                       partial(read_netcdf, path, variable))
    read = whole_file_reader(path) or (read_vrt if path.lower().endswith(".vrt") else read_geotiff)
    stamp = _envi_stamp(path) if read is read_envi else _file_stamp(path)
    return _cached(_READ_CACHE, _READ_CACHE_SIZE, key, stamp, partial(read, path))


def read_geotiff_window_cached(path, row0, row1, col0, col1, level=0, variable=None):
    """Read one pixel window of a large GeoTIFF (block-level decode,
    optionally of an overview level), VRT, Zarr store (chunk-level decode
    of ``variable``), HDF4 file (chunk-level decode) or netCDF file (of
    ``variable``: a netCDF-4 file's chunks, a classic file's cached whole
    decode sliced) through an mtime-validated LRU keyed by ``(path,
    window, level, variable)``."""
    from dask_geomodeling_tpu_torch.io.geotiff import read_geotiff_window
    from dask_geomodeling_tpu_torch.io.hdf4 import read_hdf4_window
    from dask_geomodeling_tpu_torch.io.netcdf import read_netcdf_window
    from dask_geomodeling_tpu_torch.io.vrt import read_vrt_window
    from dask_geomodeling_tpu_torch.io.zarr import read_zarr_window

    path = os.path.abspath(path)
    check_ported_format(path)
    key = (path, int(row0), int(row1), int(col0), int(col1), int(level), variable)
    stamp = _file_stamp(path)
    if path.lower().endswith(".zarr"):
        stamp = _store_stamp(path)
        read = partial(read_zarr_window, path, row0, row1, col0, col1, variable=variable)
    elif is_hdf4(path):
        read = partial(read_hdf4_window, path, row0, row1, col0, col1)
    elif is_netcdf(path):
        read = partial(read_netcdf_window, path, row0, row1, col0, col1, variable=variable)
    elif path.lower().endswith(".vrt"):
        read = partial(read_vrt_window, path, row0, row1, col0, col1)
    else:
        read = partial(read_geotiff_window, path, row0, row1, col0, col1, level=level)
    return _cached(_WINDOW_CACHE, _WINDOW_CACHE_SIZE, key, stamp, read)


def read_vector_cached(path, layer=None):
    """Read a whole vector file through an mtime-validated LRU keyed by
    ``(path, layer)``, so the tiles of a request parse an unchanged file
    once.  The frame is shared: callers must treat it as read-only
    (GeometryFileSource copies it before it writes to it)."""
    from dask_geomodeling_tpu_torch.io import vectorfile

    path = os.path.abspath(path)
    return _cached(
        _VECTOR_CACHE, _VECTOR_CACHE_SIZE, (path, layer), _file_stamp(path),
        partial(vectorfile.read_vector, path, layer=layer),
    )


def clear_read_cache():
    """Drop all cached decoded rasters and vector frames."""
    with _CACHE_LOCK:
        _READ_CACHE.clear()
        _WINDOW_CACHE.clear()
        _VECTOR_CACHE.clear()
