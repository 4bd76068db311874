"""The GeoTIFF codec: the port's copy of dask_geomodeling_tpu/io/geotiff.py.

The same reader and writer, so that the port writes the same bytes (zlib
level 6) and reads every file the JAX package writes.  LZW and PackBits
chunks decode natively, as the JAX package's do: ``native/tiffcodec.cpp``,
built with g++ at first use (native/__init__.py), on the codec's thread
pool, a window's chunks in parallel (ctypes releases the GIL).  JPEG
chunks (compression 7) decode on the same pool with the port's own codec,
``native/jpegcodec.cpp``, and WebP chunks (compression 50001, lossy or
lossless) with ``native/webpcodec.cpp``, which also writes them
(losslessly), where the JAX package calls Pillow.  The
pure-Python ``_lzw_decode`` and ``_packbits_decode`` are the plain
versions the native decoders are held to; no read falls back to them.

Read support (foreign files):

- classic TIFF and BigTIFF, little- and big-endian
- striped or tiled layout, chunky (contig) or planar organization
- uncompressed, DEFLATE (zlib), LZW (with early-change), PackBits, LZMA
  (stdlib ``lzma``); ZSTD through a lazy import of ``zstandard`` where it
  is installed; JPEG (the IFD's JPEGTables spliced into abbreviated
  chunks); WebP, lossy (an ALPH chunk's alpha the fourth sample) or
  lossless (an animated WebP chunk raises NotImplementedError naming the
  JAX module that reads it with Pillow)
- horizontal-differencing predictor (2) for integer samples
- dtypes: u1 i1 u2 i2 u4 i4 f4 f8 (bool is stored as u1)
- GeoTIFF georeferencing: ModelPixelScale + ModelTiepoint, EPSG code via
  the GeoKeyDirectory; nodata via the GDAL_NODATA ASCII tag; per-band
  metadata as JSON in ImageDescription; PAM sidecar overrides

Write support: classic or BigTIFF (auto-selected when the payload would
overflow classic TIFF's 32-bit offsets — >4 GB exports), little- or
big-endian, uncompressed or DEFLATE, striped or tiled, and the
cloud-optimized layout with nearest or average overviews.

Bands are the time axis (t, y, x), written planar (one plane per band).
"""
import json
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

__all__ = [
    "write_geotiff",
    "read_geotiff",
    "read_geotiff_window",
    "read_geotiff_overviews",
    "read_geotiff_info",
    "GeoTIFFInfo",
]

# TIFF tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_IMAGE_DESCRIPTION = 270
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_PLANAR_CONFIG = 284
_PREDICTOR = 317
_TILE_WIDTH = 322
_TILE_LENGTH = 323
_TILE_OFFSETS = 324
_TILE_BYTE_COUNTS = 325
_SAMPLE_FORMAT = 339
_MODEL_PIXEL_SCALE = 33550
_MODEL_TIEPOINT = 33922
_GEO_KEY_DIRECTORY = 34735
_GEO_ASCII_PARAMS = 34737
_GDAL_NODATA = 42113

_TYPE_ASCII = 2
_TYPE_SHORT = 3
_TYPE_LONG = 4
_TYPE_DOUBLE = 12
_TYPE_LONG8 = 16

_TYPE_SIZES = {
    1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4,
    12: 8, 16: 8, 17: 8, 18: 8,
}

_SAMPLE_FORMATS = {"u": 1, "i": 2, "f": 3, "b": 1}

_COMPRESSION_NONE = 1
_COMPRESSION_LZW = 5
_COMPRESSION_DEFLATE = 8
_COMPRESSION_PACKBITS = 32773
_COMPRESSION_DEFLATE_OLD = 32946
_COMPRESSION_JPEG = 7  # new-style JPEG (tables in tag 347)
_JPEG_TABLES = 347
_COMPRESSION_LZMA = 34925
_COMPRESSION_ZSTD = 50000
_COMPRESSION_WEBP = 50001


@dataclass
class GeoTIFFInfo:
    """Header of a GeoTIFF: everything but the pixels."""

    width: int
    height: int
    bands: int
    dtype: str
    projection: str
    geo_transform: tuple
    no_data_value: float
    metadata: list


def _geokeys_for_projection(projection):
    """(GeoKeyDirectory shorts, GeoAsciiParams text) for a CRS.

    EPSG-coded CRSes write the code; others write user-defined (32767)
    types with the structural WKT in the citation key — the GeoTIFF way
    to carry arbitrary CRSes (GDAL reads the citation back)."""
    from dask_geomodeling_tpu_torch.geo.crs import get_sr

    sr = get_sr(projection)
    keys = []
    ascii_params = ""
    model = 2 if sr.is_geographic else 1
    type_key = 2048 if sr.is_geographic else 3072
    keys.append((1024, 0, 1, model))  # GTModelType
    if sr.code:
        keys.append((type_key, 0, 1, sr.code))
    else:
        wkt = sr.ExportToWkt() + "|"
        keys.append((1026, _GEO_ASCII_PARAMS, len(wkt), 0))  # GTCitation
        keys.append((type_key, 0, 1, 32767))  # user-defined
        ascii_params = wkt
    header = (1, 1, 0, len(keys))
    flat = list(header)
    for key in keys:
        flat.extend(key)
    return flat, ascii_params


def _projection_from_geokeys(shorts, ascii_params=None):
    n_keys = shorts[3]
    citation = None
    for i in range(n_keys):
        key_id, location, count, value = shorts[4 + 4 * i : 8 + 4 * i]
        if (
            key_id in (1026, 2049, 3073)  # GT/Geog/PCS citation
            and location == _GEO_ASCII_PARAMS
            and ascii_params
        ):
            text = ascii_params[value : value + count]
            citation = text.rstrip("|").strip()
        if key_id in (2048, 3072) and location == 0 and value != 32767:
            return "EPSG:{}".format(value)
    return citation


class _TiffLayout:
    """Structural constants of the two TIFF container formats."""

    def __init__(self, bigtiff, byte_order):
        self.bigtiff = bigtiff
        self.bo = byte_order
        if bigtiff:
            self.header_size = 16
            self.entry_size = 20
            self.count_fmt = "Q"  # IFD entry count
            self.offset_fmt = "Q"
            self.inline_size = 8
            self.offsets_type = _TYPE_LONG8
        else:
            self.header_size = 8
            self.entry_size = 12
            self.count_fmt = "H"
            self.offset_fmt = "I"
            self.inline_size = 4
            self.offsets_type = _TYPE_LONG

    def header(self, ifd_offset):
        magic = b"II" if self.bo == "<" else b"MM"
        if self.bigtiff:
            return magic + struct.pack(
                self.bo + "HHHQ", 43, 8, 0, ifd_offset
            )
        return magic + struct.pack(self.bo + "HI", 42, ifd_offset)

    def ifd_size(self, n_entries):
        count_size = 8 if self.bigtiff else 2
        next_size = 8 if self.bigtiff else 4
        return count_size + n_entries * self.entry_size + next_size


def _chunk_pool():
    """The codec's thread pool: zlib, lzma, zstandard and the native LZW
    and PackBits decoders (through ctypes) release the GIL, so the chunks
    of one image (de)compress on every core, each chunk's bytes what one
    thread would give."""
    global _POOL
    if _POOL is None:
        _POOL = ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 1))
    return _POOL


_POOL = None


def _map_chunks(func, items):
    """``[func(item) for item in items]``, on the pool when there are
    several."""
    if len(items) < 2:
        return [func(item) for item in items]
    return list(_chunk_pool().map(func, items))


def _encode_image(array, compression, file_dtype, tiled, tile_size):
    """Encode one image's pixel payload per band (planar organization)."""
    bands, height, width = array.shape
    planes = []  # each chunk's pixels, in file order
    if tiled:
        tw = th = int(tile_size)
        for b in range(bands):
            for ty in range(-(-height // th)):
                for tx in range(-(-width // tw)):
                    tile = np.zeros((th, tw), dtype=file_dtype)
                    ys, xs = ty * th, tx * tw
                    sub = array[b, ys : ys + th, xs : xs + tw]
                    tile[: sub.shape[0], : sub.shape[1]] = sub
                    planes.append(tile)
    else:
        for b in range(bands):
            planes.append(np.ascontiguousarray(array[b], file_dtype))
    if compression == _COMPRESSION_WEBP:
        return _map_chunks(_encode_webp_chunk, planes)
    return _map_chunks(lambda plane: _encode(plane.tobytes(), compression), planes)


def _encode_webp_chunk(tile):
    """Lossless WebP bytes for one (h, w) uint8 band chunk, from the port's
    own encoder (native/webpcodec.cpp): the JAX package writes Pillow's
    bytes, these differ from them but decode to the same pixels."""
    from dask_geomodeling_tpu_torch.native import webp_encode_native

    if tile.dtype != np.uint8:
        raise ValueError(
            "WebP TIFF compression requires uint8 data (got %s)" % tile.dtype
        )
    return webp_encode_native(tile)


def _image_blob(
    array, chunks, base, layout, bo, compression, tiled, tile_size,
    geo_transform, projection, no_data_value, metadata, reduced,
    data_start=None,
):
    """Assemble one image's [IFD | out-of-line tags | chunk data] blob
    positioned at absolute file offset ``base``.

    With ``data_start`` given, the chunk data is NOT appended: offsets
    point into a caller-managed data region starting there (the
    cloud-optimized layout, where all IFDs precede all pixel data).

    Returns ``(blob, next_ptr_rel)``: the byte blob and the position of
    its next-IFD pointer relative to the blob start (patched by the
    caller to chain overview IFDs)."""
    bigtiff = layout.bigtiff
    bands, height, width = array.shape
    dtype = array.dtype

    tags = []

    def tag(tid, ttype, values):
        tags.append((tid, ttype, values))

    if reduced:
        # overview IFDs carry only pixel layout (GDAL pyramid layout)
        tag(_NEW_SUBFILE_TYPE, _TYPE_LONG, [1])
    tag(_IMAGE_WIDTH, _TYPE_LONG, [width])
    tag(_IMAGE_LENGTH, _TYPE_LONG, [height])
    tag(_BITS_PER_SAMPLE, _TYPE_SHORT, [dtype.itemsize * 8] * bands)
    tag(_COMPRESSION, _TYPE_SHORT, [compression])
    tag(_PHOTOMETRIC, _TYPE_SHORT, [1])  # BlackIsZero
    if not reduced and metadata is not None:
        desc = json.dumps({"band_metadata": list(metadata)})
        tag(_IMAGE_DESCRIPTION, _TYPE_ASCII, desc)
    tag(_SAMPLES_PER_PIXEL, _TYPE_SHORT, [bands])
    tag(_PLANAR_CONFIG, _TYPE_SHORT, [2])  # planar: band-sequential
    tag(_SAMPLE_FORMAT, _TYPE_SHORT, [_SAMPLE_FORMATS[dtype.kind]] * bands)

    if not reduced:
        p, a, _, q, _, d = geo_transform
        tag(_MODEL_PIXEL_SCALE, _TYPE_DOUBLE, [abs(a), abs(d), 0.0])
        tag(_MODEL_TIEPOINT, _TYPE_DOUBLE, [0.0, 0.0, 0.0, p, q, 0.0])
        geokeys, ascii_params = _geokeys_for_projection(projection)
        tag(_GEO_KEY_DIRECTORY, _TYPE_SHORT, geokeys)
        if ascii_params:
            tag(_GEO_ASCII_PARAMS, _TYPE_ASCII, ascii_params)
        if no_data_value is not None:
            # plain-float repr: numpy scalars render "np.float64(...)"
            tag(_GDAL_NODATA, _TYPE_ASCII, repr(float(no_data_value)))

    if tiled:
        tag(_TILE_WIDTH, _TYPE_SHORT, [int(tile_size)])
        tag(_TILE_LENGTH, _TYPE_SHORT, [int(tile_size)])
        offsets_tag = (_TILE_OFFSETS, layout.offsets_type)
        counts_tag = (_TILE_BYTE_COUNTS, layout.offsets_type)
    else:
        tag(_ROWS_PER_STRIP, _TYPE_LONG, [height])
        offsets_tag = (_STRIP_OFFSETS, layout.offsets_type)
        counts_tag = (_STRIP_BYTE_COUNTS, layout.offsets_type)

    # blob layout: IFD | out-of-line tag data | chunk data
    n_entries = len(tags) + 2  # plus offsets & counts
    ifd_size = layout.ifd_size(n_entries)

    extra = bytearray()
    extra_offset = base + ifd_size

    def pack_values(ttype, values):
        if ttype == _TYPE_ASCII:
            data = values.encode() + b"\x00"
            return data, len(data)
        fmt = {
            _TYPE_SHORT: "H",
            _TYPE_LONG: "I",
            _TYPE_DOUBLE: "d",
            _TYPE_LONG8: "Q",
        }[ttype]
        return struct.pack(bo + "%d%s" % (len(values), fmt), *values), len(values)

    entries = []

    all_tags = tags + [
        (offsets_tag[0], offsets_tag[1], [0] * len(chunks)),  # patched later
        (counts_tag[0], counts_tag[1], [len(c) for c in chunks]),
    ]
    all_tags.sort(key=lambda t: t[0])

    inline = layout.inline_size
    chunk_offsets_entry = None
    for tid, ttype, values in all_tags:
        data, count = pack_values(ttype, values)
        if len(data) <= inline:
            value_field = data + b"\x00" * (inline - len(data))
            entries.append([tid, ttype, count, value_field, None])
        else:
            entries.append([tid, ttype, count, None, data])
        if tid in (_STRIP_OFFSETS, _TILE_OFFSETS):
            chunk_offsets_entry = entries[-1]

    # place out-of-line data
    for entry in entries:
        if entry[4] is not None:
            entry[3] = struct.pack(
                bo + layout.offset_fmt, extra_offset + len(extra)
            )
            extra.extend(entry[4])
            if len(extra) % 2:
                extra.append(0)

    include_data = data_start is None
    if include_data:
        data_start = extra_offset + len(extra)

    # compute chunk offsets and patch them in
    offsets = []
    pos = data_start
    for c in chunks:
        offsets.append(pos)
        pos += len(c)
    offset_item = "Q" if layout.offsets_type == _TYPE_LONG8 else "I"
    offsets_data = struct.pack(bo + "%d%s" % (len(offsets), offset_item), *offsets)
    if chunk_offsets_entry[4] is not None:
        # out-of-line: overwrite in extra at the recorded position
        (abs_pos,) = struct.unpack(bo + layout.offset_fmt, chunk_offsets_entry[3])
        rel = abs_pos - extra_offset
        extra[rel : rel + len(offsets_data)] = offsets_data
    else:
        chunk_offsets_entry[3] = offsets_data + b"\x00" * (
            inline - len(offsets_data)
        )

    blob = bytearray()
    blob += struct.pack(bo + layout.count_fmt, n_entries)
    for tid, ttype, count, value_field, _ in entries:
        blob += (
            struct.pack(
                bo + "HH" + ("Q" if layout.bigtiff else "I"), tid, ttype, count
            )
            + value_field
        )
    next_ptr_rel = len(blob)
    blob += struct.pack(bo + layout.offset_fmt, 0)  # no next IFD (default)
    blob += bytes(extra)
    if include_data:
        for c in chunks:
            blob += c
    return bytes(blob), next_ptr_rel


def write_geotiff(
    path,
    array,
    geo_transform,
    projection,
    no_data_value,
    metadata=None,
    compress="deflate",
    tiled=False,
    tile_size=256,
    bigtiff=None,
    byte_order="<",
    overviews=None,
    cog=False,
    overview_resampling="nearest",
):
    """Write a (bands, height, width) array as a GeoTIFF.

    ``bigtiff=None`` auto-selects: the BigTIFF container is used whenever
    the pixel payload could overflow classic TIFF's 32-bit offsets.

    ``overviews`` is an optional list of integer decimation factors
    (e.g. ``[2, 4, 8]``); each appends a reduced-resolution IFD
    (``NewSubfileType`` 1) chained after the main one — the pyramid
    layout ``gdaladdo`` produces, selectable for coarse requests via
    ``geomodeling.use-overviews``.  ``overview_resampling`` picks the
    level builder: ``"nearest"`` (gdaladdo's default) or ``"average"``
    (nodata-aware block mean, gdaladdo's recommendation for imagery).

    ``cog=True`` writes the cloud-optimized GeoTIFF layout (the GDAL COG
    driver's structure, minus its optional ghost-area hints): tiled
    pixel data, auto-generated overview pyramid when ``overviews`` is
    not given, every IFD at the head of the file, and pixel data ordered
    smallest-overview-first / full-resolution-last so remote range reads
    resolve headers and previews without scanning the file.
    """
    array = np.asarray(array)
    if array.ndim == 2:
        array = array[np.newaxis]
    if array.dtype == bool:
        array = array.astype(np.uint8)
    dtype = array.dtype
    try:
        compression = {
            "deflate": _COMPRESSION_DEFLATE,
            "zstd": _COMPRESSION_ZSTD,
            "lzma": _COMPRESSION_LZMA,
            "webp": _COMPRESSION_WEBP,
            "none": _COMPRESSION_NONE,
            None: _COMPRESSION_NONE,
        }[compress]
    except KeyError:
        raise ValueError("Unsupported compression: %r" % (compress,))
    bo = byte_order
    file_dtype = dtype.newbyteorder(bo)

    if cog:
        tiled = True
        if overviews is None:
            # halve until the overview fits in a single tile
            overviews = []
            factor = 2
            while min(array.shape[1], array.shape[2]) // factor > int(
                tile_size
            ):
                overviews.append(factor)
                factor *= 2

    images = [array]
    for factor in overviews or ():
        factor = int(factor)
        if factor < 2:
            raise ValueError("overview factors must be >= 2: %r" % factor)
        images.append(
            _decimate(array, factor, overview_resampling, no_data_value)
        )

    image_chunks = [
        _encode_image(image, compression, file_dtype, tiled, tile_size)
        for image in images
    ]
    if bigtiff is None:
        # decide from the ACTUAL encoded payload (tiled writes pad tiles
        # to full size, so array.nbytes can badly undercount), with slack
        # for the header/IFD/out-of-line tag data
        total = sum(len(c) for chunks in image_chunks for c in chunks)
        bigtiff = total > 2**32 - 2**16
    layout = _TiffLayout(bigtiff, byte_order)

    data_starts = [None] * len(images)
    if cog:
        # sizing pass: IFD blob sizes are offset-independent (fixed-width
        # binary fields), so a zero data_start yields the true layout
        ifd_sizes = [
            len(_image_blob(
                image, chunks, 0, layout, bo, compression, tiled, tile_size,
                geo_transform, projection, no_data_value, metadata,
                reduced=index > 0, data_start=0,
            )[0])
            for index, (image, chunks) in enumerate(zip(images, image_chunks))
        ]
        # data region: smallest overview first, full resolution last
        data_order = list(range(len(images) - 1, -1, -1))
        pos = layout.header_size + sum(ifd_sizes)
        for index in data_order:
            data_starts[index] = pos
            pos += sum(len(c) for c in image_chunks[index])

    blobs = []
    starts = []  # absolute file offset of each IFD
    next_ptr_positions = []  # absolute file position of each next-IFD ptr
    base = layout.header_size
    for index, (image, chunks) in enumerate(zip(images, image_chunks)):
        starts.append(base)
        blob, next_rel = _image_blob(
            image, chunks, base, layout, bo, compression, tiled, tile_size,
            geo_transform, projection, no_data_value, metadata,
            reduced=index > 0, data_start=data_starts[index],
        )
        blobs.append(blob)
        next_ptr_positions.append(base + next_rel)
        base += len(blob)

    out = bytearray()
    out += layout.header(layout.header_size)
    for blob in blobs:
        out += blob
    if cog:
        for index in data_order:
            assert len(out) == data_starts[index]
            for c in image_chunks[index]:
                out += c
    # chain the IFDs
    for index in range(len(blobs) - 1):
        struct.pack_into(
            bo + layout.offset_fmt, out, next_ptr_positions[index],
            starts[index + 1],
        )
    with open(path, "wb") as f:
        f.write(bytes(out))


def _encode(data, compression):
    if compression == _COMPRESSION_DEFLATE:
        return zlib.compress(data, 6)
    if compression == _COMPRESSION_ZSTD:
        import zstandard

        return zstandard.ZstdCompressor(level=9).compress(data)
    if compression == _COMPRESSION_LZMA:
        import lzma

        # the .xz stream libtiff's LZMA codec reads and writes
        return lzma.compress(data, format=lzma.FORMAT_XZ)
    return data


def _lzw_decode(data):
    """TIFF LZW (MSB-first bit packing, early code-width change)."""
    out = bytearray()
    max_width = 12
    table = []
    width = 9
    next_code = 258

    def reset_table():
        nonlocal table, width, next_code
        table = [bytes([i]) for i in range(256)] + [b"", b""]
        width = 9
        next_code = 258

    reset_table()
    acc = 0
    nbits = 0
    pos = 0
    n = len(data)
    prev = None
    while True:
        while nbits < width:
            if pos >= n:
                return bytes(out)
            acc = (acc << 8) | data[pos]
            pos += 1
            nbits += 8
        nbits -= width
        code = (acc >> nbits) & ((1 << width) - 1)
        if code == 256:  # ClearCode
            reset_table()
            prev = None
            continue
        if code == 257:  # EndOfInformation
            return bytes(out)
        if prev is None:
            entry = table[code]
        else:
            if code < next_code:
                entry = table[code]
            elif code == next_code:
                entry = prev + prev[:1]
            else:
                raise ValueError("Corrupt LZW stream")
            table.append(prev + entry[:1])
            next_code += 1
            # TIFF early change (matches libtiff; validated against
            # Pillow/libtiff-written streams in tests)
            if next_code == (1 << width) - 1 and width < max_width:
                width += 1
        out += entry
        prev = entry


def _packbits_decode(data):
    """TIFF PackBits byte-run decoding."""
    out = bytearray()
    pos = 0
    n = len(data)
    while pos < n:
        header = data[pos]
        pos += 1
        if header < 128:  # literal run of header+1 bytes
            out += data[pos : pos + header + 1]
            pos += header + 1
        elif header > 128:  # repeat next byte 257-header times
            out += data[pos : pos + 1] * (257 - header)
            pos += 1
        # header == 128: no-op
    return bytes(out)


def _decode(data, compression, expected_size, jpeg_tables=None, samples=None):
    """One chunk's bytes; ``expected_size`` is its nominal payload, the
    native decoders' first capacity; a JPEG chunk takes the IFD's
    JPEGTables and its samples per pixel."""
    if compression == _COMPRESSION_NONE:
        return data
    if compression in (_COMPRESSION_DEFLATE, _COMPRESSION_DEFLATE_OLD):
        return zlib.decompress(data)
    if compression in (_COMPRESSION_LZW, _COMPRESSION_PACKBITS):
        from dask_geomodeling_tpu_torch.native import tiff_decode_native

        kind = "lzw" if compression == _COMPRESSION_LZW else "packbits"
        return tiff_decode_native(kind, data, expected_size)
    if compression == _COMPRESSION_LZMA:
        # libtiff's LZMA codec wraps each chunk as an .xz stream
        import lzma

        return lzma.decompress(data)
    if compression == _COMPRESSION_ZSTD:
        # plain zstd frames without a content-size field (libtiff)
        import zstandard

        return zstandard.ZstdDecompressor().decompressobj().decompress(data)
    if compression == _COMPRESSION_JPEG:
        return _decode_jpeg_chunk(data, jpeg_tables, samples)
    if compression == _COMPRESSION_WEBP:
        return _decode_webp_chunk(data, samples)
    raise NotImplementedError("Unsupported TIFF compression: %d" % compression)


def _decode_webp_chunk(data, samples):
    """Pixel bytes from a WebP (compression 50001) chunk, a standalone
    lossy or lossless WebP file, decoded by the port's native codec; as the JAX
    package keeps them: band 0 of a codec-promoted gray image for a
    1-sample file, else the first ``samples`` bands."""
    from dask_geomodeling_tpu_torch.native import webp_decode_native

    # a one-sample file keeps band 0 alone: the codec writes just that
    pixels = webp_decode_native(data, bands=1 if samples == 1 else None)
    if samples is not None and pixels.shape[2] != samples:
        if samples == 1:
            pixels = pixels[:, :, 0]  # grayscale promoted by the codec
        else:
            pixels = pixels[:, :, :samples]
    return pixels.tobytes()


def _decode_jpeg_chunk(data, jpeg_tables, samples):
    """Pixel bytes from a JPEG (new-style, compression 7) chunk: each
    tile/strip is a standalone JPEG stream, an abbreviated one getting the
    IFD-level JPEGTables (tag 347) spliced in after its SOI marker; the
    port's native codec decodes it (YCbCr to RGB), and a 1-sample file
    keeps one band of a codec-promoted image."""
    from dask_geomodeling_tpu_torch.native import jpeg_decode_native

    if jpeg_tables is not None and len(jpeg_tables) > 4 and data[:2] == b"\xff\xd8":
        # SOI + tables (sans its SOI/EOI markers) + the chunk after SOI
        data = b"\xff\xd8" + bytes(jpeg_tables)[2:-2] + data[2:]
    pixels = jpeg_decode_native(data)
    if samples is not None and pixels.ndim == 3 and pixels.shape[2] != samples:
        if samples == 1:
            pixels = pixels[:, :, 0]  # grayscale promoted by the codec
        else:
            pixels = pixels[:, :, :samples]
    return pixels.tobytes()


def _undo_predictor(chunk, predictor, samples):
    """Invert horizontal differencing in place on a (rows, w, samples)
    array (modular accumulation matches the wraparound differencing)."""
    if predictor == 2:
        np.cumsum(chunk, axis=1, dtype=chunk.dtype, out=chunk)
    elif predictor not in (None, 1):
        raise NotImplementedError("Unsupported TIFF predictor: %d" % predictor)
    return chunk


def _read_ifd(f, byte_order, bigtiff):
    if bigtiff:
        (n_entries,) = struct.unpack(byte_order + "Q", f.read(8))
        entry_head, inline = "HHQ", 8
    else:
        (n_entries,) = struct.unpack(byte_order + "H", f.read(2))
        entry_head, inline = "HHI", 4
    tags = {}
    for _ in range(n_entries):
        tid, ttype, count = struct.unpack(
            byte_order + entry_head, f.read(4 + inline)
        )
        value_field = f.read(inline)
        size = _TYPE_SIZES.get(ttype, 1) * count
        if size <= inline:
            data = value_field[:size]
        else:
            (offset,) = struct.unpack(
                byte_order + ("Q" if bigtiff else "I"), value_field
            )
            pos = f.tell()
            f.seek(offset)
            data = f.read(size)
            f.seek(pos)
        tags[tid] = _parse_tag_values(ttype, count, data, byte_order)
    # the next-IFD pointer trails the entry table
    (next_ifd,) = struct.unpack(
        byte_order + ("Q" if bigtiff else "I"), f.read(8 if bigtiff else 4)
    )
    return tags, next_ifd


def _parse_tag_values(ttype, count, data, byte_order):
    if ttype == _TYPE_ASCII:
        return data.rstrip(b"\x00").decode("utf-8", "replace")
    fmt = {
        1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d",
        16: "Q", 17: "q", 18: "Q",
    }.get(ttype)
    if fmt is None:
        return data
    return list(struct.unpack(byte_order + "%d%s" % (count, fmt), data))


def _open_tiff(path):
    f = open(path, "rb")
    header = f.read(4)
    if header[:2] == b"II":
        byte_order = "<"
    elif header[:2] == b"MM":
        byte_order = ">"
    else:
        f.close()
        raise ValueError("Not a TIFF file: %s" % path)
    (magic,) = struct.unpack(byte_order + "H", header[2:4])
    if magic == 42:
        bigtiff = False
        (ifd_offset,) = struct.unpack(byte_order + "I", f.read(4))
    elif magic == 43:
        bigtiff = True
        offset_size, reserved = struct.unpack(byte_order + "HH", f.read(4))
        if offset_size != 8 or reserved != 0:
            f.close()
            raise ValueError("Unsupported BigTIFF offset size: %s" % path)
        (ifd_offset,) = struct.unpack(byte_order + "Q", f.read(8))
    else:
        f.close()
        raise ValueError("Not a TIFF file (magic %d): %s" % (magic, path))
    f.seek(ifd_offset)
    tags, _ = _read_ifd(f, byte_order, bigtiff)
    return f, byte_order, tags


_NEW_SUBFILE_TYPE = 254


def _open_tiff_all(path):
    """Open a TIFF and parse every IFD in its chain."""
    f, byte_order, _ = _open_tiff(path)
    # re-derive the chain from the start (cheap: headers only)
    f.seek(2)
    (magic,) = struct.unpack(byte_order + "H", f.read(2))
    bigtiff = magic == 43
    if bigtiff:
        f.seek(8)
        (offset,) = struct.unpack(byte_order + "Q", f.read(8))
    else:
        f.seek(4)
        (offset,) = struct.unpack(byte_order + "I", f.read(4))
    ifds = []
    while offset and len(ifds) < 64:
        f.seek(offset)
        tags, offset = _read_ifd(f, byte_order, bigtiff)
        ifds.append(tags)
    return f, byte_order, ifds


def read_geotiff_overviews(path):
    """(width, height) of each reduced-resolution (overview) IFD, in
    file order — the pyramid levels GDAL's ``-ovr`` machinery selects
    among for coarse-resolution requests.

    Falls back to external overviews (``gdaladdo -ro``'s ``<path>.ovr``,
    itself a TIFF where every IFD is one pyramid level) when the file
    carries no internal reduced-resolution IFDs."""
    f, _, ifds = _open_tiff_all(path)
    f.close()
    out = []
    for tags in ifds[1:]:
        if tags.get(_NEW_SUBFILE_TYPE, [0])[0] & 1:
            out.append((tags[_IMAGE_WIDTH][0], tags[_IMAGE_LENGTH][0]))
    if not out:
        for tags in _external_overview_ifds(path):
            out.append((tags[_IMAGE_WIDTH][0], tags[_IMAGE_LENGTH][0]))
    return out


def _external_overview_ifds(path):
    """All IFDs of ``<path>.ovr`` (external overviews), or []."""
    import os

    sidecar = path + ".ovr"
    if not os.path.exists(sidecar):
        return []
    f, _, ifds = _open_tiff_all(sidecar)
    f.close()
    return ifds


def write_external_overviews(path, factors, resampling="nearest"):
    """Build ``<path>.ovr`` holding pyramid levels — the ``gdaladdo -ro``
    layout for read-only source files.

    ``factors`` is the gdaladdo decimation ladder (e.g. ``[2, 4, 8]``);
    later factors should be multiples of the first, as levels beyond the
    first are decimated from the first level.  ``resampling`` is
    ``"nearest"`` or ``"average"`` (see :func:`write_geotiff`)."""
    if not factors:
        raise ValueError("need at least one decimation factor")
    factors = sorted(int(factor) for factor in factors)
    if factors[0] < 2:
        raise ValueError("decimation factors start at 2")
    base = read_geotiff(path)
    first = factors[0]
    level = np.ascontiguousarray(
        _decimate(base.array, first, resampling, base.no_data_value)
    )
    gt = base.geo_transform
    write_geotiff(
        path + ".ovr",
        level,
        (gt[0], gt[1] * first, gt[2], gt[3], gt[4], gt[5] * first),
        projection=base.projection,
        no_data_value=base.no_data_value,
        overviews=[factor // first for factor in factors[1:]] or None,
        overview_resampling=resampling,
    )


def _decimate(array, factor, method, no_data_value=None):
    """One pyramid level: nearest subsampling or nodata-aware block mean
    (gdaladdo's AVERAGE, which skips nodata cells and rounds integers)."""
    if method == "nearest":
        return array[:, ::factor, ::factor]
    if method != "average":
        raise ValueError("Unsupported overview resampling: %r" % (method,))
    bands, height, width = array.shape
    out_h, out_w = -(-height // factor), -(-width // factor)
    padded = np.full(
        (bands, out_h * factor, out_w * factor), np.nan, np.float64
    )
    padded[:, :height, :width] = array
    if no_data_value is not None:
        padded[:, :height, :width][array == no_data_value] = np.nan
    blocks = padded.reshape(bands, out_h, factor, out_w, factor)
    valid = ~np.isnan(blocks)
    counts = valid.sum(axis=(2, 4))
    sums = np.where(valid, blocks, 0.0).sum(axis=(2, 4))
    means = sums / np.maximum(counts, 1)
    if np.issubdtype(array.dtype, np.integer):
        means = np.rint(means)
    fill = no_data_value if no_data_value is not None else 0
    return np.where(counts > 0, means, fill).astype(array.dtype)


def _pam_overrides(path):
    """GDAL PAM sidecar (``<path>.aux.xml``) overrides: (srs, nodata).

    ``gdal_edit -a_nodata``/``-a_srs`` and QGIS write these next to the
    file without touching the TIFF itself; GDAL gives PAM precedence
    over the internal tags, and so does this reader.
    """
    import os
    import xml.etree.ElementTree as ET

    sidecar = path + ".aux.xml"
    if not os.path.exists(sidecar):
        return None, None
    try:
        root = ET.parse(sidecar).getroot()
    except (ET.ParseError, OSError):
        return None, None
    srs = root.findtext("SRS")
    srs = srs.strip() if srs and srs.strip() else None
    nodata = None
    text = root.findtext(".//NoDataValue")
    if text:
        try:
            nodata = float(text)
        except ValueError:
            pass
    return srs, nodata


def _info_from_tags(tags, path=None):
    width = tags[_IMAGE_WIDTH][0]
    height = tags[_IMAGE_LENGTH][0]
    bands = tags.get(_SAMPLES_PER_PIXEL, [1])[0]
    if not (0 < width <= 2**28 and 0 < height <= 2**28
            and 0 < bands <= 2**16 and width * height * bands <= 2**36):
        # corrupt headers must not drive giant allocations in a server
        raise ValueError(
            "Implausible TIFF dimensions %r x %r x %r bands"
            % (width, height, bands)
        )
    bits = tags[_BITS_PER_SAMPLE][0]
    sample_format = tags.get(_SAMPLE_FORMAT, [1])[0]
    if bits not in (8, 16, 32, 64) or sample_format not in (1, 2, 3):
        raise ValueError(
            "Unsupported TIFF sample layout: %r bits, format %r"
            % (bits, sample_format)
        )
    kind = {1: "u", 2: "i", 3: "f"}[sample_format]
    dtype = "%s%d" % (kind, bits // 8)

    scale = tags.get(_MODEL_PIXEL_SCALE, [1.0, 1.0, 0.0])
    tiepoint = tags.get(_MODEL_TIEPOINT, [0.0] * 6)
    geo_transform = (tiepoint[3], scale[0], 0.0, tiepoint[4], 0.0, -scale[1])

    projection = None
    if _GEO_KEY_DIRECTORY in tags:
        projection = _projection_from_geokeys(
            tags[_GEO_KEY_DIRECTORY], tags.get(_GEO_ASCII_PARAMS)
        )

    no_data_value = None
    if _GDAL_NODATA in tags:
        try:
            no_data_value = float(tags[_GDAL_NODATA])
        except ValueError:
            pass

    metadata = None
    if _IMAGE_DESCRIPTION in tags:
        try:
            metadata = json.loads(tags[_IMAGE_DESCRIPTION]).get("band_metadata")
        except (ValueError, AttributeError, TypeError):
            pass  # corrupt/non-JSON descriptions carry no band metadata

    if path is not None:
        pam_srs, pam_nodata = _pam_overrides(path)
        if pam_srs is not None:
            projection = pam_srs
        if pam_nodata is not None:
            no_data_value = pam_nodata

    return GeoTIFFInfo(
        width=width,
        height=height,
        bands=bands,
        dtype=dtype,
        projection=projection,
        geo_transform=geo_transform,
        no_data_value=no_data_value,
        metadata=metadata,
    )


def read_geotiff_info(path):
    """Read only the header of a GeoTIFF."""
    f, _, tags = _open_tiff(path)
    f.close()
    return _info_from_tags(tags, path)


def read_geotiff(path):
    """Read a full GeoTIFF into a RasterData-compatible object.

    Delegates to :func:`read_geotiff_window` with the full pixel range —
    one decode loop maintains the compression/predictor/planar logic.
    """
    return read_geotiff_window(path, 0, 2**62, 0, 2**62)


def read_geotiff_window(path, row0, row1, col0, col1, level=0):
    try:
        return _read_geotiff_window(path, row0, row1, col0, col1, level)
    except (struct.error, IndexError, KeyError, OverflowError,
            TypeError, zlib.error) as e:
        # corrupt/truncated streams surface as the catchable format
        # error serving code already handles, never a raw parse error
        raise ValueError(
            "Corrupt or truncated TIFF file '%s': %r" % (path, e)
        )


def _read_geotiff_window(path, row0, row1, col0, col1, level=0):
    """Read only the pixel window [row0:row1, col0:col1) of a GeoTIFF.

    Decodes just the strips/tiles that intersect the window — the
    block-level access pattern GDAL uses when the reference warps from a
    large (cloud-optimized) GeoTIFF (reference raster/sources.py:133-144
    reads through the dataset's block cache, never the whole file).  The
    returned RasterData carries the window's shifted geotransform, so
    every consumer treats it exactly like a smaller file.

    ``level`` > 0 reads the level-th reduced-resolution (overview) IFD
    instead — window coordinates are then in that level's pixel space,
    and the geotransform scales accordingly (georeferencing, nodata and
    projection always come from the main IFD; overview IFDs carry only
    pixel layout, like GDAL-built pyramids).
    """
    from dask_geomodeling_tpu_torch.raster.sources import RasterData

    if level == 0:
        f, byte_order, tags = _open_tiff(path)
        scale_info = None
    else:
        f, byte_order, ifds = _open_tiff_all(path)
        overviews = [
            t for t in ifds[1:] if t.get(_NEW_SUBFILE_TYPE, [0])[0] & 1
        ]
        scale_info = _info_from_tags(ifds[0], path)
        if not overviews:
            # external overviews (gdaladdo -ro): pixel data lives in the
            # .ovr sidecar; georeferencing/nodata stay with the main file
            external = _external_overview_ifds(path)
            if external:
                f.close()
                f, byte_order, _ = _open_tiff(path + ".ovr")
                overviews = external
        if level > len(overviews):
            f.close()
            raise ValueError(
                "overview level %d of %d requested: %s"
                % (level, len(overviews), path)
            )
        tags = overviews[level - 1]
    try:
        info = _info_from_tags(tags, path)
        if scale_info is not None:
            # overview IFDs lack geo tags: scale the main geotransform
            gt = scale_info.geo_transform
            fx = scale_info.width / float(info.width)
            fy = scale_info.height / float(info.height)
            info = GeoTIFFInfo(
                width=info.width,
                height=info.height,
                bands=info.bands,
                dtype=info.dtype,
                projection=scale_info.projection,
                geo_transform=(
                    gt[0], gt[1] * fx, gt[2], gt[3], gt[4], gt[5] * fy
                ),
                no_data_value=scale_info.no_data_value,
                metadata=scale_info.metadata,
            )
        row0 = max(0, min(int(row0), info.height))
        row1 = max(row0, min(int(row1), info.height))
        col0 = max(0, min(int(col0), info.width))
        col1 = max(col0, min(int(col1), info.width))
        if row1 == row0:
            row1 = min(row0 + 1, info.height) or 1
            row0 = row1 - 1
        if col1 == col0:
            col1 = min(col0 + 1, info.width) or 1
            col0 = col1 - 1
        out_h, out_w = row1 - row0, col1 - col0
        dtype = np.dtype(info.dtype).newbyteorder(byte_order)
        compression = tags.get(_COMPRESSION, [_COMPRESSION_NONE])[0]
        predictor = tags.get(_PREDICTOR, [1])[0]
        planar = tags.get(_PLANAR_CONFIG, [1])[0]
        # sparse files (GDAL SPARSE_OK) leave unwritten blocks with
        # offset/bytecount 0; those regions read as nodata (or 0 when
        # nodata is unset/unrepresentable), matching GDAL's block cache
        fill = 0
        if info.no_data_value is not None:
            try:
                cast = np.asarray(info.no_data_value, dtype=info.dtype)
                if np.isnan(info.no_data_value) or float(cast) == float(
                    info.no_data_value
                ):
                    fill = cast
            except (OverflowError, ValueError):
                pass
        array = np.full((info.bands, out_h, out_w), fill, dtype=info.dtype)

        if _TILE_OFFSETS in tags:
            tw = tags[_TILE_WIDTH][0]
            th = tags[_TILE_LENGTH][0]
            offsets = tags[_TILE_OFFSETS]
            counts = tags[_TILE_BYTE_COUNTS]
            tiles_x = -(-info.width // tw)
            tiles_y = -(-info.height // th)
            n_planes = info.bands if planar == 2 else 1
            samples = 1 if planar == 2 else info.bands
            tile_nbytes = th * tw * samples * dtype.itemsize
            wanted = []  # (plane, ty, tx, compressed bytes)
            for plane in range(n_planes):
                for ty in range(row0 // th, -(-row1 // th)):
                    for tx in range(col0 // tw, -(-col1 // tw)):
                        idx = (plane * tiles_y + ty) * tiles_x + tx
                        if not offsets[idx] or not counts[idx]:
                            continue  # sparse tile: stays at fill
                        f.seek(offsets[idx])
                        wanted.append((plane, ty, tx, f.read(counts[idx])))
            decoded = _map_chunks(
                lambda item: _decode(item[3], compression, tile_nbytes,
                                     tags.get(_JPEG_TABLES), samples),
                wanted,
            )
            for (plane, ty, tx, _), raw in zip(wanted, decoded):
                tile = np.frombuffer(raw, dtype=dtype)
                tile = tile[: th * tw * samples].reshape(
                    th, tw, samples
                )
                if predictor != 1:
                    tile = _undo_predictor(
                        tile.copy(), predictor, samples
                    )
                ys, xs = ty * th, tx * tw
                # overlap of this tile with the window
                ty0 = max(row0, ys)
                ty1 = min(row1, min(ys + th, info.height))
                tx0 = max(col0, xs)
                tx1 = min(col1, min(xs + tw, info.width))
                src = tile[ty0 - ys : ty1 - ys, tx0 - xs : tx1 - xs]
                if planar == 2:
                    array[
                        plane, ty0 - row0 : ty1 - row0,
                        tx0 - col0 : tx1 - col0,
                    ] = src[:, :, 0]
                else:
                    for b in range(info.bands):
                        array[
                            b, ty0 - row0 : ty1 - row0,
                            tx0 - col0 : tx1 - col0,
                        ] = src[:, :, b]
        else:
            offsets = tags[_STRIP_OFFSETS]
            counts = tags[_STRIP_BYTE_COUNTS]
            rows_per_strip = min(
                tags.get(_ROWS_PER_STRIP, [info.height])[0], info.height
            )
            strips_per_plane = -(-info.height // rows_per_strip)
            samples = 1 if planar == 2 else info.bands
            strip_nbytes = (
                rows_per_strip * info.width * samples * dtype.itemsize
            )
            n_planes = info.bands if planar == 2 else 1
            wanted = []  # (plane, strip, compressed bytes)
            for plane in range(n_planes):
                for strip in range(
                    row0 // rows_per_strip, -(-row1 // rows_per_strip)
                ):
                    idx = plane * strips_per_plane + strip
                    if not offsets[idx] or not counts[idx]:
                        continue  # sparse strip: stays at fill
                    f.seek(offsets[idx])
                    wanted.append((plane, strip, f.read(counts[idx])))
            decoded = _map_chunks(
                lambda item: _decode(item[2], compression, strip_nbytes,
                                     tags.get(_JPEG_TABLES), samples),
                wanted,
            )
            for (plane, strip, _), raw in zip(wanted, decoded):
                data = np.frombuffer(raw, dtype=dtype)
                y0 = strip * rows_per_strip
                rows = min(rows_per_strip, info.height - y0)
                chunk = data[: rows * info.width * samples].reshape(
                    rows, info.width, samples
                )
                if predictor != 1:
                    chunk = _undo_predictor(chunk.copy(), predictor, samples)
                sy0, sy1 = max(row0, y0), min(row1, y0 + rows)
                src = chunk[sy0 - y0 : sy1 - y0, col0:col1]
                if planar == 2:
                    array[plane, sy0 - row0 : sy1 - row0] = src[:, :, 0]
                else:
                    for b in range(info.bands):
                        array[b, sy0 - row0 : sy1 - row0] = src[:, :, b]
    finally:
        f.close()

    gt = info.geo_transform
    window_gt = (
        gt[0] + col0 * gt[1] + row0 * gt[2],
        gt[1],
        gt[2],
        gt[3] + col0 * gt[4] + row0 * gt[5],
        gt[4],
        gt[5],
    )
    return RasterData(
        array=array,
        projection=info.projection,
        geo_transform=window_gt,
        no_data_value=info.no_data_value,
        metadata=info.metadata,
    )
