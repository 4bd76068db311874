"""PNG raster reader (and writer) on the stdlib, no external codecs.

Counterpart of dask_geomodeling_tpu/io/png.py, copied: the writer gives
its bytes, and the WMS server (ipyleaflet_plugin.py) encodes its tiles
and legends with it.  The format is decoded natively: zlib IDAT streams,
all five scanline filters, bit depths 1/2/4/8/16, color types gray /
RGB / palette / gray+alpha / RGBA.  Georeferencing follows GDAL's PNG conventions: an
ESRI world file sidecar (``.pgw``/``.wld``) supplies the geotransform
and a ``.prj`` sidecar the CRS — absent those, a unit top-left grid.

Palette images load as the raw index band (GDAL's band-1 + color-table
view); ``read_png`` returns the same RasterData payload the GeoTIFF
codec produces so ``RasterFileSource`` serves PNGs transparently.
"""
import os
import struct
import zlib

import numpy as np

__all__ = ["decode_png_bytes", "write_png_bytes", "read_png", "write_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"

#: color type -> samples per pixel
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _read_chunks(raw):
    pos = 8
    while pos + 8 <= len(raw):
        (length,) = struct.unpack_from(">I", raw, pos)
        ctype = raw[pos + 4 : pos + 8]
        data = raw[pos + 8 : pos + 8 + length]
        yield ctype, data
        pos += 12 + length  # length + type + data + crc


def _unfilter(raw, height, stride, bpp):
    """Undo the per-scanline filters; returns (height, stride) bytes."""
    if len(raw) >= height * (stride + 1):
        lines = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(height, stride + 1)
        if not lines[:, 0].any():  # every line unfiltered (the writer's): no loop
            return lines[:, 1:].copy()
    out = np.empty((height, stride), np.uint8)
    pos = 0
    prev = np.zeros(stride, np.uint16)
    for row in range(height):
        ftype = raw[pos]
        pos += 1
        line = np.frombuffer(raw, np.uint8, stride, pos).astype(np.uint16)
        pos += stride
        if ftype == 0:  # None
            cur = line
        elif ftype == 1:  # Sub: per-channel cumulative sum mod 256
            cur = line.copy()
            for j in range(bpp):
                cur[j::bpp] = (
                    np.cumsum(line[j::bpp], dtype=np.uint64) & 0xFF
                ).astype(np.uint16)
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype == 3:  # Average (true sequential dependency: bytearray
            # loop over Python ints, no numpy scalar overhead)
            work = bytearray(line.astype(np.uint8).tobytes())
            prow = bytes(prev.astype(np.uint8).tobytes())
            for i in range(stride):
                left = work[i - bpp] if i >= bpp else 0
                work[i] = (work[i] + ((left + prow[i]) >> 1)) & 0xFF
            cur = np.frombuffer(bytes(work), np.uint8).astype(np.uint16)
        elif ftype == 4:  # Paeth (sequential, same treatment)
            work = bytearray(line.astype(np.uint8).tobytes())
            prow = bytes(prev.astype(np.uint8).tobytes())
            for i in range(stride):
                a = work[i - bpp] if i >= bpp else 0
                b = prow[i]
                c = prow[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa = p - a if p >= a else a - p
                pb = p - b if p >= b else b - p
                pc = p - c if p >= c else c - p
                if pa <= pb and pa <= pc:
                    pred = a
                elif pb <= pc:
                    pred = b
                else:
                    pred = c
                work[i] = (work[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(work), np.uint8).astype(np.uint16)
        else:
            raise ValueError("Unknown PNG filter type %d" % ftype)
        out[row] = cur.astype(np.uint8)
        prev = cur
    return out


def _unpack_bits(rows, width, samples, depth):
    """(height, stride) filtered bytes -> (height, width, samples) ints."""
    height = rows.shape[0]
    if depth == 8:
        return rows[:, : width * samples].reshape(height, width, samples)
    if depth == 16:
        pairs = rows[:, : width * samples * 2].reshape(
            height, width * samples, 2
        )
        values = (
            pairs[..., 0].astype(np.uint16) << 8
        ) | pairs[..., 1].astype(np.uint16)
        return values.reshape(height, width, samples)
    # sub-byte depths: big-endian bit packing, one sample per cell
    bits = np.unpackbits(rows, axis=1)
    per = depth
    cells = bits[:, : width * per].reshape(height, width, per)
    weights = (1 << np.arange(per - 1, -1, -1)).astype(np.uint16)
    return (cells * weights).sum(axis=2, dtype=np.uint16)[..., None]


def _world_file(path, extensions=(".pgw", ".wld", ".PGW")):
    """The 6-line ESRI world file geotransform, if a sidecar exists.

    ``extensions`` lists the sidecar suffixes in preference order (PNG:
    .pgw; JPEG passes .jgw first).
    """
    base, _ = os.path.splitext(path)
    for candidate in (base + ext for ext in extensions):
        if os.path.exists(candidate):
            with open(candidate) as stream:
                lines = [
                    float(line.strip())
                    for line in stream.read().split()[:6]
                ]
            dx, roty, rotx, dy, cx, cy = lines
            # world files reference the CENTER of the upper-left pixel
            return (cx - dx / 2, dx, rotx, cy - dy / 2, roty, dy)
    return (0.0, 1.0, 0.0, 0.0, 0.0, -1.0)


def decode_png_bytes(raw, source="<bytes>"):
    """Decode an in-memory PNG stream into ((bands, h, w), nodata)."""
    if raw[:8] != _SIGNATURE:
        raise IOError("Not a PNG file: '%s'" % source)

    width = height = depth = ctype = interlace = None
    idat = []
    transparent = None
    for chunk, data in _read_chunks(raw):
        if chunk == b"IHDR":
            width, height, depth, ctype, _, _, interlace = struct.unpack(
                ">IIBBBBB", data
            )
        elif chunk == b"IDAT":
            idat.append(data)
        elif chunk == b"tRNS":
            transparent = data  # interpretation depends on the color type
        elif chunk == b"IEND":
            break
    if width is None:
        raise IOError("PNG without IHDR: '%s'" % source)
    if interlace:
        raise NotImplementedError(
            "Adam7-interlaced PNG is not supported: '%s'" % source
        )
    samples = _SAMPLES.get(ctype)
    if samples is None:
        raise IOError("Unknown PNG color type %d" % ctype)

    decompressed = zlib.decompress(b"".join(idat))
    stride = (width * samples * depth + 7) // 8
    bpp = max(1, samples * depth // 8)
    rows = _unfilter(decompressed, height, stride, bpp)
    pixels = _unpack_bits(rows, width, samples, depth)

    dtype = np.uint16 if depth == 16 else np.uint8
    array = np.ascontiguousarray(
        pixels.transpose(2, 0, 1).astype(dtype)
    )  # (bands, h, w)

    # nodata from tRNS: the uint16 gray level for grayscale; for palette
    # images the chunk is one alpha byte per index — the first fully
    # transparent index is the nodata value.  Without declared
    # transparency there is NO nodata (saturated pixels are data, as
    # GDAL's PNG reader reports)
    no_data_value = None
    if transparent:
        if ctype == 0 and len(transparent) >= 2:
            no_data_value = float(struct.unpack(">H", transparent[:2])[0])
        elif ctype == 3:
            alphas = np.frombuffer(transparent, np.uint8)
            clear = np.flatnonzero(alphas == 0)
            if clear.size:
                no_data_value = float(clear[0])
    return array, no_data_value


def write_png_bytes(values):
    """Encode (bands, h, w) uint8/uint16 data as an in-memory PNG."""
    values = np.asarray(values)
    if values.ndim == 2:
        values = values[None]
    bands, height, width = values.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}.get(bands)
    if ctype is None:
        raise ValueError("PNG supports 1-4 bands, got %d" % bands)
    if values.dtype == np.uint16:
        depth = 16
        interleaved = values.transpose(1, 2, 0).astype(">u2").tobytes()
        stride = width * bands * 2
    else:
        depth = 8
        interleaved = (
            values.transpose(1, 2, 0).astype(np.uint8).tobytes()
        )
        stride = width * bands

    lines = []
    for row in range(height):
        lines.append(b"\x00")  # filter None
        lines.append(interleaved[row * stride : (row + 1) * stride])
    compressed = zlib.compress(b"".join(lines), 6)

    def chunk(ctag, data):
        crc = zlib.crc32(ctag + data) & 0xFFFFFFFF
        return struct.pack(">I", len(data)) + ctag + data + struct.pack(">I", crc)

    header = struct.pack(">IIBBBBB", width, height, depth, ctype, 0, 0, 0)
    return (
        _SIGNATURE
        + chunk(b"IHDR", header)
        + chunk(b"IDAT", compressed)
        + chunk(b"IEND", b"")
    )


def read_png(path):
    """Read a PNG file into a RasterData payload."""
    from dask_geomodeling_tpu_torch.io.asciigrid import _sidecar_projection
    from dask_geomodeling_tpu_torch.io.geotiff import _pam_overrides
    from dask_geomodeling_tpu_torch.raster.sources import RasterData

    with open(path, "rb") as stream:
        array, no_data_value = decode_png_bytes(stream.read(), path)
    pam_nodata = _pam_overrides(path)[1]
    if pam_nodata is not None:  # GDAL PAM wins over tRNS transparency
        no_data_value = pam_nodata
    return RasterData(
        array=array,
        projection=_sidecar_projection(path),
        geo_transform=_world_file(path),
        no_data_value=no_data_value,
        metadata=[""] * array.shape[0],
    )


def write_png(path, values, geo_transform=None, projection=None):
    """Write (bands, h, w) uint8/uint16 data as a PNG (+ world file).

    Bands 1/2/3/4 map to gray / gray+alpha / RGB / RGBA.
    """
    with open(path, "wb") as f:
        f.write(write_png_bytes(values))

    if geo_transform is not None:
        p, a, b, q, c, d = geo_transform
        base, _ = os.path.splitext(path)
        with open(base + ".pgw", "w") as f:
            f.write(
                "\n".join(
                    "%.10f" % v
                    for v in (a, c, b, d, p + a / 2, q + d / 2)
                )
            )
    if projection is not None:
        base, _ = os.path.splitext(path)
        from dask_geomodeling_tpu_torch.geo.crs import get_sr

        with open(base + ".prj", "w") as f:
            f.write(get_sr(projection).ExportToWkt())
