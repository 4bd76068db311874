"""JPEG, BMP and GIF rasters (world-file georeferencing): the port's copy of
dask_geomodeling_tpu/io/jpeg.py.

The JAX package decodes these through Pillow; the port decodes JPEG with
its own codec (``native/jpegcodec.cpp``, bitwise to Pillow's libjpeg-turbo)
and BMP and GIF with the small numpy decoders below, each giving the array
Pillow gives.  The geospatial layer is the JAX module's: the world-file
sidecars of ``_WORLD_SUFFIXES``, the ``.prj`` or PAM projection, a PAM
nodata.  Grayscale loads as one band, RGB as three; palettes, bilevel
images, CMYK and alpha convert as Pillow's ``convert`` does
(``to_pillow_bands``).
"""
import os
import struct

import numpy as np

__all__ = ["read_jpeg", "read_pillow_raster", "decode_image", "to_pillow_bands",
           "cmyk_to_rgb"]

_JPEG_MAGIC = b"\xff\xd8\xff"
_BMP_MAGIC = b"BM"
_GIF_MAGICS = (b"GIF87a", b"GIF89a")


def cmyk_to_rgb(cmyk):
    """Pillow's CMYK to RGB conversion (Convert.c: cmyk2rgb) of an
    (..., 4) uint8 array."""
    c = cmyk.astype(np.int32)
    nk = 255 - c[..., 3:4]
    tmp = c[..., :3] * nk + 128
    return np.clip(nk - (((tmp >> 8) + tmp) >> 8), 0, 255).astype(np.uint8)


def to_pillow_bands(image):
    """An image of decode_image as the JAX package's ``read_pillow_raster``
    holds it: (1, h, w) for grayscale, (3, h, w) for everything in colour.
    Modes other than L and RGB convert as Pillow's ``convert`` does:
    a palette to RGB (even a one-band palette is colour), bilevel to L,
    RGBA and CMYK to RGB."""
    mode, pixels = image["mode"], image["pixels"]
    if mode == "P":
        pixels = image["palette"][pixels]
    elif mode == "1":
        pixels = np.where(pixels != 0, 255, 0).astype(np.uint8)
    elif mode == "RGBA":
        pixels = pixels[..., :3]
    elif mode == "CMYK":
        pixels = cmyk_to_rgb(pixels)
    if pixels.ndim == 2:
        return pixels[None]
    return np.ascontiguousarray(pixels.transpose(2, 0, 1))


def decode_image(blob):
    """Decode the bytes of a JPEG, BMP or GIF file as Pillow opens it:
    {"mode": Pillow's mode, "pixels": (h, w[, bands]) uint8, "palette":
    (256, 3) uint8 for mode "P"}.  JPEG decodes natively
    (native.jpeg_decode_native); OSError where Pillow cannot identify or
    read the file."""
    head = bytes(blob[:6])
    if head.startswith(_JPEG_MAGIC):
        from dask_geomodeling_tpu_torch.native import jpeg_decode_native

        pixels = jpeg_decode_native(blob)
        mode = "L" if pixels.ndim == 2 else {3: "RGB", 4: "CMYK"}[pixels.shape[2]]
        return {"mode": mode, "pixels": pixels}
    if head.startswith(_BMP_MAGIC):
        return _decode_bmp(bytes(blob))
    if head.startswith(_GIF_MAGICS):
        return _decode_gif(bytes(blob))
    raise OSError("cannot identify image file")


def read_pillow_raster(path, world_extensions=(".wld", ".WLD")):
    """Read a JPEG, BMP or GIF image into a RasterData payload."""
    from dask_geomodeling_tpu_torch.io.asciigrid import _sidecar_projection
    from dask_geomodeling_tpu_torch.io.geotiff import _pam_overrides
    from dask_geomodeling_tpu_torch.io.png import _world_file
    from dask_geomodeling_tpu_torch.raster.sources import RasterData

    with open(path, "rb") as stream:
        blob = stream.read()
    array = to_pillow_bands(decode_image(blob))
    geo_transform = _world_file(path, extensions=world_extensions)
    return RasterData(
        array=np.ascontiguousarray(array),
        projection=_sidecar_projection(path),
        geo_transform=geo_transform,
        # these formats carry no nodata concept themselves (GDAL reports
        # none), but a PAM sidecar can declare one
        no_data_value=_pam_overrides(path)[1],
        metadata=[""] * array.shape[0],
    )


#: GDAL-convention world-file suffixes per extension
_WORLD_SUFFIXES = {
    ".jpg": (".jgw", ".JGW", ".wld", ".WLD"),
    ".jpeg": (".jgw", ".JGW", ".wld", ".WLD"),
    ".bmp": (".bpw", ".BPW", ".wld", ".WLD"),
    ".gif": (".gfw", ".GFW", ".wld", ".WLD"),
}


def read_jpeg(path):
    """Read a JPEG/BMP/GIF file into a RasterData payload."""
    ext = os.path.splitext(path)[1].lower()
    return read_pillow_raster(path, _WORLD_SUFFIXES.get(ext, (".wld", ".WLD")))


# --- BMP (Pillow's BmpImagePlugin.py) ---


def _palette_table(entries):
    """A 256-entry RGB lookup: ``entries`` first, a gray ramp after them
    (Pillow's palette for indices the file's palette does not hold)."""
    table = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    entries = np.asarray(entries, np.uint8).reshape(-1, 3)[:256]
    table[: len(entries)] = entries
    return table


def _decode_bmp(blob):
    """A Windows bitmap as Pillow reads it: 1-, 4- and 8-bit palettes
    (a gray or black-and-white palette read as L or "1"), 24-bit BGR,
    32-bit BGRX or bitfields, RLE8 and RLE4, bottom-up or top-down."""
    def u32(at):
        return struct.unpack_from("<I", blob, at)[0]

    def u16(at):
        return struct.unpack_from("<H", blob, at)[0]

    try:
        offset = u32(10)
        header_size = u32(14)
        if header_size == 12:
            width, height, bits = u16(18), u16(20), u16(24)
            compression, colors, padding, direction = 0, 0, 3, -1
            masks = None
        elif header_size in (40, 52, 56, 64, 108, 124):
            y_flip = blob[14 + 4 + 7] == 0xFF
            direction = 1 if y_flip else -1
            width = u32(18)
            height = 2**32 - u32(22) if y_flip else u32(22)
            bits, compression, colors = u16(28), u32(30), u32(46)
            padding = 4
            masks = None
            if compression == 3:
                if header_size >= 52:
                    masks = tuple(u32(54 + 4 * i) for i in range(4 if header_size >= 56 else 3))
                    masks = masks + (0,) * (4 - len(masks))
                else:
                    masks = tuple(u32(54 + 4 * i) for i in range(3)) + (0,)
        else:
            raise OSError("Unsupported BMP header type (%d)" % header_size)
    except struct.error:
        raise OSError("image file is truncated")
    colors = colors if colors else (1 << bits)
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors
    if bits not in (1, 4, 8, 24, 32):
        raise NotImplementedError(
            "BMP of %d bits a pixel is not ported (dask_geomodeling_tpu/io/jpeg.py reads it "
            "with Pillow)" % bits)
    mode, raw = ("P", "P") if bits <= 8 else ("RGB", "BGR" if bits == 24 else "BGRX")
    rle = False
    if compression == 3:
        layouts = {
            (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
            (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
            (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
            (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
            (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
            (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
            (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
            (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
            (24, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGR",
        }
        key = (bits, masks if bits == 32 else masks[:3] + (0,))
        if key not in layouts:
            raise OSError("Unsupported BMP bitfields layout")
        raw = layouts[key]
        if "A" in raw:
            mode = "RGBA"
    elif compression in (1, 2):
        rle = True
    elif compression != 0:
        raise OSError("Unsupported BMP compression (%d)" % compression)

    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise OSError("Unsupported BMP Palette size (%d)" % colors)
        start = 14 + header_size + (12 if compression == 3 and header_size == 40 else 0)
        entries = blob[start : start + padding * colors]
        table = np.frombuffer(entries, np.uint8)
        table = table[: len(table) // padding * padding].reshape(-1, padding)[:, 2::-1]
        expected = [0, 255] if colors == 2 else list(range(colors))
        gray = len(table) >= len(expected) and all(
            (table[i] == v).all() for i, v in enumerate(expected))
        if gray:
            mode = "1" if colors == 2 else "L"
            # Pillow then reads the rows in that raw mode, which only
            # fits 1-bit bilevel and 8-bit gray rows
            if (mode, bits) not in (("1", 1), ("L", 8)):
                raise OSError("codec configuration error when reading image file")
        else:
            palette = _palette_table(table)

    if rle:
        indices = _bmp_rle(blob, offset, width, height, compression == 2)
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        need = stride * height
        data = np.frombuffer(blob, np.uint8, count=max(0, min(need, len(blob) - offset)),
                             offset=min(offset, len(blob)))
        if data.size < need:
            raise OSError("image file is truncated")
        rows = data.reshape(height, stride)
        if bits == 1:
            indices = np.unpackbits(rows, axis=1)[:, :width]
        elif bits == 4:
            nibbles = np.stack([rows >> 4, rows & 15], axis=2).reshape(height, -1)
            indices = nibbles[:, :width]
        elif bits == 8:
            indices = rows[:, :width]
        else:
            indices = None
            px = rows[:, : width * (bits // 8)].reshape(height, width, bits // 8)
            order = {"BGR": (2, 1, 0), "BGRX": (2, 1, 0), "XBGR": (3, 2, 1),
                     "BGXR": (3, 1, 0), "ABGR": (3, 2, 1, 0), "RGBA": (0, 1, 2, 3),
                     "BGRA": (2, 1, 0, 3), "BGAR": (3, 1, 0, 2)}[raw]
            pixels = px[..., list(order)]
        if direction == -1:
            if indices is not None:
                indices = indices[::-1]
            else:
                pixels = pixels[::-1]
    if mode in ("P", "L", "1"):
        pixels = np.ascontiguousarray(indices, np.uint8)
        if mode == "1":
            pixels = np.where(pixels != 0, 255, 0).astype(np.uint8)
    else:
        pixels = np.ascontiguousarray(pixels)
    return {"mode": mode, "pixels": pixels, "palette": palette}


def _bmp_rle(blob, offset, width, height, rle4):
    """Pillow's BmpRleDecoder: RLE8/RLE4 runs, absolute runs, end of line,
    end of bitmap and delta (whose two bytes Pillow reads twice), rows
    bottom-up; ValueError as Pillow raises when the data runs short."""
    data = bytearray()
    x = 0
    pos = offset
    n = len(blob)
    dest = width * height
    while len(data) < dest:
        if pos + 2 > n:
            break
        count, byte = blob[pos], blob[pos + 1]
        pos += 2
        if count:
            if x + count > width:
                count = max(0, width - x)
            if rle4:
                first, second = byte >> 4, byte & 15
                data += bytes(first if i % 2 == 0 else second for i in range(count))
            else:
                data += bytes([byte]) * count
            x += count
        elif byte == 0:
            while len(data) % width:
                data.append(0)
            x = 0
        elif byte == 1:
            break
        elif byte == 2:
            if pos + 2 > n:
                break
            pos += 2
            right, up = blob[pos], blob[pos + 1]
            pos += 2
            data += b"\x00" * (right + up * width)
            x = len(data) % width
        else:
            if rle4:
                got = blob[pos : pos + byte // 2]
                pos += len(got)
                for value in got:
                    data.append(value >> 4)
                    data.append(value & 15)
                short = len(got) < byte // 2
            else:
                got = blob[pos : pos + byte]
                pos += len(got)
                data += got
                short = len(got) < byte
            if short:
                break
            x += byte
            if pos % 2:
                pos += 1
    if len(data) < dest:
        raise ValueError("not enough image data")
    return np.frombuffer(bytes(data[:dest]), np.uint8).reshape(height, width)[::-1]


# --- GIF (Pillow's GifImagePlugin.py, the first frame) ---


def _gif_palette(raw):
    """Pillow's palette, or None when ``raw`` is the gray identity ramp
    (GifImagePlugin._is_palette_needed: the frame then reads as L)."""
    entries = np.frombuffer(raw, np.uint8).reshape(-1, 3)
    if (entries == np.arange(len(entries))[:, None]).all():
        return None
    return _palette_table(entries)


def _decode_gif(blob):
    """The first frame of a GIF as Pillow loads it: mode P over the frame's
    (or the global) palette, L when there is none or it is the gray ramp;
    the logical screen, grown to hold the frame, filled with the
    transparent index (else 0) outside the frame; interlaced rows put in
    place."""
    n = len(blob)
    if n < 13:
        raise OSError("image file is truncated")
    width, height = struct.unpack_from("<HH", blob, 6)
    flags = blob[10]
    pos = 13
    palette = None
    if flags & 128:
        size = 3 << ((flags & 7) + 1)
        palette = _gif_palette(blob[pos : pos + size])
        pos += size
    transparency = None

    def sub_blocks(at):
        """The data sub-blocks from ``at``: (bytes, the position after the
        terminator, whether it was found)."""
        out = bytearray()
        while at < n:
            length = blob[at]
            at += 1
            if length == 0:
                return bytes(out), at, True
            out += blob[at : at + length]
            at += length
        return bytes(out), at, False

    while True:
        if pos >= n or blob[pos] == 0x3B:
            raise EOFError("image not found in GIF frame")
        kind = blob[pos]
        pos += 1
        if kind == 0x21:
            label = blob[pos] if pos < n else 0
            pos += 1
            first = blob[pos] if pos < n else 0
            block = blob[pos + 1 : pos + 1 + first] if first else None
            if label == 249 and block is not None and len(block) >= 4 and block[0] & 1:
                transparency = block[3]
            _, pos, _ = sub_blocks(pos)
        elif kind == 0x2C:
            x0, y0, fw, fh, frame_flags = struct.unpack_from("<HHHHB", blob, pos)
            pos += 9
            interlace = bool(frame_flags & 64)
            if frame_flags & 128:
                size = 3 << ((frame_flags & 7) + 1)
                local = blob[pos : pos + size]
                pos += size
                # a local gray ramp reads as L, whatever the global palette
                palette = _gif_palette(local)
            min_code = blob[pos]
            pos += 1
            data, pos, terminated = sub_blocks(pos)
            break
        else:
            continue  # Pillow skips a byte it does not know
    x1, y1 = x0 + fw, y0 + fh
    width, height = max(width, x1), max(height, y1)
    canvas = np.full((height, width), transparency if transparency is not None else 0, np.uint8)
    indices, complete = _gif_lzw(data, min_code, fw * fh)
    if not complete and not terminated:
        raise OSError("image file is truncated")
    # the decoded pixels in the frame's rows (interlaced: rows 0, 8, ...;
    # 4, 12, ...; 2, 6, ...; 1, 3, ...), a short stream's rest left as
    # the canvas
    if interlace:
        rows = np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                               np.arange(2, fh, 4), np.arange(1, fh, 2)])
    else:
        rows = np.arange(fh)
    region = canvas[y0:y1, x0:x1]
    full = indices.size // fw if fw else 0
    region[rows[:full]] = indices[: full * fw].reshape(full, fw)
    if full < fh and indices.size % fw:
        region[rows[full], : indices.size % fw] = indices[full * fw :]
    if palette is None:
        return {"mode": "L", "pixels": canvas, "palette": None}
    return {"mode": "P", "pixels": canvas, "palette": palette}


def _gif_lzw(data, min_code, count):
    """GIF's LSB-first LZW: at most ``count`` indices, in time linear in
    the output (each code's string is its prefix's plus one byte, read
    back through the prefix chain).  Returns (indices, whether ``count``
    were decoded)."""
    min_code = max(1, min(int(min_code), 11))
    clear = 1 << min_code
    end = clear + 1
    prefix_l = [0] * 4096
    suffix_l = [code & 0xFF if code < clear else 0 for code in range(4096)]
    first_l = list(suffix_l)
    length_l = [1 if code < clear else 0 for code in range(4096)]
    out = bytearray(count)
    filled = 0
    size = min_code + 1
    next_code = end + 1
    prev = -1
    acc = 0
    nbits = 0
    at = 0
    n = len(data)
    while filled < count:
        while nbits < size and at < n:
            acc |= data[at] << nbits
            at += 1
            nbits += 8
        if nbits < size:
            break
        code = acc & ((1 << size) - 1)
        acc >>= size
        nbits -= size
        if code == clear:
            size = min_code + 1
            next_code = end + 1
            prev = -1
            continue
        if code == end:
            break
        if prev < 0:
            if code >= next_code:
                break
            entry = code
            head = first_l[code]
        elif code < next_code:
            entry = code
            head = first_l[code]
        elif code == next_code:
            entry = -1  # prev's string and its own first byte
            head = first_l[prev]
        else:
            break
        if prev >= 0 and next_code < 4096:
            prefix_l[next_code] = prev
            suffix_l[next_code] = head
            first_l[next_code] = first_l[prev]
            length_l[next_code] = length_l[prev] + 1
            if entry < 0:
                entry = next_code
            next_code += 1
            if next_code == (1 << size) and size < 12:
                size += 1
        elif entry < 0:
            break
        # write the entry's string backwards through its prefix chain
        k = length_l[entry]
        stop = min(filled + k, count)
        index = filled + k - 1
        code_at = entry
        while index >= filled:
            if index < stop:
                out[index] = suffix_l[code_at]
            code_at = prefix_l[code_at]
            index -= 1
        filled = stop
        prev = entry
    return np.frombuffer(bytes(out[:filled]), np.uint8), filled >= count
