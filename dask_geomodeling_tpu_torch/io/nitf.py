"""NITF 2.1 / 2.0 raster reader (native, header-driven).

Counterpart of dask_geomodeling_tpu/io/nitf.py, copied: the same
RasterData payload and header info, the same errors and messages, with
three differences.

- JPEG segments (IC = C3, and M3's blocks) decode with the port's own
  codec (native/jpegcodec.cpp, through io/jpeg.py:decode_image), where the
  JAX package calls Pillow: the same arrays.
- Segments compressed as JPEG 2000 (C8, M8) raise NotImplementedError,
  from ``read_nitf`` and ``read_nitf_info`` alike: the JAX package decodes
  their codestreams with Pillow, and the port has no JPEG 2000 decoder.
- The payload is not copied on its way to the decoder: segments are
  memoryviews of the file's bytes, a masked segment's blocks are copied
  once into a buffer of the dense payload's size, and the blocks are
  reordered into the image by one reshape and transpose whose copy is
  also the conversion to native byte order.

NITF is the imagery container of the US/NATO standards (MIL-STD-2500C /
STANAG 4545), in which commercial multispectral products arrive.

Scope:

- file versions NITF02.10 and NITF02.00 headers
- every image segment becomes one band stack entry; segments must share
  grid shape to stack (like GRIB messages)
- pixel types INT/SI (8/16/32 bit) and R (32/64-bit IEEE floats),
  actual-bits-per-pixel honoured by masking
- compression IC=NC (none), IC=NM (masked: absent blocks fill with
  the pad pixel code), IC=C3 (JPEG) and IC=M3 (masked JPEG blocks)
- block layouts IMODE B (band interleaved by block), S (band
  sequential) and P (pixel interleaved), arbitrary NBPR x NBPC blocking
  with edge padding cropped
- georeferencing from ICORDS G (DMS corners) and D (decimal-degree
  corners): the IGEOLO corner points define a full affine geotransform
  (rotation preserved); ICORDS N/S/U (UTM/MGRS) and missing ICORDS
  yield a pixel-space geotransform with no projection

LUT-mapped bands and DES/TRE interpretation are out of scope and
raise named errors.
"""
import struct

import numpy as np

__all__ = ["read_nitf", "read_nitf_info"]

#: the compressions whose codestreams the JAX package decodes with Pillow
_COMPRESSED = ("C3", "C8", "M3", "M8")
#: those the port has no decoder for (JPEG 2000)
_UNPORTED = ("C8", "M8")


class _NitfError(ValueError):
    pass


class _Cursor:
    """Fixed-width ASCII field reader over the header bytes."""

    def __init__(self, data, start=0):
        self.data = data
        self.pos = start

    def take(self, n):
        if self.pos + n > len(self.data):
            raise _NitfError("NITF header truncated")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def text(self, n):
        return self.take(n).decode("latin-1")

    def number(self, n):
        raw = self.text(n).strip()
        if not raw:
            return 0
        try:
            return int(raw)
        except ValueError:
            raise _NitfError("Bad NITF numeric field %r" % raw)


def _skip_security(cur, version):
    """Security block: 167 bytes in 2.1; 2.0 uses a different layout."""
    if version >= (2, 1):
        cur.take(167)
    else:  # NITF 2.0: FSCODE(40) FSCTLH(40) FSREL(40) FSCAUT(20) FSCTLN(20)
        cur.take(40 + 40 + 40 + 20 + 20)
        downgrade = cur.text(6)  # FSDWNG; FSDEVT(40) only when '999998'
        if downgrade == "999998":
            cur.take(40)


def _parse_dms(token):
    """ddmmssH or dddmmssH -> signed decimal degrees."""
    hemisphere = token[-1:].upper()
    digits = token[:-1]
    if hemisphere in ("N", "S"):
        deg, minutes, seconds = digits[:2], digits[2:4], digits[4:6]
    else:
        deg, minutes, seconds = digits[:3], digits[3:5], digits[5:7]
    value = int(deg) + int(minutes) / 60.0 + int(seconds) / 3600.0
    return -value if hemisphere in ("S", "W") else value


def _parse_igeolo(icords, igeolo):
    """Four (lon, lat) corners UL, UR, LR, LL from the 60-char field."""
    corners = []
    for k in range(4):
        token = igeolo[k * 15 : (k + 1) * 15]
        if icords == "G":
            lat = _parse_dms(token[:7])
            lon = _parse_dms(token[7:15])
        else:  # "D": +-dd.ddd+-ddd.ddd
            lat = float(token[:7])
            lon = float(token[7:15])
        corners.append((lon, lat))
    return corners


def _geotransform(corners, nrows, ncols):
    """Affine geotransform from the UL/UR/LL corner points (corner
    coordinates name pixel centers per MIL-STD-2500C, hence the
    half-pixel shift to edge convention)."""
    (ulx, uly), (urx, ury), _, (llx, lly) = corners
    a = (urx - ulx) / max(ncols - 1, 1)
    b = (llx - ulx) / max(nrows - 1, 1)
    d = (ury - uly) / max(ncols - 1, 1)
    e = (lly - uly) / max(nrows - 1, 1)
    return (ulx - a / 2 - b / 2, a, b, uly - d / 2 - e / 2, d, e)


def _dtype(pvtype, nbpp):
    if pvtype == "INT":
        return {8: np.uint8, 16: np.uint16, 32: np.uint32}.get(nbpp)
    if pvtype == "SI":
        return {8: np.int8, 16: np.int16, 32: np.int32}.get(nbpp)
    if pvtype == "R":
        return {32: np.float32, 64: np.float64}.get(nbpp)
    return None


def _parse_image_subheader(data, offset, version):
    cur = _Cursor(data, offset)
    if cur.text(2) != "IM":
        raise _NitfError("NITF image subheader does not start with IM")
    cur.take(10 + 14 + 17 + 80)  # IID1, IDATIM, TGTID, IID2
    cur.take(1)  # ISCLAS
    _skip_security(cur, version)
    cur.take(1)  # ENCRYP
    cur.take(42)  # ISORCE
    nrows = cur.number(8)
    ncols = cur.number(8)
    pvtype = cur.text(3).strip()
    cur.take(8)  # IREP
    cur.take(8)  # ICAT
    abpp = cur.number(2)
    cur.take(1)  # PJUST
    icords = cur.text(1).strip()
    # NITF 2.0: ICORDS 'N' means NO coordinates (IGEOLO absent); only
    # 2.1 redefined 'N' as UTM-north (which does carry IGEOLO)
    has_igeolo = bool(icords) and not (version < (2, 1) and icords == "N")
    igeolo = cur.text(60) if has_igeolo else ""
    ncom = cur.number(1)
    cur.take(80 * ncom)
    ic = cur.text(2)
    if ic not in ("NC", "NM") + _COMPRESSED:
        raise _NitfError(
            "NITF compression '%s' is not supported (NC, NM, C3/M3 JPEG "
            "and C8/M8 JPEG2000 are)" % ic
        )
    if ic not in ("NC", "NM"):
        cur.take(4)  # COMRAT (absent for NC and NM)
    nbands = cur.number(1)
    if nbands == 0:
        nbands = cur.number(5)  # XBANDS
    for _ in range(nbands):
        cur.take(2 + 6 + 1 + 3)  # IREPBAND, ISUBCAT, IFC, IMFLT
        nluts = cur.number(1)
        if nluts:
            raise _NitfError("NITF LUT-mapped bands are not supported")
    cur.take(1)  # ISYNC
    imode = cur.text(1)
    nbpr = cur.number(4)
    nbpc = cur.number(4)
    nppbh = cur.number(4)
    nppbv = cur.number(4)
    nbpp = cur.number(2)
    cur.take(3 + 3 + 10 + 4)  # IDLVL, IALVL, ILOC, IMAG
    udidl = cur.number(5)
    if udidl:
        cur.take(udidl)
    ixshdl = cur.number(5)
    if ixshdl:
        cur.take(ixshdl)
    return {
        "nrows": nrows,
        "ncols": ncols,
        "pvtype": pvtype,
        "abpp": abpp,
        "icords": icords,
        "igeolo": igeolo,
        "ic": ic,
        "nbands": max(nbands, 1),
        "imode": imode,
        "nbpr": max(nbpr, 1),
        "nbpc": max(nbpc, 1),
        "nppbh": nppbh or ncols,
        "nppbv": nppbv or nrows,
        "nbpp": nbpp or abpp,
        "header_end": cur.pos,
    }


def _pixel_dtype(sub):
    dtype = _dtype(sub["pvtype"], sub["nbpp"])
    if dtype is None:
        raise _NitfError(
            "NITF pixel type %s/%d bits is not supported"
            % (sub["pvtype"], sub["nbpp"])
        )
    return np.dtype(dtype)


def _decode_blocks(raw, sub):
    """(bands, nrows, ncols) from an uncompressed blocked payload."""
    dtype = _pixel_dtype(sub).newbyteorder(">")
    bands, nbpr, nbpc = sub["nbands"], sub["nbpr"], sub["nbpc"]
    bh, bw = sub["nppbv"], sub["nppbh"]
    per_block = bh * bw
    itemsize = dtype.itemsize
    expected = bands * nbpr * nbpc * per_block * itemsize
    if len(raw) < expected:
        raise _NitfError("NITF image data truncated")
    values = np.frombuffer(raw, dtype, count=expected // itemsize)

    imode = sub["imode"]
    if imode == "P":
        # pixel-interleaved within each block
        grid = values.reshape(nbpc, nbpr, bh, bw, bands)
        grid = np.moveaxis(grid, -1, 0)  # (bands, nbpc, nbpr, bh, bw)
    elif imode == "S":
        grid = values.reshape(bands, nbpc, nbpr, bh, bw)
    elif imode == "B":
        # band interleaved by block: per block position, band-major
        grid = values.reshape(nbpc, nbpr, bands, bh, bw)
        grid = np.moveaxis(grid, 2, 0)
    else:
        raise _NitfError("NITF IMODE '%s' is not supported" % imode)
    full = grid.transpose(0, 1, 3, 2, 4).reshape(
        bands, nbpc * bh, nbpr * bw
    )
    # one copy: the crop, C order and native byte order together
    out = np.array(
        full[:, : sub["nrows"], : sub["ncols"]],
        dtype=dtype.newbyteorder("="), order="C",
    )
    if sub["pvtype"] == "INT" and 0 < sub["abpp"] < sub["nbpp"]:
        out &= np.array((1 << sub["abpp"]) - 1, out.dtype)
    return out


def _parse_mask(raw, sub):
    """The image data mask subheader (IC = NM/M3/M8): returns
    ``(offsets, pad_code, data)`` — block offsets (None when only pad
    pixels are marked), the pad pixel code bytes, and the payload after
    the mask.  Offsets count from the end of the mask subheader, the
    convention GDAL's reader uses."""
    if len(raw) < 10:
        raise _NitfError("NITF image data mask truncated")
    imdatoff = int.from_bytes(raw[0:4], "big")
    bmrlnth = int.from_bytes(raw[4:6], "big")
    tmrlnth = int.from_bytes(raw[6:8], "big")
    tpxcdlnth = int.from_bytes(raw[8:10], "big")
    pos = 10
    pad_bytes = (tpxcdlnth + 7) // 8
    pad_code = bytes(raw[pos : pos + pad_bytes])
    pos += pad_bytes

    positions = sub["nbpr"] * sub["nbpc"]
    n_records = positions * (sub["nbands"] if sub["imode"] == "S" else 1)
    offsets = None
    if bmrlnth:
        if pos + 4 * n_records > len(raw):
            raise _NitfError("NITF block mask truncated")
        offsets = np.frombuffer(raw, ">u4", count=n_records, offset=pos).tolist()
        pos += 4 * n_records
    if tmrlnth:
        pos += 4 * n_records  # pad-pixel mask records: not needed to read
    return offsets, pad_code, raw[imdatoff:]


def _unmask_blocks(raw, sub):
    """IC=NM: rebuild the dense blocked payload — absent blocks
    (offset 0xFFFFFFFF) fill with the pad pixel code (or zeros)."""
    offsets, pad_code, data = _parse_mask(raw, sub)
    if offsets is None:
        return data  # only pad-pixel marking: the payload is dense

    per_record = sub["nppbh"] * sub["nppbv"] * _pixel_dtype(sub).itemsize
    if sub["imode"] != "S":
        per_record *= sub["nbands"]

    fill = (
        (pad_code * (per_record // max(len(pad_code), 1) + 1))[:per_record]
        if pad_code
        else bytes(per_record)
    )
    out = bytearray(per_record * len(offsets))
    for k, offset in enumerate(offsets):
        at = k * per_record
        if offset == 0xFFFFFFFF:
            out[at : at + per_record] = fill
        else:
            if offset + per_record > len(data):
                raise _NitfError("NITF masked block offset out of range")
            out[at : at + per_record] = data[offset : offset + per_record]
    return out


def _refuse_compressed(sub):
    if sub["ic"] in _UNPORTED:
        raise NotImplementedError(
            "reading NITF %s segments is not ported: the port has no JPEG 2000 decoder; "
            "dask_geomodeling_tpu/io/nitf.py decodes them with Pillow" % sub["ic"]
        )


def _decode_masked_compressed(raw, sub):
    """IC=M3: every present block is its own JPEG codestream at its mask
    offset (the next present offset bounds it); absent blocks fill with
    the pad pixel code."""
    offsets, pad_code, data = _parse_mask(raw, sub)
    if offsets is None:
        raise _NitfError(
            "NITF %s segment without a block mask" % sub["ic"]
        )
    bands = sub["nbands"]
    bh, bw = sub["nppbv"], sub["nppbh"]
    nbpr, nbpc = sub["nbpr"], sub["nbpc"]
    positions = nbpr * nbpc
    pad_value = int.from_bytes(pad_code, "big") if pad_code else 0
    full = None

    present = sorted(
        (offset, record)
        for record, offset in enumerate(offsets)
        if offset != 0xFFFFFFFF
    )
    for index, (offset, record) in enumerate(present):
        end = present[index + 1][0] if index + 1 < len(present) else len(data)
        block = _decode_compressed(data[offset:end], sub, whole=False)
        if full is None:
            full = np.full(
                (bands, nbpc * bh, nbpr * bw), pad_value, block.dtype
            )
        position = record % positions if sub["imode"] == "S" else record
        row, col = divmod(position, nbpr)
        window = full[:, row * bh : (row + 1) * bh, col * bw : (col + 1) * bw]
        if sub["imode"] == "S":
            window[record // positions] = block[0, :bh, :bw]
        else:
            window[:] = block[:, :bh, :bw]
    if full is None:
        full = np.full((bands, nbpc * bh, nbpr * bw), pad_value, np.uint8)
    return full[:, : sub["nrows"], : sub["ncols"]]


def _decode_compressed(raw, sub, whole=True):
    """A C3 codestream as Pillow's ``np.asarray`` gives it (the port's
    codec); ``whole`` crops to the full segment extent, a masked block
    keeps its own size."""
    from dask_geomodeling_tpu_torch.io.jpeg import decode_image

    array = decode_image(bytes(raw))["pixels"]
    if array.ndim == 2:
        array = array[None]
    else:
        array = np.moveaxis(array, -1, 0)
    if whole:
        return array[:, : sub["nrows"], : sub["ncols"]]
    return array


def _parse_header(data):
    cur = _Cursor(data)
    magic = cur.text(9)
    if magic == "NITF02.10":
        version = (2, 1)
    elif magic == "NITF02.00":
        version = (2, 0)
    else:
        raise _NitfError("Not a NITF 2.x file (header %r)" % magic)
    cur.take(2 + 4 + 10 + 14 + 80)  # CLEVEL, STYPE, OSTAID, FDT, FTITLE
    cur.take(1)  # FSCLAS
    _skip_security(cur, version)
    cur.take(5 + 5)  # FSCOP, FSCPYS
    cur.take(1)  # ENCRYP
    if version >= (2, 1):
        cur.take(3)  # FBKGC
        cur.take(24 + 18)  # ONAME, OPHONE
    else:
        cur.take(27 + 18)  # ONAME(27), OPHONE(18) in 2.0
    cur.take(12)  # FL
    header_length = cur.number(6)
    numi = cur.number(3)
    segments = []
    for _ in range(numi):
        lish = cur.number(6)
        li = cur.number(10)
        segments.append((lish, li))
    return version, header_length, segments


def _read_segments(path):
    with open(path, "rb") as fh:
        data = fh.read()
    version, header_length, segments = _parse_header(data)
    if not segments:
        raise _NitfError("NITF file has no image segments")
    view = memoryview(data)
    offset = header_length
    out = []
    for lish, li in segments:
        sub = _parse_image_subheader(data, offset, version)
        payload = view[offset + lish : offset + lish + li]
        out.append((sub, payload))
        offset += lish + li
    return out


def _georeference(head):
    """(geo_transform, projection) of the first segment's corners."""
    if head["icords"] in ("G", "D") and head["igeolo"].strip():
        corners = _parse_igeolo(head["icords"], head["igeolo"])
        return _geotransform(corners, head["nrows"], head["ncols"]), "EPSG:4326"
    return (0.0, 1.0, 0.0, 0.0, 0.0, 1.0), None


def read_nitf(path):
    """Decode a NITF file into the shared RasterData payload (segments
    stack into bands when their grids agree — the GRIB convention)."""
    from dask_geomodeling_tpu_torch.raster.sources import RasterData

    try:
        segments = _read_segments(path)
    except (struct.error, IndexError, UnicodeDecodeError) as error:
        raise _NitfError("Corrupt NITF file: %r" % error)

    stacks = []
    head = segments[0][0]
    for sub, payload in segments:
        if (sub["nrows"], sub["ncols"]) != (head["nrows"], head["ncols"]):
            raise _NitfError(
                "NITF image segments have mismatched grids "
                "(%dx%d vs %dx%d)"
                % (sub["nrows"], sub["ncols"], head["nrows"], head["ncols"])
            )
        _refuse_compressed(sub)
        if sub["ic"] == "NC":
            stacks.append(_decode_blocks(payload, sub))
        elif sub["ic"] == "NM":
            stacks.append(_decode_blocks(_unmask_blocks(payload, sub), sub))
        elif sub["ic"] == "M3":
            stacks.append(_decode_masked_compressed(payload, sub))
        else:
            stacks.append(_decode_compressed(payload, sub))
    array = stacks[0] if len(stacks) == 1 else np.concatenate(stacks, axis=0)

    geo_transform, projection = _georeference(head)
    return RasterData(
        array=array,
        projection=projection,
        geo_transform=geo_transform,
        no_data_value=None,
        metadata=None,
    )


def read_nitf_info(path):
    """Header-only info (no pixel decode)."""
    from dask_geomodeling_tpu_torch.io.geotiff import GeoTIFFInfo

    segments = _read_segments(path)
    for sub, _ in segments:
        _refuse_compressed(sub)
    head = segments[0][0]
    dtype = _dtype(head["pvtype"], head["nbpp"])
    gt, projection = _georeference(head)
    return GeoTIFFInfo(
        width=head["ncols"],
        height=head["nrows"],
        bands=sum(sub["nbands"] for sub, _ in segments),
        dtype=str(np.dtype(dtype)) if dtype else "uint8",
        projection=projection,
        geo_transform=gt,
        no_data_value=None,
        metadata=None,
    )
