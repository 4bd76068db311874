"""ERDAS Imagine ``.img`` rasters (HFA — Hierarchical File Architecture).

Counterpart of dask_geomodeling_tpu/io/hfa.py, copied: the same
RasterData payload as the JAX reader, and the JAX writer's bytes.

The format is self-describing: a little-endian node tree (``Ehfa_Entry``
records) whose node payloads are laid out according to a *data
dictionary* — a text grammar embedded in the file defining every
structure type.

This module parses that dictionary and computes field offsets from it
(the GDAL driver's approach), so payload layouts come from the file
itself, not from hardcoded structs.  Supported: uncompressed and
ESRI-GRID-RLE-compressed blocks, all integer/float pixel types
including the sub-byte u1/u2/u4, multi-band layers, ``Eprj_MapInfo``
cell-center georeferencing, UTM/geographic ``Eprj_ProParameters``, and
the ``Eimg_NonInitializedValue`` nodata basedata.  A compressed block's
run counts are read a stretch of one-byte counts at a time
(``_run_counts``), with the JAX decoder's counts, errors and result.

A writer producing minimal standard-conforming files (uncompressed
blocks) backs the raster sink interop tests.
"""
import struct

import numpy as np

__all__ = ["read_hfa", "write_hfa"]

_MAGIC = b"EHFA_HEADER_TAG\x00"

#: in-stream byte widths of the basic dictionary item types
_ITEM_SIZES = {
    "c": 1, "C": 1,
    "e": 2, "s": 2, "S": 2,
    "t": 4, "l": 4, "L": 4, "f": 4,
    "d": 8,
}
#: sub-byte types: bits per element
_BIT_ITEMS = {"1": 1, "2": 2, "4": 4}

_PIXEL_TYPES = [
    "u1", "u2", "u4", "u8", "s8", "u16", "s16", "u32", "s32",
    "f32", "f64", "c64", "c128",
]
_PIXEL_DTYPES = {
    "u8": np.uint8, "s8": np.int8, "u16": np.uint16, "s16": np.int16,
    "u32": np.uint32, "s32": np.int32, "f32": np.float32, "f64": np.float64,
}


# --- data dictionary ---


class _Field:
    __slots__ = ("count", "item", "inner", "name", "enum_names", "obj_type")

    def __init__(self, count, item, inner, name, enum_names=None,
                 obj_type=None):
        self.count = count
        self.item = item  # 'p'/'*' for pointers, else == inner
        self.inner = inner  # the payload type char
        self.name = name
        self.enum_names = enum_names
        self.obj_type = obj_type  # for 'o'/'x': the nested type definition

    @property
    def pointered(self):
        return self.item in ("p", "*")


class _Dictionary:
    """Parsed HFA data dictionary: type name -> list of fields."""

    def __init__(self, text):
        self.types = {}
        pos = 0
        while pos < len(text) and text[pos] == "{":
            fields, pos = self._parse_fields(text, pos)
            end = text.index(",", pos)
            self.types[text[pos:end]] = fields
            pos = end + 1
        self._sizes = {}

    def _parse_fields(self, text, pos):
        assert text[pos] == "{"
        pos += 1
        fields = []
        while text[pos] != "}":
            colon = text.index(":", pos)
            count = int(text[pos:colon])
            pos = colon + 1
            item = text[pos]
            pos += 1
            pointered = item in ("p", "*")
            if pointered:
                pointer, item = item, text[pos]
                pos += 1
            else:
                pointer = None
            enum_names = obj_type = None
            if item == "e":
                colon = text.index(":", pos)
                n_values = int(text[pos:colon])
                pos = colon + 1
                enum_names = []
                for _ in range(n_values):
                    end = text.index(",", pos)
                    enum_names.append(text[pos:end])
                    pos = end + 1
            elif item == "o":
                end = text.index(",", pos)
                obj_type = text[pos:end]
                pos = end + 1
            elif item == "x":
                # inline object: x{subfields}TYPENAME,FIELDNAME,
                if text[pos] == "{":
                    obj_type, pos = self._parse_fields(text, pos)
                    pos = text.index(",", pos) + 1  # skip the inline name
            end = text.index(",", pos)
            name = text[pos:end]
            pos = end + 1
            fields.append(
                _Field(count, pointer or item, item, name, enum_names,
                       obj_type)
            )
        return fields, pos + 1

    def type_size(self, name):
        """In-stream byte size of a named type (pointers are 8 bytes)."""
        if name in self._sizes:
            return self._sizes[name]
        size = self._fields_size(self.types[name])
        self._sizes[name] = size
        return size

    def _fields_size(self, fields):
        total = 0
        for field in fields:
            total += self._field_size(field)
        return total

    def _field_size(self, field):
        if field.pointered:
            return 8
        inner = field.inner
        if inner in _BIT_ITEMS:
            return (field.count * _BIT_ITEMS[inner] + 7) // 8
        if inner in _ITEM_SIZES:
            return field.count * _ITEM_SIZES[inner]
        if inner == "o":
            return field.count * self.type_size(field.obj_type)
        if inner == "x":
            return field.count * self._fields_size(field.obj_type)
        if inner == "b":
            raise ValueError("un-pointered BASEDATA has no static size")
        raise ValueError("unknown dictionary item %r" % inner)


class _Node:
    """One Ehfa_Entry with typed access to its data payload."""

    def __init__(self, hfa, offset):
        self._hfa = hfa
        raw = hfa.raw
        (self.next_ptr, self.prev, self.parent, self.child_ptr,
         self.data_ptr, self.data_size) = struct.unpack_from("<6I", raw, offset)
        self.name = _cstr(raw[offset + 24 : offset + 88])
        self.type = _cstr(raw[offset + 88 : offset + 120])

    def children(self):
        ptr = self.child_ptr
        while ptr:
            node = _Node(self._hfa, ptr)
            yield node
            ptr = node.next_ptr

    def find(self, name=None, type_=None):
        for child in self.children():
            if (name is None or child.name == name) and (
                type_ is None or child.type == type_
            ):
                return child
        return None

    def get(self, path, default=None):
        """Extract a (possibly nested) field value: ``"a.b.c"``."""
        try:
            return self._hfa.extract(
                self.type, self._hfa.raw, self.data_ptr, path.split(".")
            )
        except (KeyError, ValueError, IndexError, struct.error):
            return default


def _cstr(raw):
    return raw.split(b"\x00", 1)[0].decode("ascii", "replace")


class _HFAFile:
    def __init__(self, path):
        with open(path, "rb") as stream:
            self.raw = stream.read()
        if self.raw[:16] != _MAGIC:
            raise ValueError("not an ERDAS Imagine (HFA) file: %s" % path)
        (header_ptr,) = struct.unpack_from("<I", self.raw, 16)
        (version, _free, root_ptr, _ehl, dict_ptr) = struct.unpack_from(
            "<IIIHI", self.raw, header_ptr
        )
        if version != 1:
            raise ValueError("unsupported HFA version %d" % version)
        # the dictionary is a text blob at dict_ptr; the parse loop stops
        # at the terminating '.' (or any non-'{' byte) on its own
        end = self.raw.find(b"\x00", dict_ptr)
        if end < 0:
            end = len(self.raw)
        text = self.raw[dict_ptr:end].decode("ascii", "replace")
        self.dictionary = _Dictionary(text)
        self.root = _Node(self, root_ptr)

    # --- generic field extraction driven by the dictionary ---

    def extract(self, type_name, raw, base, path):
        fields = self.dictionary.types[type_name]
        return self._extract_fields(fields, raw, base, path)

    def _extract_fields(self, fields, raw, base, path):
        offset = base
        target = path[0]
        for field in fields:
            if field.name == target:
                return self._field_value(field, raw, offset, path[1:])
            offset += self.dictionary._field_size(field)
        raise KeyError(target)

    def _field_value(self, field, raw, offset, rest):
        dic = self.dictionary
        if field.pointered:
            count, data_ptr = struct.unpack_from("<II", raw, offset)
            if data_ptr == 0:
                return None
            inner = field.inner
            if inner == "b":
                return _read_basedata(raw, data_ptr)
            if inner in ("c", "C"):
                end = raw.index(b"\x00", data_ptr)
                return raw[data_ptr:end].decode("ascii", "replace")
            if inner == "o":
                if rest:
                    return self.extract(field.obj_type, raw, data_ptr, rest)
                return data_ptr
            if inner == "x":
                if rest:
                    return self._extract_fields(
                        field.obj_type, raw, data_ptr, rest
                    )
                return data_ptr
            if inner in _ITEM_SIZES:
                return self._scalars(inner, raw, data_ptr, count, field)
            raise ValueError("unsupported pointered item %r" % inner)
        inner = field.inner
        if inner == "o":
            return self.extract(field.obj_type, raw, offset, rest)
        if inner == "x":
            return self._extract_fields(field.obj_type, raw, offset, rest)
        if inner in ("c", "C"):
            return _cstr(raw[offset : offset + field.count])
        if inner in _ITEM_SIZES:
            return self._scalars(inner, raw, offset, field.count, field)
        raise ValueError("unsupported item %r" % inner)

    def _scalars(self, inner, raw, offset, count, field):
        fmt = {"e": "H", "s": "H", "S": "h", "t": "I", "l": "I", "L": "i",
               "f": "f", "d": "d"}[inner]
        values = struct.unpack_from("<%d%s" % (count, fmt), raw, offset)
        if inner == "e" and field.enum_names is not None:
            values = tuple(
                field.enum_names[v] if v < len(field.enum_names) else v
                for v in values
            )
        return values[0] if count == 1 else list(values)


def _read_basedata(raw, ptr):
    """BASEDATA: rows/cols/pixel-type header + payload; returns ndarray."""
    rows, cols, dtype_code = struct.unpack_from("<iih", raw, ptr)
    name = _PIXEL_TYPES[dtype_code] if dtype_code < len(_PIXEL_TYPES) else None
    if name not in _PIXEL_DTYPES:
        raise ValueError("unsupported basedata type %r" % dtype_code)
    dt = np.dtype(_PIXEL_DTYPES[name]).newbyteorder("<")
    n = rows * cols
    return np.frombuffer(raw, dt, n, ptr + 12).reshape(rows, cols)


# --- RLE (ESRI GRID compression) ---


def _rle_values(raw, base, n, n_bits):
    """The packed value stream of a compressed block: ``n`` values of
    ``n_bits`` each.  Sub-byte widths are LSB-first within each byte and
    16/32-bit values big-endian (GDAL hfaband.cpp conventions)."""
    if n_bits == 0:
        return np.zeros(n, np.int64)
    if n_bits in (1, 2, 4):
        per_byte = 8 // n_bits
        nbytes = (n + per_byte - 1) // per_byte
        bytes_ = np.frombuffer(raw, np.uint8, nbytes, base)
        shifts = np.arange(per_byte, dtype=np.uint8) * n_bits
        mask = (1 << n_bits) - 1
        expanded = (bytes_[:, None] >> shifts[None, :]) & mask
        return expanded.reshape(-1)[:n].astype(np.int64)
    if n_bits in (8, 16, 32):
        fmt = {8: np.uint8, 16: np.dtype(">u2"), 32: np.dtype(">u4")}[n_bits]
        return np.frombuffer(raw, fmt, n, base).astype(np.int64)
    raise ValueError("unsupported RLE bit width %d" % n_bits)


def _rle_decode(raw, ptr, n_values):
    """Decode one ESRI-GRID-compressed block into ``n_values`` ints."""
    (minimum,) = struct.unpack_from("<i", raw, ptr)
    (n_runs,) = struct.unpack_from("<i", raw, ptr + 4)
    (data_offset,) = struct.unpack_from("<I", raw, ptr + 8)
    n_bits = raw[ptr + 12]
    if n_runs == -1:
        # not run-length encoded: one packed value per pixel at +13
        return _rle_values(raw, ptr + 13, n_values, n_bits) + minimum
    counts = _run_counts(raw, ptr + 13, n_runs)
    values = _rle_values(raw, ptr + data_offset, n_runs, n_bits)
    out = np.repeat(values + minimum, counts)
    if len(out) < n_values:
        raise ValueError("RLE block underflow: %d < %d" % (len(out), n_values))
    return out[:n_values]


def _run_counts(raw, start, n_runs):
    """The ``n_runs`` run lengths stored from ``start`` on: each is a byte
    whose top two bits count the bytes that follow it (big-endian) and
    whose low six bits lead the length.  A byte below 64 is a whole run,
    so each stretch of such bytes is copied at once and only the longer
    runs are read one by one, from ``raw`` itself: the counts of a
    byte-by-byte read, and its IndexError where they run past the end."""
    counts = np.empty(n_runs, np.int64)
    # a run takes at most four bytes
    stream = np.frombuffer(raw, np.uint8, min(len(raw) - start, 4 * n_runs), start)
    heads = np.flatnonzero(stream >= 64)  # where a longer run may start
    i = pos = 0
    while i < n_runs:
        k = np.searchsorted(heads, pos)
        singles = min((heads[k] if k < len(heads) else len(stream)) - pos, n_runs - i)
        counts[i : i + singles] = stream[pos : pos + singles]
        i += singles
        pos += singles
        if i == n_runs:
            break
        first = raw[start + pos]  # past the end: the IndexError of raw[]
        value = first & 0x3F
        for _ in range(first >> 6):
            pos += 1
            value = (value << 8) | raw[start + pos]
        pos += 1
        counts[i] = value
        i += 1
    return counts


def _unpack_bits(data, bits, n):
    """Unpack u1/u2/u4 pixels (LSB-first within each byte, like GDAL)."""
    per_byte = 8 // bits
    mask = (1 << bits) - 1
    bytes_ = np.frombuffer(data, np.uint8, (n + per_byte - 1) // per_byte)
    shifts = np.arange(per_byte, dtype=np.uint8) * bits
    expanded = (bytes_[:, None] >> shifts[None, :]) & mask
    return expanded.reshape(-1)[:n]


# --- reader ---


def read_hfa(path):
    """Read an ERDAS Imagine raster into the RasterData payload."""
    from dask_geomodeling_tpu_torch.raster.sources import RasterData

    hfa = _HFAFile(path)
    # Eimg_Layer_SubSample nodes are reduced-resolution overviews —
    # only full-resolution layers stack as bands
    layers = [
        node for node in hfa.root.children() if node.type == "Eimg_Layer"
    ]
    if not layers:
        raise ValueError("HFA file has no raster layers: %s" % path)
    bands = []
    no_data = None
    for layer in layers:
        bands.append(_read_layer(hfa, layer))
        if no_data is None:
            nd_node = layer.find(type_="Eimg_NonInitializedValue")
            if nd_node is not None:
                basedata = nd_node.get("valueBD")
                if basedata is not None and basedata.size:
                    no_data = float(basedata.reshape(-1)[0])
    array = np.stack(bands)

    geo_transform = (0.0, 1.0, 0.0, 0.0, 0.0, -1.0)
    projection = None
    map_node = layers[0].find(type_="Eprj_MapInfo")
    if map_node is not None:
        ulx = map_node.get("upperLeftCenter.x")
        uly = map_node.get("upperLeftCenter.y")
        psx = map_node.get("pixelSize.width")
        psy = map_node.get("pixelSize.height")
        if None not in (ulx, uly, psx, psy):
            geo_transform = (
                ulx - psx / 2.0, psx, 0.0, uly + psy / 2.0, 0.0, -psy
            )
    pro_node = layers[0].find(type_="Eprj_ProParameters")
    if pro_node is not None:
        projection = _projection_from_pro(pro_node)

    return RasterData(
        array=array,
        projection=projection,
        geo_transform=geo_transform,
        no_data_value=no_data,
        metadata=[""] * array.shape[0],
    )


def _read_layer(hfa, layer):
    width = layer.get("width")
    height = layer.get("height")
    pixel_type = layer.get("pixelType")
    block_w = layer.get("blockWidth")
    block_h = layer.get("blockHeight")
    if None in (width, height, pixel_type, block_w, block_h):
        raise ValueError("incomplete Eimg_Layer header")
    if pixel_type in ("c64", "c128"):
        raise ValueError("complex HFA pixel type %s unsupported" % pixel_type)

    dms = layer.find(name="RasterDMS") or layer.find(type_="Edms_State")
    if dms is None:
        raise ValueError("layer %r lacks a RasterDMS node" % layer.name)
    info_ptr = dms.get("blockinfo")
    n_blocks = dms.get("numvirtualblocks")
    per_block = dms.get("numobjectsperblock")
    if info_ptr is None or n_blocks is None:
        raise ValueError("RasterDMS lacks blockinfo")
    info_size = hfa.dictionary.type_size("Edms_VirtualBlockInfo")

    if pixel_type in _BIT_ITEMS:
        out_dtype = np.uint8
        bits = _BIT_ITEMS[pixel_type]
    else:
        out_dtype = _PIXEL_DTYPES[pixel_type]
        bits = None
    band = np.zeros((height, width), out_dtype)

    blocks_x = -(-width // block_w)
    raw = hfa.raw
    for index in range(n_blocks):
        base = info_ptr + index * info_size
        offset = hfa.extract("Edms_VirtualBlockInfo", raw, base, ["offset"])
        logvalid = hfa.extract(
            "Edms_VirtualBlockInfo", raw, base, ["logvalid"]
        )
        compressed = hfa.extract(
            "Edms_VirtualBlockInfo", raw, base, ["compressionType"]
        )
        if str(logvalid) == "false" or offset in (None, 0):
            continue  # never-written block: stays zero
        is_compressed = str(compressed) not in ("no compression", "0")
        n_values = per_block or block_w * block_h
        if is_compressed:
            if out_dtype in (np.float32, np.float64):
                raise ValueError(
                    "ESRI GRID compression on float pixels unsupported"
                )
            flat = _rle_decode(raw, offset, n_values)
            block = flat.astype(out_dtype)
        elif bits is not None:
            block = _unpack_bits(
                raw[offset : offset + (n_values * bits + 7) // 8],
                bits, n_values,
            ).astype(out_dtype)
        else:
            dt = np.dtype(out_dtype).newbyteorder("<")
            block = np.frombuffer(raw, dt, n_values, offset).astype(out_dtype)
        block = block[: block_h * block_w].reshape(block_h, block_w)
        by, bx = divmod(index, blocks_x)
        y0, x0 = by * block_h, bx * block_w
        h = min(block_h, height - y0)
        w = min(block_w, width - x0)
        if h <= 0 or w <= 0:
            continue
        band[y0 : y0 + h, x0 : x0 + w] = block[:h, :w]
    return band


def _projection_from_pro(pro_node):
    number = pro_node.get("proNumber")
    if number == 0:
        return "EPSG:4326"
    if number == 1:
        zone = pro_node.get("proZone") or 0
        if zone >= 2**31:
            zone -= 2**32  # proZone is a ULONG field; south is negative
        datum = (pro_node.get("proSpheroid.sphereName") or "").upper()
        if zone:
            south = zone < 0
            zone = abs(zone)
            if "NAD27" in datum or "CLARKE 1866" in datum:
                return "EPSG:%d" % (26700 + zone)
            base = 32700 if south else 32600
            return "EPSG:%d" % (base + zone)
    name = pro_node.get("proName") or ""
    # only a name the CRS machinery can actually parse is useful as a
    # projection; bare method names ("Lambert Conformal Conic") are not
    if name.upper().startswith(
        ("EPSG:", "ESRI:", "PROJCS", "GEOGCS", "PROJCRS", "GEOGCRS", "+PROJ")
    ):
        return name
    return None


# --- writer (uncompressed; fixture/interop support) ---

_DICTIONARY = (
    "{1:lversion,1:LfreeList,1:LrootEntryPtr,1:sentryHeaderLength,"
    "1:LdictionaryPtr,}Ehfa_File,"
    "{1:Lnext,1:Lprev,1:Lparent,1:Lchild,1:Ldata,1:ldataSize,64:cname,"
    "32:ctype,1:tmodTime,}Ehfa_Entry,"
    "{1:lwidth,1:lheight,1:e3:thematic,athematic,fft of real-valued data,"
    "layerType,1:e13:u1,u2,u4,u8,s8,u16,s16,u32,s32,f32,f64,c64,c128,"
    "pixelType,1:lblockWidth,1:lblockHeight,}Eimg_Layer,"
    "{1:lnumvirtualblocks,1:lnumobjectsperblock,1:lnextobjectnum,"
    "1:e2:no compression,ESRI GRID compression,compressionType,"
    "0:poEdms_VirtualBlockInfo,blockinfo,0:pcdependent,}Edms_State,"
    "{1:SfileCode,1:Loffset,1:lsize,1:e2:false,true,logvalid,"
    "1:e2:no compression,compression,compressionType,}Edms_VirtualBlockInfo,"
    "{1:dx,1:dy,}Eprj_Coordinate,"
    "{1:dwidth,1:dheight,}Eprj_Size,"
    "{0:pcproName,1:*oEprj_Coordinate,upperLeftCenter,"
    "1:*oEprj_Coordinate,lowerRightCenter,1:*oEprj_Size,pixelSize,"
    "0:pcunits,}Eprj_MapInfo,"
    "{1:e2:EPRJ_INTERNAL,EPRJ_EXTERNAL,proType,1:lproNumber,"
    "0:pcproExeName,0:pcproName,1:lproZone,0:pdproParams,"
    "1:*oEprj_Spheroid,proSpheroid,}Eprj_ProParameters,"
    "{0:pcsphereName,1:da,1:db,1:deSquared,1:dradius,}Eprj_Spheroid,"
    "{1:*bvalueBD,}Eimg_NonInitializedValue,"
    "."
)

_ENTRY_SIZE = 128


class _Writer:
    def __init__(self):
        self.buf = bytearray()

    def reserve(self, n):
        pos = len(self.buf)
        self.buf += b"\x00" * n
        return pos

    def put(self, fmt, pos, *values):
        struct.pack_into(fmt, self.buf, pos, *values)

    def append(self, data):
        pos = len(self.buf)
        self.buf += data
        return pos


def write_hfa(path, values, geo_transform=None, projection=None,
              no_data_value=None):
    """Write (bands, h, w) data as a standard uncompressed HFA file."""
    values = np.asarray(values)
    if values.ndim == 2:
        values = values[np.newaxis]
    bands, height, width = values.shape
    kind_map = {
        ("u", 1): "u8", ("i", 1): "s8", ("u", 2): "u16", ("i", 2): "s16",
        ("u", 4): "u32", ("i", 4): "s32", ("f", 4): "f32", ("f", 8): "f64",
    }
    key = (values.dtype.kind, values.dtype.itemsize)
    if values.dtype == bool:
        values = values.astype(np.uint8)
        key = ("u", 1)
    if key not in kind_map:
        raise ValueError("unsupported dtype %s for HFA" % values.dtype)
    pixel_name = kind_map[key]
    pixel_code = _PIXEL_TYPES.index(pixel_name)

    w = _Writer()
    w.append(_MAGIC)
    header_ptr_pos = w.reserve(4)
    header_pos = w.reserve(18)  # Ehfa_File
    w.put("<I", header_ptr_pos, header_pos)

    entries = []  # (pos, parent_idx, name, type, data_ptr, data_size)

    def add_entry(parent_idx, name, type_, data, data_size):
        pos = w.reserve(_ENTRY_SIZE)
        entries.append([pos, parent_idx, name, type_, data, data_size])
        return len(entries) - 1

    root_idx = add_entry(-1, "root", "root", 0, 0)

    block_w = min(64, width)
    block_h = min(64, height)
    blocks_x = -(-width // block_w)
    blocks_y = -(-height // block_h)
    per_block = block_w * block_h
    dt = np.dtype(values.dtype).newbyteorder("<")

    for b in range(bands):
        # Eimg_Layer: width l@0, height l@4, layerType e@8, pixelType
        # e@10, blockWidth l@12, blockHeight l@16
        layer_data = w.reserve(20)
        w.put("<i", layer_data, width)
        w.put("<i", layer_data + 4, height)
        w.put("<H", layer_data + 8, 1)  # athematic
        w.put("<H", layer_data + 10, pixel_code)
        w.put("<i", layer_data + 12, block_w)
        w.put("<i", layer_data + 16, block_h)
        layer_idx = add_entry(
            root_idx, "Layer_%d" % (b + 1), "Eimg_Layer",
            layer_data, 20,
        )

        # block payloads
        offsets = []
        for by in range(blocks_y):
            for bx in range(blocks_x):
                tile = np.zeros((block_h, block_w), dt)
                sub = values[
                    b, by * block_h : (by + 1) * block_h,
                    bx * block_w : (bx + 1) * block_w,
                ]
                tile[: sub.shape[0], : sub.shape[1]] = sub
                offsets.append(w.append(tile.tobytes()))

        info_size = 2 + 4 + 4 + 2 + 2
        info_ptr = w.reserve(len(offsets) * info_size)
        for i, off in enumerate(offsets):
            base = info_ptr + i * info_size
            w.put("<h", base, 0)
            w.put("<i", base + 2, off)
            w.put("<i", base + 6, per_block * dt.itemsize)
            w.put("<H", base + 10, 1)  # logvalid true
            w.put("<H", base + 12, 0)  # no compression
        dms_data = w.reserve(4 * 3 + 2 + 8 + 8)
        w.put("<i", dms_data, len(offsets))
        w.put("<i", dms_data + 4, per_block)
        w.put("<i", dms_data + 8, len(offsets))
        w.put("<H", dms_data + 12, 0)  # no compression
        w.put("<II", dms_data + 14, len(offsets), info_ptr)
        w.put("<II", dms_data + 22, 0, 0)  # dependent: none
        add_entry(layer_idx, "RasterDMS", "Edms_State", dms_data, 30)

        if b == 0 and geo_transform is not None:
            gt = geo_transform
            ulc = w.reserve(16)
            w.put("<dd", ulc, gt[0] + gt[1] / 2.0, gt[3] + gt[5] / 2.0)
            lrc = w.reserve(16)
            w.put(
                "<dd", lrc,
                gt[0] + gt[1] * (width - 0.5),
                gt[3] + gt[5] * (height - 0.5),
            )
            psize = w.reserve(16)
            w.put("<dd", psize, abs(gt[1]), abs(gt[5]))
            name_ptr = w.append(b"map\x00")
            units_ptr = w.append(b"meters\x00")
            map_data = w.reserve(8 * 5)
            w.put("<II", map_data, 4, name_ptr)
            w.put("<II", map_data + 8, 1, ulc)
            w.put("<II", map_data + 16, 1, lrc)
            w.put("<II", map_data + 24, 1, psize)
            w.put("<II", map_data + 32, 7, units_ptr)
            add_entry(layer_idx, "Map_Info", "Eprj_MapInfo", map_data, 40)

        if b == 0 and projection is not None:
            number, zone, sphere = _pro_fields_for(projection)
            sphere_name = w.append(sphere.encode("ascii") + b"\x00")
            sphere_data = w.reserve(8 + 8 * 4)
            w.put("<II", sphere_data, len(sphere) + 1, sphere_name)
            pro_name = w.append(projection.encode("ascii") + b"\x00")
            pro_data = w.reserve(2 + 4 + 8 + 8 + 4 + 8 + 8)
            w.put("<H", pro_data, 0)  # EPRJ_INTERNAL
            w.put("<i", pro_data + 2, number)
            w.put("<II", pro_data + 6, 0, 0)  # proExeName
            w.put("<II", pro_data + 14, len(projection) + 1, pro_name)
            w.put("<i", pro_data + 22, zone)
            w.put("<II", pro_data + 26, 0, 0)  # proParams
            w.put("<II", pro_data + 34, 1, sphere_data)
            add_entry(
                layer_idx, "Projection", "Eprj_ProParameters", pro_data, 42
            )

        if b == 0 and no_data_value is not None:
            basedata = w.reserve(12 + 8)
            w.put("<iih", basedata, 1, 1, _PIXEL_TYPES.index("f64"))
            w.put("<d", basedata + 12, float(no_data_value))
            nd_data = w.reserve(8)
            w.put("<II", nd_data, 1, basedata)
            add_entry(
                layer_idx, "Eimg_NonInitializedValue",
                "Eimg_NonInitializedValue", nd_data, 8,
            )

    dict_ptr = w.append(_DICTIONARY.encode("ascii") + b"\x00")

    # link the entry tree
    first_child = {}
    last_child = {}
    for idx, (pos, parent, *_rest) in enumerate(entries):
        if parent < 0:
            continue
        if parent not in first_child:
            first_child[parent] = idx
        else:
            prev_idx = last_child[parent]
            w.put("<I", entries[prev_idx][0], entries[idx][0])  # next
            w.put("<I", entries[idx][0] + 4, entries[prev_idx][0])  # prev
        last_child[parent] = idx
    for idx, (pos, parent, name, type_, data, data_size) in enumerate(entries):
        if parent >= 0:
            w.put("<I", pos + 8, entries[parent][0])
        if idx in first_child:
            w.put("<I", pos + 12, entries[first_child[idx]][0])
        w.put("<I", pos + 16, data)
        w.put("<i", pos + 20, data_size)
        w.put("<64s", pos + 24, name.encode("ascii"))
        w.put("<32s", pos + 88, type_.encode("ascii"))

    # Ehfa_File header
    w.put("<IIIHI", header_pos, 1, 0, entries[0][0], _ENTRY_SIZE, dict_ptr)

    with open(path, "wb") as stream:
        stream.write(bytes(w.buf))


def _pro_fields_for(projection):
    text = (projection or "").upper().replace("EPSG:", "")
    try:
        code = int(text)
    except ValueError:
        code = None
    if code == 4326:
        return 0, 0, "WGS 84"
    if code is not None:
        if 32601 <= code <= 32660:
            return 1, code - 32600, "WGS 84"
        if 32701 <= code <= 32760:
            return 1, -(code - 32700), "WGS 84"
        if 26701 <= code <= 26722:
            return 1, code - 26700, "Clarke 1866"
    # anything else rides on proName (readers fall back to the name)
    return 99, 0, "WGS 84"
