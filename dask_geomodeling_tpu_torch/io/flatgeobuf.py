"""FlatGeobuf (.fgb) vector read/write.

Counterpart of dask_geomodeling_tpu/io/flatgeobuf.py, on the port's
pandas-free frame (geo/features.py) and without the ``flatbuffers``
package: its tables are read and built by io/_flatbuffers.py, a copy of
the runtime's behaviour, so the files written are byte-identical to the
JAX writer's and each package reads the other's files into equal frames.

The format (FlatGeobuf 3: magic ``fgb\\x03fgb\\x00``, a header and
per-feature flatbuffers, little-endian size prefixes, an optional packed
Hilbert R-tree index): reading accepts files with or without the spatial
index; with a ``bbox`` and an index present, the packed R-tree is
searched and only the intersecting features decode.  Writing
Hilbert-sorts the features and emits the index by default
(``index_node_size=0`` for unindexed frame-order files).  Property
values encode per the spec's column-indexed binary layout; column types
map from the frame's column dtypes as the JAX writer maps pandas' (Bool,
Int, Long, ULong, Double, String, Json, Binary).

Geometries cover Point/MultiPoint/LineString/MultiLineString/Polygon/
MultiPolygon.
"""
import json
import math
import struct

import numpy as np

from dask_geomodeling_tpu_torch.io._flatbuffers import Builder, root

__all__ = ["read_flatgeobuf", "write_flatgeobuf"]

MAGIC = b"fgb\x03fgb\x00"

# GeometryType enum (spec header.fbs)
_GT_UNKNOWN = 0
_GT_POINT = 1
_GT_LINESTRING = 2
_GT_POLYGON = 3
_GT_MULTIPOINT = 4
_GT_MULTILINESTRING = 5
_GT_MULTIPOLYGON = 6

_GT_BY_NAME = {
    "Point": _GT_POINT,
    "LineString": _GT_LINESTRING,
    "Polygon": _GT_POLYGON,
    "MultiPoint": _GT_MULTIPOINT,
    "MultiLineString": _GT_MULTILINESTRING,
    "MultiPolygon": _GT_MULTIPOLYGON,
}

# ColumnType enum (spec header.fbs)
_CT_BYTE = 0
_CT_UBYTE = 1
_CT_BOOL = 2
_CT_SHORT = 3
_CT_USHORT = 4
_CT_INT = 5
_CT_UINT = 6
_CT_LONG = 7
_CT_ULONG = 8
_CT_FLOAT = 9
_CT_DOUBLE = 10
_CT_STRING = 11
_CT_JSON = 12
_CT_DATETIME = 13
_CT_BINARY = 14

_FIXED_FMT = {
    _CT_BYTE: "<b",
    _CT_UBYTE: "<B",
    _CT_BOOL: "<B",
    _CT_SHORT: "<h",
    _CT_USHORT: "<H",
    _CT_INT: "<i",
    _CT_UINT: "<I",
    _CT_LONG: "<q",
    _CT_ULONG: "<Q",
    _CT_FLOAT: "<f",
    _CT_DOUBLE: "<d",
}

_NODE_BYTES = 40  # 4 float64 bounds + uint64 offset


_NODE_ITEM = struct.Struct("<4dQ")  # minx, miny, maxx, maxy, offset


def _rtree_level_sizes(num_items, node_size):
    """Per-level node counts, ROOT FIRST (the spec's storage order).

    Do-while semantics like :func:`_packed_rtree_size`: even a single
    item gets a distinct root level."""
    if num_items <= 0:
        raise ValueError("packed R-tree needs at least one item")
    node_size = max(int(node_size), 2)
    sizes = [int(num_items)]
    while True:
        n = math.ceil(sizes[-1] / node_size)
        sizes.append(n)
        if n == 1:
            break
    return list(reversed(sizes))


def _hilbert_codes(xs, ys, order=16):
    """Vectorized Hilbert curve distance for grid coordinates in
    [0, 2**order) — the packing order the FlatGeobuf spec prescribes."""
    x = np.asarray(xs, dtype=np.uint64).copy()
    y = np.asarray(ys, dtype=np.uint64).copy()
    d = np.zeros_like(x)
    n_minus_1 = np.uint64((1 << order) - 1)
    s = np.uint64(1 << (order - 1))
    one = np.uint64(1)
    while s > 0:
        rx = ((x & s) > 0).astype(np.uint64)
        ry = ((y & s) > 0).astype(np.uint64)
        d += s * s * ((np.uint64(3) * rx) ^ ry)
        # rotate the quadrant (canonical xy2d: reflect about the FULL
        # grid, which keeps coordinates in [0, 2**order) — no underflow)
        swap = ry == 0
        flip = swap & (rx == one)
        x = np.where(flip, n_minus_1 - x, x)
        y = np.where(flip, n_minus_1 - y, y)
        x_new = np.where(swap, y, x)
        y_new = np.where(swap, x, y)
        x, y = x_new, y_new
        s >>= one
    return d


def _level_starts(sizes):
    """Each level's first node index, and the node count."""
    starts = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    return starts[:-1], starts[-1]


def _build_packed_rtree(leaf_items, node_size):
    """Serialize the packed R-tree for leaf (bbox, offset) items already
    in storage order; internal offsets are absolute first-child node
    indices (the reference implementation's convention)."""
    n = len(leaf_items)
    sizes = _rtree_level_sizes(n, node_size)
    starts, total = _level_starts(sizes)
    nodes = [None] * total
    nodes[total - n :] = list(leaf_items)
    for level in range(len(sizes) - 2, -1, -1):
        child_start = starts[level + 1]
        child_count = sizes[level + 1]
        for k in range(sizes[level]):
            first = child_start + k * node_size
            last = min(first + node_size, child_start + child_count)
            group = nodes[first:last]
            nodes[starts[level] + k] = (
                min(g[0] for g in group),
                min(g[1] for g in group),
                max(g[2] for g in group),
                max(g[3] for g in group),
                first,
            )
    return b"".join(_NODE_ITEM.pack(*node) for node in nodes)


def _search_packed_rtree(buf, tree_pos, num_items, node_size, bbox):
    """Feature byte offsets (features-section relative) whose leaf boxes
    intersect ``bbox``, plus their leaf ranks (= feature ids)."""
    sizes = _rtree_level_sizes(num_items, node_size)
    starts, total = _level_starts(sizes)
    leaf_start = total - num_items
    minx, miny, maxx, maxy = bbox
    hits = []
    queue = [(0, 0)]
    while queue:
        index, level = queue.pop()
        nx0, ny0, nx1, ny1, offset = _NODE_ITEM.unpack_from(
            buf, tree_pos + index * _NODE_ITEM.size
        )
        if nx1 < minx or nx0 > maxx or ny1 < miny or ny0 > maxy:
            continue
        if index >= leaf_start:
            hits.append((index - leaf_start, offset))
        else:
            child_level = level + 1
            end = starts[child_level] + sizes[child_level]
            for child in range(offset, min(offset + node_size, end)):
                queue.append((child, child_level))
    return sorted(hits)


def _packed_rtree_size(num_items, node_size):
    """Byte size of the spec's packed Hilbert R-tree."""
    if num_items == 0:
        return 0
    return sum(_rtree_level_sizes(num_items, node_size)) * _NODE_BYTES


def header_index_node_size(head):
    """The header's index node size (the spec's default 16 when the slot
    is absent) from the first bytes of a file, or None when they are not
    a whole FlatGeobuf header."""
    if bytes(head[:7]) != MAGIC[:7] or len(head) < 12:
        return None
    (header_size,) = struct.unpack_from("<I", head, 8)
    return root(memoryview(head)[12 : 12 + header_size]).scalar(9, "<H", 16)


# --- geometry decode ---


def _decode_geometry(tab, geometry_type):
    from dask_geomodeling_tpu_torch.geo.geometry import (
        LineString,
        MultiLineString,
        MultiPoint,
        MultiPolygon,
        Point,
        Polygon,
    )

    # Geometry table slots (spec feature.fbs): ends=0, xy=1, z=2, m=3,
    # t=4, tm=5, type=6, parts=7
    gtype = tab.scalar(6, "<B", 0) or geometry_type
    xy = tab.array(1, "<f8")
    ends = tab.array(0, "<u4")
    parts = tab.tables(7)

    if (xy is None or len(xy) == 0) and not parts:
        # empty geometry: no coordinate vector and no sub-parts
        return None
    pts = None if xy is None else xy.astype(np.float64).reshape(-1, 2)
    if gtype == _GT_POINT:
        (pt,) = pts
        return Point(*pt)
    if gtype == _GT_MULTIPOINT:
        return MultiPoint([Point(*p) for p in pts])
    if gtype == _GT_LINESTRING:
        return LineString(pts)
    if ends is None or len(ends) == 0:
        rings = [pts]
    else:
        bounds = [0] + ends.tolist()
        rings = [pts[start:end] for start, end in zip(bounds, bounds[1:])]
    if gtype == _GT_MULTILINESTRING:
        return MultiLineString([LineString(r) for r in rings])
    if gtype == _GT_POLYGON:
        return Polygon(rings[0], rings[1:] or None)
    if gtype == _GT_MULTIPOLYGON:
        return MultiPolygon([_decode_geometry(part, _GT_POLYGON) for part in parts])
    raise NotImplementedError("FlatGeobuf geometry type %d" % gtype)


def _decode_properties(raw, columns):
    values = {}
    pos = 0
    n = len(raw)
    while pos + 2 <= n:
        (idx,) = struct.unpack_from("<H", raw, pos)
        pos += 2
        name, ctype = columns[idx]
        if ctype in _FIXED_FMT:
            fmt = _FIXED_FMT[ctype]
            (value,) = struct.unpack_from(fmt, raw, pos)
            pos += struct.calcsize(fmt)
            if ctype == _CT_BOOL:
                value = bool(value)
        else:
            (length,) = struct.unpack_from("<I", raw, pos)
            pos += 4
            data = raw[pos : pos + length]
            pos += length
            if ctype == _CT_BINARY:
                value = bytes(data)
            else:
                value = data.decode("utf-8")
                if ctype == _CT_JSON:
                    value = json.loads(value)
        values[name] = value
    return values


def _frame_of_records(records, geometries, crs):
    """A frame as the JAX reader's pandas ``from_records`` makes it: one
    column per key in the order the keys first appear, NaN where a record
    lacks the key, the geometry column after them."""
    from dask_geomodeling_tpu_torch.geo.features import GeoDataFrame, _as_column

    keys = {}
    for record in records:
        keys.update(dict.fromkeys(record))
    if not keys:
        return GeoDataFrame(geometry=geometries, crs=crs)
    table = GeoDataFrame({k: _as_column([r.get(k, np.nan) for r in records]) for k in keys})
    return GeoDataFrame(table, geometry=geometries, crs=crs)


def read_flatgeobuf(path, bbox=None, bbox_projection=None):
    """Read a FlatGeobuf file into a GeoDataFrame.

    With ``bbox`` (``(x1, y1, x2, y2)``, in ``bbox_projection`` or the
    file CRS) and a spatial index in the file, only the features whose
    boxes intersect decode; the frame index holds their file positions
    (fids).  Without an index the whole file decodes (bbox filtering is
    then the caller's job)."""
    from dask_geomodeling_tpu_torch.geo.features import Index

    stream = open(path, "rb")
    head = stream.read(12)
    # Byte 7 is the patch version, which readers must ignore (current
    # writers emit 0x01); validate only the magic + major version bytes.
    if head[:7] != MAGIC[:7]:
        stream.close()
        raise IOError("Not a FlatGeobuf file: '%s'" % path)
    (header_size,) = struct.unpack_from("<I", head, 8)
    header = root(memoryview(stream.read(header_size)))

    # Header slots (spec header.fbs): name=0, envelope=1, geometry_type=2,
    # has_z=3, has_m=4, has_t=5, has_tm=6, columns=7, features_count=8,
    # index_node_size=9, crs=10
    geometry_type = header.scalar(2, "<B", 0)
    features_count = header.scalar(8, "<Q", 0)
    index_node_size = header.scalar(9, "<H", 16)
    # Column slots: name=0, type=1
    columns = [(col.string(0), col.scalar(1, "<B", 0)) for col in header.tables(7)]
    crs_tab = header.table(10)
    crs = None
    if crs_tab is not None:
        # Crs slots: org=0, code=1, name=2, description=3, wkt=4
        org = crs_tab.string(0)
        code = crs_tab.scalar(1, "<i", 0)
        wkt = crs_tab.string(4)
        if code:
            # spec header.fbs: org NULL means EPSG
            crs = "%s:%d" % (org or "EPSG", code)
        elif wkt:
            crs = wkt
    if crs is None:
        crs = "EPSG:4326"

    tree_size = (
        _packed_rtree_size(features_count, index_node_size)
        if index_node_size
        else 0
    )
    features_start = 12 + header_size + tree_size

    def decode_blob(blob):
        feature = root(memoryview(blob))
        # Feature slots: geometry=0, properties=1, columns=2
        geom_tab = feature.table(0)
        geometry = None
        if geom_tab is not None:
            geometry = _decode_geometry(geom_tab, geometry_type)
        record = _decode_properties(feature.byte_vector(1), columns)
        return geometry, record

    geometries = []
    records = []
    fids = None
    if bbox is not None and bbox_projection is not None:
        from dask_geomodeling_tpu_torch.geo.crs import get_projection, transform_extent

        try:
            same = (
                get_projection(bbox_projection).upper()
                == get_projection(crs).upper()
            )
        except Exception:
            same = False
        if not same:
            bbox = transform_extent(bbox, bbox_projection, crs)
    try:
        if bbox is not None and index_node_size and features_count:
            # seek-based random access: only the tree region and the hit
            # features' byte ranges are read from disk
            tree = stream.read(tree_size)
            fids = []
            for fid, offset in _search_packed_rtree(
                tree, 0, features_count, index_node_size, bbox
            ):
                stream.seek(features_start + offset)
                (size,) = struct.unpack("<I", stream.read(4))
                geometry, record = decode_blob(stream.read(size))
                geometries.append(geometry)
                records.append(record)
                fids.append(fid)
        else:
            stream.seek(features_start)
            while True:
                size_bytes = stream.read(4)
                if len(size_bytes) < 4:
                    break
                (size,) = struct.unpack("<I", size_bytes)
                geometry, record = decode_blob(stream.read(size))
                geometries.append(geometry)
                records.append(record)
    finally:
        stream.close()

    frame = _frame_of_records(records, geometries, crs)
    if fids is not None and len(frame):
        frame.index = Index(np.asarray(fids, dtype=np.int64))
    return frame


# --- writing ---


def _column_type_of(values):
    """The column type the JAX writer gives a pandas column of the same
    data: by dtype for bool, integer and float columns, else by the first
    value that is not missing."""
    kind = values.dtype.kind
    if kind == "b":
        return _CT_BOOL
    if kind == "i":
        return _CT_LONG if values.dtype.itemsize > 4 else _CT_INT
    if kind == "u":
        return _CT_ULONG
    if kind == "f":
        return _CT_DOUBLE
    sample = next(
        (
            v
            for v in values
            if v is not None
            and not (isinstance(v, float) and math.isnan(v))
        ),
        None,
    )
    if isinstance(sample, bool):
        return _CT_BOOL
    if isinstance(sample, (int, np.integer)):
        return _CT_LONG
    if isinstance(sample, (float, np.floating)):
        return _CT_DOUBLE
    if isinstance(sample, (list, dict)):
        return _CT_JSON
    if isinstance(sample, bytes):
        return _CT_BINARY
    return _CT_STRING


def _encode_properties(record, column_order, column_types):
    out = bytearray()
    for idx, name in enumerate(column_order):
        value = record.get(name)
        if value is None or (
            isinstance(value, float) and math.isnan(value)
        ):
            continue
        ctype = column_types[idx]
        out += struct.pack("<H", idx)
        if ctype in _FIXED_FMT:
            if ctype == _CT_BOOL:
                value = int(bool(value))
            elif ctype in (_CT_INT, _CT_LONG, _CT_ULONG):
                value = int(value)
            else:
                value = float(value)
            out += struct.pack(_FIXED_FMT[ctype], value)
        else:
            if ctype == _CT_JSON:
                data = json.dumps(value).encode("utf-8")
            elif ctype == _CT_BINARY:
                data = bytes(value)
            else:
                data = str(value).encode("utf-8")
            out += struct.pack("<I", len(data)) + data
    return bytes(out)


def _geometry_arrays(geom):
    """(geometry_type, xy list, ends list, parts) for one geometry."""
    gt = _GT_BY_NAME.get(geom.geom_type)
    if gt is None:
        raise NotImplementedError(
            "FlatGeobuf cannot encode %s" % geom.geom_type
        )
    if gt == _GT_POINT:
        return gt, [geom.x, geom.y], None, None
    if gt == _GT_MULTIPOINT:
        xy = []
        for part in geom.geoms:
            xy += [part.x, part.y]
        return gt, xy, None, None
    if gt == _GT_LINESTRING:
        xy = []
        for x, y in geom.coords:
            xy += [x, y]
        return gt, xy, None, None
    if gt == _GT_MULTILINESTRING:
        xy = []
        ends = []
        for part in geom.geoms:
            for x, y in part.coords:
                xy += [x, y]
            ends.append(len(xy) // 2)
        return gt, xy, ends, None
    if gt == _GT_POLYGON:
        xy = []
        ends = []
        rings = [geom.exterior] + list(geom.interiors)
        for ring in rings:
            for x, y in ring.coords:
                xy += [x, y]
            ends.append(len(xy) // 2)
        if len(ends) == 1:
            ends = None  # single ring: ends may be omitted
        return gt, xy, ends, None
    # MultiPolygon: child part tables
    parts = [_geometry_arrays(p) for p in geom.geoms]
    return gt, None, None, parts


def _build_geometry(builder, arrays):
    gt, xy, ends, parts = arrays
    part_offsets = None
    if parts is not None:
        part_offsets = [_build_geometry(builder, p) for p in parts]

    xy_off = ends_off = parts_off = None
    if xy is not None:
        xy_off = builder.CreateNumpyVector(np.asarray(xy, dtype="<f8"))
    if ends is not None:
        ends_off = builder.CreateNumpyVector(np.asarray(ends, dtype="<u4"))
    if part_offsets is not None:
        builder.StartVector(4, len(part_offsets), 4)
        for off in reversed(part_offsets):
            builder.PrependUOffsetTRelative(off)
        parts_off = builder.EndVector()

    builder.StartObject(8)
    if ends_off is not None:
        builder.PrependUOffsetTRelativeSlot(0, ends_off, 0)
    if xy_off is not None:
        builder.PrependUOffsetTRelativeSlot(1, xy_off, 0)
    builder.PrependUint8Slot(6, gt, 0)
    if parts_off is not None:
        builder.PrependUOffsetTRelativeSlot(7, parts_off, 0)
    return builder.EndObject()


def write_flatgeobuf(frame, path, name="layer", index_node_size=16):
    """Write a GeoDataFrame as FlatGeobuf.

    With ``index_node_size`` > 0 (16 default, the spec's default) the
    features are Hilbert-sorted and a packed R-tree spatial index is
    written, enabling bbox-limited reads here and in other readers
    (GDAL/QGIS); 0 writes an unindexed file in frame order."""
    from dask_geomodeling_tpu_torch.geo.crs import get_sr

    column_order = [c for c in frame.columns if c != "geometry"]
    column_types = [_column_type_of(frame[c].values) for c in column_order]
    geometries = list(frame.geometry)
    geometry_types = {
        g.geom_type for g in geometries if g is not None
    }
    header_gt = (
        _GT_BY_NAME[next(iter(geometry_types))]
        if len(geometry_types) == 1
        else _GT_UNKNOWN
    )

    # header
    builder = Builder(1024)
    name_off = builder.CreateString(name)
    column_offs = []
    for cname, ctype in zip(column_order, column_types):
        cname_off = builder.CreateString(cname)
        builder.StartObject(11)
        builder.PrependUOffsetTRelativeSlot(0, cname_off, 0)
        builder.PrependUint8Slot(1, ctype, 0)
        # nullable defaults true in the spec; leave remaining slots default
        column_offs.append(builder.EndObject())
    builder.StartVector(4, len(column_offs), 4)
    for off in reversed(column_offs):
        builder.PrependUOffsetTRelative(off)
    columns_off = builder.EndVector()

    crs_off = None
    crs = getattr(frame, "crs", None)
    if crs:
        try:
            code = get_sr(crs).code
        except Exception:
            code = None
        # written before the table in either case, as the JAX writer does
        org_off = builder.CreateString("EPSG")
        wkt_off = None
        if not code:
            # emit real WKT1 for the wkt slot so spec-conformant readers
            # (GDAL importFromWkt) can parse it; fall back to the raw
            # string only when the CRS cannot be exported
            try:
                wkt_text = get_sr(crs).ExportToWkt()
            except Exception:
                wkt_text = str(crs)
            wkt_off = builder.CreateString(wkt_text)
        builder.StartObject(6)
        if code:
            builder.PrependUOffsetTRelativeSlot(0, org_off, 0)
            builder.PrependInt32Slot(1, int(code), 0)
        else:
            # no EPSG mapping: pass the CRS text through the wkt slot
            builder.PrependUOffsetTRelativeSlot(4, wkt_off, 0)
        crs_off = builder.EndObject()

    # encode every feature first: the index needs sizes and bboxes
    records = ([cells for _, cells in frame.iterrows()] if column_order
               else [{} for _ in geometries])
    blobs = []
    boxes = []
    for geom, record in zip(geometries, records):
        fb = Builder(1024)
        props = _encode_properties(record, column_order, column_types)
        props_off = fb.CreateByteVector(props) if props else None
        geom_off = (
            _build_geometry(fb, _geometry_arrays(geom))
            if geom is not None
            else None
        )
        fb.StartObject(3)
        if geom_off is not None:
            fb.PrependUOffsetTRelativeSlot(0, geom_off, 0)
        if props_off is not None:
            fb.PrependUOffsetTRelativeSlot(1, props_off, 0)
        feature = fb.EndObject()
        fb.Finish(feature)
        blobs.append(bytes(fb.Output()))
        boxes.append(tuple(geom.bounds) if geom is not None else ())

    # null/empty geometries have no envelope to index: write those
    # frames unindexed in frame order (OGR's FlatGeobuf driver errors
    # on this combination; degrading keeps them writable)
    indexed = (
        bool(index_node_size)
        and len(blobs) > 0
        and all(len(b) == 4 for b in boxes)
    )
    if indexed:
        # Hilbert-sort by bbox center over the dataset extent (the
        # packing order the spec prescribes for locality)
        box_arr = np.asarray(boxes, dtype=float)
        cx = (box_arr[:, 0] + box_arr[:, 2]) / 2.0
        cy = (box_arr[:, 1] + box_arr[:, 3]) / 2.0
        ext_w = max(float(cx.max() - cx.min()), 1e-300)
        ext_h = max(float(cy.max() - cy.min()), 1e-300)
        grid = (1 << 16) - 1
        order = np.argsort(
            _hilbert_codes(
                np.floor((cx - cx.min()) / ext_w * grid),
                np.floor((cy - cy.min()) / ext_h * grid),
            ),
            kind="stable",
        )
        blobs = [blobs[i] for i in order]
        boxes = [boxes[i] for i in order]
        offsets = []
        pos = 0
        for blob in blobs:
            offsets.append(pos)
            pos += 4 + len(blob)
        tree = _build_packed_rtree(
            [boxes[i] + (offsets[i],) for i in range(len(blobs))],
            index_node_size,
        )

    envelope_off = None
    full_boxes = [b for b in boxes if len(b) == 4]
    if full_boxes:
        box_arr = np.asarray(full_boxes, dtype=float)
        builder.StartVector(8, 4, 8)
        for v in reversed([
            float(box_arr[:, 0].min()), float(box_arr[:, 1].min()),
            float(box_arr[:, 2].max()), float(box_arr[:, 3].max()),
        ]):
            builder.PrependFloat64(v)
        envelope_off = builder.EndVector()

    builder.StartObject(14)
    builder.PrependUOffsetTRelativeSlot(0, name_off, 0)
    if envelope_off is not None:
        builder.PrependUOffsetTRelativeSlot(1, envelope_off, 0)
    builder.PrependUint8Slot(2, header_gt, 0)
    builder.PrependUOffsetTRelativeSlot(7, columns_off, 0)
    builder.PrependUint64Slot(8, len(geometries), 0)
    builder.PrependUint16Slot(9, index_node_size if indexed else 0, 16)
    if crs_off is not None:
        builder.PrependUOffsetTRelativeSlot(10, crs_off, 0)
    header = builder.EndObject()
    builder.Finish(header)
    header_bytes = bytes(builder.Output())

    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(header_bytes)))
        f.write(header_bytes)
        if indexed:
            f.write(tree)
        for body in blobs:
            f.write(struct.pack("<I", len(body)))
            f.write(body)
