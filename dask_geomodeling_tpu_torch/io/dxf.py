"""AutoCAD DXF (ASCII) entity reader and writer: the port's copy of
dask_geomodeling_tpu/io/dxf.py on the pandas-free frame.

The ENTITIES section is parsed natively: POINT, LINE, LWPOLYLINE,
classic POLYLINE/VERTEX/SEQEND, CIRCLE (densified), and 3DFACE/SOLID,
with the entity's layer name as the one attribute column (OGR's default
Layer field).  Closed polylines load as polygons, open ones as
linestrings.  DXF carries no CRS: the frame's is None, and a
GeometryFileSource takes it to be in the request's projection.
"""
import numpy as np

__all__ = ["read_dxf", "write_dxf"]


def _pairs(lines):
    """(code, value) stream from the 2-line group encoding."""
    it = iter(lines)
    for code in it:
        try:
            value = next(it)
        except StopIteration:
            return
        try:
            yield int(code.strip()), value.strip()
        except ValueError:
            continue


def _fields(entity):
    table = {}
    for code, value in entity["groups"]:
        table.setdefault(code, []).append(value)
    return table


def _closed_path(points, closed):
    from dask_geomodeling_tpu_torch.geo.geometry import LineString, Polygon

    if closed and len(points) >= 3:
        return Polygon(points + [points[0]])
    if len(points) >= 2:
        return LineString(points)
    return None


def read_dxf(path):
    """Read a DXF file's ENTITIES into a GeoDataFrame."""
    from dask_geomodeling_tpu_torch.geo.features import GeoDataFrame
    from dask_geomodeling_tpu_torch.geo.geometry import LineString, Point, Polygon

    with open(path, errors="replace") as stream:
        groups = list(_pairs(stream.read().splitlines()))

    # scope to the ENTITIES section
    start = end = None
    for k, (code, value) in enumerate(groups):
        if code == 2 and value.upper() == "ENTITIES" and start is None:
            start = k + 1
        elif code == 0 and value.upper() == "ENDSEC" and start is not None:
            end = k
            break
    if start is None:
        raise IOError("No ENTITIES section in '%s'" % path)
    groups = groups[start: end if end is not None else len(groups)]

    # split into entities at each 0 group
    entities = []
    current = None
    for code, value in groups:
        if code == 0:
            current = {"type": value.upper(), "groups": []}
            entities.append(current)
        elif current is not None:
            current["groups"].append((code, value))

    geometries = []
    layers = []
    index = 0
    while index < len(entities):
        entity = entities[index]
        table = _fields(entity)
        layer = table.get(8, ["0"])[0]
        kind = entity["type"]
        geom = None
        if kind == "POINT":
            geom = Point(float(table[10][0]), float(table[20][0]))
        elif kind == "LINE":
            geom = LineString([(float(table[10][0]), float(table[20][0])),
                               (float(table[11][0]), float(table[21][0]))])
        elif kind == "LWPOLYLINE":
            points = list(zip((float(v) for v in table.get(10, [])),
                              (float(v) for v in table.get(20, []))))
            geom = _closed_path(points, int(table.get(70, ["0"])[0]) & 1)
        elif kind == "POLYLINE":
            closed = int(table.get(70, ["0"])[0]) & 1
            points = []
            index += 1
            while index < len(entities) and entities[index]["type"] == "VERTEX":
                vt = _fields(entities[index])
                points.append((float(vt[10][0]), float(vt[20][0])))
                index += 1
            # the SEQEND terminator, when present, is consumed here
            if not (index < len(entities) and entities[index]["type"] == "SEQEND"):
                index -= 1
            geom = _closed_path(points, closed)
        elif kind == "CIRCLE":
            cx, cy = float(table[10][0]), float(table[20][0])
            r = float(table[40][0])
            theta = np.linspace(0, 2 * np.pi, 65)
            geom = Polygon([(cx + r * np.cos(t), cy + r * np.sin(t)) for t in theta])
        elif kind in ("3DFACE", "SOLID"):
            points = []
            for px, py in ((10, 20), (11, 21), (12, 22), (13, 23)):
                if px in table:
                    points.append((float(table[px][0]), float(table[py][0])))
            if kind == "SOLID" and len(points) == 4:
                # SOLID stores its 3rd/4th corners swapped
                points[2], points[3] = points[3], points[2]
            if len(points) >= 3:
                geom = Polygon(points + [points[0]])
        if geom is not None:
            geometries.append(geom)
            layers.append(layer)
        index += 1

    return GeoDataFrame({"Layer": layers}, geometry=geometries, crs=None)


def write_dxf(frame, path):
    """Write a GeoDataFrame's geometries as a minimal ASCII DXF."""
    out = ["0", "SECTION", "2", "ENTITIES"]
    layer_names = frame["Layer"].values if "Layer" in frame.columns else None

    def polyline(points, closed, layer):
        chunk = ["0", "LWPOLYLINE", "8", layer, "90", str(len(points)),
                 "70", "1" if closed else "0"]
        for x, y in points:
            chunk += ["10", "%.10g" % x, "20", "%.10g" % y]
        return chunk

    for row_index, geom in enumerate(frame.geometry):
        if geom is None:
            continue
        layer = "0" if layer_names is None else str(layer_names[row_index])
        kind = geom.geom_type
        if kind == "Point":
            out += ["0", "POINT", "8", layer, "10", "%.10g" % geom.x, "20", "%.10g" % geom.y]
        elif kind == "MultiPoint":
            for p in geom.geoms:
                out += ["0", "POINT", "8", layer, "10", "%.10g" % p.x, "20", "%.10g" % p.y]
        elif kind == "LineString":
            out += polyline(list(geom.coords), False, layer)
        elif kind == "MultiLineString":
            for part in geom.geoms:
                out += polyline(list(part.coords), False, layer)
        elif kind in ("Polygon", "MultiPolygon"):
            for poly in (geom.geoms if kind == "MultiPolygon" else [geom]):
                out += polyline(list(poly.exterior.coords)[:-1], True, layer)
                for ring in poly.interiors:
                    out += polyline(list(ring.coords)[:-1], True, layer)
        else:
            raise NotImplementedError("DXF cannot store %s" % kind)
    out += ["0", "ENDSEC", "0", "EOF"]
    with open(path, "w") as stream:
        stream.write("\n".join(out) + "\n")
