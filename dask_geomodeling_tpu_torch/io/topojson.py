"""TopoJSON vector format (.topojson): the port's copy of
dask_geomodeling_tpu/io/topojson.py on the pandas-free frame.

Reading decodes the shared-arc topology: quantized delta-encoded arcs
are expanded with the ``transform`` (scale + translate), and each
geometry stitches its (possibly reversed) arc references back into
coordinate rings.  Every named object in ``objects`` is a layer.

Writing emits a valid (non-quantized) Topology in which each ring/line
is its own arc, the same text as the JAX writer's.
"""
import json

import numpy as np

from dask_geomodeling_tpu_torch.geo.features import Index
from dask_geomodeling_tpu_torch.geo.geometry import shape

__all__ = ["read_topojson", "write_topojson"]


def _decode_arcs(topology):
    """All arcs as absolute-coordinate float arrays."""
    transform = topology.get("transform")
    arcs = []
    for arc in topology.get("arcs", []):
        points = np.asarray(arc, dtype=float) if arc else np.zeros((0, 2), dtype=float)
        if transform is not None and len(points):
            points = points.copy()
            points[:, :2] = np.cumsum(points[:, :2], axis=0)
            points[:, 0] = points[:, 0] * transform["scale"][0] + transform["translate"][0]
            points[:, 1] = points[:, 1] * transform["scale"][1] + transform["translate"][1]
        arcs.append(points[:, :2])
    return arcs


def _point_of(topology, coordinates):
    transform = topology.get("transform")
    x, y = float(coordinates[0]), float(coordinates[1])
    if transform is not None:
        x = x * transform["scale"][0] + transform["translate"][0]
        y = y * transform["scale"][1] + transform["translate"][1]
    return (x, y)


def _stitch(arc_refs, arcs):
    """One coordinate line from a list of arc indices (negative index
    ``i`` means arc ``~i`` reversed), joining at shared endpoints."""
    coordinates = []
    for ref in arc_refs:
        arc = arcs[ref] if ref >= 0 else arcs[~ref][::-1]
        points = [tuple(p) for p in arc]
        if coordinates and points and coordinates[-1] == points[0]:
            points = points[1:]
        coordinates.extend(points)
    return coordinates


def _geometry_of(topology, geometry, arcs):
    """A __geo_interface__ mapping for one TopoJSON geometry object."""
    kind = geometry["type"]
    if kind == "Point":
        return {"type": "Point", "coordinates": _point_of(topology, geometry["coordinates"])}
    if kind == "MultiPoint":
        return {"type": "MultiPoint",
                "coordinates": [_point_of(topology, c) for c in geometry["coordinates"]]}
    if kind == "LineString":
        return {"type": "LineString", "coordinates": _stitch(geometry["arcs"], arcs)}
    if kind == "MultiLineString":
        return {"type": "MultiLineString",
                "coordinates": [_stitch(refs, arcs) for refs in geometry["arcs"]]}
    if kind == "Polygon":
        return {"type": "Polygon",
                "coordinates": [_stitch(ring, arcs) for ring in geometry["arcs"]]}
    if kind == "MultiPolygon":
        return {"type": "MultiPolygon",
                "coordinates": [[_stitch(ring, arcs) for ring in polygon]
                                for polygon in geometry["arcs"]]}
    if kind == "GeometryCollection":
        return {"type": "GeometryCollection",
                "geometries": [_geometry_of(topology, g, arcs) for g in geometry["geometries"]]}
    raise NotImplementedError("TopoJSON geometry type '%s'" % kind)


def read_topojson(path, layer=None):
    """Read one object ("layer") of a TopoJSON file into a GeoDataFrame."""
    from dask_geomodeling_tpu_torch.io.vectorfile import _frame, _index_values

    with open(path) as stream:
        topology = json.load(stream)
    if topology.get("type") != "Topology":
        raise IOError("Not a TopoJSON file: '%s'" % path)
    objects = topology.get("objects", {})
    if not objects:
        raise IOError("No objects in TopoJSON file '%s'" % path)
    if layer is None:
        name = next(iter(objects))
    elif layer in objects:
        name = layer
    else:
        raise IOError("No object named '%s' in '%s'" % (layer, path))
    collection = objects[name]
    members = (collection["geometries"] if collection.get("type") == "GeometryCollection"
               else [collection])

    arcs = _decode_arcs(topology)
    geometries, records, ids = [], [], []
    declared_ids = False
    for i, member in enumerate(members):
        geometries.append(shape(_geometry_of(topology, member, arcs)))
        records.append(member.get("properties") or {})
        declared_ids = declared_ids or "id" in member
        ids.append(member.get("id", i))
    frame = _frame(records, geometries, "EPSG:4326")
    frame.index = Index(_index_values(ids), name="fid" if declared_ids else None)
    return frame


def _encode_geometry(geom, arcs):
    """TopoJSON geometry object for ``geom``; rings append to ``arcs``."""
    mapping = geom.__geo_interface__
    kind = mapping["type"]

    def add_arc(coordinates):
        arcs.append([list(point) for point in coordinates])
        return len(arcs) - 1

    if kind in ("Point", "MultiPoint"):
        return {"type": kind, "coordinates": mapping["coordinates"]}
    if kind == "LineString":
        return {"type": kind, "arcs": [add_arc(mapping["coordinates"])]}
    if kind == "MultiLineString":
        return {"type": kind, "arcs": [[add_arc(line)] for line in mapping["coordinates"]]}
    if kind == "Polygon":
        return {"type": kind, "arcs": [[add_arc(ring)] for ring in mapping["coordinates"]]}
    if kind == "MultiPolygon":
        return {"type": kind, "arcs": [[[add_arc(ring)] for ring in polygon]
                                       for polygon in mapping["coordinates"]]}
    if kind == "GeometryCollection":
        return {"type": kind, "geometries": [_encode_geometry(g, arcs) for g in geom.geoms]}
    raise NotImplementedError("Cannot write %s to TopoJSON" % kind)


def write_topojson(frame, path, layer=None):
    """Write a GeoDataFrame as a one-object TopoJSON file."""
    from dask_geomodeling_tpu_torch.io.vectorfile import _jsonify

    geometry_column = frame._geometry_column_name or "geometry"
    arcs = []
    geometries = []
    for idx, row in frame.iterrows():
        geom = row[geometry_column]
        if geom is None:
            continue
        member = _encode_geometry(geom, arcs)
        member["id"] = _jsonify(idx)
        member["properties"] = {k: _jsonify(v) for k, v in row.items() if k != geometry_column}
        geometries.append(member)
    topology = {
        "type": "Topology",
        "objects": {(layer or "layer"): {"type": "GeometryCollection",
                                         "geometries": geometries}},
        "arcs": arcs,
    }
    with open(path, "w") as f:
        json.dump(topology, f)
