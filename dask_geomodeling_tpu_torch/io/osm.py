"""OpenStreetMap XML (``.osm``) vector reads: the port's copy of
dask_geomodeling_tpu/io/osm.py on the pandas-free frame.

GDAL's OSM driver's layer model:

- ``points`` — tagged nodes
- ``lines`` — open ways (and closed ways that are not areas)
- ``multipolygons`` — closed ways whose tags mark an area (the
  osmconf.ini ``closed_ways_are_polygons`` key list) and
  ``type=multipolygon``/``boundary`` relations with their member ways
  stitched into outer/inner rings

Coordinates are always EPSG:4326.  Each feature carries ``osm_id`` plus
its tags as columns; ``read_osm(path)`` with no layer concatenates the
layers with a ``layer`` column.  There is no writer.
"""
import xml.etree.ElementTree as ET

from dask_geomodeling_tpu_torch.geo.geometry import shape

__all__ = ["read_osm"]

_LAYERS = ("points", "lines", "multipolygons")

#: tag keys whose presence makes a closed way an area (GDAL osmconf.ini)
_AREA_KEYS = {
    "area", "aeroway", "amenity", "boundary", "building", "craft",
    "geological", "historic", "landuse", "leisure", "military", "natural",
    "office", "place", "shop", "sport", "tourism",
}


def _tags(element):
    return {tag.get("k"): tag.get("v") for tag in element.findall("tag") if tag.get("k")}


def _is_area(tags, closed):
    if not closed:
        return False
    if tags.get("area") == "no":
        return False
    return any(key in tags for key in _AREA_KEYS)


def _stitch_rings(chains):
    """Join way node-chains into closed rings by matching endpoints."""
    chains = [list(chain) for chain in chains if len(chain) >= 2]
    rings = []
    while chains:
        ring = chains.pop(0)
        progressed = True
        while ring[0] != ring[-1] and progressed:
            progressed = False
            for index, chain in enumerate(chains):
                if chain[0] == ring[-1]:
                    ring += chain[1:]
                elif chain[-1] == ring[-1]:
                    ring += chain[-2::-1]
                elif chain[-1] == ring[0]:
                    ring = chain[:-1] + ring
                elif chain[0] == ring[0]:
                    ring = chain[::-1][:-1] + ring
                else:
                    continue
                chains.pop(index)
                progressed = True
                break
        if ring[0] == ring[-1] and len(ring) >= 4:
            rings.append(ring)
    return rings


def read_osm(path, layer=None):
    """Read an OSM XML extract into a GeoDataFrame."""
    from dask_geomodeling_tpu_torch.io.vectorfile import _frame

    if layer is not None and layer not in _LAYERS:
        raise ValueError("Unknown OSM layer '{}' (expected one of {})".format(layer, _LAYERS))
    root = ET.parse(path).getroot()
    if root.tag != "osm":
        raise ValueError("not an OSM XML document: %s" % path)

    nodes = {}  # id -> (lon, lat)
    node_tags = {}
    ways = {}  # id -> [node ids]
    way_tags = {}
    for element in root:
        if element.tag == "node":
            node_id = element.get("id")
            nodes[node_id] = (float(element.get("lon")), float(element.get("lat")))
            tags = _tags(element)
            if tags:
                node_tags[node_id] = tags
        elif element.tag == "way":
            way_id = element.get("id")
            ways[way_id] = [nd.get("ref") for nd in element.findall("nd") if nd.get("ref")]
            way_tags[way_id] = _tags(element)

    def want(name):
        return layer is None or layer == name

    geometries, records = [], []

    def coords(refs):
        return [nodes[r] for r in refs if r in nodes]

    if want("points"):
        for node_id, tags in node_tags.items():
            geometries.append(shape({"type": "Point", "coordinates": nodes[node_id]}))
            records.append({"layer": "points", "osm_id": node_id, **tags})

    relation_way_ids = set()
    relations = []
    for element in root:
        if element.tag != "relation":
            continue
        tags = _tags(element)
        if tags.get("type") not in ("multipolygon", "boundary"):
            continue
        members = [(member.get("ref"), member.get("role") or "outer")
                   for member in element.findall("member")
                   if member.get("type") == "way" and member.get("ref") in ways]
        if not members:
            continue
        relations.append((element.get("id"), tags, members))
        relation_way_ids.update(ref for ref, _ in members)

    if want("lines"):
        for way_id, refs in ways.items():
            tags = way_tags[way_id]
            pts = coords(refs)
            if len(pts) < 2:
                continue
            closed = pts[0] == pts[-1]
            if _is_area(tags, closed) or (not tags and way_id in relation_way_ids):
                continue  # areas and bare relation members are not lines
            geometries.append(shape({"type": "LineString", "coordinates": pts}))
            records.append({"layer": "lines", "osm_id": way_id, **tags})

    if want("multipolygons"):
        for way_id, refs in ways.items():
            tags = way_tags[way_id]
            pts = coords(refs)
            if len(pts) < 4 or pts[0] != pts[-1]:
                continue
            if not _is_area(tags, True):
                continue
            geometries.append(shape({"type": "Polygon", "coordinates": [pts]}))
            records.append({"layer": "multipolygons", "osm_id": way_id, **tags})
        for relation_id, tags, members in relations:
            outers = _stitch_rings([coords(ways[ref]) for ref, role in members
                                    if role in ("outer", "")])
            inners = _stitch_rings([coords(ways[ref]) for ref, role in members
                                    if role == "inner"])
            if not outers:
                continue
            polygons = [[outer] for outer in outers]
            for inner in inners:
                # attach each hole to the first outer that contains its
                # first vertex (adequate for well-formed OSM data)
                target = 0
                for index, outer in enumerate(outers):
                    if _point_in_ring(inner[0], outer):
                        target = index
                        break
                polygons[target].append(inner)
            geometry = ({"type": "Polygon", "coordinates": polygons[0]} if len(polygons) == 1
                        else {"type": "MultiPolygon", "coordinates": polygons})
            geometries.append(shape(geometry))
            records.append({"layer": "multipolygons", "osm_id": relation_id, **tags})

    if layer is not None:
        # one layer: no layer column (a ``layer`` tag goes with it, as it
        # does in the JAX package's ``drop(columns=["layer"])``)
        for record in records:
            record.pop("layer", None)
    return _frame(records, geometries, "EPSG:4326")


def _point_in_ring(point, ring):
    """Even-odd crossing test."""
    x, y = point
    inside = False
    for (x1, y1), (x2, y2) in zip(ring, ring[1:]):
        if (y1 > y) != (y2 > y):
            t = (y - y1) / (y2 - y1)
            if x < x1 + t * (x2 - x1):
                inside = not inside
    return inside
