"""GDAL PAM raster attribute tables (RAT).

Counterpart of dask_geomodeling_tpu/io/pam.py, copied: the same tables,
the JAX writer's sidecar bytes and the same errors.

A raster attribute table maps pixel values of a thematic raster to
attribute rows (class names, colors, statistics).  The table is a GDAL
dataset property (``band.GetDefaultRAT()``), so this module covers the
interop surface: the ``.aux.xml`` PAM sidecar where GDAL serializes RATs
for every driver without a native table container, read AND write, plus
a bridge that turns a table into the ``data`` argument of
:class:`~dask_geomodeling_tpu_torch.raster.misc.Reclassify` so the
semantics (value -> class) are usable in views.

A table is represented as a plain dict::

    {"fields": [{"name": str, "type": "int"|"float"|"string",
                 "usage": str}, ...],
     "rows": [[v0, v1, ...], ...]}

Field usages follow GDAL's GFU_* enum names ("generic", "pixelcount",
"name", "min", "max", "minmax", ...).
"""
import os
import xml.etree.ElementTree as ET

__all__ = [
    "read_raster_attribute_table",
    "write_raster_attribute_table",
    "rat_as_reclassify_data",
]

# GDALRATFieldType / GDALRATFieldUsage (gdal_rat.h)
_FIELD_TYPES = {0: "int", 1: "float", 2: "string"}
_FIELD_TYPE_CODES = {v: k for k, v in _FIELD_TYPES.items()}
_FIELD_USAGES = {
    0: "generic",
    1: "pixelcount",
    2: "name",
    3: "min",
    4: "max",
    5: "minmax",
    6: "red",
    7: "green",
    8: "blue",
    9: "alpha",
    10: "redmin",
    11: "greenmin",
    12: "bluemin",
    13: "alphamin",
    14: "redmax",
    15: "greenmax",
    16: "bluemax",
    17: "alphamax",
}
_FIELD_USAGE_CODES = {v: k for k, v in _FIELD_USAGES.items()}

_CASTS = {"int": int, "float": float, "string": str}


def _sidecar(path):
    return path + ".aux.xml"


def _band_element(root, band):
    for elem in root.iter("PAMRasterBand"):
        if elem.get("band", "1") == str(band):
            return elem
    return None


def read_raster_attribute_table(path, band=1):
    """The raster attribute table of ``path``'s PAM sidecar, or None.

    ``path`` is the raster file itself; the table is read from
    ``<path>.aux.xml`` (the sidecar ``gdaladdo``/``gdal_edit``-style
    tools and QGIS write).  Unparseable sidecars return None — a RAT
    is auxiliary metadata and must never block opening the raster.
    """
    sidecar = _sidecar(path)
    if not os.path.exists(sidecar):
        return None
    try:
        root = ET.parse(sidecar).getroot()
    except (ET.ParseError, OSError):
        return None
    scope = _band_element(root, band)
    if scope is None:
        return None
    table = scope.find("GDALRasterAttributeTable")
    if table is None:
        return None

    fields = []
    for defn in sorted(
        table.findall("FieldDefn"), key=lambda e: int(e.get("index", "0"))
    ):
        type_code = int(defn.findtext("Type", "0"))
        usage_code = int(defn.findtext("Usage", "0"))
        fields.append(
            {
                "name": defn.findtext("Name", ""),
                "type": _FIELD_TYPES.get(type_code, "string"),
                "usage": _FIELD_USAGES.get(usage_code, "generic"),
            }
        )

    casts = [_CASTS[f["type"]] for f in fields]
    rows = []
    for row in sorted(
        table.findall("Row"), key=lambda e: int(e.get("index", "0"))
    ):
        values = [cell.text or "" for cell in row.findall("F")]
        if len(values) != len(fields):
            # ragged tables are corrupt; keep the well-formed prefix
            continue
        try:
            rows.append([cast(v) for cast, v in zip(casts, values)])
        except ValueError:
            continue
    return {"fields": fields, "rows": rows}


def write_raster_attribute_table(path, rat, band=1):
    """Serialize ``rat`` into ``<path>.aux.xml``, GDAL-compatibly.

    An existing sidecar is merged into (other PAM content — SRS,
    nodata, histograms — is preserved); the band's previous table is
    replaced.
    """
    fields = rat["fields"]
    rows = rat["rows"]
    for row in rows:
        if len(row) != len(fields):
            raise ValueError(
                "RAT row %r does not match the %d declared fields"
                % (row, len(fields))
            )

    sidecar = _sidecar(path)
    root = None
    if os.path.exists(sidecar):
        try:
            root = ET.parse(sidecar).getroot()
        except (ET.ParseError, OSError):
            root = None
    if root is None:
        root = ET.Element("PAMDataset")

    scope = _band_element(root, band)
    if scope is None:
        scope = ET.SubElement(root, "PAMRasterBand")
        scope.set("band", str(band))
    old = scope.find("GDALRasterAttributeTable")
    if old is not None:
        scope.remove(old)

    table = ET.SubElement(scope, "GDALRasterAttributeTable")
    table.set("tableType", "thematic")
    for index, field in enumerate(fields):
        defn = ET.SubElement(table, "FieldDefn")
        defn.set("index", str(index))
        ET.SubElement(defn, "Name").text = field["name"]
        ET.SubElement(defn, "Type").text = str(
            _FIELD_TYPE_CODES[field["type"]]
        )
        ET.SubElement(defn, "Usage").text = str(
            _FIELD_USAGE_CODES.get(field.get("usage", "generic"), 0)
        )
    for index, row in enumerate(rows):
        elem = ET.SubElement(table, "Row")
        elem.set("index", str(index))
        for value in row:
            ET.SubElement(elem, "F").text = str(value)

    ET.indent(root)
    ET.ElementTree(root).write(
        sidecar, encoding="utf-8", xml_declaration=False
    )


def _field_index(rat, field):
    names = [f["name"] for f in rat["fields"]]
    if field in names:
        return names.index(field)
    usages = [f["usage"] for f in rat["fields"]]
    if field in usages:
        return usages.index(field)
    raise KeyError(
        "RAT has no field named or used as %r (fields: %s)"
        % (field, ", ".join(names))
    )


def rat_as_reclassify_data(rat, target, value=None):
    """``[[pixel value, target value], ...]`` pairs from a RAT, ready
    for :class:`~dask_geomodeling_tpu_torch.raster.misc.Reclassify`.

    ``target`` names the field (by name or usage) supplying the new
    values; it must be numeric.  ``value`` names the pixel-value
    field; by default the "minmax" usage column or a field named
    VALUE/Value is used.
    """
    if value is None:
        usages = [f["usage"] for f in rat["fields"]]
        names = [f["name"].lower() for f in rat["fields"]]
        if "minmax" in usages:
            value_index = usages.index("minmax")
        elif "value" in names:
            value_index = names.index("value")
        else:
            raise KeyError(
                "RAT has no minmax-usage or VALUE field; pass value="
            )
    else:
        value_index = _field_index(rat, value)
    target_index = _field_index(rat, target)
    if rat["fields"][target_index]["type"] == "string":
        raise TypeError(
            "RAT field %r is a string column; Reclassify targets must "
            "be numeric" % rat["fields"][target_index]["name"]
        )
    if rat["fields"][value_index]["type"] != "int":
        raise TypeError(
            "RAT pixel-value field %r must be an integer column"
            % rat["fields"][value_index]["name"]
        )
    return [[row[value_index], row[target_index]] for row in rat["rows"]]
