"""VRT mosaics: the port's copy of dask_geomodeling_tpu/io/vrt.py.

``build_vrt`` writes a standard VRT XML (the XML the JAX package writes)
mosaicking GeoTIFF tiles onto a common grid; ``to_file`` writes one.
``read_vrt`` and ``read_vrt_window`` read such a mosaic back, the window
read opening only the members a window touches (RasterFileSource).
"""
import os
import xml.etree.ElementTree as ET

import numpy as np

__all__ = ["build_vrt", "read_vrt", "read_vrt_window", "read_vrt_info"]

_GDAL_TYPES = {
    "u1": "Byte",
    "i1": "Int8",
    "u2": "UInt16",
    "i2": "Int16",
    "u4": "UInt32",
    "i4": "Int32",
    "f4": "Float32",
    "f8": "Float64",
}
_NUMPY_TYPES = {v: k for k, v in _GDAL_TYPES.items()}


def build_vrt(target, source_paths):
    """Write a VRT XML mosaicking the given GeoTIFF files."""
    from dask_geomodeling_tpu_torch.io.geotiff import read_geotiff_info

    if not source_paths:
        raise IOError("Cannot build a VRT from zero sources")

    infos = [read_geotiff_info(p) for p in source_paths]

    # common grid: all tiles must share resolution; origin is the envelope
    first = infos[0]
    px_w = first.geo_transform[1]
    px_h = first.geo_transform[5]
    x1 = min(i.geo_transform[0] for i in infos)
    y2 = max(i.geo_transform[3] for i in infos)
    x2 = max(i.geo_transform[0] + i.width * px_w for i in infos)
    y1 = min(i.geo_transform[3] + i.height * px_h for i in infos)
    width = int(round((x2 - x1) / px_w))
    height = int(round((y1 - y2) / px_h))

    root = ET.Element(
        "VRTDataset", rasterXSize=str(width), rasterYSize=str(height)
    )
    if first.projection:
        from dask_geomodeling_tpu_torch.geo.crs import get_sr

        ET.SubElement(root, "SRS").text = get_sr(first.projection).ExportToWkt()
    ET.SubElement(root, "GeoTransform").text = ", ".join(
        repr(v) for v in (x1, px_w, 0.0, y2, 0.0, px_h)
    )

    dtype_key = np.dtype(first.dtype).str.lstrip("<>|=")
    band = ET.SubElement(
        root, "VRTRasterBand", dataType=_GDAL_TYPES[dtype_key], band="1"
    )
    if first.no_data_value is not None:
        ET.SubElement(band, "NoDataValue").text = repr(first.no_data_value)

    for path, info in zip(source_paths, infos):
        source = ET.SubElement(band, "ComplexSource")
        ET.SubElement(
            source, "SourceFilename", relativeToVRT="0"
        ).text = os.path.abspath(path)
        ET.SubElement(source, "SourceBand").text = "1"
        ET.SubElement(
            source,
            "SrcRect",
            xOff="0",
            yOff="0",
            xSize=str(info.width),
            ySize=str(info.height),
        )
        x_off = int(round((info.geo_transform[0] - x1) / px_w))
        y_off = int(round((info.geo_transform[3] - y2) / px_h))
        ET.SubElement(
            source,
            "DstRect",
            xOff=str(x_off),
            yOff=str(y_off),
            xSize=str(info.width),
            ySize=str(info.height),
        )
        if info.no_data_value is not None:
            ET.SubElement(source, "NODATA").text = repr(info.no_data_value)

    ET.indent(root)
    ET.ElementTree(root).write(target, encoding="unicode")


def _parse_vrt(path):
    """(width, height, geo_transform, projection, dtype, nodata, band)."""
    from dask_geomodeling_tpu_torch.geo.crs import get_epsg_or_wkt

    tree = ET.parse(path)
    root = tree.getroot()
    width = int(root.get("rasterXSize"))
    height = int(root.get("rasterYSize"))
    geo_transform = tuple(
        float(v) for v in root.findtext("GeoTransform").split(",")
    )
    srs = root.findtext("SRS")
    projection = get_epsg_or_wkt(srs) if srs else None

    band = root.find("VRTRasterBand")
    dtype = np.dtype(_NUMPY_TYPES[band.get("dataType")])
    no_data_text = band.findtext("NoDataValue")
    no_data_value = float(no_data_text) if no_data_text is not None else None
    return width, height, geo_transform, projection, dtype, no_data_value, band


def read_vrt(path):
    """Read a VRT mosaic into a RasterData (materializes the full grid)."""
    width, height, *_ = _parse_vrt(path)
    return read_vrt_window(path, 0, height, 0, width)


def read_vrt_info(path):
    """Header-only info: the mosaic grid without touching any member."""
    from dask_geomodeling_tpu_torch.io.geotiff import GeoTIFFInfo

    width, height, geo_transform, projection, dtype, nodata, _ = _parse_vrt(
        path
    )
    return GeoTIFFInfo(
        width=width, height=height, bands=1, dtype=str(dtype),
        projection=projection, geo_transform=geo_transform,
        no_data_value=nodata, metadata=None,
    )


def read_vrt_window(path, row0, row1, col0, col1):
    """Read one pixel window of a VRT mosaic: only the member rasters the
    window touches are opened, and each is read through the block-level
    GeoTIFF window reader (the to_file tile-pyramid access pattern)."""
    from dask_geomodeling_tpu_torch.io.geotiff import read_geotiff_window
    from dask_geomodeling_tpu_torch.raster.sources import RasterData

    width, height, geo_transform, projection, dtype, no_data_value, band = (
        _parse_vrt(path)
    )
    row0 = max(0, min(int(row0), height - 1))
    row1 = max(row0 + 1, min(int(row1), height))
    col0 = max(0, min(int(col0), width - 1))
    col1 = max(col0 + 1, min(int(col1), width))

    fill = no_data_value if no_data_value is not None else 0
    array = np.full((1, row1 - row0, col1 - col0), fill, dtype=dtype)

    for source in band:
        if source.tag not in ("ComplexSource", "SimpleSource"):
            continue
        dst = source.find("DstRect")
        x_off = int(dst.get("xOff"))
        y_off = int(dst.get("yOff"))
        x_size = int(dst.get("xSize"))
        y_size = int(dst.get("ySize"))
        # mosaic-space overlap of this member with the window
        r0 = max(row0, y_off)
        r1 = min(row1, y_off + y_size)
        c0 = max(col0, x_off)
        c1 = min(col1, x_off + x_size)
        if r1 <= r0 or c1 <= c0:
            continue  # untouched member: never opened
        src = source.find("SrcRect")
        src_y = int(src.get("yOff")) if src is not None else 0
        src_x = int(src.get("xOff")) if src is not None else 0
        tile = read_geotiff_window(
            source.findtext("SourceFilename"),
            src_y + r0 - y_off, src_y + r1 - y_off,
            src_x + c0 - x_off, src_x + c1 - x_off,
        )
        array[
            0, r0 - row0 : r1 - row0, c0 - col0 : c1 - col0
        ] = tile.array[0]

    gt = geo_transform
    return RasterData(
        array=array,
        projection=projection,
        geo_transform=(
            gt[0] + col0 * gt[1], gt[1], gt[2],
            gt[3] + row0 * gt[5], gt[4], gt[5],
        ),
        no_data_value=no_data_value,
        metadata=None,
    )
