"""WMS tile serving and the ipyleaflet notebook integration.

Counterpart of dask_geomodeling_tpu/ipyleaflet_plugin.py.  Every request
names a registered layer or carries the view JSON; the view is evaluated
for one tile through ``get_data`` on ``geomodeling.torch-device`` (the
card unless the caller configured ``cpu``; a device error propagates, and
the WSGI server answers it with a 500) and rendered on the host.

- :func:`render_wms_tile`: the framework-agnostic core (parse params,
  overload guard, evaluate, colour map, PNG bytes);
- :func:`wms_app`: a WSGI application usable under any server
  (``python -m dask_geomodeling_tpu_torch.wms_serve`` runs it);
- ``GeomodelingWMSHandler`` / ``GeomodelingLayer``: the Tornado handler
  and the ipyleaflet layer, defined only where those packages are.

The render needs neither matplotlib nor Pillow: the colour maps are the
port's own tables (render/colormaps.py), the PNG writer is io/png.py's,
the JPEG encoder the port's native codec (native/jpegcodec.cpp, the bytes
Pillow writes at its defaults) and the WebP encoder its lossless one
(native/webpcodec.cpp).  The one answer whose pixels differ from the JAX
package's: ``image/webp``, which the JAX package writes with Pillow's
default save (lossy, quality 80) and the port losslessly, the image/png
answer's pixels.
"""
import threading
from datetime import datetime
from urllib.parse import parse_qs, urljoin
from xml.sax.saxutils import escape, quoteattr

import numpy as np

from dask_geomodeling_tpu_torch.core import Block

__all__ = [
    "render_wms_tile", "render_coverage", "render_feature_info",
    "render_legend_graphic", "tile_values", "encode_tile",
    "wms_app", "register_layer",
    "unregister_layers",
    "get_capabilities_xml",
]

_LAYER_LOCK = threading.Lock()
_LAYERS = {}  # name -> Block


def register_layer(name, block):
    """Register a named layer served by :func:`wms_app`.

    Standard WMS clients (QGIS, Leaflet) pick layers from
    GetCapabilities by NAME; this registry maps those names to views.
    Raw view JSON in the ``layers`` parameter keeps working (the
    reference's ship-the-view pattern)."""
    with _LAYER_LOCK:
        _LAYERS[str(name)] = block


def unregister_layers():
    """Drop all registered layers (tests; service reconfiguration)."""
    with _LAYER_LOCK:
        _LAYERS.clear()


def _layer_block(text):
    """A Block from the layers parameter: a registered name, else JSON.

    The JSON fallback is gated by ``geomodeling.wms-json-layers``: a
    production server with named layers must not let clients construct
    arbitrary views (file sources read any path the process can)."""
    from dask_geomodeling_tpu_torch.config import config

    with _LAYER_LOCK:
        block = _LAYERS.get(text)
    if block is not None:
        return block
    if not config.get("geomodeling.wms-json-layers", True):
        raise ValueError(
            "unknown layer name %r (raw view JSON is disabled on this "
            "server; use a registered layer from GetCapabilities)" % text[:80]
        )
    return Block.from_json(text)


def get_capabilities_xml(base_url="http://localhost/wms"):
    """A minimal WMS 1.1.1 GetCapabilities document listing the
    registered layers with their WGS84 bounding boxes (of the layer's
    ``geometry``)."""
    from dask_geomodeling_tpu_torch.geo.crs import transform_extent

    entries = []
    with _LAYER_LOCK:
        layers = dict(_LAYERS)
    for name, block in layers.items():
        bbox = ""
        try:
            extent = block.geometry.bounds
            projection = block.projection
            if projection and extent:
                w, s, e, n = transform_extent(
                    extent, projection, "EPSG:4326"
                )
                bbox = (
                    '<LatLonBoundingBox minx="%.9g" miny="%.9g" '
                    'maxx="%.9g" maxy="%.9g"/>' % (w, s, e, n)
                )
        except Exception:
            pass
        entries.append(
            "<Layer queryable=\"0\"><Name>%s</Name><Title>%s</Title>"
            "<SRS>EPSG:4326</SRS><SRS>EPSG:3857</SRS>%s</Layer>"
            % (escape(str(name)), escape(str(name)), bbox)
        )
    return (
        '<?xml version="1.0" encoding="UTF-8"?>'
        '<WMT_MS_Capabilities version="1.1.1">'
        "<Service><Name>OGC:WMS</Name>"
        "<Title>dask_geomodeling_tpu</Title>"
        '<OnlineResource xmlns:xlink="http://www.w3.org/1999/xlink" '
        "xlink:href=%s/></Service>"
        "<Capability><Request><GetCapabilities>"
        "<Format>application/vnd.ogc.wms_xml</Format>"
        "</GetCapabilities><GetMap><Format>image/png</Format>"
        "<Format>image/jpeg</Format><Format>image/webp</Format>"
        "</GetMap><GetFeatureInfo><Format>application/json</Format>"
        "<Format>text/plain</Format></GetFeatureInfo></Request>"
        "<Layer><Title>dask_geomodeling_tpu</Title>%s</Layer>"
        "</Capability></WMT_MS_Capabilities>"
        % (quoteattr(str(base_url)), "".join(entries))
    )


class WMSError(Exception):
    """A WMS client error carrying an HTTP status code and message."""
    def __init__(self, status, message):
        self.status = status
        self.message = message
        super().__init__(message)


#: the WMS FORMAT= values the port writes
_IMAGE_FORMATS = ("image/jpeg", "image/png", "image/webp")


def _masked(values, no_data_value):
    """``np.ma.masked_equal(values, no_data_value)``.  A nodata value the
    dtype cannot hold (HillShade's 256 on uint8) matches no cell: the JAX
    render's device route masks nothing there (its host route raises)."""
    try:
        return np.ma.masked_equal(values, no_data_value)
    except TypeError:
        return np.ma.masked_array(values, mask=np.zeros(values.shape, bool))


def _geographic(srs):
    """Whether a WMS 1.3 bbox in ``srs`` comes lat/lon ordered: EPSG
    geodetic codes do; CRS:84 / OGC:CRS84 are defined lon/lat."""
    from dask_geomodeling_tpu_torch.geo.crs import get_sr

    if "CRS84" in srs.upper().replace(":", ""):
        return False
    try:
        return get_sr(srs).is_geographic
    except Exception:
        return False


def render_wms_tile(params):
    """Render one WMS GetMap request; returns PNG, JPEG or WebP bytes.

    ``params`` is a flat dict of query parameters (strings):
    layers (view JSON), styles (a matplotlib colormap name), vmin, vmax,
    format, srs, bbox, width, height, maxcellsize, time (ISO or empty).

    Raises WMSError for client errors.
    """
    try:
        block = _layer_block(params["layers"])
    except Exception as e:
        raise WMSError(400, "Invalid 'layers' parameter: {}".format(e))
    style = params.get("styles") or "viridis"  # clients send STYLES=
    vmin = float(params.get("vmin") or 0.0)
    vmax = float(params.get("vmax") or 1.0)
    img_format = (params.get("format") or "image/png").lower()
    if img_format not in _IMAGE_FORMATS:
        raise WMSError(
            400,
            "Unsupported format %r (supported: %s)"
            % (img_format, ", ".join(_IMAGE_FORMATS)),
        )
    # WMS TRANSPARENT/BGCOLOR: nodata stays transparent unless the client
    # says TRANSPARENT=FALSE
    transparent = (params.get("transparent") or "true").lower() != "false"
    try:
        bgcolor = int((params.get("bgcolor") or "0xFFFFFF").replace(
            "0x", ""
        ), 16)
    except ValueError:
        raise WMSError(400, "Invalid BGCOLOR (expected 0xRRGGBB)")
    # WMS 1.1 sends SRS=, 1.3 sends CRS= (and flips the bbox axis order
    # for geographic CRSes to lat/lon)
    srs = params.get("srs") or params.get("crs")
    if not srs:
        raise WMSError(400, "Missing SRS/CRS parameter")
    height = int(params["height"])
    width = int(params["width"])
    max_cell_size = float(params.get("maxcellsize") or 10.0)
    time_isoformat = params.get("time", "")
    if time_isoformat:
        time = datetime.strptime(time_isoformat, "%Y-%m-%dT%H:%M:%S.%fZ")
    else:
        time = None
    bbox = [float(x) for x in params["bbox"].split(",")]
    if params.get("version", "").startswith("1.3") and _geographic(srs):
        bbox = [bbox[1], bbox[0], bbox[3], bbox[2]]

    # overload protection (reference ipyleaflet_plugin.py:48-53)
    cell_size_x = (bbox[2] - bbox[0]) / width
    cell_size_y = (bbox[3] - bbox[1]) / height
    if cell_size_x > max_cell_size or cell_size_y > max_cell_size:
        raise WMSError(400, "Too large area requested")

    data = block.get_data(
        mode="vals",
        bbox=tuple(bbox),
        height=height,
        width=width,
        projection=srs,
        start=time,
    )
    return encode_tile(tile_values(data, height, width), style, vmin, vmax, transparent, bgcolor,
                       img_format)


def tile_values(data, height, width):
    """The masked (height, width) array a GetMap tile colours: the first
    band of a ``get_data`` answer with its nodata masked, or all masked
    for None."""
    if data is None:
        return np.ma.masked_all((height, width))
    return _masked(data["values"][0], data["no_data_value"])


def encode_tile(values, style, vmin, vmax, transparent=True, bgcolor=0xFFFFFF,
                img_format="image/png"):
    """The PNG (or JPEG, or lossless WebP) of a masked (height, width)
    array: normalized to [vmin, vmax], coloured by the map ``style``,
    masked cells transparent (or, with ``transparent`` False, everything
    composited on ``bgcolor``; JPEG has no alpha, so it always composites)."""
    from dask_geomodeling_tpu_torch.io.png import write_png_bytes
    from dask_geomodeling_tpu_torch.render import colormaps

    normalized = colormaps.normalize(values, vmin, vmax)
    try:
        img_uint8 = colormaps.apply(style, normalized)
    except KeyError:
        raise WMSError(400, "Unknown style (colormap): %r" % style)
    img_uint8[np.ma.getmaskarray(normalized), 3] = 0  # nodata is transparent

    jpeg = img_format == "image/jpeg"
    if jpeg or not transparent:
        background = np.array(
            [(bgcolor >> 16) & 0xFF, (bgcolor >> 8) & 0xFF, bgcolor & 0xFF],
            dtype=np.float32,
        )
        alpha = img_uint8[..., 3:4].astype(np.float32) / 255.0
        img_uint8 = np.rint(
            alpha * img_uint8[..., :3].astype(np.float32)
            + (1.0 - alpha) * background
        ).astype(np.uint8)

    if jpeg:
        from dask_geomodeling_tpu_torch.native import jpeg_encode_native

        return jpeg_encode_native(img_uint8)
    if img_format == "image/webp":
        from dask_geomodeling_tpu_torch.native import webp_encode_native

        return webp_encode_native(img_uint8)
    return write_png_bytes(img_uint8.transpose(2, 0, 1))


def render_feature_info(params):
    """Answer a WMS GetFeatureInfo request; returns JSON bytes.

    The "identify" click of desktop clients: resolve the pixel at
    ``I``/``J`` (WMS 1.3; ``X``/``Y`` in 1.1) inside the GetMap grid,
    evaluate the view for just that cell, and report its value
    (``null`` for nodata).  ``query_layers`` falls back to ``layers``;
    ``info_format`` supports application/json (default) and text/plain.
    """
    import json

    try:
        block = _layer_block(
            params.get("query_layers") or params["layers"]
        )
    except Exception as e:
        raise WMSError(400, "Invalid query_layers parameter: {}".format(e))
    srs = params.get("srs") or params.get("crs")
    if not srs:
        raise WMSError(400, "Missing SRS/CRS parameter")
    info_format = (params.get("info_format") or "application/json").lower()
    if info_format not in ("application/json", "text/plain"):
        raise WMSError(400, "Unsupported info_format %r" % info_format)
    height = int(params["height"])
    width = int(params["width"])
    # WMS 1.3 names the pixel I/J; 1.1 used X/Y
    col_text = params.get("i", params.get("x"))
    row_text = params.get("j", params.get("y"))
    if col_text is None or row_text is None:
        raise WMSError(400, "Missing pixel coordinates (I/J or X/Y)")
    col, row = int(col_text), int(row_text)
    if not (0 <= col < width and 0 <= row < height):
        raise WMSError(400, "Pixel coordinates outside the map")
    time_isoformat = params.get("time", "")
    time = (
        datetime.strptime(time_isoformat, "%Y-%m-%dT%H:%M:%S.%fZ")
        if time_isoformat
        else None
    )
    bbox = [float(x) for x in params["bbox"].split(",")]
    if params.get("version", "").startswith("1.3") and _geographic(srs):
        bbox = [bbox[1], bbox[0], bbox[3], bbox[2]]

    cell_x = (bbox[2] - bbox[0]) / width
    cell_y = (bbox[3] - bbox[1]) / height
    x = bbox[0] + (col + 0.5) * cell_x
    y = bbox[3] - (row + 0.5) * cell_y
    data = block.get_data(
        mode="vals",
        bbox=(x, y, x, y),
        height=1,
        width=1,
        projection=srs,
        start=time,
    )
    value = None
    if data is not None:
        raw = data["values"][0, 0, 0]
        nodata = data["no_data_value"]
        # NaN sentinels need isnan equality (NaN != NaN is always true);
        # a non-finite data value itself also maps to null — strict JSON
        # has no NaN/Infinity literal
        is_nodata = nodata is not None and (
            raw == nodata
            or (
                isinstance(raw, np.floating)
                and np.isnan(raw)
                and np.isnan(nodata)
            )
        )
        if not is_nodata:
            value = raw.item()
            if isinstance(value, float) and not np.isfinite(value):
                value = None
    payload = {"x": x, "y": y, "crs": srs, "value": value}
    if info_format == "text/plain":
        return ("value: %s\n" % ("" if value is None else value)).encode()
    return json.dumps(payload, allow_nan=False).encode()


def render_legend_graphic(params):
    """Render a WMS GetLegendGraphic request; returns PNG bytes.

    A vertical colorbar for the layer's style: the colormap from
    ``styles``/``style`` with the ``vmin``..``vmax`` range annotated at
    the ends.  ``width``/``height`` default to 24x160 (the compact strip
    QGIS embeds in its layer tree)."""
    from dask_geomodeling_tpu_torch.io.png import write_png_bytes
    from dask_geomodeling_tpu_torch.render import colormaps

    style = params.get("styles") or params.get("style") or "viridis"
    try:
        colormaps.lookup_table(style)
    except KeyError:
        raise WMSError(400, "Unknown style (colormap): %r" % style)
    width = int(params.get("width") or 24)
    height = int(params.get("height") or 160)
    if not (0 < width <= 1024 and 0 < height <= 1024):
        raise WMSError(400, "Legend size out of range")
    ramp = np.linspace(1.0, 0.0, height)[:, None].repeat(width, axis=1)
    return write_png_bytes(colormaps.apply(style, ramp).transpose(2, 0, 1))


def render_coverage(params):
    """Render one WCS-style GetCoverage request; returns GeoTIFF bytes.

    The data sibling of :func:`render_wms_tile`: same layer resolution
    (registered name or view JSON) and bbox/width/height/CRS
    parameters, but the response is the raw raster — nodata tag,
    georeferencing and dtype preserved — for clients that want values,
    not pictures."""
    import os
    import tempfile

    from dask_geomodeling_tpu_torch.geo.geotransform import GeoTransform
    from dask_geomodeling_tpu_torch.io.geotiff import write_geotiff

    try:
        block = _layer_block(params.get("coverage") or params["layers"])
    except Exception as e:
        raise WMSError(400, "Invalid coverage/layers parameter: {}".format(e))
    srs = params.get("srs") or params.get("crs")
    if not srs:
        raise WMSError(400, "Missing SRS/CRS parameter")
    height = int(params["height"])
    width = int(params["width"])
    max_cell_size = float(params.get("maxcellsize") or 10.0)
    time_isoformat = params.get("time", "")
    time = (
        datetime.strptime(time_isoformat, "%Y-%m-%dT%H:%M:%S.%fZ")
        if time_isoformat
        else None
    )
    bbox = [float(x) for x in params["bbox"].split(",")]
    if (bbox[2] - bbox[0]) / width > max_cell_size or (
        bbox[3] - bbox[1]
    ) / height > max_cell_size:
        raise WMSError(400, "Too large area requested")

    data = block.get_data(
        mode="vals", bbox=tuple(bbox), height=height, width=width,
        projection=srs, start=time,
    )
    if data is None:
        raise WMSError(404, "No data for this request")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "coverage.tif")
        write_geotiff(
            path, np.asarray(data["values"]),
            geo_transform=tuple(GeoTransform.from_bbox(
                tuple(bbox), height, width
            )),
            projection=srs,
            no_data_value=(
                float(data["no_data_value"])
                if data["no_data_value"] is not None
                else None
            ),
        )
        with open(path, "rb") as stream:
            return stream.read()


_NO_CACHE_HEADERS = [
    ("Pragma", "no-cache"),
    (
        "Cache-Control",
        "no-store, no-cache=Set-Cookie, proxy-revalidate, max-age=0, "
        "post-check=0, pre-check=0",
    ),
    ("Expires", "Wed, 2 Dec 1837 21:00:12 GMT"),
]


def wms_app(environ, start_response):
    """WSGI application serving WMS GetMap (and GetCapabilities for
    registered layers) at any path."""
    query = parse_qs(environ.get("QUERY_STRING", ""))
    params = {k.lower(): v[0] for k, v in query.items()}
    if params.get("request", "").lower() == "getfeatureinfo":
        try:
            raw = render_feature_info(params)
        except WMSError as e:
            start_response(
                "%d Bad Request" % e.status,
                [("Content-Type", "text/plain")],
            )
            return [e.message.encode()]
        except (KeyError, ValueError, TypeError) as e:
            body = ("Invalid request parameters: %s" % e).encode()
            start_response("400 Bad Request", [("Content-Type", "text/plain")])
            return [body]
        info_type = (
            "text/plain"
            if (params.get("info_format") or "").lower() == "text/plain"
            else "application/json"
        )
        start_response(
            "200 OK",
            [("Content-Type", info_type),
             ("Content-Length", str(len(raw)))] + _NO_CACHE_HEADERS,
        )
        return [raw]
    if params.get("request", "").lower() == "getlegendgraphic":
        try:
            raw = render_legend_graphic(params)
        except WMSError as e:
            start_response(
                "%d Bad Request" % e.status,
                [("Content-Type", "text/plain")],
            )
            return [e.message.encode()]
        except (KeyError, ValueError, TypeError) as e:
            body = ("Invalid request parameters: %s" % e).encode()
            start_response("400 Bad Request", [("Content-Type", "text/plain")])
            return [body]
        start_response(
            "200 OK",
            [("Content-Type", "image/png"),
             ("Content-Length", str(len(raw)))] + _NO_CACHE_HEADERS,
        )
        return [raw]
    if params.get("request", "").lower() == "getcoverage":
        try:
            raw = render_coverage(params)
        except WMSError as e:
            body = e.message.encode()
            start_response(
                "%d Bad Request" % e.status,
                [("Content-Type", "text/plain")],
            )
            return [body]
        except (KeyError, ValueError, TypeError) as e:
            body = ("Invalid request parameters: %s" % e).encode()
            start_response("400 Bad Request", [("Content-Type", "text/plain")])
            return [body]
        start_response(
            "200 OK",
            [("Content-Type", "image/tiff"),
             ("Content-Length", str(len(raw)))] + _NO_CACHE_HEADERS,
        )
        return [raw]
    if params.get("request", "").lower() == "getcapabilities":
        scheme = environ.get("wsgi.url_scheme", "http")
        host = environ.get("HTTP_HOST") or environ.get(
            "SERVER_NAME", "localhost"
        )
        body = get_capabilities_xml(
            "%s://%s%s" % (scheme, host, environ.get("PATH_INFO", "/wms"))
        ).encode()
        start_response(
            "200 OK",
            [("Content-Type", "application/vnd.ogc.wms_xml"),
             ("Content-Length", str(len(body)))] + _NO_CACHE_HEADERS,
        )
        return [body]
    try:
        raw = render_wms_tile(params)
    except WMSError as e:
        body = e.message.encode()
        start_response(
            "%d Bad Request" % e.status, [("Content-Type", "text/plain")]
        )
        return [body]
    except (KeyError, ValueError, TypeError) as e:
        # malformed query parameters are client errors, not server crashes
        body = ("Invalid request parameters: %s" % e).encode()
        start_response("400 Bad Request", [("Content-Type", "text/plain")])
        return [body]
    content_type = (params.get("format") or "image/png").lower()
    headers = [
        ("Content-Type", content_type),
        ("Content-Length", str(len(raw))),
    ] + _NO_CACHE_HEADERS
    start_response("200 OK", headers)
    return [raw]


try:
    import tornado.web

    class GeomodelingWMSHandler(tornado.web.RequestHandler):
        """Tornado handler serving WMS tiles (mounted under the Jupyter
        server by :func:`load_jupyter_server_extension`, or in any tornado
        Application at a ``/wms`` route)."""

        def get(self):
            # take every query parameter, case-insensitively (WMS 1.3
            # clients send CRS=/VERSION=; names are case-insensitive)
            params = {
                key.lower(): values[-1].decode("utf-8", "replace")
                for key, values in self.request.query_arguments.items()
            }
            if params.get("request", "").lower() == "getlegendgraphic":
                try:
                    raw = render_legend_graphic(params)
                except WMSError as e:
                    self.set_status(e.status)
                    self.finish(e.message)
                    return
                except (KeyError, ValueError, TypeError) as e:
                    self.set_status(400)
                    self.finish("Invalid request parameters: %s" % e)
                    return
                self.set_header("Content-Type", "image/png")
                for key, value in _NO_CACHE_HEADERS:
                    self.set_header(key, value)
                self.write(raw)
                self.finish()
                return
            if params.get("request", "").lower() == "getfeatureinfo":
                try:
                    raw = render_feature_info(params)
                except WMSError as e:
                    self.set_status(e.status)
                    self.finish(e.message)
                    return
                except (KeyError, ValueError, TypeError) as e:
                    self.set_status(400)
                    self.finish("Invalid request parameters: %s" % e)
                    return
                self.set_header(
                    "Content-Type",
                    "text/plain"
                    if (params.get("info_format") or "").lower()
                    == "text/plain"
                    else "application/json",
                )
                for key, value in _NO_CACHE_HEADERS:
                    self.set_header(key, value)
                self.write(raw)
                self.finish()
                return
            if params.get("request", "").lower() == "getcapabilities":
                body = get_capabilities_xml(
                    self.request.full_url().split("?")[0]
                ).encode()
                self.set_header(
                    "Content-Type", "application/vnd.ogc.wms_xml"
                )
                for key, value in _NO_CACHE_HEADERS:
                    self.set_header(key, value)
                self.write(body)
                self.finish()
                return
            try:
                raw = render_wms_tile(params)
            except WMSError as e:
                self.set_status(e.status)
                self.finish(e.message)
                return
            except (KeyError, ValueError, TypeError) as e:
                self.set_status(400)
                self.finish("Invalid request parameters: %s" % e)
                return
            self.set_header("Content-Length", len(raw))
            self.set_header(
                "Content-Type", (params.get("format") or "image/png").lower()
            )
            for key, value in _NO_CACHE_HEADERS:
                self.set_header(key, value)
            self.write(raw)
            self.finish()

except ImportError:  # tornado not installed: WSGI app remains available
    GeomodelingWMSHandler = None


def load_jupyter_server_extension(nb_server_app):
    """Register the WMS handler on a running Jupyter notebook server."""
    from notebook.utils import url_path_join

    web_app = nb_server_app.web_app
    route_pattern = url_path_join(web_app.settings["base_url"], "/wms")
    web_app.add_handlers(".*$", [(route_pattern, GeomodelingWMSHandler)])


try:  # pragma: no cover - optional notebook integration
    import traitlets
    from ipyleaflet import WMSLayer

    class GeomodelingLayer(WMSLayer):
        """Visualize a RasterBlock on an ipyleaflet Map; the view JSON is
        shipped as the WMS 'layers' parameter."""

        format = traitlets.Unicode("image/png").tag(sync=True, o=True)
        maxcellsize = traitlets.Float(10.0).tag(sync=True, o=True)
        time = traitlets.Unicode("").tag(sync=True, o=True)
        vmin = traitlets.Float(0.0).tag(sync=True, o=True)
        vmax = traitlets.Float(1.0).tag(sync=True, o=True)

        def __init__(self, block, url, **kwargs):
            self.layers = block.to_json()
            super().__init__(url=urljoin(url, "wms"), **kwargs)

except ImportError:
    GeomodelingLayer = None
