"""The port's WMS server against the JAX package's: every case of
tests/test_wms.py, carried across.

Each case builds its view in the JAX package; the port's comes from
``from_reference``, and each server is handed its own package's view
JSON (or a registered layer).  The JAX side runs its numpy executor, the
port ``get_data`` on the CPU (``geomodeling.torch-device`` "cpu").  PNG
answers are compared as decoded RGBA (Pillow), bitwise: the port writes
its PNGs with its own encoder, so the bytes need not agree.
GetFeatureInfo JSON and GetCoverage values are equal, and the
GetCapabilities XML is the JAX package's.  image/jpeg answers the JAX
package's bytes; image/webp, lossy quality 80 in the JAX package, answers
the port's lossless WebP of the image/png answer's pixels.
Beyond the JAX cases: HillShade's out-of-range nodata, a layer naming a
class of the JAX package (refused before any import, in a process
without either), and a device error answered with a 500.
"""
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime, timedelta
from io import BytesIO
from urllib.parse import urlencode
from wsgiref.simple_server import make_server
from xml.etree import ElementTree

import numpy as np
import pytest
from PIL import Image

from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu import ipyleaflet_plugin as jax_plugin
from dask_geomodeling_tpu.raster import HillShade as JaxHillShade
from dask_geomodeling_tpu.raster import MemorySource as JaxMemorySource
from dask_geomodeling_tpu.raster import Smooth as JaxSmooth
from dask_geomodeling_tpu_torch import compute_host, from_reference
from dask_geomodeling_tpu_torch import ipyleaflet_plugin as plugin
from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.core import Block
from dask_geomodeling_tpu_torch.runtime import results

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PNG = b"\x89PNG\r\n\x1a\n"


@pytest.fixture(autouse=True)
def cpu_and_numpy():
    """The port on the CPU, the JAX package on its numpy executor, no
    registered layers and an empty result cache, before and after."""
    plugin.unregister_layers()
    jax_plugin.unregister_layers()
    results.clear()
    with config.set({"geomodeling.torch-device": "cpu"}), \
            jax_config.set({"geomodeling.executor": "numpy"}):
        yield
    plugin.unregister_layers()
    jax_plugin.unregister_layers()
    results.clear()


def columns_source(**overrides):
    """The JAX package's 10x10 source of tests/test_wms.py: each cell holds
    its column index."""
    kwargs = dict(
        data=[[float(i) for i in range(10)] for _ in range(10)],
        no_data_value=255.0,
        projection="EPSG:3857",
        pixel_size=1.0,
        pixel_origin=(0, 10),
    )
    kwargs.update(overrides)
    return JaxMemorySource(**kwargs)


def both(jax_view):
    """(JAX view JSON, the port's view JSON) of one JAX-package view."""
    return jax_view.to_json(), from_reference(jax_view.serialize()).to_json()


@pytest.fixture
def views():
    return both(columns_source())


def base_params(view_json):
    return {
        "layers": view_json,
        "styles": "viridis",
        "vmin": "0",
        "vmax": "10",
        "format": "image/png",
        "srs": "EPSG:3857",
        "height": "64",
        "width": "64",
        "maxcellsize": "10.0",
        "time": "",
        "bbox": "0,0,10,10",
    }


def decoded(raw):
    with Image.open(BytesIO(raw)) as img:
        assert img.format == "PNG"
        return img.mode, np.asarray(img)


def assert_same_pixels(port_raw, jax_raw):
    assert port_raw[:8] == PNG
    port_mode, port_pixels = decoded(port_raw)
    jax_mode, jax_pixels = decoded(jax_raw)
    assert port_mode == jax_mode
    assert port_pixels.dtype == jax_pixels.dtype
    np.testing.assert_array_equal(port_pixels, jax_pixels)


def render_both(port_params, jax_params):
    port_raw = plugin.render_wms_tile(port_params)
    assert_same_pixels(port_raw, jax_plugin.render_wms_tile(jax_params))
    return port_raw


def wsgi(app, query, **environ):
    captured = {}

    def start_response(status, headers):
        captured["status"] = status
        captured["headers"] = dict(headers)

    environ["QUERY_STRING"] = query if isinstance(query, str) else urlencode(query)
    body = b"".join(app(environ, start_response))
    return captured["status"], captured["headers"], body


# --- GetMap ---


def test_render_png(views):
    jax_json, port_json = views
    render_both(base_params(port_json), base_params(jax_json))


def test_overload_guard(views):
    for module, view_json in zip((jax_plugin, plugin), views):
        params = dict(base_params(view_json), bbox="0,0,100000,100000")
        with pytest.raises(module.WMSError, match="Too large"):
            module.render_wms_tile(params)


def test_bad_format(views):
    for module, view_json in zip((jax_plugin, plugin), views):
        with pytest.raises(module.WMSError, match="Unsupported format"):
            module.render_wms_tile(dict(base_params(view_json), format="image/gif"))


def test_invalid_layers():
    for module in (jax_plugin, plugin):
        with pytest.raises(module.WMSError, match="Invalid 'layers'"):
            module.render_wms_tile(base_params("{not json"))


def test_wsgi_app(views):
    jax_json, port_json = views
    status, headers, body = wsgi(plugin.wms_app, base_params(port_json))
    assert status == "200 OK"
    assert headers["Content-Type"] == "image/png"
    _, _, jax_body = wsgi(jax_plugin.wms_app, base_params(jax_json))
    assert_same_pixels(body, jax_body)


def test_wsgi_app_error():
    for module in (jax_plugin, plugin):
        status, _, _ = wsgi(module.wms_app, "layers=broken")
        assert status.startswith("400")


def test_render_on_the_cpu_device(views):
    """test_render_under_jax_executor: the port with its device given as
    "cpu" explicitly renders the JAX numpy executor's pixels, and the
    same bytes as under the fixture's configuration."""
    jax_json, port_json = views
    expected = plugin.render_wms_tile(base_params(port_json))
    with config.set({"geomodeling.torch-device": "cpu"}):
        actual = plugin.render_wms_tile(base_params(port_json))
    assert actual == expected
    assert_same_pixels(actual, jax_plugin.render_wms_tile(base_params(jax_json)))


def serve(app):
    httpd = make_server("127.0.0.1", 0, app)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread


def http_get(port, query):
    """(status, content type, body) of a GET, errors included."""
    url = "http://127.0.0.1:%d/wms?%s" % (port, query if isinstance(query, str) else urlencode(query))
    try:
        with urllib.request.urlopen(url, timeout=30) as response:
            return response.status, response.headers["Content-Type"], response.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_live_http_server(views):
    jax_json, port_json = views
    httpd, thread = serve(plugin.wms_app)
    try:
        status, content_type, body = http_get(httpd.server_address[1], base_params(port_json))
        assert status == 200 and content_type == "image/png"
        assert_same_pixels(body, jax_plugin.render_wms_tile(base_params(jax_json)))
        # a client error comes back as a 4xx, not a server crash
        status, _, _ = http_get(httpd.server_address[1],
                                dict(base_params(port_json), bbox="not,a,bbox"))
        assert 400 <= status < 500
    finally:
        httpd.shutdown()
        thread.join(timeout=5)


def test_device_error_is_a_server_error(views):
    """A tile whose device is missing is not answered from the host: the
    error reaches the WSGI server, which answers 500."""
    _, port_json = views
    httpd, thread = serve(plugin.wms_app)
    try:
        with config.set({"geomodeling.torch-device": "meta"}):
            status, _, _ = http_get(httpd.server_address[1], base_params(port_json))
        assert status == 500
    finally:
        httpd.shutdown()
        thread.join(timeout=5)


def test_time_parameter():
    source = JaxMemorySource(
        data=[[[float(i)] * 4 for _ in range(4)] for i in (1, 9)],
        no_data_value=255.0,
        projection="EPSG:3857",
        pixel_size=1.0,
        pixel_origin=(0, 4),
        time_first=datetime(2000, 1, 1),
        time_delta=timedelta(hours=1),
    )
    jax_json, port_json = both(source)

    def params(view_json, time):
        return dict(base_params(view_json), bbox="0,0,4,4", vmax="10", time=time)

    late = "2000-01-01T01:00:00.000000Z"
    early = "2000-01-01T00:00:00.000000Z"
    with_time = render_both(params(port_json, late), params(jax_json, late))
    without_time = render_both(params(port_json, ""), params(jax_json, ""))
    assert with_time != render_both(params(port_json, early), params(jax_json, early))
    assert without_time == with_time  # no time = latest frame = 01:00


def test_concurrent_rendering(views):
    """Tiles rendered on a thread pool equal the serial renders, and the
    JAX package's."""
    jax_json, port_json = views

    def tile_params(view_json, i, j):
        return dict(base_params(view_json), bbox="%d,%d,%d,%d" % (i, j, i + 5, j + 5))

    corners = [(i, j) for i in range(0, 10, 5) for j in range(0, 10, 5)]
    jobs = [tile_params(port_json, i, j) for i, j in corners]
    serial = [plugin.render_wms_tile(p) for p in jobs]
    with ThreadPoolExecutor(max_workers=4) as pool:
        for _ in range(3):  # repeat to shake out cache races
            assert list(pool.map(plugin.render_wms_tile, jobs)) == serial
    for raw, (i, j) in zip(serial, corners):
        assert_same_pixels(raw, jax_plugin.render_wms_tile(tile_params(jax_json, i, j)))


def run_tornado(handler):
    """A tornado HTTPServer on a free port in a thread; (port, loop, thread)."""
    import asyncio

    import tornado.httpserver
    import tornado.netutil
    import tornado.web

    started = threading.Event()
    box = {}

    def loop_thread():
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        app = tornado.web.Application([(r"/wms", handler)])
        server = tornado.httpserver.HTTPServer(app)
        sockets = tornado.netutil.bind_sockets(0, "127.0.0.1")
        server.add_sockets(sockets)
        box["port"] = sockets[0].getsockname()[1]
        box["loop"] = loop
        started.set()
        loop.run_forever()

    thread = threading.Thread(target=loop_thread, daemon=True)
    thread.start()
    assert started.wait(timeout=30)
    return box["port"], box["loop"], thread


def test_tornado_handler(views):
    jax_json, port_json = views
    assert plugin.GeomodelingWMSHandler is not None
    port, loop, thread = run_tornado(plugin.GeomodelingWMSHandler)
    try:
        url = "http://127.0.0.1:%d/wms?%s" % (port, urlencode(base_params(port_json)))
        with urllib.request.urlopen(url, timeout=30) as response:
            assert response.status == 200
            assert response.headers["Content-Type"] == "image/png"
            assert response.headers["Pragma"] == "no-cache"
            body = response.read()
        assert body == plugin.render_wms_tile(base_params(port_json))
        assert_same_pixels(body, jax_plugin.render_wms_tile(base_params(jax_json)))
        status, _, text = http_get(port, dict(base_params(port_json), bbox="0,0,100000,100000"))
        assert status == 400 and b"Too large" in text
        status, _, _ = http_get(port, dict(base_params(port_json), bbox="not,a,bbox"))
        assert status == 400
    finally:
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=5)


def test_load_jupyter_server_extension_registers_route(monkeypatch):
    import types

    stub_utils = types.ModuleType("notebook.utils")
    stub_utils.url_path_join = lambda *parts: "/".join(
        p.strip("/") for p in parts if p.strip("/")
    ) or "/"
    stub_notebook = types.ModuleType("notebook")
    stub_notebook.utils = stub_utils
    monkeypatch.setitem(sys.modules, "notebook", stub_notebook)
    monkeypatch.setitem(sys.modules, "notebook.utils", stub_utils)
    registered = {}

    class FakeWebApp:
        settings = {"base_url": "/user/me/"}

        def add_handlers(self, pattern, handlers):
            registered["handlers"] = handlers

    plugin.load_jupyter_server_extension(types.SimpleNamespace(web_app=FakeWebApp()))
    (route, handler), = registered["handlers"]
    assert route.endswith("wms")
    assert handler is plugin.GeomodelingWMSHandler


def test_geomodeling_layer_with_stub_ipyleaflet(monkeypatch):
    import importlib
    import types

    import traitlets

    class StubWMSLayer(traitlets.HasTraits):
        url = traitlets.Unicode("")
        layers = traitlets.Unicode("")

        def __init__(self, url="", **kwargs):
            super().__init__()
            self.url = url
            for key, value in kwargs.items():
                setattr(self, key, value)

    stub = types.ModuleType("ipyleaflet")
    stub.WMSLayer = StubWMSLayer
    monkeypatch.setitem(sys.modules, "ipyleaflet", stub)
    module = importlib.reload(plugin)
    try:
        assert module.GeomodelingLayer is not None
        view = from_reference(JaxMemorySource(
            data=np.zeros((1, 4, 4), dtype="u1"), no_data_value=255,
            projection="EPSG:3857", pixel_size=1.0, pixel_origin=(0.0, 4.0),
            time_first=datetime(2000, 1, 1), time_delta=None,
        ).serialize())
        layer = module.GeomodelingLayer(view, "http://localhost:8888/", vmin=0.0, vmax=10.0)
        assert layer.url == "http://localhost:8888/wms"
        # the layer carries the view's JSON; loaded without validation, as
        # in the JAX package, its uint8 data comes back as an int64 list
        # and answers the same values
        assert layer.layers == view.to_json()
        request = dict(mode="vals", bbox=(0.0, 0.0, 4.0, 4.0), projection="EPSG:3857",
                       width=4, height=4)
        np.testing.assert_array_equal(Block.from_json(layer.layers).get_data(**request)["values"],
                                      view.get_data(**request)["values"])
        assert layer.vmax == 10.0
    finally:
        monkeypatch.delitem(sys.modules, "ipyleaflet")
        importlib.reload(plugin)


def test_serving_soak_memory_bounded(views):
    """Threaded serving with the result cache on holds memory roughly
    flat across hundreds of distinct tiles, and the cache its budget."""
    import gc
    import tracemalloc

    _, port_json = views

    def tile_params(i):
        x = (i * 7) % 60 / 10.0
        y = (i * 13) % 60 / 10.0
        return dict(base_params(port_json), bbox="%g,%g,%g,%g" % (x, y, x + 2, y + 2),
                    width="32", height="32")

    with config.set({"geomodeling.result-cache-size": 2 * 10**6}):
        with ThreadPoolExecutor(max_workers=4) as pool:
            list(pool.map(plugin.render_wms_tile, [tile_params(i) for i in range(100)]))
            gc.collect()
            tracemalloc.start()
            first = tracemalloc.take_snapshot()
            for _ in range(3):
                list(pool.map(plugin.render_wms_tile, [tile_params(i) for i in range(300)]))
            gc.collect()
            second = tracemalloc.take_snapshot()
            tracemalloc.stop()
    growth = sum(s.size_diff for s in second.compare_to(first, "filename") if s.size_diff > 0)
    assert growth < 32 * 10**6, "leaked %.1f MB" % (growth / 1e6)
    assert results.stats()["bytes"] <= 2 * 10**6


def capabilities(module, **environ):
    environ.setdefault("HTTP_HOST", "tiles.example:8080")
    environ.setdefault("PATH_INFO", "/wms")
    status, headers, body = wsgi(module.wms_app, "SERVICE=WMS&REQUEST=GetCapabilities", **environ)
    assert status == "200 OK"
    return headers, body


def test_named_layers_and_capabilities(views):
    jax_json, port_json = views
    plugin.register_layer("rainfall", Block.from_json(port_json))
    jax_plugin.register_layer("rainfall", jax_plugin.Block.from_json(jax_json))
    _, body = capabilities(plugin)
    root = ElementTree.fromstring(body)
    assert "rainfall" in [e.text for e in root.iter("Name")]
    assert b"tiles.example:8080" in body
    bbox = next(root.iter("LatLonBoundingBox"))
    assert float(bbox.get("minx")) < float(bbox.get("maxx"))
    # the JAX package's document, its GetMap formats too
    _, jax_body = capabilities(jax_plugin)
    assert b"<Format>image/webp</Format>" in jax_body
    assert body == jax_body

    # GetMap by the registered name, uppercase query keys
    query = {
        "SERVICE": "WMS", "REQUEST": "GetMap", "LAYERS": "rainfall",
        "SRS": "EPSG:3857", "BBOX": "0,0,10,10",
        "WIDTH": "64", "HEIGHT": "64", "STYLES": "viridis",
        "VMIN": "0", "VMAX": "10", "FORMAT": "image/png",
    }
    status, _, png = wsgi(plugin.wms_app, query)
    assert status == "200 OK"
    assert png == plugin.render_wms_tile(base_params(port_json))
    _, _, jax_png = wsgi(jax_plugin.wms_app, query)
    assert_same_pixels(png, jax_png)


def test_capabilities_of_a_file_layer_read_its_footprint(tmp_path):
    """The port reads a layer's WGS84 box off its geometry as the JAX
    package does: the same document for a file layer in EPSG:28992."""
    from dask_geomodeling_tpu.io.geotiff import write_geotiff
    from dask_geomodeling_tpu.raster import RasterFileSource

    path = str(tmp_path / "a.tif")
    write_geotiff(path, np.ones((1, 40, 60), "f4"), (135000.0, 0.5, 0.0, 456000.0, 0.0, -0.5),
                  "EPSG:28992", -9999.0)
    view = JaxSmooth(RasterFileSource(path), 2)
    plugin.register_layer("ahn", from_reference(view.serialize()))
    jax_plugin.register_layer("ahn", view)
    _, body = capabilities(plugin)
    _, jax_body = capabilities(jax_plugin)
    assert b"LatLonBoundingBox" in body
    assert body == jax_body


def test_wms_13_crs_and_axis_order(views):
    jax_json, port_json = views
    geographic = both(columns_source(projection="EPSG:4326", pixel_size=0.1,
                                     pixel_origin=(4.0, 53.0)))
    for module, (view_json, merc_json) in zip((jax_plugin, plugin),
                                              zip(geographic, (jax_json, port_json))):
        p11 = dict(base_params(view_json), srs="EPSG:4326",
                   bbox="4.0,52.0,5.0,53.0", maxcellsize="1")
        expected = module.render_wms_tile(p11)
        p13 = dict(p11)
        del p13["srs"]
        p13.update(crs="EPSG:4326", version="1.3.0", bbox="52.0,4.0,53.0,5.0")
        assert module.render_wms_tile(p13) == expected
        p13_merc = dict(base_params(merc_json), version="1.3.0")
        p13_merc["crs"] = p13_merc.pop("srs")
        assert module.render_wms_tile(p13_merc) == module.render_wms_tile(base_params(merc_json))
        bad = base_params(merc_json)
        del bad["srs"]
        with pytest.raises(module.WMSError, match="SRS/CRS"):
            module.render_wms_tile(bad)
    p11 = [dict(base_params(j), srs="EPSG:4326", bbox="4.0,52.0,5.0,53.0", maxcellsize="1")
           for j in geographic]
    render_both(p11[1], p11[0])


def test_wms_serve_main_configuration(views, monkeypatch, tmp_path):
    from dask_geomodeling_tpu_torch import wms_serve
    from dask_geomodeling_tpu_torch.runtime import router

    _, port_json = views
    served = {}

    class FakeServer:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def serve_forever(self):
            served["up"] = True

    monkeypatch.setattr(wms_serve, "make_server", lambda h, p, app: FakeServer())
    keys = ("geomodeling.result-cache-size", "geomodeling.wms-json-layers",
            "geomodeling.block-import-paths", "geomodeling.router-state")
    before = {key: config.get(key) for key in keys}
    try:
        wms_serve.main(port=0, layers={"demo": port_json}, result_cache_bytes=123456)
        assert served["up"]
        assert config.get("geomodeling.result-cache-size") == 123456
        assert config.get("geomodeling.block-import-paths") == ["dask_geomodeling_tpu_torch"]
        # named layers registered => raw view JSON off by default
        assert config.get("geomodeling.wms-json-layers") is False
        assert "demo" in plugin.get_capabilities_xml()
        # router_state names the router's file and seeds the table from it
        state = tmp_path / "routes.json"
        state.write_text('{"abc:16": {"numpy": 1.0, "torch": 9.0, "torch_runs": 2}}')
        wms_serve.main(port=0, router_state=str(state))
        assert config.get("geomodeling.router-state") == str(state)
        assert router.stats()[("abc", 16)]["torch"] == 9.0
    finally:
        config.set(before)
        router.reset(reseed=False)


def test_wms_13_crs84_never_flips():
    for module, view_json in zip((jax_plugin, plugin), both(columns_source(
            projection="EPSG:4326", pixel_size=0.1, pixel_origin=(4.0, 53.0)))):
        reference = module.render_wms_tile(dict(
            base_params(view_json), srs="EPSG:4326", bbox="4.0,52.0,5.0,53.0", maxcellsize="1"))
        p = dict(base_params(view_json), maxcellsize="1", version="1.3.0",
                 bbox="4.0,52.0,5.0,53.0")
        del p["srs"]
        p["crs"] = "CRS:84"
        assert module.render_wms_tile(p) == reference


def test_capabilities_host_header_is_attribute_safe():
    headers, body = capabilities(
        plugin, HTTP_HOST='evil"/><Layer><Name>fake</Name></Layer><x a="')
    root = ElementTree.fromstring(body)
    assert "fake" not in [e.text for e in root.iter("Name")]
    assert headers["Cache-Control"].startswith("no-store")


def test_tornado_handler_capabilities_and_wms13(views):
    jax_json, port_json = views
    plugin.register_layer("rainfall", Block.from_json(port_json))
    jax_plugin.register_layer("rainfall", jax_plugin.Block.from_json(jax_json))
    port, loop, thread = run_tornado(plugin.GeomodelingWMSHandler)
    try:
        status, _, body = http_get(port, "SERVICE=WMS&REQUEST=GetCapabilities")
        assert status == 200 and b"rainfall" in body
        query = {
            "REQUEST": "GetMap", "VERSION": "1.3.0", "LAYERS": "rainfall",
            "CRS": "EPSG:3857", "BBOX": "0,0,10,10",
            "WIDTH": "64", "HEIGHT": "64", "VMAX": "10",
        }
        status, _, body = http_get(port, query)
        assert status == 200
        _, _, jax_body = wsgi(jax_plugin.wms_app, query)
        assert_same_pixels(body, jax_body)
    finally:
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=5)


def test_empty_styles_and_unknown_colormap(views):
    jax_json, port_json = views
    render_both(dict(base_params(port_json), styles=""), dict(base_params(jax_json), styles=""))
    for module, view_json in zip((jax_plugin, plugin), views):
        with pytest.raises(module.WMSError, match="colormap"):
            module.render_wms_tile(dict(base_params(view_json), styles="nope-123"))


def test_empty_optional_params_use_defaults(views):
    empty = dict(vmin="", vmax="", maxcellsize="", format="", styles="", time="")
    jax_json, port_json = views
    render_both(dict(base_params(port_json), **empty), dict(base_params(jax_json), **empty))


def test_wcs_getcoverage(views, tmp_path):
    from dask_geomodeling_tpu.io.geotiff import read_geotiff as jax_read_geotiff
    from dask_geomodeling_tpu_torch.io.geotiff import read_geotiff

    jax_json, port_json = views
    plugin.register_layer("rain", Block.from_json(port_json))
    jax_plugin.register_layer("rain", jax_plugin.Block.from_json(jax_json))
    query = {
        "SERVICE": "WCS", "REQUEST": "GetCoverage", "COVERAGE": "rain",
        "CRS": "EPSG:3857", "BBOX": "0,0,10,10",
        "WIDTH": "10", "HEIGHT": "10", "FORMAT": "GeoTIFF",
    }
    status, headers, body = wsgi(plugin.wms_app, query)
    assert status == "200 OK"
    assert headers["Content-Type"] == "image/tiff"
    (tmp_path / "port.tif").write_bytes(body)
    (tmp_path / "jax.tif").write_bytes(wsgi(jax_plugin.wms_app, query)[2])
    data = read_geotiff(str(tmp_path / "port.tif"))
    expected = jax_read_geotiff(str(tmp_path / "jax.tif"))
    np.testing.assert_array_equal(data.array, expected.array)
    assert data.array.dtype == expected.array.dtype
    assert data.no_data_value == expected.no_data_value
    np.testing.assert_allclose(data.geo_transform, (0.0, 1.0, 0.0, 10.0, 0.0, -1.0))
    assert data.geo_transform == tuple(expected.geo_transform)
    bad = {"REQUEST": "GetCoverage", "COVERAGE": "missing!", "CRS": "EPSG:3857",
           "BBOX": "0,0,1,1", "WIDTH": "4", "HEIGHT": "4"}
    assert wsgi(plugin.wms_app, bad)[0].startswith("400")


@pytest.mark.parametrize("dtype", ["u1", "i2"])
def test_wcs_getcoverage_of_an_integer_json_layer(dtype):
    """An integer view passed as raw JSON in COVERAGE: both servers load it
    without validation (the integer list becomes int64) and write the
    same GeoTIFF, byte for byte."""
    source = columns_source(data=np.tile(np.arange(10, dtype=dtype), (10, 1)),
                            no_data_value=255 if dtype == "u1" else -1)
    port_json = from_reference((source + 1).serialize()).to_json()
    jax_json = port_json.replace("dask_geomodeling_tpu_torch.", "dask_geomodeling_tpu.")
    query = {"SERVICE": "WCS", "REQUEST": "GetCoverage", "CRS": "EPSG:3857",
             "BBOX": "0,0,10,10", "WIDTH": "20", "HEIGHT": "20", "FORMAT": "GeoTIFF"}
    status, headers, body = wsgi(plugin.wms_app, dict(query, COVERAGE=port_json))
    jax_status, _, jax_body = wsgi(jax_plugin.wms_app, dict(query, COVERAGE=jax_json))
    assert status == jax_status == "200 OK"
    assert headers["Content-Type"] == "image/tiff"
    assert body == jax_body


# --- FORMAT, TRANSPARENT and BGCOLOR ---


def format_params(view_json, **extra):
    params = dict(layers=view_json, bbox="0,0,10,10", width="16", height="16",
                  srs="EPSG:3857", maxcellsize="10")
    params.update(extra)
    return params


@pytest.mark.parametrize("image_format, encoder", [("image/jpeg", "JPEG"), ("image/webp", "WebP")])
def test_jpeg_and_webp_answer_400(views, image_format, encoder):
    """The JAX package encodes these with Pillow; neither answers 400 in
    the port any more.  JPEG: the port's native encoder writes the JAX
    package's bytes (the same composited pixels, Pillow's default save),
    plain and over BGCOLOR.  WebP (the JAX package's lossy quality 80):
    the port's lossless encoder, whose body Pillow decodes to the pixels of
    the JAX package's image/png answer to the same request, transparent
    and flattened, under the same Content-Type."""
    jax_json, port_json = views
    with Image.open(BytesIO(jax_plugin.render_wms_tile(
            format_params(jax_json, format=image_format)))) as img:
        assert img.format == image_format.split("/")[1].upper()
    if encoder == "JPEG":
        for extra in ({}, dict(transparent="false", bgcolor="0x336699", vmin="0", vmax="3")):
            ours = plugin.render_wms_tile(format_params(port_json, format=image_format, **extra))
            theirs = jax_plugin.render_wms_tile(format_params(jax_json, format=image_format,
                                                              **extra))
            assert ours[:2] == b"\xff\xd8" and ours == theirs
        return
    for extra in ({}, dict(transparent="false", bgcolor="0x336699", vmin="0", vmax="3")):
        ours = plugin.render_wms_tile(format_params(port_json, format=image_format, **extra))
        png = jax_plugin.render_wms_tile(format_params(jax_json, format="image/png", **extra))
        with Image.open(BytesIO(ours)) as img, Image.open(BytesIO(png)) as want:
            assert img.format == "WEBP"
            mode = want.mode
            assert np.array_equal(np.asarray(img.convert(mode)), np.asarray(want))
        status, headers, body = wsgi(plugin.wms_app, format_params(port_json, format=image_format,
                                                                   **extra))
        _, jax_headers, _ = wsgi(jax_plugin.wms_app, format_params(jax_json, format=image_format,
                                                                   **extra))
        assert status.startswith("200") and body == ours
        assert headers["Content-Type"] == jax_headers["Content-Type"] == "image/webp"


def test_unknown_format_400(views):
    for module, view_json in zip((jax_plugin, plugin), views):
        with pytest.raises(module.WMSError) as err:
            module.render_wms_tile(format_params(view_json, format="image/gif"))
        assert err.value.status == 400


def test_transparent_false_composites_bgcolor(views):
    jax_json, port_json = views
    extra = dict(transparent="FALSE", bgcolor="0xFF0000", vmin="0", vmax="1")
    raw = render_both(format_params(port_json, **extra), format_params(jax_json, **extra))
    mode, pixels = decoded(raw)
    assert mode == "RGB" and pixels.shape == (16, 16, 3)  # alpha dropped


def test_transparent_false_over_nodata():
    """The composite where cells are nodata: the background shows."""
    jax_json, port_json = both(JaxMemorySource(
        data=[[255.0, 1.0, 2.0, 255.0]] * 4, no_data_value=255.0, projection="EPSG:3857",
        pixel_size=1.0, pixel_origin=(0, 4)))
    extra = dict(transparent="false", bgcolor="0x336699", vmin="0", vmax="3",
                 bbox="0,0,4,4", width="8", height="8")
    raw = render_both(format_params(port_json, **extra), format_params(jax_json, **extra))
    np.testing.assert_array_equal(decoded(raw)[1][0, 0], [0x33, 0x66, 0x99])


def test_invalid_bgcolor_400(views):
    for module, view_json in zip((jax_plugin, plugin), views):
        with pytest.raises(module.WMSError) as err:
            module.render_wms_tile(format_params(view_json, transparent="false", bgcolor="red"))
        assert err.value.status == 400


def test_wsgi_content_type_echoes_format(views):
    """Both servers answer image/jpeg with the same body, and image/png."""
    jax_json, port_json = views
    status, headers, body = wsgi(jax_plugin.wms_app, format_params(jax_json, format="image/jpeg"))
    assert status.startswith("200") and headers["Content-Type"] == "image/jpeg"
    assert body[:2] == b"\xff\xd8"
    status, headers, port_body = wsgi(plugin.wms_app, format_params(port_json, format="image/jpeg"))
    assert status.startswith("200") and headers["Content-Type"] == "image/jpeg"
    assert port_body == body
    status, headers, body = wsgi(plugin.wms_app, format_params(port_json, format="image/png"))
    assert status.startswith("200") and headers["Content-Type"] == "image/png"


def test_capabilities_advertises_formats():
    xml = plugin.get_capabilities_xml()
    assert ("<GetMap><Format>image/png</Format><Format>image/jpeg</Format>"
            "<Format>image/webp</Format></GetMap>") in xml
    assert "<Format>image/webp</Format>" in jax_plugin.get_capabilities_xml()


# --- GetFeatureInfo ---


def info_params(view_json, **extra):
    params = dict(layers=view_json, bbox="0,0,10,10", width="10", height="10",
                  srs="EPSG:3857", request="GetFeatureInfo")
    params.update(extra)
    return {k: v for k, v in params.items() if v is not None}


def info_both(jax_json, port_json, **extra):
    raw = plugin.render_feature_info(info_params(port_json, **extra))
    assert raw == jax_plugin.render_feature_info(info_params(jax_json, **extra))
    return raw


def test_feature_info_json_value(views):
    payload = json.loads(info_both(*views, i="3", j="2"))
    assert payload["value"] == 3.0
    assert payload["crs"] == "EPSG:3857"
    assert payload["x"] == 3.5 and payload["y"] == 7.5


def test_feature_info_wms11_xy_names(views):
    assert json.loads(info_both(*views, x="7", y="9"))["value"] == 7.0


def test_feature_info_plain_text(views):
    assert info_both(*views, i="1", j="1", info_format="text/plain") == b"value: 1.0\n"


def test_feature_info_nodata_is_null():
    jax_json, port_json = both(JaxMemorySource(
        data=[[255.0, 1.0], [2.0, 3.0]], no_data_value=255.0,
        projection="EPSG:3857", pixel_size=1.0, pixel_origin=(0, 2)))
    raw = info_both(jax_json, port_json, i="0", j="0", bbox="0,0,2,2", width="2", height="2")
    assert json.loads(raw)["value"] is None


def test_feature_info_nan_nodata_is_null():
    jax_json, port_json = both(JaxMemorySource(
        data=[[float("nan"), 1.0], [2.0, 3.0]], no_data_value=float("nan"),
        projection="EPSG:3857", pixel_size=1.0, pixel_origin=(0, 2)))
    raw = info_both(jax_json, port_json, i="0", j="0", bbox="0,0,2,2", width="2", height="2")
    assert json.loads(raw)["value"] is None
    assert b"NaN" not in raw


def test_feature_info_pixel_out_of_range_400(views):
    for module, view_json in zip((jax_plugin, plugin), views):
        with pytest.raises(module.WMSError) as err:
            module.render_feature_info(info_params(view_json, i="10", j="0"))
        assert err.value.status == 400


def test_feature_info_missing_pixel_400(views):
    for module, view_json in zip((jax_plugin, plugin), views):
        with pytest.raises(module.WMSError):
            module.render_feature_info(info_params(view_json))


def test_feature_info_wms13_axis_flip():
    jax_json, port_json = both(columns_source(
        projection="EPSG:4326", pixel_size=0.1, pixel_origin=(0, 1)))
    raw = info_both(jax_json, port_json, i="3", j="2", version="1.3.0", srs=None,
                    crs="EPSG:4326", bbox="0,0,1,1")
    assert json.loads(raw)["value"] == 3.0


def test_feature_info_wsgi_route(views):
    jax_json, port_json = views
    status, headers, body = wsgi(plugin.wms_app, info_params(port_json, i="3", j="2"))
    assert status.startswith("200")
    assert headers["Content-Type"] == "application/json"
    assert json.loads(body)["value"] == 3.0
    assert body == wsgi(jax_plugin.wms_app, info_params(jax_json, i="3", j="2"))[2]


def test_feature_info_capabilities_advertises():
    assert "GetFeatureInfo" in plugin.get_capabilities_xml()


# --- GetLegendGraphic ---


def test_legend_png_strip():
    raw = plugin.render_legend_graphic({"styles": "viridis"})
    assert_same_pixels(raw, jax_plugin.render_legend_graphic({"styles": "viridis"}))
    mode, pixels = decoded(raw)
    assert mode == "RGBA" and pixels.shape == (160, 24, 4)
    assert not (pixels[0] == pixels[-1]).all()  # top = colormap(1.0), bottom = colormap(0.0)


@pytest.mark.parametrize("style, width, height", [
    ("terrain", 24, 160), ("gray", 1, 1), ("tab10", 16, 300), ("Spectral_r", 7, 1024)])
def test_legend_styles_and_sizes(style, width, height):
    params = {"style": style, "width": str(width), "height": str(height)}
    assert_same_pixels(plugin.render_legend_graphic(params),
                       jax_plugin.render_legend_graphic(params))


def test_legend_unknown_style_400():
    for module in (jax_plugin, plugin):
        with pytest.raises(module.WMSError) as err:
            module.render_legend_graphic({"styles": "not_a_map"})
        assert err.value.status == 400


def test_legend_wsgi_route():
    query = {"request": "GetLegendGraphic", "styles": "magma", "width": "16", "height": "64"}
    status, headers, body = wsgi(plugin.wms_app, query)
    assert status.startswith("200")
    assert headers["Content-Type"] == "image/png"
    assert_same_pixels(body, wsgi(jax_plugin.wms_app, query)[2])


def test_legend_size_guard():
    for module in (jax_plugin, plugin):
        with pytest.raises(module.WMSError):
            module.render_legend_graphic({"width": "100000"})


# --- the JSON gate and the import guard ---


def test_json_rejected_when_disabled(views):
    _, port_json = views
    with config.set({"geomodeling.wms-json-layers": False}):
        with pytest.raises(plugin.WMSError, match="registered layer"):
            plugin.render_wms_tile(base_params(port_json))


def test_registered_name_still_works_when_disabled(views):
    _, port_json = views
    plugin.register_layer("gated", Block.from_json(port_json))
    with config.set({"geomodeling.wms-json-layers": False}):
        raw = plugin.render_wms_tile(dict(base_params(port_json), layers="gated"))
    assert raw[:8] == PNG


def test_serve_defaults():
    import inspect

    from dask_geomodeling_tpu_torch import wms_serve

    sig = inspect.signature(wms_serve.main)
    assert sig.parameters["allow_json_layers"].default is None
    assert sig.parameters["block_import_paths"].default == ("dask_geomodeling_tpu_torch",)
    assert "allow_json_layers = not layers" in inspect.getsource(wms_serve.main)


def test_a_jax_package_layer_is_refused_before_any_import():
    """In a process that has loaded neither jax nor the JAX package, the
    port's server answers a layer naming a JAX-package class with 400, and
    loads neither; its own layers still render."""
    jax_json = columns_source().to_json()
    script = "\n".join([
        "import sys, json",
        "from urllib.parse import urlencode",
        "from dask_geomodeling_tpu_torch.config import config",
        "from dask_geomodeling_tpu_torch.ipyleaflet_plugin import wms_app",
        "from dask_geomodeling_tpu_torch.raster import MemorySource",
        "config.set({'geomodeling.torch-device': 'cpu',",
        "            'geomodeling.block-import-paths': ['dask_geomodeling_tpu_torch']})",
        "status = {}",
        "def start(s, h): status['s'] = s",
        "params = json.loads(sys.stdin.read())",
        "body = b''.join(wms_app({'QUERY_STRING': urlencode(params)}, start))",
        "assert status['s'].startswith('400'), status",
        "assert b'dask_geomodeling_tpu.raster.sources.MemorySource\" is outside' in body, body",
        "source = MemorySource(data=[[1.0, 2.0]], no_data_value=255.0,",
        "                      projection='EPSG:3857', pixel_size=1.0, pixel_origin=(0, 1))",
        "params['layers'] = source.to_json()",
        "body = b''.join(wms_app({'QUERY_STRING': urlencode(params)}, start))",
        "assert status['s'] == '200 OK' and body[:4] == b'\\x89PNG', status",
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')",
        "       or m.startswith('dask_geomodeling_tpu.') or m == 'dask_geomodeling_tpu']",
        "assert not bad, bad",
        "print('refused')",
    ])
    proc = subprocess.run([sys.executable, "-c", script], input=json.dumps(base_params(jax_json)),
                          cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "refused"


@pytest.mark.parametrize("allowed, path, admitted", [
    (["dask_geomodeling_tpu"], "dask_geomodeling_tpu_torch.raster.sources.MemorySource", False),
    (["dask_geomodeling_tpu_torch"], "dask_geomodeling_tpu_torch.raster.sources.MemorySource",
     True),
    (["dask_geomodeling_tpu_torch.raster"], "dask_geomodeling_tpu_torch.raster.sources.MemorySource",
     True),
    (["dask_geomodeling_tpu_torch.rast"], "dask_geomodeling_tpu_torch.raster.sources.MemorySource",
     False),
    (None, "dask_geomodeling_tpu_torch.raster.sources.MemorySource", True),
    (None, "dask_geomodeling_tpu.raster.sources.MemorySource", False),
    (["dask_geomodeling_tpu"], "dask_geomodeling_tpu.raster.sources.MemorySource", False),
    (["dask_geomodeling_tpu_torch"], "os.path.join", False),
])
def test_import_guard_prefixes(allowed, path, admitted):
    """A prefix admits its package and the modules inside it, never a
    package whose name merely starts with it; the port never imports
    outside its own package."""
    with config.set({"geomodeling.block-import-paths": allowed}):
        if admitted:
            assert Block.from_import_path(path).__name__ == path.rsplit(".", 1)[1]
        else:
            with pytest.raises(TypeError, match="outside"):
                Block.from_import_path(path)


# --- what the JAX cases do not reach ---


def hillshade_views():
    rng = np.random.RandomState(3)
    data = (rng.rand(1, 24, 24) * 8).astype("f4")
    data[0, 3:6, 4:9] = -1.0
    return JaxHillShade(JaxMemorySource(
        data=data, no_data_value=-1.0, projection="EPSG:3857", pixel_size=1.0,
        pixel_origin=(0, 24)))


def test_hillshade_nodata_masks_nothing():
    """HillShade answers uint8 with nodata 256, which no cell can hold: the
    port's render masks nothing, as the JAX render's device route does (its
    host route raises TypeError on ``np.ma.masked_equal``, a 400)."""
    view = hillshade_views()
    port_view = from_reference(view.serialize())
    params = dict(base_params(port_view.to_json()), bbox="0,0,24,24", width="24", height="24",
                  styles="gray", vmin="0", vmax="255")
    _, pixels = decoded(plugin.render_wms_tile(params))
    assert (pixels[..., 3] == 255).all()
    request = dict(mode="vals", bbox=(0.0, 0.0, 24.0, 24.0), projection="EPSG:3857",
                   width=24, height=24)
    host = compute_host(*port_view.get_compute_graph(**request))
    assert host["no_data_value"] == 256 and host["values"].dtype == np.uint8
    np.testing.assert_array_equal(
        pixels, np.asarray(Image.open(BytesIO(plugin.encode_tile(
            np.ma.masked_array(host["values"][0], mask=False), "gray", 0.0, 255.0)))))
    with pytest.raises(TypeError, match="fill_value 256"):
        jax_plugin.render_wms_tile(dict(params, layers=view.to_json()))
    status, _, _ = wsgi(jax_plugin.wms_app, dict(params, layers=view.to_json()))
    assert status.startswith("400")


def test_smooth_tiles_equal_the_jax_numpy_executor():
    """A Smooth layer (the Gaussian's plain version on the CPU) over a
    source with nodata, in several tiles, styles and ranges."""
    rng = np.random.RandomState(4)
    data = (rng.rand(1, 64, 64) * 10).astype("f4")
    data[0, 10:20, 30:40] = -9999.0
    jax_json, port_json = both(JaxSmooth(JaxMemorySource(
        data=data, no_data_value=-9999.0, projection="EPSG:28992", pixel_size=0.5,
        pixel_origin=(135000.0, 456032.0)), 2))
    for style, (vmin, vmax), bbox in [
        ("terrain", (0, 10), "135000,456000,135032,456032"),
        ("viridis", (2.5, 7.5), "135004,456008,135020,456024"),
        ("tab10", (0, 10), "134990,455990,135010,456010"),
    ]:
        extra = dict(styles=style, vmin=str(vmin), vmax=str(vmax), bbox=bbox,
                     srs="EPSG:28992", width="32", height="32")
        render_both(dict(base_params(port_json), **extra), dict(base_params(jax_json), **extra))
