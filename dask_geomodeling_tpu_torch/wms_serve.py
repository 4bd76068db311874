"""Standalone WMS server of the port:
``python -m dask_geomodeling_tpu_torch.wms_serve [port] [host]``.

Counterpart of dask_geomodeling_tpu/wms_serve.py: serves the WSGI app of
ipyleaflet_plugin with the stdlib server.  Each tile runs on
``geomodeling.torch-device`` (the card by default).

Hardened defaults for the unauthenticated surface: binds 127.0.0.1 (pass
an explicit host to expose it) and restricts Block deserialization to
``dask_geomodeling_tpu_torch.*`` import paths, checked before any import,
so a query string cannot trigger arbitrary module imports
(``geomodeling.block-import-paths``).
"""
import sys
from wsgiref.simple_server import make_server

from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.ipyleaflet_plugin import wms_app


def main(port=8787, host="127.0.0.1",
         block_import_paths=("dask_geomodeling_tpu_torch",),
         layers=None, result_cache_bytes=256 * 2**20, router_state=None,
         allow_json_layers=None):
    """Serve the WMS WSGI app forever on ``host:port``.

    ``layers`` maps names to Blocks (or view-JSON strings) advertised by
    GetCapabilities; the serving defaults turn on the cross-request
    result cache and, when ``router_state`` names a file, keep the auto
    router's measurements there across restarts (runtime/router.py; it
    routes only under ``geomodeling.executor`` "auto").

    ``allow_json_layers``: whether the ``layers`` query parameter may
    carry raw view JSON.  Defaults to False whenever named ``layers``
    are registered (a client that can construct views can point a
    RasterFileSource at any readable path and read it through
    GetMap/GetFeatureInfo) and True for a bare dev server, whose only
    way to specify a view is JSON."""
    from dask_geomodeling_tpu_torch.core import Block
    from dask_geomodeling_tpu_torch.ipyleaflet_plugin import register_layer

    if allow_json_layers is None:
        allow_json_layers = not layers
    settings = {
        "geomodeling.block-import-paths": list(block_import_paths),
        "geomodeling.result-cache-size": int(result_cache_bytes or 0),
        "geomodeling.wms-json-layers": bool(allow_json_layers),
    }
    if router_state:
        settings["geomodeling.router-state"] = router_state
    config.set(settings)
    if router_state:
        # restore the learned routes now (and make a later reset re-seed
        # from the file instead of exploring every view again)
        from dask_geomodeling_tpu_torch.runtime import router

        router.reset(reseed=True)
    for name, block in (layers or {}).items():
        if isinstance(block, str):
            block = Block.from_json(block)
        register_layer(name, block)
    with make_server(host, port, wms_app) as httpd:
        print(
            "Serving WMS on %s:%d (GET /wms?layers=<name or view json>"
            "&...; GetCapabilities lists named layers)" % (host, port)
        )
        httpd.serve_forever()


if __name__ == "__main__":
    main(
        int(sys.argv[1]) if len(sys.argv) > 1 else 8787,
        sys.argv[2] if len(sys.argv) > 2 else "127.0.0.1",
    )
