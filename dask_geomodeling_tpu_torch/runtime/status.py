"""One-call runtime observability: the runtime's counters in one
JSON-serialisable snapshot.

Counterpart of dask_geomodeling_tpu/runtime/status.py.  The JAX
package's snapshot also holds the tile runtime's gather-mode counters and
its compiled-program cache; the port has neither (no gather modes, and
PyTorch runs eagerly), so it reports the tile programs built and the
batches run instead.  Its router count of host-only keys is left out
too: the port's router pins no key to the host.
"""

__all__ = ["snapshot"]


def snapshot():
    """All runtime counters as one JSON-serialisable dict: the router's
    table, the result cache's counters, the tile runtime's programs and
    batches, and the host nodes the torch executors ran."""
    from dask_geomodeling_tpu_torch.runtime import executor, results, router, tiles

    routes = router.stats()
    return {
        "router": {
            "routes": len(routes),
            "torch_routes": sum(1 for s in routes.values() if s.get("torch") is not None),
        },
        "result_cache": results.stats(),
        "tiles": {"programs": tiles.programs_built, "batches": tiles.batches_run},
        "host_node_runs": executor.host_node_runs,
    }
