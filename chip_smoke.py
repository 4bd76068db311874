#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dask_geomodeling_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: csrc/gaussian_blur.cu with nvcc for sm_90a, from this checkout;
3. kernel check: the CUDA Gaussian against its plain torch version on the
   card (torch.equal) at the main path's shape (64, 516, 516) and sigma
   (radius 3), at radius 8 and at a zoom-mode radius 40; one plane against
   scipy.ndimage.gaussian_filter on the host, bitwise;
4. main path: bench.py's view (8192^2 EPSG:28992 source) over a 10240^2
   EPSG:3857 request in 512^2 tiles, batches of 64, through the port's
   evaluate_tiled and get_data.  The Gaussian launch count must equal the
   number of batches (all of the fused shape), no node may run on the
   host, a view with a node that has no twin (MovingMax) must raise, a
   64^2 corner must equal the numpy executor bit for bit and 16 tiles
   spread over the request may differ from it in at most 5e-4 of their
   cells;
5. timing: median of 3 evaluate_tiled runs (Mpx/s), the numpy host rate
   on the sampled tiles, one run's seconds per phase (plan, run, fetch,
   assemble), one run under torch.profiler for the device's busy time and
   idle share, and one (64, 516, 516) blur by the kernel and by the plain
   version (CUDA events).

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Without CUDA the script exits non-zero
before printing any result.  It imports nothing of JAX, and checks that.
"""
import json
import subprocess
import sys
import time

import numpy as np

MAX_SHARE = 5e-4
OUT_PX = 10240
TILE = 512
BATCH = 64


def check(condition, message):
    if not condition:
        raise RuntimeError("check failed: " + message)


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_busy_ms(run):
    """(wall s, device busy ms) of ``run()`` under torch.profiler: the
    summed time of the kernels and copies on the card; busy ms is None
    when the profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    busy_us = 0.0
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            busy_us += getattr(event, "self_device_time_total", None) or getattr(
                event, "self_cuda_time_total", 0.0)
    return wall_s, (busy_us / 1e3 if busy_us > 0 else None)


def card_description():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return proc.stdout.strip().splitlines()[0]


def main_path_sigma(view, request):
    """(sigma_y, sigma_x) of the Smooth node in the first tile's plan."""
    graph, _ = view.get_compute_graph(**request)
    for value in graph.values():
        if isinstance(value, tuple) and getattr(value[0], "__name__", "") == "_smooth_process":
            size_y, size_x = value[2]["size"]
            return size_y / 3, size_x / 3
    raise RuntimeError("no Smooth node in the main path")


def tile_window(index, nx, height, tile):
    """(row slice, col slice) of full tile ``index`` in the assembled
    output: tiles run from the south-west corner, rows from the north."""
    j, i = divmod(index, nx)
    row_end = height - j * tile
    return slice(row_end - tile, row_end), slice(i * tile, (i + 1) * tile)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import bench
    from dask_geomodeling_tpu import config
    from dask_geomodeling_tpu.raster import MovingMax
    from dask_geomodeling_tpu_torch import evaluate_tiled, get_data
    from dask_geomodeling_tpu_torch.ops import _build, cuda_stencils
    from dask_geomodeling_tpu_torch.ops.stencils import gaussian_blur_reference
    from dask_geomodeling_tpu_torch.runtime import executor
    from dask_geomodeling_tpu_torch.runtime.tiles import NotLowerable, tile_requests
    from scipy import ndimage

    # 1. device
    card = card_description()
    device = torch.device("cuda", 0)
    print(card)
    print("device: torch %s, CUDA %s, %d card(s)" % (
        torch.__version__, torch.version.cuda, torch.cuda.device_count()))

    # 2. build
    t0 = time.perf_counter()
    _build.load_library("gaussian_blur")
    build_s = time.perf_counter() - t0
    print("build: gaussian_blur.cu in %.2f s (nvcc %.2f s)" % (
        build_s, _build.build_log["gaussian_blur"]["seconds"]))
    for line in _build.build_log["gaussian_blur"]["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas: " + line.strip())

    # 3. kernel check
    source, view = bench.build_view()
    request = bench.full_request(source, OUT_PX)
    tiles, nx = tile_requests(request, TILE)
    sigma = main_path_sigma(view, tiles[0])
    rng = np.random.RandomState(0)
    planes = torch.from_numpy(
        (rng.rand(BATCH, TILE + 4, TILE + 4) * 250).astype(np.float32)
    ).to(device)
    max_abs_err = None
    for label, (sy, sx) in [
        ("main path", sigma),
        ("radius 8", (2.0, 2.0)),
        ("radius 40 (zoom mode)", (10.0, 10.0)),
    ]:
        before = (cuda_stencils.launches, cuda_stencils.fused_launches)
        got = cuda_stencils.gaussian_blur(planes, sy, sx, 0)
        fused = cuda_stencils.fused_launches - before[1]
        check(cuda_stencils.launches - before[0] == (1 if fused else 2),
              "launch count of the %s check" % label)
        want = gaussian_blur_reference(planes, sy, sx, 0)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        equal = torch.equal(got, want)
        print("kernel check: %s sigma=(%.6f, %.6f) shape=%s %s launch equal=%s max_abs_err=%r"
              % (label, sy, sx, tuple(planes.shape), "fused" if fused else "two-pass",
                 equal, err))
        check(equal, "kernel differs from its plain version (%s)" % label)
        if max_abs_err is None:
            max_abs_err = err
    host_plane = planes[0].cpu().numpy()
    scipy_plane = ndimage.gaussian_filter(host_plane, sigma, mode="constant", cval=0)
    kernel_plane = cuda_stencils.gaussian_blur(planes[:1].contiguous(), *sigma, 0)
    check(np.array_equal(kernel_plane[0].cpu().numpy(), scipy_plane),
          "kernel differs from scipy.ndimage.gaussian_filter")
    print("kernel check: one plane bitwise equal to scipy.ndimage.gaussian_filter")

    # 4. main path
    n_batches = -(-len(tiles) // BATCH)
    cuda_stencils.reset_launches()
    host_runs = executor.host_node_runs
    t0 = time.perf_counter()
    result = evaluate_tiled(view, request, tile_size=TILE, batch=BATCH, device=device)
    first_s = time.perf_counter() - t0
    main_launches = cuda_stencils.launches
    main_fused = cuda_stencils.fused_launches
    values = result["values"]
    print("main path: evaluate_tiled %s %s in %.2f s (first run), %d gaussian launches "
          "(%d fused) for %d batches"
          % (values.shape, values.dtype, first_s, main_launches, main_fused, n_batches))
    check(main_launches == n_batches, "gaussian launches != batches")
    check(main_fused == main_launches, "the main path left the fused launch shape")
    check(values.shape == (1, OUT_PX, OUT_PX), "output shape")
    check(set(np.unique(values).tolist()) <= {0, 1, 2, 3, 4, 255}, "output alphabet")
    check((values != 255).mean() > 0.5, "output is mostly fill")

    cuda_stencils.reset_launches()
    routed = get_data(view, device=device, **request)
    check(cuda_stencils.launches == n_batches, "get_data did not run as tiles")
    check(np.array_equal(routed["values"], values), "get_data differs from evaluate_tiled")
    x1, y1, x2, y2 = request["bbox"]
    sub = dict(request, width=256, height=256, bbox=(
        (x1 + x2) / 2, (y1 + y2) / 2,
        (x1 + x2) / 2 + (x2 - x1) / 40, (y1 + y2) / 2 + (y2 - y1) / 40))
    cuda_stencils.reset_launches()
    sub_port = get_data(view, device=device, **sub)
    check(cuda_stencils.launches == 1, "sub-tile get_data did not launch the kernel")
    check(executor.host_node_runs == host_runs, "a node ran on the host")
    print("main path: get_data (tiled and a 256^2 sub-tile request) ran every node on the card")
    no_twin = MovingMax(source, size=3)
    for label, req in [("sub-tile", sub), ("tiled", request)]:
        try:
            get_data(no_twin, device=device, **req)
        except NotLowerable as exc:
            print("main path: MovingMax %s request raised NotLowerable (%s)" % (label, exc))
        else:
            raise RuntimeError("check failed: MovingMax %s request did not raise" % label)
    check(executor.host_node_runs == host_runs, "a node ran on the host")

    with config.set({"geomodeling.executor": "numpy"}):
        crop = dict(request, width=64, height=64, bbox=(
            x1, y2 - (y2 - y1) * 64 / OUT_PX, x1 + (x2 - x1) * 64 / OUT_PX, y2))
        expected_crop = view.get_data(**crop)["values"]
        check(np.array_equal(values[:, :64, :64], expected_crop), "64^2 crop differs")
        sub_host = view.get_data(**sub)["values"]
        sampled = list(range(0, len(tiles), len(tiles) // 16))[:16]
        t0 = time.perf_counter()
        host_tiles = [view.get_data(**tiles[k])["values"] for k in sampled]
        host_s = time.perf_counter() - t0
    differing = 0
    for k, host_tile in zip(sampled, host_tiles):
        rows, cols = tile_window(k, nx, OUT_PX, TILE)
        differing += int(np.count_nonzero(values[:, rows, cols] != host_tile))
    share = differing / (len(sampled) * TILE * TILE)
    sub_share = np.count_nonzero(sub_port["values"] != sub_host) / sub_host.size
    print("main path: 64^2 crop bitwise equal; %d tiles: %d of %d cells differ (share %r); "
          "sub-tile share %r" % (len(sampled), differing, len(sampled) * TILE * TILE,
                                 share, sub_share))
    check(share <= MAX_SHARE, "differing share above %g" % MAX_SHARE)
    check(sub_share <= MAX_SHARE, "sub-tile differing share above %g" % MAX_SHARE)

    # 5. timing
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate_tiled(view, request, tile_size=TILE, batch=BATCH, device=device)
        runs.append(time.perf_counter() - t0)
    total_mpx = OUT_PX * OUT_PX / 1e6
    port_rate = total_mpx / sorted(runs)[1]
    host_rate = len(sampled) * TILE * TILE / 1e6 / host_s
    phases = {}
    t0 = time.perf_counter()
    evaluate_tiled(view, request, tile_size=TILE, batch=BATCH, device=device,
                   phase_seconds=phases)
    phased_s = time.perf_counter() - t0
    profiled_s, busy_ms = device_busy_ms(lambda: evaluate_tiled(
        view, request, tile_size=TILE, batch=BATCH, device=device))
    kernel_ms = cuda_ms(lambda: cuda_stencils.gaussian_blur(planes, *sigma, 0), 20)
    plain_ms = cuda_ms(lambda: gaussian_blur_reference(planes, *sigma, 0), 5)
    print("timing [%s]: port %.3f Mpx/s (median of 3: %s s); numpy host %.3f Mpx/s on %d tiles"
          % (card, port_rate, ", ".join("%.3f" % r for r in runs), host_rate, len(sampled)))
    print("timing [%s]: phases of one run (synchronised, %.4f s in all): %s"
          % (card, phased_s, ", ".join("%s %.4f s" % kv for kv in phases.items())))
    print("timing [%s]: profiled run %.4f s, device busy %s, idle share %s"
          % (card, profiled_s,
             "not measured" if busy_ms is None else "%.3f ms" % busy_ms,
             "not measured" if busy_ms is None else "%.4f" % (1 - busy_ms / 1e3 / profiled_s)))
    print("timing [%s]: gaussian_blur (64, 516, 516) kernel %.4f ms, plain torch %.4f ms"
          % (card, kernel_ms, plain_ms))
    check("jax" not in sys.modules, "jax was imported")

    print(json.dumps({"kernels": [{
        "name": "gaussian_blur",
        "route": "cuda",
        "source": "dask_geomodeling_tpu_torch/csrc/gaussian_blur.cu",
        "replaces": "dask_geomodeling_tpu/ops/pallas_stencils.py:55",
        "launches": main_launches,
        "fused_launches": main_fused,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
