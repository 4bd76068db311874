"""The port's shared state under threads (a WMS server renders tiles on a
thread pool), on the CPU: more threads than cores, a shortened switch
interval, and invariants a lost update would break.

- the kernels' launch counters (``ops/cuda_stencils.py``) stay exact;
- each library's ctypes signatures are declared once;
- ``ops/_build.load_library`` builds and loads each source once, and two
  sources at the same time;
- the result cache counts every call once and stores each key once;
- the native layer's counters (``native/__init__.py``) stay exact while
  the decoders and the burn run on many threads, each answer the one a
  single thread gives.

The kernels themselves, launched from eight threads on the card, are in
tests/test_torch_paths_cuda.py::test_launch_counters_exact_under_threads.
"""
import os
import sys
import threading
import types

import numpy as np
import pytest

from dask_geomodeling_tpu_torch.ops import _build, cuda_stencils
from dask_geomodeling_tpu_torch.runtime import results

THREADS = max(16, 2 * (os.cpu_count() or 1))


@pytest.fixture(autouse=True)
def short_switch_interval():
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(interval)


def run_threads(work, count=THREADS):
    """Start ``count`` threads on ``work(index)`` together; join each with
    a timeout and return the exceptions they raised."""
    start = threading.Barrier(count)
    errors = []

    def body(index):
        try:
            start.wait(timeout=30)
            work(index)
        except Exception as exc:  # collected and asserted by the caller
            errors.append(exc)

    threads = [threading.Thread(target=body, args=(i,)) for i in range(count)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=60)
    assert not any(thread.is_alive() for thread in threads)
    return errors


def test_launch_counters_stay_exact():
    cuda_stencils.reset_launches()
    try:
        def work(_):
            for _ in range(500):
                cuda_stencils._count(gaussian=1, fused=1)
                cuda_stencils._count(moving_max=1)
                cuda_stencils._count(gaussian=2)

        assert run_threads(work) == []
        assert cuda_stencils.launches == THREADS * 500 * 3
        assert cuda_stencils.fused_launches == THREADS * 500
        assert cuda_stencils.moving_max_launches == THREADS * 500
    finally:
        cuda_stencils.reset_launches()


def test_native_counters_stay_exact_and_answers_alike():
    from dask_geomodeling_tpu_torch import native
    from tests.test_geotiff_foreign import lzw_encode

    data = np.repeat(np.arange(64, dtype=np.uint8), 40).tobytes()
    stream = lzw_encode(data)
    coords = np.array([0, 0, 8, 0, 8, 8, 0, 8, 0, 0], np.float64)
    gt = (0.0, 1.0, 0.0, 8.0, 0.0, -1.0)
    want = np.zeros((8, 8), np.int32)
    native.rasterize_native(coords, [5], [1], [7], want, gt)
    pixels = np.add.outer(np.arange(24), np.arange(40)).astype(np.uint8)
    jpeg = native.jpeg_encode_native(pixels)
    decoded = native.jpeg_decode_native(jpeg)
    webp = native.webp_encode_native(pixels)
    unpacked = native.webp_decode_native(webp)
    native.reset_counts()
    rounds = 50

    def work(_):
        for _ in range(rounds):
            assert native.tiff_decode_native("lzw", stream, len(data)) == data
            out = np.zeros((8, 8), np.int32)
            assert native.rasterize_native(coords, [5], [1], [7], out, gt)
            assert np.array_equal(out, want)
            assert native.jpeg_encode_native(pixels) == jpeg
            assert np.array_equal(native.jpeg_decode_native(jpeg), decoded)
            assert native.webp_encode_native(pixels) == webp
            assert np.array_equal(native.webp_decode_native(webp), unpacked)

    try:
        assert run_threads(work) == []
        assert native.counts == {"tiff_decodes": THREADS * rounds,
                                 "tiff_bytes": THREADS * rounds * len(data),
                                 "jpeg_decodes": THREADS * rounds,
                                 "jpeg_bytes": THREADS * rounds * decoded.size,
                                 "jpeg_encodes": THREADS * rounds,
                                 "jpeg_encoded_bytes": THREADS * rounds * len(jpeg),
                                 "webp_decodes": THREADS * rounds,
                                 "webp_bytes": THREADS * rounds * unpacked.size,
                                 "webp_encodes": THREADS * rounds,
                                 "webp_encoded_bytes": THREADS * rounds * len(webp),
                                 "burns": THREADS * rounds}
    finally:
        native.reset_counts()


def fake_library(*names):
    lib = types.SimpleNamespace(**{name: types.SimpleNamespace() for name in names})
    return lib


@pytest.mark.parametrize("which", ["gaussian", "moving_max"])
def test_declarations_run_once(monkeypatch, which):
    if which == "gaussian":
        lib = fake_library(*cuda_stencils._ENTRY.values(), cuda_stencils._TRUNC_ENTRY,
                           "gaussian_blur_fused_max_radius", "gaussian_blur_error_string")
        declare, get = "_declare_gaussian", cuda_stencils._library
    else:
        lib = fake_library("moving_max", "moving_max_error_string")
        declare, get = "_declare_moving_max", cuda_stencils._moving_max_library
    calls = []
    original = getattr(cuda_stencils, declare)

    def counted(target):
        calls.append(target)
        original(target)

    monkeypatch.setattr(cuda_stencils, declare, counted)
    monkeypatch.setattr(_build, "load_library", lambda name: lib)
    seen = []
    assert run_threads(lambda _: seen.append(get())) == []
    assert len(calls) == 1 and all(found is lib for found in seen)
    assert lib._declared


def test_each_source_builds_once_and_two_at_once(monkeypatch):
    """Sixteen threads ask for two libraries: each is built once, and the
    two builds overlap (each waits for the other at a barrier, which a
    build under one global lock would never pass)."""
    both_building = threading.Barrier(2)
    built = []

    def library_path(name):
        built.append(name)
        both_building.wait(timeout=30)
        return name

    monkeypatch.setattr(_build, "_LIBRARIES", {})
    monkeypatch.setattr(_build, "_NAME_LOCKS", {})
    monkeypatch.setattr(_build, "library_path", library_path)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: types.SimpleNamespace(path=path))
    loaded = {}

    def work(index):
        name = ("gaussian_blur", "moving_max")[index % 2]
        lib = _build.load_library(name)
        loaded.setdefault(name, set()).add(id(lib))

    assert run_threads(work) == []
    assert sorted(built) == ["gaussian_blur", "moving_max"]
    assert {name: len(ids) for name, ids in loaded.items()} == {"gaussian_blur": 1,
                                                                "moving_max": 1}


class _Token:
    def __init__(self, token):
        self.token = token


def test_result_cache_counts_every_call_once():
    results.clear()
    try:
        keys = 5
        rounds = 200

        def work(index):
            for k in range(rounds):
                key = (index + k) % keys
                answer = results.get_or_compute(
                    _Token("threads-%d" % key), {"mode": "vals"},
                    lambda: {"values": np.full((1, 2, 2), key, "u1"), "no_data_value": 255},
                    10**6)
                assert int(answer["values"][0, 0, 0]) == key

        assert run_threads(work) == []
        stats = results.stats()
        assert stats["hits"] + stats["misses"] == THREADS * rounds
        assert stats["entries"] == keys and stats["evictions"] == 0
        assert stats["misses"] >= keys
    finally:
        results.clear()
