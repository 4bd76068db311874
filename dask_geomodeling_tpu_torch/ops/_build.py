"""Build ``csrc/*.cu`` at first use and load it with ctypes.

Each source compiles on its own with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds).  The library's file name carries a hash of the source and the
flags, so an edited source rebuilds and a stale library is never loaded.
Outputs go to ``dask_geomodeling_tpu_torch/_build/`` (ignored by git).
Nothing here runs at import time.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

__all__ = ["load_library", "library_path", "build_log", "nvcc_path"]

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_DIR = os.path.join(_PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    # the kernels promise bitwise agreement with their plain versions:
    # no multiply-add may be contracted into an FMA
    "-fmad=false",
    "-Xptxas", "-v",
    "-shared",
    "-Xcompiler", "-fPIC",
)

_LIBRARIES = {}
_LOCK = threading.Lock()
#: one lock per source name, held while it builds and loads
_NAME_LOCKS = {}
#: per source name: {"seconds": build time (0 when reused), "log": nvcc output}
build_log = {}


def nvcc_path():
    """nvcc from CUDA_HOME, else PATH, else the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        candidate = os.path.join(home, "bin", "nvcc")
        if os.path.exists(candidate):
            return candidate
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = os.path.join("/usr/local/cuda", "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def load_library(name):
    """The ctypes library built from ``csrc/<name>.cu`` (built if needed).
    Safe from several threads: each source builds once, under its own
    lock, so two sources build at the same time."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBRARIES.get(name)
        if lib is None:
            lib = _LIBRARIES[name] = ctypes.CDLL(library_path(name))
        return lib


def library_path(name):
    """The path of the library built from ``csrc/<name>.cu`` (built if
    needed)."""
    source = os.path.join(SOURCE_DIR, name + ".cu")
    with open(source, "rb") as f:
        text = f.read()
    digest = hashlib.sha256(text + repr(NVCC_FLAGS).encode()).hexdigest()[:16]
    target = os.path.join(BUILD_DIR, "lib%s-%s.so" % (name, digest))
    if os.path.exists(target):
        build_log.setdefault(name, {"seconds": 0.0, "log": "reused " + target})
        return target
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a private name, then rename: a concurrent build or a
    # killed one never leaves a half-written library under the final name
    fd, partial = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", partial, source],
            capture_output=True,
            text=True,
            timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                "nvcc failed on %s (exit %d):\n%s%s"
                % (source, proc.returncode, proc.stdout, proc.stderr)
            )
        os.replace(partial, target)
    finally:
        if os.path.exists(partial):
            os.unlink(partial)
    build_log[name] = {
        "seconds": time.perf_counter() - t0,
        "log": proc.stdout + proc.stderr,
    }
    return target
