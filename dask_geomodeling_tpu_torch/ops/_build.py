"""Build ``csrc/*.cu`` and the host's C++ sources at first use and load
them with ctypes.

Each ``.cu`` source compiles on its own with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  A host ``.cpp`` source (``native/*.cpp``) compiles with
``g++ -O3 -shared -fPIC -std=c++17``, the JAX package's flags
(dask_geomodeling_tpu/native/__init__.py).  A library's file name carries
a hash of its source and the flags, so an edited source rebuilds and a
stale library is never loaded.  Outputs go to
``dask_geomodeling_tpu_torch/_build/`` (ignored by git), never beside the
sources.  A failed build raises, naming the compiler and the source.
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

__all__ = [
    "load_library",
    "library_path",
    "load_host_library",
    "host_library_path",
    "build_log",
    "nvcc_path",
    "gxx_path",
]

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

#: the host C++ sources' flags (the JAX package's native/__init__.py)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LIBRARIES = {}
_LOCK = threading.Lock()
#: one lock per source, held while it builds and loads
_NAME_LOCKS = {}
#: per source name: {"seconds": build time (0 when reused), "log": the
#: compiler's output}
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


def gxx_path():
    """g++ from PATH."""
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found (put g++ on PATH)")


def load_library(name):
    """The ctypes library built from ``csrc/<name>.cu`` (built if needed).
    Safe from several threads: each source builds once, under its own
    lock, so two sources build at the same time."""
    return _load(name, lambda: library_path(name))


def load_host_library(source):
    """The ctypes library built with g++ from the C++ file ``source``
    (built if needed), under the same locks as load_library."""
    source = os.path.abspath(source)
    return _load(source, lambda: host_library_path(source))


def _load(key, path):
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(key, threading.Lock())
    with lock:
        lib = _LIBRARIES.get(key)
        if lib is None:
            target = path()
            try:
                lib = ctypes.CDLL(target)
            except OSError as exc:
                raise RuntimeError("could not load %s: %s" % (target, exc)) from exc
            _LIBRARIES[key] = lib
        return lib


def library_path(name):
    """The path of the library built from ``csrc/<name>.cu`` (built if
    needed)."""
    return _build(os.path.join(SOURCE_DIR, name + ".cu"), "nvcc", nvcc_path, NVCC_FLAGS)


def host_library_path(source):
    """The path of the library built with g++ from the C++ file ``source``
    (built if needed)."""
    return _build(os.path.abspath(source), "g++", gxx_path, GXX_FLAGS)


def _build(source, compiler, compiler_path, flags):
    """Compile ``source`` into ``_build/lib<name>-<hash>.so`` unless that
    file exists; ``compiler`` names the compiler in errors."""
    name = os.path.splitext(os.path.basename(source))[0]
    with open(source, "rb") as f:
        text = f.read()
    digest = hashlib.sha256(text + repr(flags).encode()).hexdigest()[:16]
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
        try:
            proc = subprocess.run(
                [compiler_path(), *flags, "-o", partial, source],
                capture_output=True,
                text=True,
                timeout=600,
            )
        except OSError as exc:
            raise RuntimeError("%s could not run on %s: %s" % (compiler, source, exc)) from exc
        if proc.returncode != 0:
            raise RuntimeError(
                "%s failed on %s (exit %d):\n%s%s"
                % (compiler, source, proc.returncode, proc.stdout, proc.stderr)
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
