"""dask_geomodeling_tpu_torch: the PyTorch and CUDA port.

It stands on its own: its own Block views (raster/ and geometry/),
planner, CRS subset, geometry engine, pandas-free feature frame, numpy
processes and host layers, each at the same relative path as its
counterpart in the JAX package (``dask_geomodeling_tpu``), of which it
imports nothing.  It adds torch twins of the process functions (raster/),
the device plane of zonal statistics (ops/segment.py), a registry that
maps one to the other (registry.py), an executor and a batched tile
runtime (runtime/), the hand-written CUDA kernels (csrc/, ops/), and
``from_reference`` (convert.py), which carries a serialized view of the
JAX package across.

Entry points take an explicit ``device``; ``None`` reads
``geomodeling.torch-device`` (default ``"cuda"``), and CUDA without a
card raises.
"""
from dask_geomodeling_tpu_torch.convert import from_reference  # noqa: F401
from dask_geomodeling_tpu_torch.device import resolve_device  # noqa: F401
from dask_geomodeling_tpu_torch.raster import get_data  # noqa: F401
from dask_geomodeling_tpu_torch.runtime.executor import compute_torch  # noqa: F401
from dask_geomodeling_tpu_torch.runtime.host import compute_host  # noqa: F401
from dask_geomodeling_tpu_torch.runtime.tiles import evaluate_tiled  # noqa: F401
