"""dask_geomodeling_tpu_torch: the PyTorch and CUDA port.

It answers the JAX package's Block views (``dask_geomodeling_tpu``) with
the same values, on an NVIDIA GPU.  The views, their planning, the host
layers and the numpy processes are the JAX package's own; this package
adds torch twins of the process functions (raster/), a registry that maps
one to the other (registry.py), an executor and a batched tile runtime
(runtime/), and the hand-written CUDA kernels (csrc/, ops/).  It never
imports jax.

Entry points take an explicit ``device``; ``None`` reads
``geomodeling.torch-device`` (default ``"cuda"``), and CUDA without a
card raises.
"""
from dask_geomodeling_tpu_torch.device import resolve_device  # noqa: F401
from dask_geomodeling_tpu_torch.raster import get_data  # noqa: F401
from dask_geomodeling_tpu_torch.runtime.executor import compute_torch  # noqa: F401
from dask_geomodeling_tpu_torch.runtime.tiles import evaluate_tiled  # noqa: F401
