"""The host schedulers' disk spill (spill.py) and the multi-machine
host-plane worker pool (hostpool.py, hostworker.py); the multi-GPU modules
of the JAX package's parallel/ (mesh, halo, distributed) are not ported."""
from dask_geomodeling_tpu_torch.parallel.hostpool import HostPool  # noqa: F401
