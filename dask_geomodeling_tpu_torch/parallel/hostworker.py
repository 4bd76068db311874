"""Host-plane worker entry point.

Usage::

    python -m dask_geomodeling_tpu_torch.parallel.hostworker HOST:PORT [--token T]

Connects to a :class:`~dask_geomodeling_tpu_torch.parallel.hostpool.HostPool`
and executes task callables until the pool disconnects.  Counterpart of
dask_geomodeling_tpu/parallel/hostworker.py.
"""
import argparse

from dask_geomodeling_tpu_torch.parallel.hostpool import worker_main


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("address", help="scheduler address, host:port")
    parser.add_argument("--token", default="", help="shared pool secret")
    args = parser.parse_args(argv)
    worker_main(args.address, token=args.token)


if __name__ == "__main__":
    main()
