"""File URL sandboxing: the port's copy of
dask_geomodeling_tpu/geo/safefiles.py.

Paths are file:// only; relative paths resolve against
``config["geomodeling.root"]``; with ``geomodeling.strict-file-paths`` the
resolved path must stay inside the root.
"""
import os
import warnings

from dask_geomodeling_tpu_torch.config import config

__all__ = ["safe_file_url", "safe_abspath"]


def _split_protocol(url):
    """``(protocol, path)`` for a URL; bare paths count as ``file``."""
    parts = url.split("://")
    if len(parts) != 2:
        return "file", url
    if parts[0] != "file":
        raise NotImplementedError('Unknown protocol: "{}"'.format(parts[0]))
    return parts[0], parts[1]


def _sandbox_root(start):
    """The effective sandbox root, honouring the deprecated ``start`` arg."""
    if start is None:
        return config.get("geomodeling.root")
    warnings.warn(
        "Using the start argument in safe_file_url is deprecated. Use "
        "'geomodeling.root' in the config",
        DeprecationWarning,
    )
    return start


def safe_file_url(url, start=None):
    """Normalize a file URL, enforcing the sandbox rules."""
    protocol, path = _split_protocol(url)
    root = _sandbox_root(start)

    if os.path.isabs(path):
        resolved = os.path.abspath(path)
    elif root is None:
        raise IOError(
            "Relative path '{}' provided but start was not given.".format(path)
        )
    else:
        resolved = os.path.abspath(os.path.join(root, path))

    if config.get("geomodeling.strict-file-paths"):
        if not resolved.startswith(root):
            raise IOError("'{}' is not contained in '{}'".format(path, root))
    return "{}://{}".format(protocol, resolved)


def safe_abspath(url, start=None):
    """Like :func:`safe_file_url` but returns only the absolute path."""
    url = safe_file_url(url, start)
    _, path = url.split("://")
    return path
