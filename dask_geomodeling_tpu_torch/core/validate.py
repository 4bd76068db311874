"""Shared constructor-argument guard (counterpart of
dask_geomodeling_tpu/core/validate.py)."""

__all__ = ["expect_instance"]


def expect_instance(value, types, label="argument"):
    """Return ``value`` when it is an instance of ``types``; otherwise
    raise the constructor-guard TypeError naming the offending type."""
    if isinstance(value, types):
        return value
    raise TypeError(
        "%s does not accept a '%s' here" % (label, type(value).__name__)
    )
