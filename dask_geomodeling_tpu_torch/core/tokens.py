"""Deterministic content-addressed hashing ("tokens").

Counterpart of dask_geomodeling_tpu/core/tokens.py:tokenize: values are
normalised to a canonical byte stream and hashed with BLAKE2b-128, giving
a 32-char hex token that is the same across processes and runs, so Block
names serve as graph keys.  Objects without a canonical form get a random
token (dask's semantics), unless a normalizer is registered for their
class (``register_normalizer``, looked up along the MRO before anything
else an object offers) or they define ``__token__``.
"""
import dataclasses
import datetime
import hashlib
import struct
import types
import uuid
import warnings

import numpy as np

__all__ = ["tokenize", "normalize_token", "register_normalizer"]

_NORMALIZERS = {}


def register_normalizer(cls):
    """Class decorator registry: ``@register_normalizer(MyType)`` makes
    the decorated function's result stand for an instance of ``MyType``
    (or of a subclass) in its token."""

    def decorator(func):
        _NORMALIZERS[cls] = func
        return func

    return decorator


def tokenize(*args):
    """Return a 32-char hex token that is deterministic in the arguments."""
    h = hashlib.blake2b(digest_size=16)
    _feed(h, args)
    return h.hexdigest()


def normalize_token(value):
    """The token of a single value (``tokenize(value)`` hashes the tuple
    of its arguments)."""
    h = hashlib.blake2b(digest_size=16)
    _feed(h, value)
    return h.hexdigest()


def _feed(h, value):
    # ordered by expected frequency
    if value is None:
        h.update(b"\x00N")
    elif isinstance(value, (bool, np.bool_)):  # before int (bool subclasses int)
        h.update(b"\x00B" + (b"1" if value else b"0"))
    elif isinstance(value, (np.datetime64, np.timedelta64)):
        # before np.integer: timedelta64 subclasses np.signedinteger
        h.update(b"\x00n" + value.dtype.str.encode() + value.tobytes())
    elif isinstance(value, (int, np.integer)):
        h.update(b"\x00i" + str(int(value)).encode())
    elif isinstance(value, (float, np.floating)):
        h.update(b"\x00f" + struct.pack("<d", float(value)))
    elif isinstance(value, str):
        h.update(b"\x00s" + value.encode("utf-8"))
    elif isinstance(value, bytes):
        h.update(b"\x00b" + value)
    elif isinstance(value, (list, tuple)):
        h.update(b"\x00L" if isinstance(value, list) else b"\x00t")
        h.update(b"%d[" % len(value))
        for item in value:
            _feed(h, item)
            h.update(b",")
        h.update(b"]")
    elif isinstance(value, dict):
        h.update(b"\x00D{")
        for key in sorted(value, key=repr):
            _feed(h, key)
            h.update(b":")
            _feed(h, value[key])
            h.update(b",")
        h.update(b"}")
    elif isinstance(value, (set, frozenset)):
        h.update(b"\x00S{")
        for item in sorted(value, key=repr):
            _feed(h, item)
            h.update(b",")
        h.update(b"}")
    elif isinstance(value, datetime.datetime):
        h.update(b"\x00dt" + value.isoformat().encode())
        if value.tzinfo is not None:
            h.update(str(value.utcoffset()).encode())
    elif isinstance(value, datetime.timedelta):
        h.update(b"\x00td" + struct.pack("<d", value.total_seconds()))
    elif isinstance(value, datetime.date):
        h.update(b"\x00d" + value.isoformat().encode())
    elif isinstance(value, np.dtype):
        h.update(b"\x00y" + value.str.encode())
    elif isinstance(value, np.ndarray):
        h.update(b"\x00a" + value.dtype.str.encode())
        h.update(str(value.shape).encode())
        if value.dtype == object:
            _feed(h, value.ravel().tolist())
        else:
            h.update(np.ascontiguousarray(value).tobytes())
    elif isinstance(value, complex):
        h.update(b"\x00c" + struct.pack("<dd", value.real, value.imag))
    elif isinstance(value, slice):
        _feed(h, ("__slice__", value.start, value.stop, value.step))
    elif isinstance(value, np.generic):
        # any remaining numpy scalar: unit-exact via dtype + raw bytes
        h.update(b"\x00g" + value.dtype.str.encode() + value.tobytes())
    elif isinstance(value, type):
        h.update(b"\x00T%s.%s" % (value.__module__.encode(), value.__qualname__.encode()))
    elif isinstance(
        value,
        (types.FunctionType, types.BuiltinFunctionType, types.MethodType),
    ):
        # plain functions hash by qualname; callable instances fall through
        # to _feed_object, where a registered normalizer or __token__ wins
        _feed_callable(h, value)
    else:
        _feed_object(h, value)


def _feed_callable(h, value):
    h.update(
        b"\x00F%s.%s"
        % (
            getattr(value, "__module__", "?").encode(),
            getattr(value, "__qualname__", repr(value)).encode(),
        )
    )


def _feed_object(h, value):
    # the registry along the MRO first, as dask dispatches
    for cls in type(value).__mro__:
        func = _NORMALIZERS.get(cls)
        if func is not None:
            h.update(b"\x00O")
            _feed(h, func(value))
            return
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        h.update(b"\x00C")
        _feed(
            h,
            (
                type(value).__module__ + "." + type(value).__qualname__,
                {
                    f.name: getattr(value, f.name)
                    for f in dataclasses.fields(value)
                },
            ),
        )
        return
    token = getattr(value, "__token__", None)
    if token is not None:
        h.update(b"\x00O")
        _feed(h, token() if callable(token) else token)
        return
    # stateless callable instances (no __token__): qualname
    if callable(value):
        _feed_callable(h, value)
        return
    # fallback: random token (dask's semantics for untokenizable input)
    warnings.warn(
        "Cannot tokenize object of type %r; using a random token" % type(value),
        stacklevel=3,
    )
    h.update(b"\x00R" + uuid.uuid4().bytes)
