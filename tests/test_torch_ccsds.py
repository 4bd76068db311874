"""The port's CCSDS coder binding (io/ccsds.py), held on the CPU to the JAX
package's.

Both modules bind the same system libraries (``libsz`` for szip,
``libaec`` for AEC) with ctypes: the port's encoders write the JAX
encoders' bytes, byte for byte, and its decoders give back the data
encoded, for every bit width and option the HDF4 and GRIB2 layouts use
and under hypothesis.  With a library set to None in both packages
(monkeypatched), every call raises the same named ValueError, and a
failing call the same coder error; a library that cannot be loaded
leaves ``_load`` answering None, so an import never fails.  The round
trips skip where the library cannot be loaded, as the JAX package's
own tests do.
"""
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dask_geomodeling_tpu.io import ccsds as jax_ccsds
from dask_geomodeling_tpu_torch.io import ccsds


@pytest.fixture
def libsz():
    if not jax_ccsds.szip_available():
        pytest.skip("libsz not loadable")


@pytest.fixture
def libaec():
    if not jax_ccsds.aec_available():
        pytest.skip("libaec not loadable")


NN, EC, MSB, K13 = 32, 4, 16, 1
#: AEC flags (libaec.h): signed, 3-byte samples, MSB first, preprocessing
AEC_SIGNED, AEC_3BYTE, AEC_MSB, AEC_PREPROCESS = 1, 2, 4, 8


def outcome(call):
    """What ``call()`` gives: its result, or its error's type and message."""
    try:
        return "result", call()
    except Exception as raised:  # the same error in both packages
        return "error", (type(raised).__name__, str(raised))


def _samples(bits, n, seed):
    rng = np.random.RandomState(seed)
    dtype = {8: ">u1", 16: ">u2", 32: ">u4"}[bits]
    smooth = np.cumsum(rng.randint(-3, 4, n)) % (2 ** min(bits, 20))
    return smooth.astype(dtype).tobytes()


@pytest.mark.parametrize("bits, options, block, scanline", [
    (8, NN | EC | K13, 8, 16), (8, EC, 16, 64), (16, NN | EC | MSB | K13, 16, 32),
    (16, NN | EC | MSB | K13, 32, 480), (16, NN | MSB, 8, 100), (32, NN | EC | MSB, 32, 64),
])
def test_szip_round_trip_equals_jax(libsz, bits, options, block, scanline):
    """The port's szip_compress writes the JAX encoder's bytes, and each
    package's szip_decompress gives the data back."""
    data = _samples(bits, scanline * 12, bits + block)
    coded = ccsds.szip_compress(data, options, bits, block, scanline)
    assert coded == jax_ccsds.szip_compress(data, options, bits, block, scanline)
    ours = ccsds.szip_decompress(coded, len(data), options, bits, block, scanline)
    assert ours == jax_ccsds.szip_decompress(coded, len(data), options, bits, block, scanline)
    assert ours == data


@pytest.mark.parametrize("bits, block, rsi, flags", [
    (8, 16, 128, AEC_PREPROCESS), (12, 32, 64, AEC_PREPROCESS | AEC_MSB),
    (16, 32, 128, AEC_PREPROCESS | AEC_MSB), (16, 8, 16, AEC_MSB),
    (24, 16, 32, AEC_PREPROCESS | AEC_MSB | AEC_3BYTE), (32, 64, 4096, AEC_PREPROCESS | AEC_MSB),
    (16, 16, 32, AEC_PREPROCESS | AEC_MSB | AEC_SIGNED),
])
def test_aec_round_trip_equals_jax(libaec, bits, block, rsi, flags):
    """The port's aec_encode writes the JAX encoder's bytes, and each
    package's aec_decode gives the data back (GRIB2 template 5.42's
    parameters: bits per sample, block size, reference sample interval
    and the flags octet)."""
    width = 1 if bits <= 8 else 2 if bits <= 16 else 3 if flags & AEC_3BYTE else 4
    rng = np.random.RandomState(bits + block)
    values = np.cumsum(rng.randint(-5, 6, 3000)) % (2 ** min(bits, 20))
    data = b"".join(int(v).to_bytes(width, "big") for v in values)
    coded = ccsds.aec_encode(data, bits, block, rsi, flags)
    assert coded == jax_ccsds.aec_encode(data, bits, block, rsi, flags)
    ours = ccsds.aec_decode(coded, len(data), bits, block, rsi, flags)
    assert ours == jax_ccsds.aec_decode(coded, len(data), bits, block, rsi, flags)
    assert ours == data


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.function_scoped_fixture])
@given(st.sampled_from([8, 16]), st.sampled_from([8, 16, 32]), st.integers(1, 64),
       st.integers(1, 40), st.booleans(), st.integers(0, 2**32 - 1))
def test_szip_under_hypothesis(libsz, bits, block, scanline_blocks, rows, nn, seed):
    """Any scanline of whole blocks and any rows of smooth or random
    samples: the same bytes from both encoders, the data back from both
    decoders."""
    scanline = block * scanline_blocks
    options = EC | K13 | (NN if nn else 0) | (MSB if bits == 16 else 0)
    rng = np.random.RandomState(seed)
    data = rng.randint(0, 2**bits, scanline * rows).astype(">u%d" % (bits // 8)).tobytes()
    coded = ccsds.szip_compress(data, options, bits, block, scanline)
    assert coded == jax_ccsds.szip_compress(data, options, bits, block, scanline)
    assert ccsds.szip_decompress(coded, len(data), options, bits, block, scanline) == data


@settings(max_examples=80, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(st.binary(max_size=200), st.integers(1, 600), st.sampled_from([8, 16, 32]),
       st.sampled_from([8, 16, 32]))
def test_szip_decompress_any_bytes_as_jax(libsz, data, size, bits, block):
    """Arbitrary bytes: the same bytes or the same coder error."""
    args = (data, size, NN | EC | MSB, bits, block, block * 4)
    ours = outcome(lambda: ccsds.szip_decompress(*args))
    theirs = outcome(lambda: jax_ccsds.szip_decompress(*args))
    assert ours == theirs


@settings(max_examples=80, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(st.binary(max_size=200), st.integers(1, 600), st.sampled_from([8, 16, 32]),
       st.sampled_from([8, 16, 32]), st.sampled_from([AEC_PREPROCESS | AEC_MSB, AEC_MSB]))
def test_aec_decode_any_bytes_as_jax(libaec, data, size, bits, block, flags):
    """Arbitrary bytes: the same bytes or the same coder error."""
    args = (data, size, bits, block, 64, flags)
    ours = outcome(lambda: ccsds.aec_decode(*args))
    theirs = outcome(lambda: jax_ccsds.aec_decode(*args))
    assert ours == theirs


def test_szip_coder_error_as_jax(libsz):
    """Parameters libsz refuses (an odd block size): the same error."""
    args = (b"\x00" * 64, NN | EC, 8, 7, 16)
    ours = outcome(lambda: ccsds.szip_compress(*args))
    assert ours[0] == "error" and ours == outcome(lambda: jax_ccsds.szip_compress(*args))


@pytest.mark.parametrize("call", [
    ("szip_decompress", (b"\x00" * 8, 16, NN | EC, 8, 8, 16)),
    ("szip_compress", (b"\x00" * 16, NN | EC, 8, 8, 16)),
])
def test_no_libsz_names_it(monkeypatch, call):
    """Without libsz both packages raise the same named ValueError."""
    name, args = call
    for module in (ccsds, jax_ccsds):
        monkeypatch.setattr(module, "_libsz", None)
    assert not ccsds.szip_available() and not jax_ccsds.szip_available()
    ours = outcome(lambda: getattr(ccsds, name)(*args))
    assert ours[0] == "error" and ours[1][0] == "ValueError"
    assert ours == outcome(lambda: getattr(jax_ccsds, name)(*args))
    if name == "szip_decompress":
        assert "libsz" in ours[1][1]


@pytest.mark.parametrize("call", [
    ("aec_decode", (b"\x00" * 8, 16, 16, 32, 128, AEC_MSB)),
    ("aec_encode", (b"\x00" * 16, 16, 32, 128, AEC_MSB)),
])
def test_no_libaec_names_it(monkeypatch, call):
    """Without libaec both packages raise the same named ValueError."""
    name, args = call
    for module in (ccsds, jax_ccsds):
        monkeypatch.setattr(module, "_libaec", None)
    assert not ccsds.aec_available() and not jax_ccsds.aec_available()
    ours = outcome(lambda: getattr(ccsds, name)(*args))
    assert ours == ("error", ("ValueError", "CCSDS/AEC-packed data needs the system libaec, "
                                           "which is not loadable here"))
    assert ours == outcome(lambda: getattr(jax_ccsds, name)(*args))


def test_a_missing_library_loads_as_none():
    """``_load`` answers None when no candidate loads: the module imports,
    its library None, and the calls raise the named errors above."""
    assert ccsds._load(["libno-such-coder.so.9", "libno-such-coder.so"]) is None
    assert jax_ccsds._load(["libno-such-coder.so.9"]) is None
    assert ccsds.szip_available() == jax_ccsds.szip_available()
    assert ccsds.aec_available() == jax_ccsds.aec_available()
