"""The port's MessagePack codec (``openvslam_tpu_torch/io/msgpack_codec.py``)
against the ``msgpack`` package: ``packb`` byte-identical to
``msgpack.packb(obj, use_bin_type=True)`` and ``unpackb`` equal to
``msgpack.unpackb(buf, raw=False)`` at every format boundary (ints at
+-2^5, 2^7, 2^8, 2^15, 2^16, 2^31, 2^32, 2^63 and 2^64-1; str and bin
lengths 31/32, 255/256, 65535/65536; arrays and maps of 15/16 and
65535/65536) and over random nested objects (hypothesis); numpy's scalars
other than float64, ext types, non-str map keys, truncated and trailing
input raise."""
import math

import hypothesis.strategies as st
import msgpack
import numpy as np
import pytest
from hypothesis import given, settings

from openvslam_tpu_torch.io.msgpack_codec import packb, unpackb


def _ref(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def _same(obj):
    buf = packb(obj)
    assert buf == _ref(obj)
    assert unpackb(buf) == msgpack.unpackb(buf, raw=False)
    return buf


_INTS = sorted({v for b in (5, 7, 8, 15, 16, 31, 32, 63) for s in (-1, 1)
                for v in (s * 2 ** b - 1, s * 2 ** b, s * 2 ** b + 1)
                if -2 ** 63 <= v <= 2 ** 64 - 1} | {0, 1, -1, 2 ** 64 - 1, 2 ** 64 - 2})


@pytest.mark.parametrize("v", _INTS)
def test_int_boundaries(v):
    _same(v)


@pytest.mark.parametrize("v", [2 ** 64, -2 ** 63 - 1])
def test_int_out_of_range(v):
    with pytest.raises(OverflowError):
        packb(v)
    with pytest.raises(OverflowError):
        _ref(v)


@pytest.mark.parametrize("n", [0, 1, 31, 32, 255, 256, 65535, 65536])
def test_str_and_bin_lengths(n):
    _same("a" * n)
    _same(b"\x01" * n)
    _same("é" * (n // 2))      # two UTF-8 bytes each


@pytest.mark.parametrize("n", [0, 15, 16, 65535, 65536])
def test_array_and_map_lengths(n):
    _same(list(range(n % 200)) * (n // 200) + list(range(n % 200)))
    _same({str(i): i for i in range(n)})


def test_scalars_containers_and_subclasses():
    for v in (None, True, False, 0.0, -0.0, 1.5, 1e300, math.inf, -math.inf, "", b"",
              (1, 2), [1, [2, [3]]], {"a": {"b": [b"c", None]}}, bytearray(b"xy"),
              memoryview(b"zw"), np.float64(2.5)):
        _same(v)
    nan = packb(math.nan)
    assert nan == _ref(math.nan) and math.isnan(unpackb(nan))
    assert unpackb(b"\xca\x3f\xc0\x00\x00") == 1.5         # float32 decodes
    assert unpackb(packb({b"k": 1})) == {b"k": 1}           # bytes keys allowed


@pytest.mark.parametrize("v", [np.float32(1.0), np.int64(3), np.int32(3), np.uint8(3),
                               np.bool_(True), 1 + 2j, {1, 2}, object()])
def test_unsupported_types_raise_as_msgpack(v):
    with pytest.raises(TypeError):
        packb(v)
    with pytest.raises(TypeError):
        _ref(v)


@pytest.mark.parametrize("buf", [b"\xd4\x01\x02", b"\xd6\xff\x00\x00\x00\x01",
                                 b"\xc7\x01\x05\x00", b"\xc1", b"\x92\x01",
                                 b"\x01\x02", b"\x81\x01\x02", b"\xda\x00\x05ab"])
def test_decoder_rejects(buf):
    """Ext types (msgpack returns ExtType/Timestamp; the map schemas have
    none), the never-used 0xc1, truncated input, trailing bytes and a
    non-str map key raise ValueError."""
    with pytest.raises(ValueError):
        unpackb(buf)


_keys = st.text(max_size=40)
_leaves = (st.none() | st.booleans() | st.integers(-2 ** 63, 2 ** 64 - 1)
           | st.floats(allow_nan=False) | st.text(max_size=300) | st.binary(max_size=300))
_objects = st.recursive(
    _leaves, lambda kids: st.lists(kids, max_size=20) | st.dictionaries(_keys, kids, max_size=20),
    max_leaves=60)


@settings(max_examples=300, deadline=None, database=None)
@given(_objects)
def test_nested_objects_match_msgpack(obj):
    _same(obj)
