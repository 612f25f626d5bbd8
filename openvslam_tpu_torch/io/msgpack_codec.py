"""MessagePack encoder and decoder for the map schemas (no JAX counterpart).

``packb(obj)`` writes the bytes ``msgpack.packb(obj, use_bin_type=True)``
writes, and ``unpackb(buf)`` returns what ``msgpack.unpackb(buf,
raw=False)`` returns, over the types the two map schemas use: ``None``,
``bool``, ``int`` (int64 and uint64 range), ``float``, ``str``, ``bytes``
(and ``bytearray`` / ``memoryview``), ``list`` / ``tuple`` and ``dict``.
Each choice is msgpack's: the smallest integer format (fixints included), a
float as float64, ``str`` as fixstr/str8/16/32 in UTF-8, bytes as
bin8/16/32, arrays and maps as fix/16/32 with maps in insertion order.
Subclasses of these types pack as their base (``numpy.float64`` is a
``float``); any other type, numpy's other scalars included, raises
TypeError, and an integer out of range OverflowError, as msgpack does.

The decoder takes float32 too, returns str for str and bytes for bin, and
raises ValueError on an ext type, a map key that is not str or bytes
(msgpack's ``strict_map_key``), truncated input or trailing bytes.

This is the port's only route to disk for maps: the same codec on every
machine, with or without the ``msgpack`` package.
"""
from __future__ import annotations

import struct

_pack_d = struct.Struct(">d").pack
_pack_B = struct.Struct(">B").pack
_pack_H = struct.Struct(">H").pack
_pack_I = struct.Struct(">I").pack
_pack_Q = struct.Struct(">Q").pack
_pack_b = struct.Struct(">b").pack
_pack_h = struct.Struct(">h").pack
_pack_i = struct.Struct(">i").pack
_pack_q = struct.Struct(">q").pack


def _int(v: int, out: list):
    if 0 <= v:
        if v < 0x80:
            out.append(_pack_B(v))
        elif v <= 0xFF:
            out.append(b"\xcc" + _pack_B(v))
        elif v <= 0xFFFF:
            out.append(b"\xcd" + _pack_H(v))
        elif v <= 0xFFFFFFFF:
            out.append(b"\xce" + _pack_I(v))
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out.append(b"\xcf" + _pack_Q(v))
        else:
            raise OverflowError("Integer value out of range")
    elif v >= -32:
        out.append(_pack_b(v))
    elif v >= -0x80:
        out.append(b"\xd0" + _pack_b(v))
    elif v >= -0x8000:
        out.append(b"\xd1" + _pack_h(v))
    elif v >= -0x80000000:
        out.append(b"\xd2" + _pack_i(v))
    elif v >= -0x8000000000000000:
        out.append(b"\xd3" + _pack_q(v))
    else:
        raise OverflowError("Integer value out of range")


def _len_header(n: int, fix: int, fix_max: int, c8, c16: bytes, c32: bytes, out: list):
    if n < fix_max:
        out.append(_pack_B(fix | n))
    elif c8 is not None and n <= 0xFF:
        out.append(c8 + _pack_B(n))
    elif n <= 0xFFFF:
        out.append(c16 + _pack_H(n))
    elif n <= 0xFFFFFFFF:
        out.append(c32 + _pack_I(n))
    else:
        raise ValueError(f"object too large for msgpack: {n} entries or bytes")


def _bin_header(n: int, out: list):
    if n <= 0xFF:
        out.append(b"\xc4" + _pack_B(n))
    elif n <= 0xFFFF:
        out.append(b"\xc5" + _pack_H(n))
    elif n <= 0xFFFFFFFF:
        out.append(b"\xc6" + _pack_I(n))
    else:
        raise ValueError(f"bytes too large for msgpack: {n}")


def _pack(obj, out: list):
    # bool before int (bool is an int); subclasses pack as their base type
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + _pack_d(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _len_header(len(raw), 0xA0, 32, b"\xd9", b"\xda", b"\xdb", out)
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _bin_header(len(raw), out)
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _len_header(len(obj), 0x90, 16, None, b"\xdc", b"\xdd", out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _len_header(len(obj), 0x80, 16, None, b"\xde", b"\xdf", out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """``obj`` as MessagePack bytes (msgpack's ``packb(obj, use_bin_type=True)``)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------
_FIXED = {  # type byte -> (struct format, size)
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_FIXED = {k: (struct.Struct(f).unpack_from, n) for k, (f, n) in _FIXED.items()}
_LEN = {  # type byte -> (kind, length-field struct, its size)
    0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
    0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
    0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
    0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4),
}
_LEN = {k: (kind, struct.Struct(f).unpack_from, n) for k, (kind, f, n) in _LEN.items()}
_EXT = frozenset((0xC7, 0xC8, 0xC9, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8))


class _Reader:
    __slots__ = ("buf", "pos", "end")

    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0
        self.end = len(self.buf)

    def need(self, n: int):
        if self.pos + n > self.end:
            raise ValueError("Unpack failed: incomplete input")

    def take(self, n: int) -> memoryview:
        self.need(n)
        p = self.pos
        self.pos = p + n
        return self.buf[p:p + n]

    def obj(self):
        self.need(1)
        b = self.buf[self.pos]
        self.pos += 1
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        fixed = _FIXED.get(b)
        if fixed is not None:
            unpack, n = fixed
            self.need(n)
            v = unpack(self.buf, self.pos)[0]
            self.pos += n
            return v
        ln = _LEN.get(b)
        if ln is not None:
            kind, unpack, n = ln
            self.need(n)
            size = unpack(self.buf, self.pos)[0]
            self.pos += n
            if kind == "str":
                return self.str_(size)
            if kind == "bin":
                return bytes(self.take(size))
            if kind == "array":
                return self.array(size)
            return self.map_(size)
        if b in _EXT:
            raise ValueError(f"msgpack ext type (0x{b:02x}) is not supported")
        raise ValueError(f"invalid msgpack type byte 0x{b:02x}")

    def str_(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"{type(k).__name__} is not allowed for map key")
            out[k] = self.obj()
        return out


def unpackb(buf):
    """The object of one MessagePack document (msgpack's ``unpackb(buf,
    raw=False)``); raises ValueError on trailing bytes."""
    r = _Reader(buf)
    obj = r.obj()
    if r.pos != r.end:
        raise ValueError(f"unpackb received extra data ({r.end - r.pos} bytes)")
    return obj
