"""The msgpack subset that checkpoint metadata uses, without the `msgpack`
package.

The subset: a map with str keys whose values are str, int, float, bool,
None, list or a nested map of the same. `encode(x)` gives the bytes that
`msgpack.packb(x)` gives (msgpack 1.x defaults: str as the str family,
ints in the narrowest type, floats as float64, the narrowest map/array
header), and `decode` reads them back. Anything outside the subset raises
TypeError (a type it does not carry) or ValueError (a value or a byte it
cannot represent).
"""
from __future__ import annotations

import struct

__all__ = ["encode", "decode"]


def _head(out: bytearray, n: int, fix: int, fix_max: int, w16: int,
          w32: int, what: str) -> None:
    if n <= fix_max:
        out.append(fix | n)
    elif n < 1 << 16:
        out += struct.pack(">BH", w16, n)
    elif n < 1 << 32:
        out += struct.pack(">BI", w32, n)
    else:
        raise ValueError(f"{what} of {n} entries is too long for msgpack")


def _int(out: bytearray, x: int) -> None:
    if x >= 0:
        if x < 0x80:
            out.append(x)
        elif x < 1 << 8:
            out += struct.pack(">BB", 0xCC, x)
        elif x < 1 << 16:
            out += struct.pack(">BH", 0xCD, x)
        elif x < 1 << 32:
            out += struct.pack(">BI", 0xCE, x)
        elif x < 1 << 64:
            out += struct.pack(">BQ", 0xCF, x)
        else:
            raise ValueError(f"integer {x} does not fit in msgpack")
    elif x >= -32:
        out += struct.pack(">b", x)
    elif x >= -(1 << 7):
        out += struct.pack(">Bb", 0xD0, x)
    elif x >= -(1 << 15):
        out += struct.pack(">Bh", 0xD1, x)
    elif x >= -(1 << 31):
        out += struct.pack(">Bi", 0xD2, x)
    elif x >= -(1 << 63):
        out += struct.pack(">Bq", 0xD3, x)
    else:
        raise ValueError(f"integer {x} does not fit in msgpack")


def _str(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    n = len(b)
    if n < 32:
        out.append(0xA0 | n)
    elif n < 1 << 8:
        out += struct.pack(">BB", 0xD9, n)
    else:
        _head(out, n, 0, -1, 0xDA, 0xDB, "str")
    out += b


def _encode(out: bytearray, x) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, int) and not isinstance(x, bool):
        _int(out, int(x))
    elif isinstance(x, float):
        out += struct.pack(">Bd", 0xCB, x)
    elif isinstance(x, str):
        _str(out, x)
    elif isinstance(x, list):
        _head(out, len(x), 0x90, 15, 0xDC, 0xDD, "array")
        for v in x:
            _encode(out, v)
    elif isinstance(x, dict):
        _head(out, len(x), 0x80, 15, 0xDE, 0xDF, "map")
        for k, v in x.items():
            if not isinstance(k, str):
                raise TypeError(f"map key {k!r} is not a str")
            _str(out, k)
            _encode(out, v)
    else:
        raise TypeError(f"{type(x).__name__} is outside the checkpoint's "
                        "msgpack subset")


def encode(x: dict) -> bytes:
    """`msgpack.packb(x)` for a map of the subset."""
    if not isinstance(x, dict):
        raise TypeError(f"top level must be a map, not {type(x).__name__}")
    out = bytearray()
    _encode(out, x)
    return bytes(out)


# fixed-width scalars: first byte -> struct format
_SCALARS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
            0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCB: ">d"}
# length-prefixed str / array / map: first byte -> (kind, length format)
_SIZED = {0xD9: ("string", ">B"), 0xDA: ("string", ">H"),
          0xDB: ("string", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:end]
        self.pos = end
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7F or b >= 0xE0:
            return b - 0x100 if b >= 0xE0 else b
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            return getattr(self, kind)(self.unpack(fmt))
        raise ValueError(f"msgpack type byte 0x{b:02x} is outside the "
                         "checkpoint's subset")

    def string(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            if not isinstance(k, str):
                raise ValueError(f"map key {k!r} is not a str")
            out[k] = self.value()
        return out


def decode(data: bytes) -> dict:
    """The map that `msgpack.packb` wrote as `data`."""
    r = _Reader(data)
    x = r.value()
    if not isinstance(x, dict):
        raise ValueError("top level is not a map")
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the map")
    return x
