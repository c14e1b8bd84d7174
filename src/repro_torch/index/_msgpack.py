"""A MessagePack codec for the subset an index manifest uses.

nil, bool, int, float64, str, bin, array and map. ``packb`` writes the same
bytes as ``msgpack.packb`` with its defaults (the smallest int encoding,
floats as float64 ``0xcb``, str and bin kept apart); ``unpackb`` reads what
``msgpack.packb`` writes (arrays come back as lists, maps as dicts). The card
machine has no ``msgpack`` package, and the manifest must stay readable by
the JAX package, which writes and reads it with ``msgpack``.
"""

from __future__ import annotations

import struct


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return bytes([v & 0xFF])
    if v >= 0:
        for code, fmt, hi in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF), (0xCE, ">I", 0xFFFFFFFF),
                              (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= hi:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, lo in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000), (0xD2, ">i", -0x80000000),
                              (0xD3, ">q", -0x8000000000000000)):
            if v >= lo:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"integer {v} does not fit in 64 bits")


def _header(n: int, fix_base: int, fix_max: int, codes) -> bytes:
    """The length header of a str, bin, array or map of length ``n``."""
    if fix_base is not None and n < fix_max:
        return bytes([fix_base | n])
    for code, fmt, hi in codes:
        if n <= hi:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} does not fit in 32 bits")


_STR = ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF), (0xDB, ">I", 0xFFFFFFFF))
_BIN = ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF), (0xC6, ">I", 0xFFFFFFFF))
_ARRAY = ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))
_MAP = ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF))


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(int(obj)))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out.append(_header(len(data), 0xA0, 32, _STR) + data)
    elif isinstance(obj, (bytes, bytearray)):
        data = bytes(obj)
        out.append(_header(len(data), None, 0, _BIN) + data)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), 0x90, 16, _ARRAY))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_header(len(obj), 0x80, 16, _MAP))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """``obj`` as MessagePack bytes, equal to ``msgpack.packb(obj)``."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated MessagePack data")
        chunk = self.data[self.pos: self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        code = self.unpack(">B")
        if code < 0x80:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0x80 <= code <= 0x8F:
            return self.map(code & 0x0F)
        if 0x90 <= code <= 0x9F:
            return self.array(code & 0x0F)
        if 0xA0 <= code <= 0xBF:
            return self.text(code & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if code in fixed:
            return fixed[code]
        scalars = {0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if code in scalars:
            return self.unpack(scalars[code])
        sized = {0xD9: (">B", self.text), 0xDA: (">H", self.text), 0xDB: (">I", self.text),
                 0xC4: (">B", self.blob), 0xC5: (">H", self.blob), 0xC6: (">I", self.blob),
                 0xDC: (">H", self.array), 0xDD: (">I", self.array),
                 0xDE: (">H", self.map), 0xDF: (">I", self.map)}
        if code in sized:
            fmt, read = sized[code]
            return read(self.unpack(fmt))
        raise ValueError(f"MessagePack type 0x{code:02x} is outside the manifest subset")

    def text(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def blob(self, n: int) -> bytes:
        return bytes(self.take(n))

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(data: bytes):
    """The object that ``msgpack.packb`` wrote as ``data``."""
    reader = _Reader(data)
    obj = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes of extra data after the MessagePack object")
    return obj
