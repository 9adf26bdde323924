"""The subset of MessagePack that flax's checkpoints use, without msgpack.

``gcc_tpu`` writes checkpoints with ``flax.serialization.msgpack_serialize``:
a msgpack map whose arrays are extension 1 (``ndarray``: the msgpack of
(shape, dtype name, C-order bytes)) and whose numpy scalars are extension 3
(``npscalar``, the same body); flax splits arrays over 2**30 bytes into
``__msgpack_chunked_array__`` maps, which this module reads and does not
write (the port's largest tensor is far smaller). It writes the bytes
``msgpack_serialize`` writes (map keys sorted; the smallest encoding of
every int, str and container, as msgpack-python chooses) and reads them
as ``msgpack_restore`` does: strings as ``str``, binaries as ``bytes``,
arrays as writable numpy arrays.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"


# ----------------------------------------------------------------- writing

def _head(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: the fix form below fix_max, else 8/16/32-bit."""
    if n < fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _pack_int(out: bytearray, x: int) -> None:
    if -32 <= x < 128:
        out += struct.pack(">b" if x < 0 else ">B", x)
    elif x >= 0:
        for code, fmt, top in ((0xcc, ">BB", 1 << 8), (0xcd, ">BH", 1 << 16),
                               (0xce, ">BI", 1 << 32), (0xcf, ">BQ", 1 << 64)):
            if x < top:
                out += struct.pack(fmt, code, x)
                return
        raise OverflowError(x)
    else:
        for code, fmt, low in ((0xd0, ">Bb", -(1 << 7)),
                               (0xd1, ">Bh", -(1 << 15)),
                               (0xd2, ">Bi", -(1 << 31)),
                               (0xd3, ">Bq", -(1 << 63))):
            if x >= low:
                out += struct.pack(fmt, code, x)
                return
        raise OverflowError(x)


def _pack_ndarray(out: bytearray, code: int, arr: np.ndarray) -> None:
    """Extension ``code`` around the msgpack of (shape, dtype name, C-order
    bytes); the array's bytes are copied once, into ``out``."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be stored")
    data = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    head = bytearray(b"\x93")  # a 3-element array
    _pack(list(arr.shape), head)
    _pack(arr.dtype.name, head)
    _head(head, data.size, 0, 0, (0xc4, 0xc5, 0xc6))
    n = len(head) + data.size
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out += struct.pack(">Bb", fixed[n], code)
    elif n < 1 << 8:
        out += struct.pack(">BBb", 0xc7, n, code)
    elif n < 1 << 16:
        out += struct.pack(">BHb", 0xc8, n, code)
    else:
        out += struct.pack(">BIb", 0xc9, n, code)
    out += head
    out += data.data


def _pack(o: Any, out: bytearray) -> None:
    t = type(o)
    if o is None:
        out.append(0xc0)
    elif t is bool:
        out.append(0xc3 if o else 0xc2)
    elif t is int:
        _pack_int(out, o)
    elif t is float:
        out += struct.pack(">Bd", 0xcb, o)
    elif t is str:
        b = o.encode("utf-8")
        _head(out, len(b), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out += b
    elif t in (bytes, bytearray):
        _head(out, len(o), 0, 0, (0xc4, 0xc5, 0xc6))
        out += o
    elif t in (list, tuple):
        _head(out, len(o), 0x90, 16, (None, 0xdc, 0xdd))
        for v in o:
            _pack(v, out)
    elif t is dict:
        _head(out, len(o), 0x80, 16, (None, 0xde, 0xdf))
        for k in sorted(o):  # flax's tree_map copy sorts every map's keys
            _pack(k, out)
            _pack(o[k], out)
    elif isinstance(o, np.ndarray):
        if o.nbytes > MAX_CHUNK_SIZE:
            raise ValueError(f"an array of {o.nbytes} bytes: flax would "
                             f"chunk it, which this writer does not")
        _pack_ndarray(out, EXT_NDARRAY, o)
    elif isinstance(o, np.generic):
        _pack_ndarray(out, EXT_NPSCALAR, np.asarray(o))
    else:
        raise TypeError(f"cannot serialize {t.__name__}")


def packb(tree: Any) -> bytearray:
    out = bytearray()
    _pack(tree, out)
    return out


# ----------------------------------------------------------------- reading

class _Reader:
    def __init__(self, data, raw: bool):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        v = self.data[self.pos:self.pos + n]
        self.pos += n
        return v

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.num(">b")
        body = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray_from(body)
        if code == EXT_NPSCALAR:
            return _ndarray_from(body)[()]
        raise ValueError(f"unknown msgpack extension type {code}")

    def value(self):
        c = self.num(">B")
        if c <= 0x7f:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self.map(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return [self.value() for _ in range(c & 0x0f)]
        if 0xa0 <= c <= 0xbf:
            return self.string(c & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if c in simple:
            return simple[c]
        ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
                0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
        if c in ints:
            return self.num(ints[c])
        sizes = {0: ">B", 1: ">H", 2: ">I"}
        if 0xc4 <= c <= 0xc6:
            return bytes(self.take(self.num(sizes[c - 0xc4])))
        if 0xd9 <= c <= 0xdb:
            return self.string(self.num(sizes[c - 0xd9]))
        if c in (0xdc, 0xdd):
            return [self.value() for _ in range(self.num(sizes[c - 0xdb]))]
        if c in (0xde, 0xdf):
            return self.map(self.num(sizes[c - 0xdd]))
        if 0xd4 <= c <= 0xd8:
            return self.ext(1 << (c - 0xd4))
        if 0xc7 <= c <= 0xc9:
            return self.ext(self.num(sizes[c - 0xc7]))
        raise ValueError(f"invalid msgpack byte 0x{c:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _ndarray_from(body: memoryview) -> np.ndarray:
    """(shape, dtype name, bytes) -> a writable array; the bytes are copied
    once, out of the file's buffer."""
    r = _Reader(body, raw=True)
    if r.num(">B") != 0x93:
        raise ValueError("an ndarray extension must hold a 3-element array")
    shape, dtype = r.value(), r.value()
    c = r.num(">B")
    if not 0xc4 <= c <= 0xc6:
        raise ValueError("an ndarray extension must hold its bytes as bin")
    buf = r.take(r.num({0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}[c]))
    if r.pos != len(body):
        raise ValueError("extra data in an ndarray extension")
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def _unchunk(tree):
    if isinstance(tree, dict):
        if CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes, raw: bool = False) -> Any:
    """One msgpack object from ``data``, which it must fill exactly."""
    r = _Reader(data, raw)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes of extra data")
    return out


def restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore``: chunked arrays joined."""
    return _unchunk(unpackb(data))

