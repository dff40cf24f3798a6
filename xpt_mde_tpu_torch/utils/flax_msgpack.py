"""The flax checkpoint codec, written with ``struct`` and numpy only.

The JAX package stores converted backbone weights (and its checkpoints)
with ``flax.serialization.to_bytes``: msgpack of a nested dict whose keys
are strings, in the dict's own order, and whose leaves are numpy arrays
(msgpack ext type 1 holding the msgpack array ``[shape, dtype name,
C-order bytes]``), numpy scalars (ext type 3, the same payload) or
Python scalars. :func:`to_bytes` writes that subset byte for byte as
flax does and :func:`from_bytes` reads it back, so that the port reads
and writes ``<datapath>/pretrained/<net>.msgpack`` without flax or the
``msgpack`` package.

flax splits an array of more than ``MAX_CHUNK_SIZE`` bytes into chunks;
no backbone comes near it (NASNetLarge is ~0.35 GB in float32), so
:func:`to_bytes` refuses such an array, and :func:`from_bytes` joins
chunks where it meets them.
"""

from __future__ import annotations

import struct
from typing import Any, Mapping

import numpy as np

MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE, bytes
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


def _header(out: bytearray, n: int, fix: int | None, fix_max: int, codes) -> None:
    """A length header: a fix form below ``fix_max``, else the narrowest of
    ``codes`` (8-, 16- and 32-bit lengths; None where msgpack has no such
    form)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of {n} items or bytes is too large")


def _pack_int(out: bytearray, value: int) -> None:
    if 0 <= value < 0x80:
        out.append(value)
    elif -32 <= value < 0:
        out += struct.pack(">b", value)
    elif value >= 0:
        for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                 (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2 ** 64 - 1)):
            if value <= limit:
                out.append(code)
                out += struct.pack(fmt, value)
                return
        raise OverflowError(f"integer {value} does not fit msgpack")
    else:
        for code, fmt, limit in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                                 (0xD2, ">i", -0x80000000), (0xD3, ">q", -2 ** 63)):
            if value >= limit:
                out.append(code)
                out += struct.pack(fmt, value)
                return
        raise OverflowError(f"integer {value} does not fit msgpack")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _header(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    """``msgpack.packb((shape, dtype name, bytes), use_bin_type=True)``."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    out = bytearray()
    _header(out, 3, 0x90, 16, (None, 0xDC, 0xDD))
    _header(out, arr.ndim, 0x90, 16, (None, 0xDC, 0xDD))
    for dim in arr.shape:
        _pack_int(out, int(dim))
    _pack(out, arr.dtype.name)
    data = arr.tobytes("C")
    _header(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
    out += data
    return bytes(out)


def _pack(out: bytearray, obj: Any, path: str = "") -> None:
    # exact types, as msgpack's strict_types: numpy scalars subclass float
    # and go to the ext form
    kind = type(obj)
    if obj is None:
        out.append(0xC0)
    elif kind is bool:
        out.append(0xC3 if obj else 0xC2)
    elif kind is int:
        _pack_int(out, obj)
    elif kind is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif kind is str:
        data = obj.encode("utf-8")
        _header(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif kind in (bytes, bytearray):
        _header(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif kind is dict:
        _header(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for key, value in obj.items():
            _pack(out, str(key))
            _pack(out, value, f"{path}/{key}")
    elif isinstance(obj, np.ndarray):
        if obj.size * obj.dtype.itemsize > MAX_CHUNK_SIZE:
            raise ValueError(f"{path or 'array'}: {obj.size * obj.dtype.itemsize} bytes pass "
                             f"flax's chunk limit of {MAX_CHUNK_SIZE} bytes (2**30); chunked "
                             "arrays are not written")
        _pack_ext(out, _EXT_NDARRAY, _ndarray_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)))
    else:  # flax writes lists and tuples as dicts: outside the subset
        raise TypeError(f"{path or 'value'}: cannot serialize {kind.__name__}")


def to_bytes(tree: Mapping[str, Any]) -> bytes:
    """``flax.serialization.to_bytes(tree)`` for a nested dict of numpy
    arrays and scalars (string keys, written in the dict's order)."""
    out = bytearray()
    _pack(out, dict(tree))
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        code = self.unpack(">B")
        if code < 0x80:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0x80 <= code <= 0x8F:
            return self._map(code & 0x0F)
        if 0x90 <= code <= 0x9F:
            return [self.read() for _ in range(code & 0x0F)]
        if 0xA0 <= code <= 0xBF:
            return str(self.take(code & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if code in simple:
            return simple[code]
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                   0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                   0xC9: ">I"}
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if code in numbers:
            return self.unpack(numbers[code])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if code in fixext:
            return self._ext(fixext[code])
        if code not in lengths:
            raise ValueError(f"unsupported msgpack type byte 0x{code:02x}")
        n = self.unpack(lengths[code])
        if code in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(n))
        if code in (0xD9, 0xDA, 0xDB):
            return str(self.take(n), "utf-8")
        if code in (0xDC, 0xDD):
            return [self.read() for _ in range(n)]
        if code in (0xDE, 0xDF):
            return self._map(n)
        return self._ext(n)

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype_name, buffer = _Reader(payload).read()
        arr = np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape).copy()
        return arr if code == _EXT_NDARRAY else arr[()]


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {key: _unchunk(value) for key, value in tree.items()}


def from_bytes(data: bytes) -> Any:
    """The tree of ``flax.serialization.msgpack_restore(data)``: nested
    dicts of numpy arrays (chunked arrays joined) and scalars."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes left after the msgpack object")
    return _unchunk(tree)
