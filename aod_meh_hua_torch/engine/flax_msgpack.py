"""A reader for the JAX package's flax-msgpack checkpoints, without
msgpack or flax (the machine with the card has neither).

The JAX package writes its checkpoints with flax.serialization.to_bytes
(aod_meh_hua_tpu/engine/checkpoint.py:19-33): a msgpack map of the
state dict, where an ndarray is ext type 1 holding a msgpack array
(shape, dtype name, C-order bytes), a numpy scalar is ext type 3 in the
same form, namedtuples are maps keyed by field name, tuples and lists
maps keyed "0", "1", ..., and an array over 2**30 bytes is a map
{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}.
`unpackb` reads maps, arrays, str, bin, ints, floats, nil and bool, and
those two ext types; anything else raises.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


class MsgpackError(ValueError):
    pass


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise MsgpackError("msgpack data ends inside an object")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7f:
            return t
        if t >= 0xe0:
            return t - 0x100
        if 0x80 <= t <= 0x8f:
            return self.map(t & 0x0f)
        if 0x90 <= t <= 0x9f:
            return self.array(t & 0x0f)
        if 0xa0 <= t <= 0xbf:
            return self.str(t & 0x1f)
        if t in _FIXED:
            return _FIXED[t]
        if t in _INTS:
            return self.unpack(_INTS[t])
        if t == 0xca:
            return self.unpack(">f")
        if t == 0xcb:
            return self.unpack(">d")
        if t in _LEN:
            kind, fmt = _LEN[t]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str(n)
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        if t in _FIXEXT:
            return self.ext(_FIXEXT[t])
        raise MsgpackError(f"msgpack type byte 0x{t:02x} is not read here")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int):
        code = struct.unpack(">b", self.take(1))[0]
        payload = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray(payload)
        if code == EXT_NPSCALAR:
            return _ndarray(payload)[()]
        raise MsgpackError(f"msgpack ext type {code} is not read here")


_FIXED = {0xc0: None, 0xc2: False, 0xc3: True}
_INTS = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
         0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_LEN = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
        0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
        0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
        0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
        0xde: ("map", ">H"), 0xdf: ("map", ">I")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _dtype(name) -> Tuple[np.dtype, bool]:
    """numpy dtype of a flax dtype name; bfloat16 (no numpy dtype) is
    read as its bits and widened to float32 exactly."""
    name = name.decode() if isinstance(name, (bytes, bytearray)) else name
    if name == "bfloat16":
        return np.dtype(np.uint16), True
    return np.dtype(name), False


def _ndarray(payload: bytes) -> np.ndarray:
    shape, name, buf = unpackb(payload)
    dtype, bf16 = _dtype(name)
    arr = np.frombuffer(bytes(buf), dtype=dtype).reshape(shape, order="C")
    if bf16:
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr


def unpackb(data: bytes) -> Any:
    """msgpack bytes -> the Python object (dict, list, str, bytes, int,
    float, None, bool, numpy arrays for the ext types)."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise MsgpackError(f"{len(r.data) - r.pos} bytes after the msgpack object")
    return out


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if tree.get(_CHUNKED) is True:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes) -> Any:
    """flax.serialization.msgpack_restore: the state dict of a flax
    checkpoint, with chunked arrays joined."""
    return _unchunk(unpackb(data))
