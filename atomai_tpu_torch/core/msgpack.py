"""A msgpack reader for the JAX package's checkpoints (``.aoi``).

The JAX package writes its arrays with flax's ``msgpack_serialize``; the
card's machine has neither ``msgpack`` nor ``flax``, so the port decodes
the format itself (reading only; the port writes ``.aoit``). It covers
the whole msgpack type set: nil, bool, ints, float32/64, str, bin, array
and map (fix/8/16/32 forms), and ext/fixext. flax's ext types
(``flax.serialization._MsgpackExtType``) become arrays:

- 1, ``ndarray``: a packed ``(shape, dtype name, C-order bytes)``, read
  into a numpy array (a writable copy); ``"bfloat16"``, which numpy lacks,
  is read as ``uint16`` and viewed as a ``torch.bfloat16`` tensor;
- 2, ``native_complex``: a packed ``(real, imag)``, a Python complex;
- 3, ``npscalar``: packed like an ndarray, a numpy scalar (a 0-d
  bfloat16 tensor for ``"bfloat16"``).

Other ext codes come back as :class:`ExtType`. Leaves over flax's
``MAX_CHUNK_SIZE`` (2**30 bytes) are written as
``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}``
dicts; :func:`restore` joins them again, as ``msgpack_restore`` does.
Arrays come back as lists, maps as dicts with str keys.
"""

import struct
from typing import Any, NamedTuple

import numpy as np
import torch

CHUNKED = "__msgpack_chunked_array__"


class ExtType(NamedTuple):
    """An ext value of a type code the reader does not know."""
    code: int
    data: bytes


_FIXED = {  # type byte -> (struct format, size) of fixed-width scalars
    0xca: (">f", 4), 0xcb: (">d", 8),
    0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
    0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"truncated msgpack data: {n} bytes wanted at "
                             f"offset {self.pos} of {len(self.buf)}")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def length(self, width: int) -> int:
        return struct.unpack(_LEN[width], self.take(width))[0]

    def str_(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = struct.unpack(">b", self.take(1))[0]
        return _ext(code, bytes(self.take(n)))

    def value(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7f:
            return t
        if t >= 0xe0:
            return t - 0x100
        if t <= 0x8f:
            return self.map(t & 0x0f)
        if t <= 0x9f:
            return self.array(t & 0x0f)
        if t <= 0xbf:
            return self.str_(t & 0x1f)
        if t == 0xc0:
            return None
        if t in (0xc2, 0xc3):
            return t == 0xc3
        if t in _FIXED:
            fmt, n = _FIXED[t]
            return struct.unpack(fmt, self.take(n))[0]
        if 0xc4 <= t <= 0xc6:                       # bin 8/16/32
            return bytes(self.take(self.length(1 << (t - 0xc4))))
        if 0xc7 <= t <= 0xc9:                       # ext 8/16/32
            return self.ext(self.length(1 << (t - 0xc7)))
        if t in _FIXEXT:
            return self.ext(_FIXEXT[t])
        if 0xd9 <= t <= 0xdb:                       # str 8/16/32
            return self.str_(self.length(1 << (t - 0xd9)))
        if t in (0xdc, 0xdd):                       # array 16/32
            return self.array(self.length(2 if t == 0xdc else 4))
        if t in (0xde, 0xdf):                       # map 16/32
            return self.map(self.length(2 if t == 0xde else 4))
        raise ValueError(f"invalid msgpack type byte 0x{t:02x} at offset "
                         f"{self.pos - 1}")


def unpackb(data: bytes) -> Any:
    """The one msgpack object of ``data`` (flax's ext types decoded)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes of trailing data "
                         "after the msgpack object")
    return out


def _ndarray(data: bytes):
    shape, name, buf = unpackb(data)
    if isinstance(name, bytes):
        name = name.decode("ascii")
    shape = tuple(int(s) for s in shape)
    if name == "bfloat16":
        a = np.frombuffer(buf, np.uint16).reshape(shape).copy()
        return torch.from_numpy(a).view(torch.bfloat16)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape).copy()


def _ext(code: int, data: bytes) -> Any:
    if code == 1:
        return _ndarray(data)
    if code == 2:
        real, imag = unpackb(data)
        return complex(real, imag)
    if code == 3:
        a = _ndarray(data)
        return a if isinstance(a, torch.Tensor) else a[()]
    return ExtType(code, data)


def _unchunk(d: dict):
    n = len(d["chunks"])
    chunks = [d["chunks"][str(i)] for i in range(n)]
    shape = tuple(int(d["shape"][str(i)]) for i in range(len(d["shape"])))
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _join_chunks(tree: Any) -> Any:
    if isinstance(tree, dict):
        if CHUNKED in tree:
            return _unchunk(tree)
        return {k: _join_chunks(v) for k, v in tree.items()}
    return tree


def restore(data: bytes) -> Any:
    """The tree that flax's ``msgpack_serialize`` wrote into ``data``,
    as ``msgpack_restore`` gives it back: nested dicts (and lists) of
    numpy arrays (bfloat16 ones as torch tensors), with chunked leaves
    joined."""
    return _join_chunks(unpackb(data))
