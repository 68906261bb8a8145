# coding: utf-8
"""Reading the JAX package's model files without ``flax`` or ``msgpack``.

``ctgcn_tpu`` saves a model's parameters with
``flax.serialization.to_bytes``: the tree that ``to_state_dict`` gives
(nested maps with string keys, tuples as maps keyed "0", "1", ...),
encoded as msgpack.  Arrays are msgpack extension values:

* ext type 1, an ndarray: the msgpack encoding of ``(shape, dtype name,
  C-order bytes)``;
* ext type 3, a numpy scalar: the same encoding of a 0-d array;
* an array above flax's ``MAX_CHUNK_SIZE`` (2**30 bytes) is written as a map
  ``{"__msgpack_chunked_array__": True, "shape": {"0": ...},
  "chunks": {"0": <flat ext-1 array>, ...}}``, its flat chunks in order.

:func:`read_flax_msgpack` decodes that subset (maps, arrays, str, bin,
ints, floats, nil, booleans and the two extension types) into the nested
dict of numpy arrays that ``to_state_dict`` gives; bfloat16 leaves come
back as float32, which holds them exactly.
"""
from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """A msgpack decoder over one buffer; ``value()`` reads the next
    object."""

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def _take(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self._unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self._unpack(fixed[b])
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sizes:
            return bytes(self._take(self._unpack(sizes[b])))
        sizes = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in sizes:
            return self._str(self._unpack(sizes[b]))
        if b in (0xDC, 0xDD):
            return self._array(self._unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        if 0xD4 <= b <= 0xD8:
            return self._ext(1 << (b - 0xD4))
        sizes = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in sizes:
            return self._ext(self._unpack(sizes[b]))
        raise ValueError(f"not msgpack: byte 0x{b:02x} at {self.pos - 1}")

    def _str(self, n):
        return str(self._take(n), "utf-8")

    def _array(self, n):
        return [self.value() for _ in range(n)]

    def _map(self, n):
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def _ext(self, n):
        code = self._unpack(">b")
        data = bytes(self._take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack extension type {code} is not an "
                             "array")
        arr = _ndarray(data)
        return arr[()] if code == _EXT_NPSCALAR else arr


def _ndarray(data: bytes):
    """An ext-1 payload, msgpack ``(shape, dtype name, bytes)``, as a
    numpy array (bfloat16 widened to float32)."""
    reader = _Reader(data)
    shape, name, raw = reader.value()
    if isinstance(name, bytes):
        name = name.decode()
    if name == "bfloat16":
        bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
        arr = bits.view(np.float32)
    else:
        arr = np.frombuffer(raw, dtype=np.dtype(name))
    return arr.reshape(shape, order="C")


def _restore(tree):
    """Chunked arrays joined back, in place of their maps."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED) is True:
        shape = tuple(tree["shape"][str(i)]
                      for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _restore(v) for k, v in tree.items()}


def read_flax_msgpack(buf: bytes):
    """The state dict that ``flax.serialization.msgpack_restore`` gives
    for ``buf`` (bytes ``to_bytes`` wrote): nested dicts of numpy arrays
    and scalars.  Raises ``ValueError`` when ``buf`` is not one msgpack
    object of that subset."""
    reader = _Reader(buf)
    try:
        tree = reader.value()
        if reader.pos != len(reader.buf):
            raise ValueError(f"{len(reader.buf) - reader.pos} bytes after "
                             "the msgpack object")
        if not isinstance(tree, dict):
            raise ValueError("the msgpack object is not a map of "
                             "parameters")
        return _restore(tree)
    except (TypeError, KeyError, AttributeError) as exc:
        # well-formed msgpack that is not flax's layout (an unhashable
        # key, an array payload or a chunk map of another shape)
        raise ValueError(f"not a flax state dict: {exc!r}") from None
