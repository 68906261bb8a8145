# coding: utf-8
"""The JAX package's model files, read and written without ``flax`` or
``msgpack``.

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
back as float32, which holds them exactly.  :func:`write_flax_msgpack` is
its mirror: it encodes such a tree as ``flax.serialization.to_bytes``
does (the same bytes for the same tree: flax's copy of the tree sorts
every map's keys, and so does the writer), chunking
every array above :data:`MAX_CHUNK_SIZE` bytes, so ``from_bytes`` (the
JAX package's ``load_params``) reads the file.
"""
from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"
#: arrays of more bytes than this are written as flax's chunked map (flax's
#: ``MAX_CHUNK_SIZE``; read when a tree is written)
MAX_CHUNK_SIZE = 2 ** 30


class _Reader:
    """A msgpack decoder over one buffer; ``value()`` reads the next
    object (a bin as a view of the buffer when ``views``)."""

    def __init__(self, buf, views=False):
        self.buf = memoryview(buf)
        self.pos = 0
        self.views = views

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
            data = self._take(self._unpack(sizes[b]))
            return data if self.views else bytes(data)
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
        data = self._take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack extension type {code} is not an "
                             "array")
        arr = _ndarray(data)
        return arr[()] if code == _EXT_NPSCALAR else arr


def _ndarray(data):
    """An ext-1 payload, msgpack ``(shape, dtype name, bytes)``, as a
    numpy array over the payload's bytes (read-only; bfloat16 widened to
    float32)."""
    reader = _Reader(data, views=True)
    shape, name, raw = reader.value()
    if not isinstance(name, str):
        name = bytes(name).decode()
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


def _sized(out, n, small, codes, fix=None):
    """A length header: ``small | n`` up to ``fix``, else the first code of
    ``codes`` ((code, struct format, limit), ...) whose limit holds n."""
    if fix is not None and n <= fix:
        out.append(struct.pack(">B", small | n))
        return
    for code, fmt, limit in codes:
        if n <= limit:
            out.append(struct.pack(">B" + fmt, code, n))
            return
    raise ValueError(f"{n} items or bytes are too many for msgpack")


_MAP = ((0xDE, "H", 0xFFFF), (0xDF, "I", 0xFFFFFFFF))
_ARRAY = ((0xDC, "H", 0xFFFF), (0xDD, "I", 0xFFFFFFFF))
_STR = ((0xD9, "B", 0xFF), (0xDA, "H", 0xFFFF), (0xDB, "I", 0xFFFFFFFF))
_BIN = ((0xC4, "B", 0xFF), (0xC5, "H", 0xFFFF), (0xC6, "I", 0xFFFFFFFF))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT = ((0xC7, "B", 0xFF), (0xC8, "H", 0xFFFF), (0xC9, "I", 0xFFFFFFFF))


def _int(out, v):
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
        return
    codes = ((0xCC, "B", 0, 0xFF), (0xCD, "H", 0, 0xFFFF),
             (0xCE, "I", 0, 0xFFFFFFFF), (0xCF, "Q", 0, 2 ** 64 - 1)) \
        if v >= 0 else ((0xD0, "b", -2 ** 7, 0), (0xD1, "h", -2 ** 15, 0),
                        (0xD2, "i", -2 ** 31, 0), (0xD3, "q", -2 ** 63, 0))
    for code, fmt, lo, hi in codes:
        if lo <= v <= hi:
            out.append(struct.pack(">B" + fmt, code, v))
            return
    raise ValueError(f"integer {v} does not fit msgpack")


def _ext(out, code, parts):
    """An extension value whose payload is the buffers ``parts``."""
    n = sum(len(part) for part in parts)
    if n in _FIXEXT:
        out.append(struct.pack(">Bb", _FIXEXT[n], code))
    else:
        _sized(out, n, 0, _EXT)
        out.append(struct.pack(">b", code))
    out.extend(parts)


def _ndarray_parts(arr):
    """The ext-1 payload of ``arr``, msgpack ``(shape, dtype name, C-order
    bytes)``: a header and a view of the array's bytes."""
    if arr.dtype.hasobject or arr.dtype.names is not None:
        raise ValueError(f"arrays of dtype {arr.dtype} cannot be written")
    head = []
    _sized(head, 3, 0x90, _ARRAY, fix=15)
    _sized(head, arr.ndim, 0x90, _ARRAY, fix=15)
    for n in arr.shape:
        _int(head, int(n))
    _pack(head, arr.dtype.name)
    data = memoryview(np.ascontiguousarray(arr).reshape(-1)).cast("B")
    _sized(head, len(data), 0, _BIN)
    return [b"".join(head), data]


def _chunked(out, arr):
    """flax's chunked map of a large array, its flat chunks in order (a
    map flax makes after sorting the tree: its keys stay in this order)."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    _map(out, [(_CHUNKED, True),
               ("shape", {str(i): n for i, n in enumerate(arr.shape)}),
               ("chunks", {str(i): flat[lo:lo + size] for i, lo in
                           enumerate(range(0, flat.size, size))})],
         ordered=True)


def _map(out, items, ordered):
    """A map of (str key, value) ``items``; its nested maps sorted by key
    unless ``ordered``, as flax's copy of the tree sorts them."""
    if not all(isinstance(key, str) for key, _ in items):
        raise ValueError(f"map keys {[k for k, _ in items]} are not all str")
    _sized(out, len(items), 0x80, _MAP, fix=15)
    for key, val in items:
        _pack(out, key)
        if ordered and isinstance(val, dict):
            _map(out, list(val.items()), ordered)
        else:
            _pack(out, val)


def _pack(out, v):
    if v is None:
        out.append(b"\xc0")
    elif isinstance(v, (bool, np.bool_)) and not isinstance(v, np.ndarray):
        out.append(b"\xc3" if v else b"\xc2")
    elif isinstance(v, np.ndarray):
        if v.size * v.dtype.itemsize > MAX_CHUNK_SIZE:
            _chunked(out, v)
        else:
            _ext(out, _EXT_NDARRAY, _ndarray_parts(v))
    elif isinstance(v, np.generic):
        _ext(out, _EXT_NPSCALAR, _ndarray_parts(np.asarray(v)))
    elif isinstance(v, int):
        _int(out, v)
    elif isinstance(v, float):
        out.append(struct.pack(">Bd", 0xCB, v))
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        _sized(out, len(raw), 0xA0, _STR, fix=31)
        out.append(raw)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        raw = bytes(v)
        _sized(out, len(raw), 0, _BIN)
        out.append(raw)
    elif isinstance(v, dict):
        _map(out, sorted(v.items(), key=lambda kv: str(kv[0])), False)
    else:
        raise ValueError(f"cannot write {type(v).__name__} as flax msgpack")


def flax_msgpack_parts(tree):
    """The buffers whose concatenation is ``write_flax_msgpack(tree)``:
    the arrays' bytes as views, not copies (a file takes them as they
    are)."""
    if not isinstance(tree, dict):
        raise ValueError("a model file holds a map of parameters")
    out = []
    _pack(out, tree)
    return out


def write_flax_msgpack(tree) -> bytes:
    """The bytes ``flax.serialization.to_bytes`` writes for a state dict
    ``tree``: nested dicts with str keys whose leaves are numpy arrays
    (ext type 1), numpy scalars (ext type 3), ``None`` (nil, a sub-module
    the model does not have), str, bytes, bool, int or float.  An array of
    more than :data:`MAX_CHUNK_SIZE` bytes is written as flax's chunked
    map.  Raises ``ValueError`` for anything else."""
    return b"".join(flax_msgpack_parts(tree))
