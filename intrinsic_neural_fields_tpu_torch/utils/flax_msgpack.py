"""The JAX package's checkpoint files, read with neither flax nor msgpack.

The JAX package writes every ``*.ckpt`` through flax's ``to_bytes``
(flax/serialization.py 0.12.3): ``msgpack.packb(to_state_dict(payload),
strict_types=True)``. ``to_state_dict`` makes every tuple and NamedTuple a
map keyed "0", "1", ... or by field name, so the file is nested maps with
string keys whose leaves are:

  ext 1   an ndarray: packb((shape, dtype name, C-order bytes));
  ext 3   a numpy scalar, the same payload at shape () (``epoch`` is np.int64);
  ext 2   a Python complex, which no checkpoint of the JAX package holds
          (refused here);
  a map {"__msgpack_chunked_array__": True, "shape": {"0": ...},
          "chunks": {"0": ...}} for an array over flax's MAX_CHUNK_SIZE
          (2**30 bytes), its flat chunks in order;
  and msgpack's own nil, bools, ints, floats, strings and bytes.

``load_flax_msgpack`` decodes such a file into what flax's
``msgpack_restore`` gives: nested dicts of numpy arrays and Python or
numpy scalars, chunked arrays joined. numpy has no bfloat16, so a
bfloat16 leaf comes back as a torch.bfloat16 tensor of the same bits
(flax's ``_dtype_from_name`` maps that name to JAX's dtype). Anything
else raises ValueError at its byte offset: a truncated file, a byte after
the top-level object, an unused type byte, an unknown ext code, ext 2, a
malformed array payload. No partial tree is returned.
"""
from __future__ import annotations

import struct

import numpy as np

CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

# fixed-width scalars: type byte -> struct format (msgpack is big-endian)
_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
            0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# length-prefixed: type byte -> (kind, struct format of the length)
_SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
          0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def fail(self, msg, at=None):
        raise ValueError(f"flax msgpack: {msg} at offset {self.pos if at is None else at}")

    def take(self, n):
        if n > len(self.buf) - self.pos:
            self.fail(f"truncated: {n} bytes wanted, {len(self.buf) - self.pos} left")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def count(self, n):
        # every element takes at least one byte: refuse a count the rest cannot hold
        if n > len(self.buf) - self.pos:
            self.fail(f"truncated: {n} elements declared, {len(self.buf) - self.pos} bytes left")
        return n

    def obj(self):
        at = self.pos
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if b <= 0x8f:
            return self.map(b & 0x0f)
        if b <= 0x9f:
            return self.array(b & 0x0f)
        if b <= 0xbf:
            return self.str(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b], at)
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str(n)
            if kind == "ext":
                return self.ext(n, at)
            return self.map(n) if kind == "map" else self.array(n)
        self.fail(f"unknown type byte 0x{b:02x}", at)

    def str(self, n):
        at = self.pos
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError as e:
            self.fail(f"invalid UTF-8 string ({e.reason})", at)

    def array(self, n):
        return [self.obj() for _ in range(self.count(n))]

    def map(self, n):
        out = {}
        for _ in range(self.count(n)):
            at = self.pos
            key = self.obj()
            if not isinstance(key, (str, bytes)):
                self.fail(f"map key of type {type(key).__name__}", at)
            out[key] = self.obj()
        return out

    def ext(self, n, at):
        code = self.unpack(">b")
        data = self.take(n)
        if code == EXT_COMPLEX:
            self.fail("ext 2 (a Python complex) is not a checkpoint leaf", at)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            self.fail(f"unknown ext code {code}", at)
        arr = _ndarray(data, at)
        return arr if code == EXT_NDARRAY else arr[()]


def _ndarray(data, at):
    """flax's _ndarray_from_bytes: the payload packb((shape, dtype name,
    C-order bytes)), read as a view of the file's bytes (read-only)."""
    inner = _Reader(data)
    try:
        payload = inner.obj()
        if inner.pos != len(inner.buf):
            inner.fail("trailing bytes in an array payload")
    except ValueError as e:
        raise ValueError(f"flax msgpack: bad array payload at offset {at} ({e})") from None
    if not (isinstance(payload, list) and len(payload) == 3):
        raise ValueError(f"flax msgpack: bad array payload at offset {at}")
    shape, name, buf = payload
    if isinstance(name, bytes):
        name = name.decode("ascii", "replace")
    if not (isinstance(shape, list) and all(isinstance(s, int) and s >= 0 for s in shape)
            and isinstance(name, str) and isinstance(buf, bytes)):
        raise ValueError(f"flax msgpack: bad array payload at offset {at}")
    size = int(np.prod(shape, dtype=np.int64))
    if name == "bfloat16":
        import torch

        if len(buf) != 2 * size:
            raise ValueError(f"flax msgpack: {len(buf)} bytes for bfloat16{shape} at offset {at}")
        return torch.frombuffer(bytearray(buf), dtype=torch.bfloat16).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"flax msgpack: unknown dtype {name!r} at offset {at}") from None
    if dtype.hasobject or len(buf) != dtype.itemsize * size:
        raise ValueError(f"flax msgpack: {len(buf)} bytes for {name}{shape} at offset {at}")
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def _tuple(d, what):
    if not (isinstance(d, dict) and set(d) == {str(i) for i in range(len(d))}):
        raise ValueError(f"flax msgpack: a chunked array's {what} is not a tuple")
    return [d[str(i)] for i in range(len(d))]


def _unchunk(d):
    shape = _tuple(d.get("shape"), "shape")
    chunks = _tuple(d.get("chunks"), "chunks")
    if not chunks or not all(isinstance(c, np.ndarray) and c.ndim == 1 for c in chunks):
        raise ValueError("flax msgpack: a chunked array's chunks are not flat arrays")
    flat = np.concatenate(chunks)
    if not all(isinstance(s, int) for s in shape) or flat.size != int(np.prod(shape)):
        raise ValueError(f"flax msgpack: {flat.size} chunked elements for shape {shape}")
    return flat.reshape(shape)


def _unchunk_leaves(node):
    """flax's _unchunk_array_leaves_in_place: maps only, lists untouched."""
    if not isinstance(node, dict):
        return node
    if CHUNKED in node:
        return _unchunk(node)
    return {k: _unchunk_leaves(v) for k, v in node.items()}


def load_flax_msgpack(path_or_bytes):
    """The tree of a flax msgpack file (a path) or of its bytes, as flax's
    ``msgpack_restore`` reads it."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        data = path_or_bytes
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    r = _Reader(data)
    tree = r.obj()
    if r.pos != len(r.buf):
        r.fail(f"{len(r.buf) - r.pos} trailing bytes after the top-level object")
    return _unchunk_leaves(tree)


def is_flax_msgpack(data):
    """A flax checkpoint is one top-level msgpack map: fixmap 0x80-0x8f,
    map16 0xde or map32 0xdf."""
    return len(data) > 0 and (0x80 <= data[0] <= 0x8f or data[0] in (0xde, 0xdf))
