"""Read the JAX package's flax ``.ckpt`` files without flax, jax or msgpack.

``c2matching_tpu/models/base_model.py`` writes a network's variables with
``flax.serialization.msgpack_serialize``: a msgpack map of maps whose
leaves are msgpack ext objects. This module decodes that format with the
standard library and numpy:

- ext type 1 (ndarray): its payload is itself msgpack, the triple
  (shape, dtype name, C-order bytes). bfloat16 leaves are widened to
  float32, which holds every bfloat16 value exactly (numpy has no
  bfloat16);
- ext 3 (numpy scalar): the same triple with shape (), returned as a
  numpy scalar;
- ext 2 (Python complex): the pair (real, imag);
- the ``__msgpack_chunked_array__`` maps that flax writes for arrays over
  2^30 bytes: the flat chunks concatenated and reshaped.

``restore(data)`` gives what ``flax.serialization.msgpack_restore`` gives
(nested dicts of numpy arrays); ``load(path)`` reads a file.
"""
import struct

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = '__msgpack_chunked_array__'


class _Ext:
    __slots__ = ('code', 'data')

    def __init__(self, code, data):
        self.code, self.data = code, data


class _Reader:
    """A msgpack decoder over ``data`` (the whole format but timestamps)."""

    def __init__(self, data, raw=False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError('msgpack data ends inside an object')
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def text(self, n):
        b = bytes(self.take(n))
        return b if self.raw else b.decode('utf-8')

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.text(b & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        sized = {0xc4: ('>B', 'bin'), 0xc5: ('>H', 'bin'), 0xc6: ('>I', 'bin'),
                 0xc7: ('>B', 'ext'), 0xc8: ('>H', 'ext'), 0xc9: ('>I', 'ext'),
                 0xd9: ('>B', 'str'), 0xda: ('>H', 'str'), 0xdb: ('>I', 'str'),
                 0xdc: ('>H', 'array'), 0xdd: ('>I', 'array'),
                 0xde: ('>H', 'map'), 0xdf: ('>I', 'map')}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == 'bin':
                return bytes(self.take(n))
            if kind == 'str':
                return self.text(n)
            if kind == 'array':
                return self.array(n)
            if kind == 'map':
                return self.map(n)
            code = self.unpack('>b')
            return _Ext(code, bytes(self.take(n)))
        fixed = {0xca: '>f', 0xcb: '>d', 0xcc: '>B', 0xcd: '>H', 0xce: '>I',
                 0xcf: '>Q', 0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}
        if b in fixed:
            return self.unpack(fixed[b])
        if 0xd4 <= b <= 0xd8:            # fixext 1, 2, 4, 8, 16
            code = self.unpack('>b')
            return _Ext(code, bytes(self.take(1 << (b - 0xd4))))
        raise ValueError(f'msgpack: unknown type byte 0x{b:02x}')

    def array(self, n):
        return [self.obj() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out


def unpackb(data, raw=False):
    """The single msgpack object of ``data`` (ext objects left as
    ``_Ext``)."""
    reader = _Reader(data, raw)
    out = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError(f'msgpack: {len(reader.buf) - reader.pos} bytes '
                         'after the object')
    return out


def _ndarray(payload):
    shape, dtype, buf = unpackb(payload, raw=True)
    name = dtype.decode() if isinstance(dtype, bytes) else dtype
    if name == 'bfloat16':
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape).copy()


def _decode(node):
    """Replace ext objects by their values and join chunked arrays."""
    if isinstance(node, _Ext):
        if node.code == EXT_NDARRAY:
            return _ndarray(node.data)
        if node.code == EXT_NPSCALAR:
            return _ndarray(node.data)[()]
        if node.code == EXT_COMPLEX:
            real, imag = unpackb(node.data)
            return complex(real, imag)
        raise ValueError(f'flax msgpack: unknown ext type {node.code}')
    if isinstance(node, dict):
        out = {k: _decode(v) for k, v in node.items()}
        if CHUNKED in out:
            shape = tuple(out['shape'][str(i)]
                          for i in range(len(out['shape'])))
            chunks = [out['chunks'][str(i)]
                      for i in range(len(out['chunks']))]
            return np.concatenate(chunks).reshape(shape)
        return out
    if isinstance(node, list):
        return [_decode(v) for v in node]
    return node


def restore(data):
    """The pytree of a ``msgpack_serialize`` byte string."""
    return _decode(unpackb(data))


def load(path):
    """The pytree of a flax ``.ckpt`` file."""
    with open(path, 'rb') as f:
        return restore(f.read())
