"""Reader and writer for flax's msgpack export format, without the
``msgpack`` package.

An export blob (``mlcomp_tpu/train/export.py`` writes it with
``flax.serialization.to_bytes``) is one msgpack map of nested string-keyed
maps whose leaves are arrays packed as msgpack ext types, as in
``flax/serialization.py``:

- ext 1, an ndarray: the payload is itself msgpack, the array
  ``[shape, dtype name, row-major bytes]``;
- ext 3, a numpy scalar: the same payload, unpacked to a 0-d value;
- an array larger than 2**30 bytes is split into a
  ``{'__msgpack_chunked_array__': True, 'shape': {...}, 'chunks': {...}}``
  map of flat pieces.

Leaves load as numpy arrays, except ``bfloat16`` (numpy has no such
type), which loads as a ``torch.bfloat16`` tensor. The writer takes numpy
arrays and CPU torch tensors and writes what flax reads back.
"""

import struct

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED_KEY = '__msgpack_chunked_array__'
#: flax splits array leaves above this many bytes (msgpack's per-object
#: limit is 2**31 - 1)
MAX_CHUNK_SIZE = 2 ** 30


# ------------------------------------------------------------------ read
class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf).cast('B')
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError('truncated msgpack data')
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def length(self, t: int, n8: int, n16: int) -> int:
        """Length field of a bin/str/ext/array/map with 8/16/32-bit
        variants at type bytes n8, n16, n16 + 1."""
        if t == n8:
            return self.unpack('>B')
        if t == n16:
            return self.unpack('>H')
        return self.unpack('>I')

    def obj(self, views: bool = False):
        t = self.take(1)[0]
        if t <= 0x7f:
            return t
        if t >= 0xe0:
            return t - 0x100
        if 0x80 <= t <= 0x8f:
            return self.map(t & 0x0f)
        if 0x90 <= t <= 0x9f:
            return [self.obj(views) for _ in range(t & 0x0f)]
        if 0xa0 <= t <= 0xbf:
            return str(self.take(t & 0x1f), 'utf-8')
        if t == 0xc0:
            return None
        if t in (0xc2, 0xc3):
            return t == 0xc3
        if t in (0xc4, 0xc5, 0xc6):
            data = self.take(self.length(t, 0xc4, 0xc5))
            return data if views else bytes(data)
        if t in (0xc7, 0xc8, 0xc9):
            n = self.length(t, 0xc7, 0xc8)
            code = self.unpack('>b')
            return _ext(code, self.take(n))
        if t == 0xca:
            return self.unpack('>f')
        if t == 0xcb:
            return self.unpack('>d')
        if 0xcc <= t <= 0xcf:
            return self.unpack('>' + 'BHIQ'[t - 0xcc])
        if 0xd0 <= t <= 0xd3:
            return self.unpack('>' + 'bhiq'[t - 0xd0])
        if 0xd4 <= t <= 0xd8:
            code = self.unpack('>b')
            return _ext(code, self.take(1 << (t - 0xd4)))
        if t in (0xd9, 0xda, 0xdb):
            return str(self.take(self.length(t, 0xd9, 0xda)), 'utf-8')
        if t in (0xdc, 0xdd):
            n = self.unpack('>H' if t == 0xdc else '>I')
            return [self.obj(views) for _ in range(n)]
        if t in (0xde, 0xdf):
            return self.map(self.unpack('>H' if t == 0xde else '>I'))
        raise ValueError(f'invalid msgpack type byte 0x{t:02x}')

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out


def _array_from_payload(payload: memoryview):
    """``[shape, dtype name, bytes]`` → numpy array (torch for bf16)."""
    shape, name, data = _Reader(payload).obj(views=True)
    if isinstance(name, bytes):
        name = name.decode()
    if name == 'bfloat16':
        flat = np.frombuffer(data, np.int16).copy()
        return torch.from_numpy(flat).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(data, np.dtype(name)).reshape(shape).copy()


def _ext(code: int, payload: memoryview):
    if code == EXT_NDARRAY:
        return _array_from_payload(payload)
    if code == EXT_NPSCALAR:
        arr = _array_from_payload(payload)
        return arr.reshape(()) if torch.is_tensor(arr) else arr[()]
    raise ValueError(f'unknown msgpack ext type {code}')


def _unchunk(node):
    if not isinstance(node, dict):
        return node
    if node.get(CHUNKED_KEY):
        try:
            shape = [node['shape'][str(i)]
                     for i in range(len(node['shape']))]
            parts = [node['chunks'][str(i)]
                     for i in range(len(node['chunks']))]
        except (KeyError, TypeError) as e:
            raise ValueError(
                f'malformed chunked array in msgpack export: {e!r}') from e
        if parts and torch.is_tensor(parts[0]):
            return torch.cat([p.reshape(-1) for p in parts]).reshape(shape)
        return np.concatenate([np.asarray(p).reshape(-1)
                               for p in parts]).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def msgpack_restore(data) -> object:
    """Bytes of a flax msgpack blob → nested dicts of arrays."""
    reader = _Reader(data)
    tree = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError('trailing bytes after msgpack object')
    return _unchunk(tree)


# ----------------------------------------------------------------- write
def _head(out: list, n: int, fix_base: int, fix_max: int, t8, t16, t32):
    if n <= fix_max and fix_base is not None:
        out.append(bytes([fix_base | n]))
    elif t8 is not None and n < 1 << 8:
        out.append(struct.pack('>BB', t8, n))
    elif n < 1 << 16:
        out.append(struct.pack('>BH', t16, n))
    else:
        out.append(struct.pack('>BI', t32, n))


def _pack_int(out: list, v: int):
    if 0 <= v <= 0x7f:
        out.append(bytes([v]))
    elif -32 <= v < 0:
        out.append(struct.pack('>b', v))
    elif v >= 0:
        for t, fmt, lim in ((0xcc, 'B', 1 << 8), (0xcd, 'H', 1 << 16),
                            (0xce, 'I', 1 << 32), (0xcf, 'Q', 1 << 64)):
            if v < lim:
                out.append(struct.pack('>B' + fmt, t, v))
                return
        raise OverflowError(f'int too large for msgpack: {v}')
    else:
        for t, fmt, bits in ((0xd0, 'b', 7), (0xd1, 'h', 15),
                             (0xd2, 'i', 31), (0xd3, 'q', 63)):
            if v >= -(1 << bits):
                out.append(struct.pack('>B' + fmt, t, v))
                return
        raise OverflowError(f'int too small for msgpack: {v}')


def _as_numpy(x):
    """(numpy array, dtype name) of an array leaf; bf16 travels as its
    raw 16-bit pattern."""
    if torch.is_tensor(x):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy(), 'bfloat16'
        return x.numpy(), str(x.numpy().dtype)
    x = np.asarray(x, order='C')        # keeps 0-d arrays 0-d
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError('object and structured dtypes cannot be exported')
    return x, x.dtype.name


def _pack_ext(out: list, code: int, arr: np.ndarray, name: str):
    inner = [b'\x93']                    # the array [shape, name, bytes]
    _pack_obj(inner, list(arr.shape))
    _pack_obj(inner, name)
    data = memoryview(arr).cast('B') if arr.size else b''
    _head(inner, len(data), None, -1, 0xc4, 0xc5, 0xc6)
    n = sum(len(c) for c in inner) + len(data)
    if n in (1, 2, 4, 8, 16):
        out.append(struct.pack('>Bb', 0xd4 + n.bit_length() - 1, code))
    else:
        _head(out, n, None, -1, 0xc7, 0xc8, 0xc9)
        out.append(struct.pack('>b', code))
    out.extend(inner)
    out.append(data)


class _Piece:
    """One flat piece of a chunked array, with its dtype name."""

    def __init__(self, arr: np.ndarray, name: str):
        self.arr, self.name = arr, name


def _chunk(arr: np.ndarray, name: str) -> dict:
    step = max(1, MAX_CHUNK_SIZE // arr.dtype.itemsize)
    flat = arr.reshape(-1)
    pieces = [flat[i:i + step] for i in range(0, flat.size, step)]
    return {CHUNKED_KEY: True,
            'shape': {str(i): d for i, d in enumerate(arr.shape)},
            'chunks': {str(i): _Piece(p, name)
                       for i, p in enumerate(pieces)}}


def _pack_obj(out: list, obj):
    if obj is None:
        out.append(b'\xc0')
    elif obj is True or obj is False:
        out.append(b'\xc3' if obj else b'\xc2')
    elif isinstance(obj, _Piece):
        _pack_ext(out, EXT_NDARRAY, obj.arr, obj.name)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        arr, name = _as_numpy(obj)
        if arr.nbytes > MAX_CHUNK_SIZE:
            _pack_obj(out, _chunk(arr, name))
        else:
            _pack_ext(out, EXT_NDARRAY, arr, name)
    elif isinstance(obj, np.generic):
        arr, name = _as_numpy(np.asarray(obj))
        _pack_ext(out, EXT_NPSCALAR, arr, name)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, str):
        data = obj.encode('utf-8')
        _head(out, len(data), 0xa0, 31, 0xd9, 0xda, 0xdb)
        out.append(data)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 15, None, 0xde, 0xdf)
        for k, v in obj.items():
            _pack_obj(out, k)
            _pack_obj(out, v)
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 15, None, 0xdc, 0xdd)
        for v in obj:
            _pack_obj(out, v)
    else:
        raise TypeError(f'cannot msgpack-serialize {type(obj).__name__}')


def msgpack_chunks(tree) -> list:
    """The encoded blob as a list of byte chunks (array data is not
    copied until it is written)."""
    out = []
    _pack_obj(out, tree)
    return out


def msgpack_serialize(tree) -> bytes:
    """Nested dicts of arrays → bytes flax's ``msgpack_restore`` reads."""
    return b''.join(msgpack_chunks(tree))


__all__ = ['msgpack_restore', 'msgpack_serialize', 'msgpack_chunks',
           'MAX_CHUNK_SIZE']
