"""A PNG reader on the standard library's ``zlib``, for image folders on
a machine without OpenCV.

``read_png(path, gray_scale)`` returns what OpenCV's ``imread`` returns
for the same file, as ``cv2.cvtColor(..., COLOR_BGR2RGB)`` orders it:
an ``[H, W, 3]`` uint8 RGB array (``IMREAD_COLOR``: gray replicated,
palette expanded, alpha dropped) or ``[H, W]`` uint8 (``IMREAD_GRAYSCALE``:
alpha dropped, colour converted as libpng's ``png_set_rgb_to_gray(...,
0.299, 0.587)``, which OpenCV asks for: 15-bit weights 9797, 19234 and
3737, truncated). It reads non-interlaced PNGs of 8 bits a sample:
gray, gray + alpha, RGB, RGBA and palette, every filter type. Other
files (16-bit or fewer-bit samples, interlaced, not a PNG) raise
``ValueError`` naming what they are. Gamma and transparency chunks are
not applied.
"""

import struct
import zlib

import numpy as np

SIGNATURE = b'\x89PNG\r\n\x1a\n'
#: colour type -> (name, samples a pixel)
COLOR_TYPES = {0: ('gray', 1), 2: ('RGB', 3), 3: ('palette', 1),
               4: ('gray+alpha', 2), 6: ('RGBA', 4)}
#: libpng's weights of R, G and B over 2^15 for 0.299 and 0.587
GRAY_WEIGHTS = (9797, 19234, 3737)

_FORMATS = ((b'\xff\xd8\xff', 'JPEG'), (b'GIF8', 'GIF'), (b'BM', 'BMP'),
            (b'II*\x00', 'TIFF'), (b'MM\x00*', 'TIFF'),
            (b'RIFF', 'RIFF/WebP'))


def _unsupported(path: str, what: str):
    return ValueError(f'{path}: {what}; the port reads PNG (8 bits a '
                      f'sample, not interlaced) and NPY images only')


def _chunks(data: bytes, path: str):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f'{path}: truncated {kind!r} chunk')
        yield kind, body
        if kind == b'IEND':
            return
        pos += 12 + length
    raise ValueError(f'{path}: no IEND chunk')


def _unfilter(raw: bytes, h: int, stride: int, bpp: int,
              path: str) -> np.ndarray:
    """The scanlines of ``raw`` with their filters undone."""
    if len(raw) < h * (stride + 1):
        raise ValueError(f'{path}: image data ends early')
    lines = np.frombuffer(raw, np.uint8)[:h * (stride + 1)].reshape(
        h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(lines[y, 0]), lines[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.int64)
                   % 256).astype(np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prev
        elif kind in (3, 4):
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 255
                    continue
                c = up[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 255
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f'{path}: unknown filter type {kind} on row {y}')
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes, path: str = '<png>') -> tuple:
    """(pixels [H, W, samples] uint8, colour type), a palette expanded
    to RGB."""
    if not data.startswith(SIGNATURE):
        for magic, name in _FORMATS:
            if data.startswith(magic):
                raise _unsupported(path, f'a {name} file')
        raise _unsupported(path, 'not a PNG file')
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'PLTE':
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b'IDAT':
            idat.append(body)
    if header is None:
        raise ValueError(f'{path}: no IHDR chunk')
    w, h, depth, color, _, _, interlace = header
    if color not in COLOR_TYPES:
        raise ValueError(f'{path}: PNG colour type {color} is not valid')
    name, samples = COLOR_TYPES[color]
    if depth != 8:
        raise _unsupported(path, f'a {depth}-bit {name} PNG')
    if interlace:
        raise _unsupported(path, f'an interlaced (Adam7) {name} PNG')
    raw = zlib.decompress(b''.join(idat))
    px = _unfilter(raw, h, w * samples, samples, path).reshape(h, w, samples)
    if color == 3:
        if palette is None:
            raise ValueError(f'{path}: palette PNG without a PLTE chunk')
        idx = px[..., 0]
        if int(idx.max(initial=0)) >= len(palette):
            raise ValueError(f'{path}: palette index out of range')
        px = palette[idx]
    return px, color


def read_png(path: str, gray_scale: bool = False) -> np.ndarray:
    """The image at ``path`` as OpenCV's ``imread`` reads it, in RGB
    order (module docstring)."""
    with open(path, 'rb') as fh:
        px, _ = decode_png(fh.read(), path)
    if px.shape[2] in (2, 4):          # alpha dropped, as libpng strips it
        px = px[..., :-1]
    if gray_scale:
        if px.shape[2] == 1:
            return px[..., 0].copy()
        r, g, b = (px[..., i].astype(np.uint32) for i in range(3))
        wr, wg, wb = GRAY_WEIGHTS
        return ((wr * r + wg * g + wb * b) >> 15).astype(np.uint8)
    if px.shape[2] == 1:
        return np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px)


__all__ = ['read_png', 'decode_png', 'GRAY_WEIGHTS', 'COLOR_TYPES']
