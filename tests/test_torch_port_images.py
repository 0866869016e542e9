"""Image folders on the port against the JAX package: ``_read_image``
(the port's PNG reader on ``zlib``) pixel for pixel against JAX's
(OpenCV's ``imread``) in both modes, for each PNG type the reader takes,
written by OpenCV, by PIL and by a writer here that sets every filter
type; the formats it refuses; ``ImageDataset`` and
``ImageWithMaskDataset`` (rows, arrays, ``max_count`` as a number and
as class ratios, masks from a folder and from RLE) against JAX's; and
the ``digits_segmentation`` dataset with and without a fold file. All
exact."""

import os
import struct
import zlib

import cv2
import numpy as np
import pandas as pd
import pytest
from PIL import Image

from mlcomp_tpu.contrib import dataset as jax_dataset
from mlcomp_tpu.contrib.dataset.classify import _read_image as jax_read
from mlcomp_tpu.contrib.transform.rle import mask2rle
from mlcomp_tpu.train import data as jax_data
from mlcomp_tpu_torch.contrib import dataset as port_dataset
from mlcomp_tpu_torch.contrib.dataset.classify import _read_image
from mlcomp_tpu_torch.train import data as port_data
from mlcomp_tpu_torch.utils.png import GRAY_WEIGHTS


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack('>I', len(body)) + kind + body + struct.pack(
        '>I', zlib.crc32(kind + body) & 0xffffffff)


def write_png(path, pixels, color_type, palette=None, filters=(0,),
              depth=8, interlace=0):
    """A PNG of ``pixels`` (uint8, [H, W] or [H, W, C]) whose row ``y``
    takes filter ``filters[y % len(filters)]``."""
    px = np.asarray(pixels, np.uint8)
    h, w = px.shape[:2]
    bpp = 1 if px.ndim == 2 else px.shape[2]
    rows = px.reshape(h, w * bpp).astype(np.int64)
    raw, prev = bytearray(), np.zeros(w * bpp, np.int64)
    for y in range(h):
        kind, cur = filters[y % len(filters)], rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pa, pb, pc = (abs(prev - upleft), abs(left - upleft),
                      abs(left + prev - 2 * upleft))
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prev, upleft))
        pred = [0, left, prev, (left + prev) // 2, paeth][kind]
        raw.append(kind)
        raw += ((cur - pred) & 255).astype(np.uint8).tobytes()
        prev = cur
    body = b'\x89PNG\r\n\x1a\n' + _chunk(b'IHDR', struct.pack(
        '>IIBBBBB', w, h, depth, color_type, 0, 0, interlace))
    if palette is not None:
        body += _chunk(b'PLTE', np.asarray(palette, np.uint8).tobytes())
    body += _chunk(b'IDAT', zlib.compress(bytes(raw)))
    with open(path, 'wb') as fh:
        fh.write(body + _chunk(b'IEND', b''))


def _rows(rows):
    """Rows with NaN made comparable, each value beside its type."""
    return [{k: ('nan', float) if isinstance(v, float) and np.isnan(v)
             else (v, type(v)) for k, v in r.items()} for r in rows]


def _pixels(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


def _cases(folder):
    """{name: path} of one PNG of each supported type from each writer
    that makes it."""
    out = {}
    rng = np.random.RandomState(1)
    h, w = 13, 21
    for name, px in (('gray', _pixels(1, (h, w))),
                     ('rgb', _pixels(2, (h, w, 3))),
                     ('rgba', _pixels(3, (h, w, 4)))):
        path = os.path.join(folder, f'cv2_{name}.png')
        bgr = px if px.ndim == 2 else np.concatenate(
            [px[..., 2::-1], px[..., 3:]], axis=-1)
        assert cv2.imwrite(path, bgr)
        out['cv2_' + name] = path
    palette = rng.randint(0, 256, (40, 3))
    index = rng.randint(0, 40, (h, w)).astype(np.uint8)
    pil = Image.fromarray(index, 'P')
    pil.putpalette(palette.astype(np.uint8).ravel().tolist())
    out['pil_palette'] = os.path.join(folder, 'pil_palette.png')
    pil.save(out['pil_palette'])
    pil.save(os.path.join(folder, 'pil_palette_t.png'),
             transparency=bytes(range(0, 200, 5)))
    out['pil_palette_transparent'] = os.path.join(folder,
                                                  'pil_palette_t.png')
    out['pil_gray_alpha'] = os.path.join(folder, 'pil_la.png')
    Image.fromarray(_pixels(4, (h, w, 2)), 'LA').save(out['pil_gray_alpha'])
    out['pil_rgb'] = os.path.join(folder, 'pil_rgb.png')
    Image.fromarray(_pixels(5, (h, w, 3)), 'RGB').save(out['pil_rgb'])
    for name, color, shape in (('gray', 0, (h, w)), ('gray_alpha', 4,
                                                     (h, w, 2)),
                               ('rgb', 2, (h, w, 3)), ('rgba', 6,
                                                       (h, w, 4)),
                               ('palette', 3, (h, w))):
        path = os.path.join(folder, f'own_{name}.png')
        px = _pixels(6 + color, shape)
        write_png(path, px % 40 if color == 3 else px, color,
                  palette=palette if color == 3 else None,
                  filters=(0, 1, 2, 3, 4, 4, 3, 1, 2))
        out['own_' + name] = path
    return out


@pytest.fixture(scope='module')
def pngs(tmp_path_factory):
    return _cases(str(tmp_path_factory.mktemp('pngs')))


@pytest.mark.parametrize('gray_scale', [False, True])
@pytest.mark.parametrize('case', [
    'cv2_gray', 'cv2_rgb', 'cv2_rgba', 'pil_palette',
    'pil_palette_transparent', 'pil_gray_alpha', 'pil_rgb', 'own_gray',
    'own_gray_alpha', 'own_rgb', 'own_rgba', 'own_palette'])
def test_read_image_is_opencvs(pngs, case, gray_scale):
    got = _read_image(pngs[case], gray_scale)
    want = jax_read(pngs[case], gray_scale)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_every_colour_is_converted_to_gray_as_opencv(tmp_path):
    """All 2^24 colours would be slow: a 4096 x 64 image of random
    colours and the equal-channel ramp."""
    px = _pixels(11, (4096, 64, 3))
    px[:256, 0] = np.arange(256)[:, None]
    path = str(tmp_path / 'many.png')
    write_png(path, px, 2, filters=(1, 2, 3, 4))
    np.testing.assert_array_equal(_read_image(path, True),
                                  jax_read(path, True))
    assert GRAY_WEIGHTS == (9797, 19234, 3737)


def test_npy_is_read_as_it_is(tmp_path):
    x = np.random.RandomState(0).rand(5, 6, 3).astype(np.float32)
    np.save(tmp_path / 'a.npy', x)
    for fn in (_read_image, jax_read):
        np.testing.assert_array_equal(fn(str(tmp_path / 'a.npy')), x)


@pytest.mark.parametrize('kind', ['jpeg', '16-bit', 'interlaced',
                                  '4-bit palette', 'text', 'missing'])
def test_other_formats_raise_naming_the_format(tmp_path, kind):
    path = str(tmp_path / ('img.jpg' if kind == 'jpeg' else 'img.png'))
    if kind == 'jpeg':
        assert cv2.imwrite(path, _pixels(0, (8, 8, 3)))
    elif kind == '16-bit':
        assert cv2.imwrite(path, np.arange(64, dtype=np.uint16).reshape(
            8, 8) * 999)
    elif kind == 'interlaced':
        write_png(path, _pixels(0, (8, 8)), 0, interlace=1)
    elif kind == '4-bit palette':
        write_png(path, _pixels(0, (8, 4)), 3, depth=4,
                  palette=_pixels(1, (16, 3)))
    elif kind == 'text':
        with open(path, 'w') as fh:
            fh.write('not an image')
    if kind == 'missing':
        with pytest.raises(FileNotFoundError, match='could not read'):
            _read_image(path)
        with pytest.raises(FileNotFoundError, match='could not read'):
            jax_read(path)
        return
    word = {'jpeg': 'JPEG', '16-bit': '16-bit', 'interlaced': 'interlaced',
            '4-bit palette': '4-bit palette', 'text': 'not a PNG'}[kind]
    with pytest.raises(ValueError, match=word) as info:
        _read_image(path)
    assert 'reads PNG' in str(info.value) and 'NPY' in str(info.value)


# ---------------------------------------------------------------- datasets
@pytest.fixture()
def folder(tmp_path):
    """12 images (npy and png), labels 0-2, folds 0-3, and a fold csv."""
    imgs = tmp_path / 'imgs'
    imgs.mkdir()
    rows = []
    for i in range(12):
        if i % 2:
            name = f'im{i}.npy'
            np.save(imgs / name, np.random.RandomState(i).rand(
                6, 5, 3).astype(np.float32) * 255)
        else:
            name = f'im{i}.png'
            write_png(str(imgs / name), _pixels(i, (6, 5, 3)), 2,
                      filters=(i % 5,))
        rows.append({'image': name, 'label': i % 3, 'fold': i % 4,
                     'rle': mask2rle(_pixels(i, (6, 5)) > 128)
                     if i % 3 else None})
    pd.DataFrame(rows).to_csv(tmp_path / 'fold.csv', index=False)
    return tmp_path


@pytest.mark.parametrize('kw', [
    {}, {'fold_number': 0}, {'fold_number': 1, 'is_test': True},
    {'fold_number': 2, 'max_count': 5},
    {'fold_number': 0, 'max_count': [1, 2, 1]},
    {'fold_number': 3, 'is_test': True, 'max_count': [2, 0, 5]},
    {'gray_scale': True, 'fold_number': 1},
    {'no_csv': True}, {'no_csv': True, 'max_count': 4}])
def test_image_dataset_is_jaxs(folder, kw):
    kw = dict(kw)
    if not kw.pop('no_csv', False):
        kw['fold_csv'] = str(folder / 'fold.csv')
    else:
        os.remove(folder / 'fold.csv')
    if kw.get('gray_scale'):
        # the PNGs alone: a gray PNG and an RGB array do not stack
        table = pd.read_csv(folder / 'fold.csv')
        table[table['image'].str.endswith('.png')].to_csv(
            folder / 'fold.csv', index=False)
    got = port_dataset.ImageDataset(img_folder=str(folder / 'imgs'), **kw)
    want = jax_dataset.ImageDataset(img_folder=str(folder / 'imgs'), **kw)
    assert len(got) == len(want) and _rows(got.rows) == _rows(want.rows)
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert sorted(g) == sorted(w) and g['image_name'] == w['image_name']
        np.testing.assert_array_equal(g['features'], w['features'])
    for g, w in zip(got.arrays(), want.arrays()):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('masks', ['npy', 'png', 'rle', 'none'])
@pytest.mark.parametrize('kw', [{'fold_number': 0},
                                {'fold_number': 2, 'is_test': True},
                                {'max_count': 3}])
def test_image_with_mask_dataset_is_jaxs(folder, masks, kw):
    mask_dir = folder / 'masks'
    mask_dir.mkdir()
    for i in range(12):
        m = (_pixels(100 + i, (6, 5)) > 100).astype(np.uint8)
        if masks == 'npy':
            np.save(mask_dir / f'im{i}.npy', m.astype(np.int32))
        elif masks == 'png':
            assert cv2.imwrite(str(mask_dir / f'im{i}.png'), m)
    extra = {'mask_folder': str(mask_dir)} if masks in ('npy', 'png') \
        else {}
    if masks == 'none':
        extra['rle_key'] = 'absent'
    args = dict(img_folder=str(folder / 'imgs'),
                fold_csv=str(folder / 'fold.csv'), **extra, **kw)
    got = port_dataset.ImageWithMaskDataset(**args)
    want = jax_dataset.ImageWithMaskDataset(**args)
    assert _rows(got.rows) == _rows(want.rows)
    (gx, gy), (wx, wy) = got.arrays(), want.arrays()
    for g, w in ((gx, wx), (gy, wy)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if masks != 'none':
        assert gy.max() == 1


def test_fold_filter_and_balance_are_jaxs(folder):
    for fold_number in (None, 0, 3):
        for is_test in (False, True):
            args = (None, str(folder / 'fold.csv'), fold_number, is_test)
            got = port_dataset.apply_fold_filter(*args)
            assert _rows(got) == _rows(jax_dataset.apply_fold_filter(*args))
    rows = [{'label': i % 4, 'i': i} for i in range(30)]
    for max_count in (None, 7, [1, 1, 1, 1], [3, 0, 1], [1, 2, 3, 4, 5],
                      [0, 0]):
        assert port_dataset.balance_max_count(rows, max_count) == \
            jax_dataset.balance_max_count(rows, max_count)


# ------------------------------------------------------ digits_segmentation
@pytest.mark.parametrize('kw', [
    {}, {'image_size': 16, 'seed': 3, 'valid_fraction': 0.3},
    {'image_size': 8, 'threshold': 0.5}, {'fold_csv': True},
    {'fold_csv': True, 'fold_number': 4, 'image_size': 24}])
def test_digits_segmentation_is_jaxs(tmp_path, kw):
    kw = dict(kw)
    if kw.pop('fold_csv', False):
        path = tmp_path / 'fold.csv'
        pd.DataFrame({'fold': np.arange(1797) % 5}).to_csv(path,
                                                           index=False)
        kw['fold_csv'] = str(path)
    got = port_data.create_dataset('digits_segmentation', **kw)
    want = jax_data.create_dataset('digits_segmentation', **kw)
    assert sorted(got) == sorted(want) and got['source'] == want['source']
    for key in ('x_train', 'y_train', 'x_valid', 'y_valid'):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize('kw,error', [
    ({'image_size': 12}, ValueError), ({'fold_csv': 'short'}, ValueError)])
def test_digits_segmentation_refuses_as_jax(tmp_path, kw, error):
    if kw.get('fold_csv'):
        path = tmp_path / 'fold.csv'
        pd.DataFrame({'fold': [0, 1]}).to_csv(path, index=False)
        kw = {'fold_csv': str(path)}
    with pytest.raises(error) as mine:
        port_data.create_dataset('digits_segmentation', **kw)
    with pytest.raises(error) as theirs:
        jax_data.create_dataset('digits_segmentation', **kw)
    assert str(mine.value) == str(theirs.value)
