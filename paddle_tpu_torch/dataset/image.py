"""Image preprocessing utilities (reference python/paddle/dataset/image.py:
197-327 resize_short, to_chw, center_crop, random_crop, left_right_flip,
simple_transform, load_and_transform).

NumPy-native: the reference hard-requires cv2 for resizing; here
`resize_short` is a pure-numpy bilinear resample (no cv2/PIL dependency),
with cv2 used opportunistically when present (identical contract, cubic
interpolation). Decoding compressed files (`load_image`) still needs
PIL or cv2 and raises a clear error when neither is importable.
"""
from __future__ import annotations

import numpy as np

try:  # probe once: a failed import inside the per-image hot path would
    import cv2 as _cv2  # re-run a full finder scan per call
except ImportError:
    _cv2 = None

__all__ = [
    "resize_short", "to_chw", "center_crop", "random_crop",
    "left_right_flip", "simple_transform", "load_and_transform",
    "load_image",
]


def _resize_bilinear(im: np.ndarray, h_new: int, w_new: int) -> np.ndarray:
    """Pure-numpy bilinear resize, HWC or HW layout, dtype-preserving."""
    h, w = im.shape[:2]
    if (h, w) == (h_new, w_new):
        return im
    squeeze = im.ndim == 2
    if squeeze:
        im = im[:, :, None]
    # sample positions with half-pixel centers (align_corners=False)
    ys = (np.arange(h_new) + 0.5) * h / h_new - 0.5
    xs = (np.arange(w_new) + 0.5) * w / w_new - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    imf = im.astype(np.float32)
    top = imf[y0][:, x0] * (1 - wx) + imf[y0][:, x1] * wx
    bot = imf[y1][:, x0] * (1 - wx) + imf[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    if np.issubdtype(im.dtype, np.integer):
        out = np.clip(np.rint(out), np.iinfo(im.dtype).min,
                      np.iinfo(im.dtype).max)
    out = out.astype(im.dtype)
    return out[:, :, 0] if squeeze else out


def resize_short(im, size):
    """Resize so the SHORTER edge equals `size` (reference image.py:197).
    im: HWC (or HW) ndarray."""
    h, w = im.shape[:2]
    h_new, w_new = size, size
    if h > w:
        h_new = size * h // w
    else:
        w_new = size * w // h
    if _cv2 is not None:  # optional fast path, reference interpolation
        return _cv2.resize(im, (w_new, h_new),
                           interpolation=_cv2.INTER_CUBIC)
    return _resize_bilinear(im, h_new, w_new)


def to_chw(im, order=(2, 0, 1)):
    """HWC -> CHW transpose (reference image.py:225)."""
    assert len(im.shape) == len(order)
    return im.transpose(order)


def center_crop(im, size, is_color=True):
    """Crop the center `size` x `size` patch (reference image.py:249)."""
    h, w = im.shape[:2]
    h_start = (h - size) // 2
    w_start = (w - size) // 2
    if is_color:
        return im[h_start:h_start + size, w_start:w_start + size, :]
    return im[h_start:h_start + size, w_start:w_start + size]


def random_crop(im, size, is_color=True, rng=None):
    """Crop a random `size` x `size` patch (reference image.py:277). The
    extra `rng` lets callers make the crop deterministic."""
    rng = rng or np.random
    # accept both the legacy RandomState API (randint) and the modern
    # Generator API (integers)
    draw = getattr(rng, "integers", None) or rng.randint
    h, w = im.shape[:2]
    h_start = int(draw(0, h - size + 1)) if h > size else 0
    w_start = int(draw(0, w - size + 1)) if w > size else 0
    if is_color:
        return im[h_start:h_start + size, w_start:w_start + size, :]
    return im[h_start:h_start + size, w_start:w_start + size]


def left_right_flip(im, is_color=True):
    """Mirror horizontally (reference image.py:305)."""
    if len(im.shape) == 3 and is_color:
        return im[:, ::-1, :]
    return im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train, is_color=True,
                     mean=None):
    """resize_short -> crop (random+flip when training, center otherwise)
    -> CHW -> optional mean subtraction (reference image.py:327)."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color=is_color)
        if np.random.randint(2) == 0:
            im = left_right_flip(im, is_color)
    else:
        im = center_crop(im, crop_size, is_color=is_color)
    if len(im.shape) == 3:
        im = to_chw(im)
    im = im.astype(np.float32)
    if mean is not None:
        mean = np.array(mean, dtype=np.float32)
        if mean.ndim == 1 and len(im.shape) == 3:
            mean = mean[:, None, None]
        im -= mean
    return im


def load_image(file, is_color=True):
    """Decode an image file to an HWC uint8 ndarray. Needs PIL or cv2
    (reference image.py:167 uses cv2)."""
    if _cv2 is not None:
        flag = _cv2.IMREAD_COLOR if is_color else _cv2.IMREAD_GRAYSCALE
        return _cv2.imread(file, flag)
    try:
        from PIL import Image

        img = Image.open(file)
        img = img.convert("RGB" if is_color else "L")
        return np.asarray(img)
    except ImportError:
        raise ImportError(
            "decoding image files needs cv2 or PIL; neither is importable "
            "(the numpy transforms resize_short/center_crop/random_crop/"
            "to_chw work on already-decoded arrays)")


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    """load_image + simple_transform (reference image.py:383)."""
    return simple_transform(load_image(filename, is_color), resize_size,
                            crop_size, is_train, is_color, mean)
