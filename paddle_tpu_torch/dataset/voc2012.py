"""Pascal VOC2012 segmentation dataset (reference
python/paddle/dataset/voc2012.py): yields (image HWC uint8,
label HW uint8 class mask) pairs.

Real data: VOCtrainval_11-May-2012.tar under DATA_HOME/voc2012 — same
tar layout the reference streams (ImageSets/Segmentation split files,
JPEGImages, SegmentationClass); decoding needs PIL. Zero-egress fallback:
synthetic scenes of colored rectangles whose mask marks the rectangle
class, so segmentation models have learnable signal.
"""
from __future__ import annotations

import io
import tarfile

import numpy as np

from .common import locate

__all__ = ["train", "test", "val", "is_synthetic"]

_TAR = "VOCtrainval_11-May-2012.tar"
SET_FILE = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
DATA_FILE = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
LABEL_FILE = "VOCdevkit/VOC2012/SegmentationClass/{}.png"
_N_CLASSES = 21
_SYN = {"trainval": 64, "train": 48, "val": 16}
_SYN_HW = (96, 128)


def is_synthetic() -> bool:
    return locate("voc2012", _TAR) is None


_SPLIT_SEED = {"trainval": 11, "train": 12, "val": 13}


def _synthetic(sub_name: str):
    # fixed per-split seed: hash() is randomized per process and would
    # break the dataset package's deterministic-fallback contract
    rng = np.random.default_rng(_SPLIT_SEED[sub_name])
    h, w = _SYN_HW
    for _ in range(_SYN[sub_name]):
        img = rng.integers(0, 64, (h, w, 3), dtype=np.uint8)
        label = np.zeros((h, w), np.uint8)
        for _ in range(int(rng.integers(1, 4))):
            cls = int(rng.integers(1, _N_CLASSES))
            y0, x0 = int(rng.integers(0, h // 2)), int(rng.integers(0, w // 2))
            y1 = y0 + int(rng.integers(h // 4, h // 2))
            x1 = x0 + int(rng.integers(w // 4, w // 2))
            color = np.array([cls * 11 % 256, cls * 37 % 256,
                              cls * 73 % 256], np.uint8)
            img[y0:y1, x0:x1] = color
            label[y0:y1, x0:x1] = cls
        yield img, label


def _tar_reader(path: str, sub_name: str):
    from PIL import Image

    tarobject = tarfile.open(path)
    name2mem = {ele.name: ele for ele in tarobject.getmembers()}

    def reader():
        sets = tarobject.extractfile(name2mem[SET_FILE.format(sub_name)])
        for line in sets:
            line = line.strip().decode()
            data = tarobject.extractfile(
                name2mem[DATA_FILE.format(line)]).read()
            label = tarobject.extractfile(
                name2mem[LABEL_FILE.format(line)]).read()
            yield (np.array(Image.open(io.BytesIO(data))),
                   np.array(Image.open(io.BytesIO(label))))

    return reader


def _reader(sub_name: str):
    path = locate("voc2012", _TAR)
    if path:
        return _tar_reader(path, sub_name)
    return lambda: _synthetic(sub_name)


def train():
    """2913 trainval images HWC (reference voc2012.py:68)."""
    return _reader("trainval")


def test():
    return _reader("train")


def val():
    return _reader("val")
