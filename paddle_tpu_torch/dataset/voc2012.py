"""The port's copy of ``paddle_tpu/dataset/voc2012.py``.

Pascal VOC2012 segmentation (reference:
python/paddle/v2/dataset/voc2012.py — (HWC uint8 image, HW class-index mask)
pairs from VOCtrainval_11-May-2012.tar; splits trainval/train/val).

Offline fallback: synthetic images with rectangular class blobs so a
segmentation head can overfit (same (image, mask) schema, 21 classes).
"""

import io
import tarfile

import numpy as np

from paddle_tpu_torch.dataset import common

ARCHIVE = "VOCtrainval_11-May-2012.tar"
SET_FILE = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
DATA_FILE = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
LABEL_FILE = "VOCdevkit/VOC2012/SegmentationClass/{}.png"
NUM_CLASSES = 21


def _real_reader(sub_name):
    def reader():
        from PIL import Image
        path = common.cached_file("voc2012", ARCHIVE)
        with tarfile.open(path) as tar:
            members = {m.name: m for m in tar.getmembers()}
            sets = tar.extractfile(members[SET_FILE.format(sub_name)])
            for line in sets:
                key = line.decode().strip()
                img = Image.open(io.BytesIO(
                    tar.extractfile(members[DATA_FILE.format(key)]).read()))
                lbl = Image.open(io.BytesIO(
                    tar.extractfile(members[LABEL_FILE.format(key)]).read()))
                yield np.array(img), np.array(lbl)
    return reader


def _synthetic_reader(split, num, seed, hw=96):
    def reader():
        r = np.random.RandomState(seed)
        for _ in range(num):
            img = r.randint(0, 255, (hw, hw, 3), np.uint8)
            mask = np.zeros((hw, hw), np.uint8)
            for _ in range(int(r.randint(1, 4))):
                cls = int(r.randint(1, NUM_CLASSES))
                y0, x0 = r.randint(0, hw - 16, 2)
                h, w = r.randint(8, 32, 2)
                mask[y0:y0 + h, x0:x0 + w] = cls
                # blob colour correlates with class so it is learnable
                img[y0:y0 + h, x0:x0 + w, cls % 3] = 200 + cls
            yield img, mask
    return common.synthetic_fallback("voc2012", split, reader)


def train():
    if common.cached_file("voc2012", ARCHIVE):
        return common.real_data(_real_reader("trainval"))
    return _synthetic_reader("train", 512, seed=71)


def test():
    if common.cached_file("voc2012", ARCHIVE):
        return common.real_data(_real_reader("train"))
    return _synthetic_reader("test", 128, seed=711)


def val():
    if common.cached_file("voc2012", ARCHIVE):
        return common.real_data(_real_reader("val"))
    return _synthetic_reader("val", 128, seed=7111)
