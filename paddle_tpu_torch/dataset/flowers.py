"""The port's copy of ``paddle_tpu/dataset/flowers.py``.

Oxford 102 Flowers (reference: python/paddle/v2/dataset/flowers.py —
102-class classification; images from 102flowers.tgz, labels/setid from
imagelabels.mat/setid.mat; train=tstid, test=trnid split swap as in the
reference; samples are (flattened 3x224x224 float32 CHW, label)).

Offline fallback keeps the (150528-float, int) schema with class-prototype
structure.
"""

import io
import tarfile

import numpy as np

from paddle_tpu_torch.dataset import common, synthetic

DATA_ARCHIVE = "102flowers.tgz"
LABEL_FILE = "imagelabels.mat"
SETID_FILE = "setid.mat"
# the official trnid is smaller than tstid; the reference trains on tstid
TRAIN_FLAG, TEST_FLAG, VALID_FLAG = "tstid", "trnid", "valid"
IMG_DIM = 3 * 224 * 224


def _have_cache():
    return all(common.cached_file("flowers", f)
               for f in (DATA_ARCHIVE, LABEL_FILE, SETID_FILE))


def _transform(img_bytes, is_train):
    """Resize short side to 256, center-crop 224, CHW float32 with the
    reference's mean subtraction (flowers.py default_mapper)."""
    from PIL import Image
    img = Image.open(io.BytesIO(img_bytes)).convert("RGB")
    w, h = img.size
    scale = 256.0 / min(w, h)
    img = img.resize((int(w * scale + 0.5), int(h * scale + 0.5)))
    w, h = img.size
    x0, y0 = (w - 224) // 2, (h - 224) // 2
    arr = np.asarray(img.crop((x0, y0, x0 + 224, y0 + 224)),
                     np.float32)              # HWC RGB
    mean = np.array([123.68, 116.78, 103.94], np.float32)
    arr = (arr - mean).transpose(2, 0, 1)     # CHW
    return arr.reshape(-1)


def _real_reader(flag, is_train):
    def reader():
        import scipy.io as scio
        labels = scio.loadmat(
            common.cached_file("flowers", LABEL_FILE))["labels"][0]
        indexes = scio.loadmat(
            common.cached_file("flowers", SETID_FILE))[flag][0]
        wanted = {int(i) for i in indexes}
        with tarfile.open(common.cached_file("flowers", DATA_ARCHIVE)) as tar:
            for m in tar:
                if not m.name.endswith(".jpg"):
                    continue
                idx = int(m.name[-9:-4])       # image_#####.jpg
                if idx not in wanted:
                    continue
                img = tar.extractfile(m).read()
                yield _transform(img, is_train), int(labels[idx - 1]) - 1
    return reader


def train():
    if _have_cache():
        return common.real_data(_real_reader(TRAIN_FLAG, True))
    return common.synthetic_fallback(
        "flowers", "train",
        synthetic.classification(2048, IMG_DIM, 102, seed=81, noise=0.5))


def test():
    if _have_cache():
        return common.real_data(_real_reader(TEST_FLAG, False))
    return common.synthetic_fallback(
        "flowers", "test",
        synthetic.classification(256, IMG_DIM, 102, seed=811, noise=0.5))


def valid():
    if _have_cache():
        return common.real_data(_real_reader(VALID_FLAG, False))
    return common.synthetic_fallback(
        "flowers", "valid",
        synthetic.classification(256, IMG_DIM, 102, seed=8111, noise=0.5))
