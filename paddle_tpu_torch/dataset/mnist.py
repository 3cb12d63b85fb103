"""The port's copy of ``paddle_tpu/dataset/mnist.py``.

MNIST (reference: python/paddle/v2/dataset/mnist.py — idx-format parser,
(784-float normalized to [-1,1], int label) samples)."""

import gzip
import struct

import numpy as np

from paddle_tpu_torch.dataset import common, synthetic

TRAIN_IMAGES = "train-images-idx3-ubyte.gz"
TRAIN_LABELS = "train-labels-idx1-ubyte.gz"
TEST_IMAGES = "t10k-images-idx3-ubyte.gz"
TEST_LABELS = "t10k-labels-idx1-ubyte.gz"


def _idx_reader(images_path, labels_path):
    def reader():
        with gzip.open(labels_path, "rb") as lf:
            magic, n = struct.unpack(">II", lf.read(8))
            labels = np.frombuffer(lf.read(n), np.uint8)
        with gzip.open(images_path, "rb") as imf:
            magic, n, rows, cols = struct.unpack(">IIII", imf.read(16))
            images = np.frombuffer(imf.read(n * rows * cols), np.uint8)
            images = images.reshape(n, rows * cols).astype(np.float32)
        images = images / 255.0 * 2.0 - 1.0   # reference normalisation
        for x, y in zip(images, labels):
            yield x, int(y)
    return reader


def _synthetic(split, n, seed):
    return common.synthetic_fallback(
        "mnist", split, synthetic.classification(n, 784, 10, seed=seed,
                                                 noise=0.4))


def train():
    imgs = common.cached_file("mnist", TRAIN_IMAGES)
    labs = common.cached_file("mnist", TRAIN_LABELS)
    if imgs and labs:
        return common.real_data(_idx_reader(imgs, labs))
    return _synthetic("train", 8192, seed=7)


def test():
    imgs = common.cached_file("mnist", TEST_IMAGES)
    labs = common.cached_file("mnist", TEST_LABELS)
    if imgs and labs:
        return common.real_data(_idx_reader(imgs, labs))
    return _synthetic("test", 1024, seed=77)


def convert(path, line_count=1024):
    """Write the dataset as recordio chunks (reference: the
    per-module convert() feeding cloud training)."""
    out = []
    out += common.convert(path, train(), line_count, 'mnist_train')
    out += common.convert(path, test(), line_count, 'mnist_test')
    return out
